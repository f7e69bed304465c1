"""``InferenceModel.inference_batch`` of the port against the JAX package's:
the same checkpoint (the port's, which JAX's ``load_model`` reads), the same
mels of 33, 40 and 64 frames (one 64-frame bucket) and, for Parallel
WaveGAN, the same noise, for HiFi-GAN (through the tail kernel K1's plain
version), Parallel WaveGAN (K3's) and Multi-band MelGAN with PQMF (K6's),
within 2e-4 (``tests/test_torch_parity.py:41``); StyleMelGAN is refused on
both sides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import InferenceModel, load_model  # noqa: E402

TOL = 2e-4
LENGTHS = (33, 40, 64)
# generator params at small widths; the second dict is the port's kernel flag
CASES = {
    "hifigan": ("HiFiGANGenerator", dict(
        in_channels=10, out_channels=1, channels=32, kernel_size=7,
        upsample_scales=[4, 2, 2], upsample_kernel_sizes=[8, 4, 4],
        resblock_kernel_sizes=[3, 7], resblock_dilations=[[1, 3], [1, 3]]),
        {"use_pallas_tail": True}),
    "pwg": ("ParallelWaveGANGenerator", dict(
        layers=4, stacks=2, residual_channels=8, gate_channels=16, skip_channels=8,
        aux_channels=10, aux_context_window=2,
        upsample_params={"upsample_scales": [4, 4]}), {"use_pallas_stack": True}),
    "mb_melgan": ("MelGANGenerator", dict(
        in_channels=10, out_channels=2, kernel_size=7, channels=32,
        upsample_scales=[4, 2], stack_kernel_size=3, stacks=2), {"use_pallas_stacks": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_inference_batch_matches_jax(tmp_path, monkeypatch, case):
    gen_type, gp, flag = CASES[case]
    gen = get_model_class(gen_type)(**gp, generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "checkpoint-1steps.pkl")
    save_checkpoint(ckpt, gen.state_dict(), steps=1)
    config = {"sampling_rate": 16000, "hop_size": 16, "format": "npy", "version": "0.5.4",
              "generator_type": gen_type, "generator_params": gp}
    model = load_model(ckpt, dict(config, generator_params=dict(gp, **flag)), device="cpu")
    route = {"hifigan": lambda g: g.tail_from, "pwg": lambda g: g.use_stack,
             "mb_melgan": lambda g: g.fused_stages}[case]
    assert route(model.generator)  # the kernel's wrapper (its plain version here)
    rs = np.random.RandomState(1)
    mels = [rs.randn(t, 10).astype(np.float32) for t in LENGTHS]

    seen = {}
    forward = model.forward_padded_batch

    def spy(c, z=None):
        seen["c"], seen["z"] = c.numpy(), None if z is None else z.numpy()
        return forward(c, z)

    model.forward_padded_batch = spy
    ys = model.inference_batch(mels, rng=torch.Generator().manual_seed(2))
    up = model.upsample_factor
    assert seen["c"].shape == (3, 64, 10)
    # each mel edge-padded to the shared bucket
    np.testing.assert_array_equal(seen["c"][0, 33:], np.repeat(mels[0][-1:], 31, 0))
    assert (seen["z"] is None) == (case != "pwg")
    jax_model = jax_load_model(ckpt, config)
    if case == "pwg":
        assert seen["z"].shape == (3, 64 * up)
        real_normal = jax.random.normal

        def normal(key, shape, *a, **k):  # JAX's draw, replaced by the port's
            if tuple(shape) != seen["z"].shape:
                return real_normal(key, shape, *a, **k)
            seen["jax_drew"] = True
            return jnp.asarray(seen["z"])

        monkeypatch.setattr(jax.random, "normal", normal)
    want = jax_model.inference_batch(mels)
    if case == "pwg":
        monkeypatch.setattr(jax.random, "normal", real_normal)
        assert seen["jax_drew"]
    assert len(ys) == len(want) == 3
    for t, y, w in zip(LENGTHS, ys, want):
        w = np.asarray(w)
        assert y.shape == w.shape == (t * up, 1)
        np.testing.assert_allclose(y, w, atol=TOL)
    # a batch of one is the single decode with the same noise
    model.forward_padded_batch = forward
    if case != "pwg":
        np.testing.assert_allclose(model.inference_batch(mels[1:2])[0],
                                   model.inference(mels[1]), atol=1e-6)


def test_inference_batch_refuses_style_melgan():
    gp = dict(in_channels=8, aux_channels=10, channels=16, noise_upsample_scales=[2, 2],
              upsample_scales=[2, 2], kernel_size=3, dilation=2)
    gen = get_model_class("StyleMelGANGenerator")(**gp).eval()
    with pytest.raises(ValueError, match="batched decode"):
        InferenceModel(gen, "cpu").inference_batch([np.zeros((32, 10), np.float32)])
