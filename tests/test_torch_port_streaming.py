"""``InferenceModel.inference_streaming`` of the port against the JAX
package's (``tests/test_streaming.py``'s shapes): the same checkpoint (the
port's, which JAX's ``load_model`` reads), the same mels and, for Parallel
WaveGAN, the same noise (numpy, given to both sides' draws), for HiFi-GAN
(the port through K1's plain version), MelGAN, Multi-band MelGAN with PQMF
(K6's) and Parallel WaveGAN (K3's), within atol 2e-4 and rtol 1e-3; each
also against the port's forward of the exact-length mel, which streaming
equals where the context covers the receptive field. Also: more than 64
interior windows (two batches), the short-input fallback, the refusals,
and the kernel wrappers' grid limits, which they check before they look at
the device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import build  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.hifigan_mrf import fused_hifigan_mrf  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import fused_hifigan_tail  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import fused_melgan_stacks  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.wavenet import (  # noqa: E402
    fused_gated_resblock,
    fused_wavenet_stack,
)
from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import InferenceModel, load_model  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3
# generator params at small widths (tests/test_streaming.py's, with
# HiFi-GAN's last two stages at stride 2 and MelGAN's two sub-bands so that
# the port's kernel flags route them); the third entry is the port's flag
CASES = {
    "hifigan": ("HiFiGANGenerator", dict(
        in_channels=8, out_channels=1, channels=16, upsample_scales=[4, 2, 2],
        upsample_kernel_sizes=[8, 4, 4], resblock_kernel_sizes=[3, 5],
        resblock_dilations=[[1, 3], [1, 3]]), {"use_pallas_tail": True}),
    "melgan": ("MelGANGenerator", dict(
        in_channels=8, out_channels=1, channels=16, upsample_scales=[4, 4], stacks=2),
        {"use_pallas_stacks": True}),
    "mb_melgan": ("MelGANGenerator", dict(
        in_channels=8, out_channels=2, channels=32, upsample_scales=[4, 2], stacks=2),
        {"use_pallas_stacks": True}),
    "pwg": ("ParallelWaveGANGenerator", dict(
        in_channels=1, out_channels=1, layers=6, stacks=2, residual_channels=16,
        gate_channels=32, skip_channels=16, aux_channels=8, aux_context_window=2,
        upsample_net="ConvInUpsampleNetwork", upsample_params={"upsample_scales": [4, 4]}),
        {"use_pallas_stack": True}),
}


def _models(tmp_path, case):
    """(port model on the CPU with its kernel flag, JAX model) of one
    random-init checkpoint."""
    gen_type, gp, flag = CASES[case]
    gen = get_model_class(gen_type)(**gp, generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "checkpoint-1steps.pkl")
    save_checkpoint(ckpt, gen.state_dict(), steps=1)
    config = {"sampling_rate": 16000, "hop_size": 16, "format": "npy", "version": "0.5.4",
              "generator_type": gen_type, "generator_params": gp}
    port = load_model(ckpt, dict(config, generator_params=dict(gp, **flag)), device="cpu")
    return port, jax_load_model(ckpt, config)


def _shared_noise(monkeypatch, port, n):
    """Give the port's ``_noise`` and JAX's ``jax.random.normal`` the same
    numpy noise of n samples; returns it."""
    z = np.random.RandomState(11).randn(n).astype(np.float32)
    monkeypatch.setattr(port, "_noise", lambda shape, rng: torch.from_numpy(z.copy()))
    real = jax.random.normal

    def normal(key, shape, *a, **k):
        return jnp.asarray(z) if tuple(shape) == (n,) else real(key, shape, *a, **k)

    monkeypatch.setattr(jax.random, "normal", normal)
    return z


def _exact(port, mel, z=None):
    """The port's forward of the whole exact-length mel."""
    with torch.inference_mode():
        return port.forward_padded(torch.from_numpy(mel),
                                   None if z is None else torch.from_numpy(z)).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_streaming_matches_jax_and_the_exact_length_forward(tmp_path, monkeypatch, case):
    port, jax_model = _models(tmp_path, case)
    mel = np.random.RandomState(0).randn(229, 8).astype(np.float32)  # 2 interior windows
    up = port.upsample_factor
    z = _shared_noise(monkeypatch, port, 229 * up) if case == "pwg" else None
    calls = []
    forward = port.forward_padded_batch

    def spy(c, zz=None):
        calls.append((tuple(c.shape), None if zz is None else tuple(zz.shape)))
        return forward(c, zz)

    monkeypatch.setattr(port, "forward_padded_batch", spy)
    got = port.inference_streaming(mel, chunk_frames=64, context_frames=32)
    # first window, the interior's bucket of 2, last window: exact lengths
    noise = (lambda n, b=1: (b, n * up)) if case == "pwg" else (lambda n, b=1: None)
    assert calls == [((1, 96, 8), noise(96)), ((2, 128, 8), noise(128, 2)),
                     ((1, 96, 8), noise(96))]
    want = np.asarray(jax_model.inference_streaming(mel, chunk_frames=64, context_frames=32))
    assert got.shape == want.shape == (229 * up, 1)
    assert float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _exact(port, mel, z), atol=ATOL, rtol=RTOL)


def test_streaming_batches_more_than_64_interior_windows(tmp_path, monkeypatch):
    """chunk 8, context 8: 66 interior windows go as a batch of 64 and one
    of 2 (zero windows pad a batch to a power of two, none here)."""
    port, jax_model = _models(tmp_path, "hifigan")
    mel = np.random.RandomState(1).randn(8 * 67 + 5, 8).astype(np.float32)
    shapes = []
    forward = port.forward_padded_batch
    monkeypatch.setattr(port, "forward_padded_batch",
                        lambda c, z=None: shapes.append(tuple(c.shape)) or forward(c, z))
    got = port.inference_streaming(mel, chunk_frames=8, context_frames=8)
    assert shapes == [(1, 16, 8), (64, 24, 8), (2, 24, 8), (1, 16, 8)]
    want = np.asarray(jax_model.inference_streaming(mel, chunk_frames=8, context_frames=8))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _exact(port, mel), atol=ATOL, rtol=RTOL)


def test_streaming_pads_a_bucket_with_zero_windows(tmp_path, monkeypatch):
    """3 interior windows run as a batch of 4 whose last window is zeros."""
    port, _ = _models(tmp_path, "melgan")
    mel = np.random.RandomState(2).randn(64 * 4 + 10, 8).astype(np.float32)
    seen = []
    forward = port.forward_padded_batch
    monkeypatch.setattr(port, "forward_padded_batch",
                        lambda c, z=None: seen.append(c.clone()) or forward(c, z))
    got = port.inference_streaming(mel, chunk_frames=64, context_frames=32)
    assert [tuple(c.shape) for c in seen] == [(1, 96, 8), (4, 128, 8), (1, 96, 8)]
    assert not seen[1][3].any() and seen[1][2].any()
    np.testing.assert_allclose(got, _exact(port, mel), atol=ATOL, rtol=RTOL)


def test_streaming_short_input_falls_back(tmp_path):
    port, jax_model = _models(tmp_path, "hifigan")
    mel = np.random.RandomState(2).randn(40, 8).astype(np.float32)
    got = port.inference_streaming(mel, chunk_frames=64, context_frames=32)
    np.testing.assert_array_equal(got, port.inference(mel))
    np.testing.assert_allclose(got, np.asarray(jax_model.inference(mel)), atol=ATOL,
                               rtol=RTOL)


def test_streaming_refuses_context_longer_than_the_chunk(tmp_path):
    port, _ = _models(tmp_path, "melgan")
    with pytest.raises(ValueError, match="must not exceed chunk_frames"):
        port.inference_streaming(np.zeros((100, 8), np.float32), chunk_frames=16,
                                 context_frames=32)


REFUSED = {
    "StyleMelGANGenerator": dict(in_channels=8, aux_channels=8, channels=16,
                                 noise_upsample_scales=[2, 2], upsample_scales=[2, 2],
                                 kernel_size=3, dilation=2),
    "DiscreteSymbolHiFiGANGenerator": dict(
        num_embs=10, num_spk_embs=0, concat_spk_emb=False, in_channels=8, channels=16,
        upsample_scales=[2, 2], upsample_kernel_sizes=[4, 4],
        resblock_kernel_sizes=[3], resblock_dilations=[[1]]),
    "DiscreteSymbolDurationGenerator": dict(
        num_embs=10, num_spk_embs=0, concat_spk_emb=False, in_channels=8, channels=16,
        upsample_scales=[2, 2], upsample_kernel_sizes=[4, 4],
        resblock_kernel_sizes=[3], resblock_dilations=[[1]],
        duration_layers=1, duration_chans=8),
    "DiscreteSymbolStyleMelGANGenerator": dict(
        num_embs=10, num_spk_embs=0, spk_emb_dim=8, concat_spk_emb=False, in_channels=8,
        aux_channels=8, channels=16, noise_upsample_scales=[2, 2],
        upsample_scales=[2, 2], kernel_size=3, dilation=2),
    "UHiFiGANGenerator": dict(in_channels=8, out_channels=1, channels=16,
                              upsample_scales=[2, 2], downsample_scales=[2, 2],
                              upsample_kernel_sizes=[4, 4],
                              downsample_kernel_sizes=[4, 4],
                              resblock_kernel_sizes=[3], resblock_dilations=[[1]]),
    "VQVAE": dict(in_channels=1, out_channels=1, num_embeds=16, embed_dim=8,
                  encoder_conf={"channels": 8, "downsample_scales": [2, 2],
                                "max_downsample_channels": 16},
                  decoder_conf={"channels": 16, "upsample_scales": [2, 2]}),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_streaming_and_sharding_refuse_what_jax_refuses(name):
    model = InferenceModel(get_model_class(name)(**REFUSED[name]).eval(), "cpu")
    mel = np.zeros((400, 8), np.float32)
    with pytest.raises(ValueError, match="not streamable"):
        model.inference_streaming(mel)
    with pytest.raises(ValueError, match="not shardable"):
        model.inference_sharded(mel, ["cpu"] * 2)


def _wide(shape):
    """A CPU tensor of ``shape`` without its memory (stride 0)."""
    return torch.zeros(1, 1, shape[2]).expand(*shape)


def test_kernel_wrappers_check_their_grid_before_the_device():
    """Each decode kernel's wrapper refuses, on the CPU too, a batch past
    blockIdx.y's 65535 or a length past the 32-bit row index's 2**30,
    naming the limit; the largest shapes streaming gives at the CLI's
    defaults and at --chunk-frames 1024 are within both."""
    for batch, rows in ((64, 98304), (64, (1024 + 2 * 64) * 256), (1, 2 ** 30)):
        build.check_grid("k", batch, rows)
    w = {"wconv": torch.zeros(1, 3, 16, 32)}
    blocks = [{"w1": torch.zeros(1, 3, 16, 16), "dilations": (1,)}]
    stages = [{"deconv_w": torch.zeros(4, 32, 16), "stride": 2, "padding": 1,
               "blocks": blocks}] * 2
    calls = {
        "fused_hifigan_tail": lambda x: fused_hifigan_tail(x, stages, None, None),
        "fused_hifigan_mrf": lambda x: fused_hifigan_mrf(x, blocks),
        "fused_wavenet_stack": lambda x: fused_wavenet_stack(x, x, w, (1,)),
        "fused_gated_resblock": lambda x: fused_gated_resblock(x, x, *[None] * 7),
        "fused_melgan_stacks": lambda x: fused_melgan_stacks(x, []),
    }
    for name, call in calls.items():
        c = 32 if name == "fused_hifigan_tail" else 16
        with pytest.raises(ValueError, match=rf"{name}: a batch of 65536 .* 65535"):
            call(_wide((65536, 4, c)))
        # the tail's rows are its output's: 4 x its input's after two stride-2 stages
        rows = 2 ** 28 + 1 if name == "fused_hifigan_tail" else 2 ** 30 + 1
        with pytest.raises(ValueError, match=rf"{name}: {4 * rows if c == 32 else rows} "
                                             r"rows .* 2\*\*30"):
            call(_wide((1, rows, c)))
