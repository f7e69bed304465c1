"""The causal HiFi-GAN generator (``use_causal_conv``) of the port against
the JAX package's on the CPU: the port's weights carried into JAX by JAX's
``convert_state_dict`` and back by the port's ``jax_params_to_state_dict``,
with ``use_pallas_tail`` and ``use_pallas_mrf`` set, which both packages'
gates leave on the plain path (JAX :205, :292); the output within 2e-4 of
JAX ``apply``, causal (a later frame changes no earlier sample), and
streamed and decoded through ``load_model`` as the JAX package does."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.convert.torch_checkpoint import convert_state_dict  # noqa: E402
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import jax_params_to_state_dict  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.models import hifigan as hifigan_mod  # noqa: E402
from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import load_model  # noqa: E402

HIFI = "HiFiGANGenerator"
KW = dict(in_channels=8, out_channels=1, channels=32, kernel_size=7,
          upsample_scales=[4, 2, 2], upsample_kernel_sizes=[8, 4, 4],
          resblock_kernel_sizes=[3, 5], resblock_dilations=[[1, 3], [1, 3]],
          use_causal_conv=True)
FLAGS = dict(use_pallas_tail=True, use_pallas_mrf=True, pallas_mrf_max_channels=128)


def _port(**flags):
    return get_model_class(HIFI)(**KW, **flags, generator=torch.Generator().manual_seed(0))


def _run(port, c):
    with torch.inference_mode():
        return port(torch.from_numpy(c).transpose(1, 2)).transpose(1, 2).numpy()


def test_causal_generator_matches_jax_through_the_converters(monkeypatch):
    port = _port(**FLAGS)
    assert port.tail_from is None and port.mrf_stages == ()  # the plain path
    for name in ("fused_hifigan_tail", "fused_hifigan_mrf"):  # never reached
        monkeypatch.setattr(hifigan_mod, name, lambda *a, **k: pytest.fail("kernel called"))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert {"input_conv.conv.weight_v", "upsamples.2.1.deconv.weight_g",
            "blocks.5.convs1.1.1.weight_v", "output_conv.1.conv.bias"} <= set(sd)
    params = convert_state_dict(HIFI, dict(KW, **FLAGS), sd)[0]
    assert set(params["input_conv"]) == {"conv"} and set(params["upsamples_0"]) == {"deconv"}
    c = np.random.RandomState(0).randn(2, 20, 8).astype(np.float32)
    want = np.asarray(jax_model_class(HIFI)(**KW, **FLAGS).apply({"params": params},
                                                                 jnp.asarray(c)))
    got = _run(port, c)
    assert got.shape == want.shape == (2, 20 * 16, 1)
    assert float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-4)
    # causal: frames from 12 on change no sample before 12 * 16
    c2 = c.copy()
    c2[:, 12:] = 0.0
    cut = _run(port, c2)
    np.testing.assert_array_equal(cut[:, : 12 * 16], got[:, : 12 * 16])
    assert not np.array_equal(cut[:, 12 * 16:], got[:, 12 * 16:])
    # and back: JAX's tree -> the port's keys, transposed convs flipped back
    back = jax_params_to_state_dict(HIFI, KW, params)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k])


def test_causal_decode_and_streaming_match_jax(tmp_path):
    """``load_model`` (weight norm folded) with the kernel flags: one-shot
    and streamed decode against JAX's load_model of the same checkpoint."""
    ckpt = str(tmp_path / "checkpoint-1steps.pkl")
    save_checkpoint(ckpt, _port().state_dict(), steps=1)
    config = {"sampling_rate": 16000, "hop_size": 16, "generator_type": HIFI,
              "generator_params": KW}
    port = load_model(ckpt, dict(config, generator_params=dict(KW, **FLAGS)), device="cpu")
    jax_model = jax_load_model(ckpt, config)
    mel = np.random.RandomState(2).randn(229, 8).astype(np.float32)
    np.testing.assert_allclose(port.inference(mel), np.asarray(jax_model.inference(mel)),
                               atol=2e-4, rtol=1e-3)
    got = port.inference_streaming(mel, chunk_frames=64, context_frames=32)
    want = np.asarray(jax_model.inference_streaming(mel, chunk_frames=64, context_frames=32))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    with torch.inference_mode():
        exact = port.forward_padded(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, exact, atol=2e-4, rtol=1e-3)
