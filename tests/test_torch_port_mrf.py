"""The port's fused HiFi-GAN MRF stage (K2) held against the JAX package.

``fused_hifigan_mrf`` (its plain version on the CPU) is fed the same numpy
blocks as the JAX ``fused_hifigan_mrf`` and ``fused_hifigan_mrf_packed``
(Pallas in interpret mode); ``HiFiGANGenerator(use_pallas_mrf=True)`` takes
the JAX ``init`` parameters and is compared with the JAX generator with the
same flag, its Pallas kernels forced on the CPU by ``PALLAS_INTERPRET_OK``.
Tolerance atol 2e-4 (float32 convolutions summed in another order).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.ops.pallas_kernels import hifigan_mrf as jax_mrf  # noqa: E402
from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.models import hifigan as port_hifigan  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import hifigan_mrf as port_mrf  # noqa: E402
from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import load_model  # noqa: E402

HIFIGAN = "HiFiGANGenerator"
TOL = 2e-4
# tests/test_hifigan_mrf_kernel.py:39-43, stage widths 16 and 8
SMALL = dict(in_channels=10, channels=32, upsample_scales=(4, 4),
             upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
             resblock_dilations=((1, 3), (1, 3)))
MEL = np.random.RandomState(0).randn(2, 20, 10).astype(np.float32)


def _blocks(rs, c, kernels=(3, 7, 11), dilations=(1, 3, 5)):
    def w(*shape):
        return (rs.randn(*shape) * 0.5 / np.sqrt(shape[1] * shape[2])).astype(np.float32)

    return [{"w1": w(len(dilations), k, c, c),
             "b1": (rs.randn(len(dilations), c) * 0.1).astype(np.float32),
             "w2": w(len(dilations), k, c, c),
             "b2": (rs.randn(len(dilations), c) * 0.1).astype(np.float32),
             "dilations": dilations} for k in kernels]


def _as(blocks, fn):
    return [{k: (v if k == "dilations" else fn(v)) for k, v in blk.items()}
            for blk in blocks]


@pytest.mark.parametrize("jax_fn,c,b,t", [
    ("fused_hifigan_mrf", 8, 2, 300),
    ("fused_hifigan_mrf", 128, 1, 96),      # K2a's width
    ("fused_hifigan_mrf_packed", 32, 1, 400),
    ("fused_hifigan_mrf_packed", 64, 2, 333),
    ("fused_hifigan_mrf_packed", 16, 1, 7),  # all edge
])
def test_fused_mrf_matches_jax(jax_fn, c, b, t):
    rs = np.random.RandomState(c + t)
    blocks = _blocks(rs, c)
    x = rs.randn(b, t, c).astype(np.float32)
    kw = {"t_tile": 128} if jax_fn == "fused_hifigan_mrf" else {}
    want = getattr(jax_mrf, jax_fn)(jnp.asarray(x), _as(blocks, jnp.asarray),
                                    interpret=True, **kw)
    calls = port_mrf.fused_hifigan_mrf.calls
    with torch.no_grad():
        got = port_mrf.fused_hifigan_mrf(torch.from_numpy(x),
                                         _as(blocks, torch.from_numpy))
    assert port_mrf.fused_hifigan_mrf.calls == calls  # no kernel on the CPU
    assert got.shape == (b, t, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_mrf_reference_equals_the_xla_twin_with_uneven_blocks():
    rs = np.random.RandomState(9)
    blocks = _blocks(rs, 16, kernels=(3, 5), dilations=(1, 2))
    blocks.append(_blocks(rs, 16, kernels=(7,), dilations=(1, 3, 9))[0])
    x = rs.randn(1, 150, 16).astype(np.float32)
    want = jax_mrf.hifigan_mrf_xla(jnp.asarray(x), _as(blocks, jnp.asarray), 0.2)
    got = port_mrf.hifigan_mrf_reference(torch.from_numpy(x),
                                         _as(blocks, torch.from_numpy), slope=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_cuda_input_checks_name_the_width():
    rs = np.random.RandomState(1)
    with pytest.raises(ValueError, match="MRF width 256 is not a power of two"):
        port_mrf._check_cuda_inputs(torch.zeros(1, 16, 256),
                                    _as(_blocks(rs, 256, kernels=(3,),
                                                dilations=(1,)), torch.from_numpy))
    many = _as(_blocks(rs, 8, kernels=(3,) * 9, dilations=(1,)), torch.from_numpy)
    with pytest.raises(ValueError, match="1 to 8 resblocks"):
        port_mrf._check_cuda_inputs(torch.zeros(1, 16, 8), many)
    port_mrf._check_cuda_inputs(torch.zeros(1, 16, 8), many[:8])  # accepted


def _spy(monkeypatch):
    calls = []
    real = port_hifigan.fused_hifigan_mrf

    def spy(x, blocks, **kw):
        calls.append(tuple(x.shape))
        return real(x, blocks, **kw)

    monkeypatch.setattr(port_hifigan, "fused_hifigan_mrf", spy)
    return calls


@pytest.mark.parametrize("kw,routed", [
    ({}, [(2, 80, 16), (2, 320, 8)]),
    ({"pallas_mrf_max_channels": 8}, [(2, 320, 8)]),
    ({"pallas_mrf_max_channels": 8, "pallas_mrf_tile": 64}, [(2, 320, 8)]),
])
def test_generator_with_mrf_flag_matches_jax(kw, routed, monkeypatch):
    monkeypatch.setenv("PALLAS_INTERPRET_OK", "1")  # JAX runs its kernels too
    g0 = jax_model_class(HIFIGAN)(**SMALL)
    v = g0.init(jax.random.key(0), jnp.asarray(MEL))
    g1 = jax_model_class(HIFIGAN)(**SMALL, use_pallas_mrf=True, **kw)
    want = np.asarray(g1.apply(v, jnp.asarray(MEL)))
    np.testing.assert_allclose(want, np.asarray(g0.apply(v, jnp.asarray(MEL))),
                               atol=TOL)
    port = get_model_class(HIFIGAN)(**SMALL, use_pallas_mrf=True, **kw).eval()
    port.load_state_dict(jax_params_to_state_dict(HIFIGAN, SMALL, v))
    calls = _spy(monkeypatch)
    with torch.no_grad():
        got = port(torch.from_numpy(MEL).transpose(1, 2)).transpose(1, 2)
    assert calls == routed
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_tail_takes_precedence_over_the_mrf_gate(monkeypatch):
    monkeypatch.setenv("PALLAS_INTERPRET_OK", "1")
    params = dict(SMALL, upsample_scales=(4, 4, 2, 2),
                  upsample_kernel_sizes=(8, 8, 4, 4))
    flags = dict(use_pallas_mrf=True, use_pallas_tail=True, pallas_tail_tile=256)
    g = jax_model_class(HIFIGAN)(**params, **flags)
    v = g.init(jax.random.key(1), jnp.asarray(MEL))
    want = np.asarray(g.apply(v, jnp.asarray(MEL)))
    port = get_model_class(HIFIGAN)(**params, **flags).eval()
    port.load_state_dict(jax_params_to_state_dict(HIFIGAN, params, v))
    assert port.tail_from == 2 and port.mrf_stages == (0, 1, 2, 3)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        got = port(torch.from_numpy(MEL).transpose(1, 2)).transpose(1, 2)
    assert calls == [(2, 80, 16)]  # stage 1's MRF runs inside the tail
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("kw,stages", [
    (dict(use_pallas_mrf=True), (0, 1)),
    (dict(use_pallas_mrf=True, use_additional_convs=False), ()),
    (dict(use_pallas_mrf=True, bias=False), ()),
    (dict(use_pallas_mrf=True, nonlinear_activation="ReLU",
          nonlinear_activation_params={"inplace": False}), ()),
    (dict(use_pallas_mrf=False), ()),
])
def test_mrf_gate(kw, stages):
    assert get_model_class(HIFIGAN)(**SMALL, **kw).mrf_stages == stages


def test_config_with_jax_tile_keys_loads_and_decodes(tmp_path):
    """Keys the JAX generator takes no longer raise TypeError in the port."""
    gp = dict(SMALL, use_pallas_mrf=True, pallas_mrf_tile=512,
              pallas_mrf_max_channels=64, pallas_tail_tile=512)
    gen = get_model_class(HIFIGAN)(**gp, generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "checkpoint-1steps.pkl")
    save_checkpoint(ckpt, gen.state_dict(), steps=1)
    config = {"sampling_rate": 16000, "hop_size": 16, "format": "npy",
              "generator_type": HIFIGAN, "generator_params": gp}
    with open(tmp_path / "config.yml", "w") as f:
        json.dump(config, f)  # JSON is YAML
    model = load_model(ckpt, device="cpu")
    assert model.generator.mrf_stages == (0, 1)
    assert set(model.generator._mrf_cache) == {0, 1}  # gathered once
    mel = MEL[0]
    got = model.inference(mel)
    want = np.asarray(jax_load_model(ckpt, config).inference(mel))
    assert got.shape == want.shape == (20 * 16, 1)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_training_forward_through_the_mrf_kernel_raises():
    port = get_model_class(HIFIGAN)(**SMALL, use_pallas_mrf=True)
    x = torch.from_numpy(MEL).transpose(1, 2)
    with pytest.raises(RuntimeError, match="inference-only"):
        port(x)
    blocks = [port.blocks[2].gather_weights()]
    blocks[0]["w1"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference-only"):
        port_mrf.fused_hifigan_mrf(torch.zeros(1, 8, 8), blocks)
