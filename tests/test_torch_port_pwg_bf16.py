"""K3's bf16-resident mode (``pallas_stack_bf16``) on the CPU: its plain
version (``wavenet_stack_reference_bf16``, which the port's
``fused_wavenet_stack(..., compute_dtype=torch.bfloat16)`` runs on a CPU
tensor) held against the JAX package's ``fused_wavenet_stack(...,
compute_dtype=jnp.bfloat16)`` in interpret mode, and the Parallel WaveGAN
generator with ``use_pallas_stack`` and ``pallas_stack_bf16`` against
JAX's (``PALLAS_INTERPRET_OK=1``, set by tests/conftest.py, sends JAX
through its fused path). The card kernel's weight tiles and arithmetic are
held on the CPU by tests/test_torch_port_wavenet_bf16_layout.py.

Both sides round the same operands to bf16 (x when a call starts, c, the
weights, g and every layer's new residual) and sum exact products in
float32, in other orders. A bf16 rounding flips only where a float32 sum
lands within that order's noise of a rounding point, so at these sizes
(the stack: C 16, aux 8, four layers at d 1-8, B 2, T 300, weights of
gain one) the residual x equals JAX's bit for bit and the float32 skip
sum differs by 2.9e-8 rms|JAX| and 8.1e-8 max|JAX| at most (measured; the
port with float64 sums differs from JAX as much, 2.8e-8 and 1.4e-7), and
the generator's output (SMALL, JAX's init) by 1.0e-7 rms and 9.3e-8 max.
The float32 stack on the same inputs differs by 4.1e-3 to 4.2e-3 rms and
4.9e-3 to 6.1e-3 max, the float32 generator by 3.3e-3 and 5.1e-3. The
bounds sit between the two, with room for a rounding or two flipped
apart: rms|diff| <= 1e-4 rms|JAX| and max|diff| <= 1e-3 max|JAX| on
every output, and x bit-equal to JAX's in at least 90 % of its elements;
the float32 controls must fail them. At PWG v1's widths and init the
chain is chaotic (one
element rounded apart spreads through the later layers: the port against
itself with float64 sums, 3.2e-3 rms on x after 10 layers, 5.2e-3 after
30); the card's check (chip_smoke.py phase 30) holds the kernel layer by
layer for that reason.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.ops.pallas_kernels.wavenet_stack import (  # noqa: E402
    fused_wavenet_stack as jax_fused_wavenet_stack,
)
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import wavenet as wn  # noqa: E402

PWG = "ParallelWaveGANGenerator"
SMALL = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
             skip_channels=8, aux_channels=10, aux_context_window=2,
             upsample_params={"upsample_scales": [4, 4]})
BF16 = dict(use_pallas_stack=True, pallas_stack_bf16=True)
L, C, CA, K, B, T = 4, 16, 8, 3, 2, 300
DILATIONS = (1, 2, 4, 8)


def _stats(got, want):
    """(rms|diff| / rms|want|, max|diff| / max|want|, share bit-equal)."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = g - w
    return (float(np.sqrt((d ** 2).mean() / (w ** 2).mean())),
            float(np.abs(d).max() / np.abs(w).max()), float((g == w).mean()))


def _close(got, want, equal_share=None) -> bool:
    rms, mx, eq = _stats(got, want)
    return rms <= 1e-4 and mx <= 1e-3 and (equal_share is None or eq >= equal_share)


def _weights(seed, c=C, ca=CA):
    rs = np.random.RandomState(seed)
    shapes = {"wconv": ((L, K, c, 2 * c), K * c), "bconv": ((L, 2 * c), 0),
              "waux": ((L, ca, 2 * c), ca), "wskip": ((L, c, c), c),
              "bskip": ((L, c), 0), "wres": ((L, c, c), c), "bres": ((L, c), 0)}
    return {k: (rs.randn(*s) * (0.1 if fan == 0 else fan ** -0.5)).astype(np.float32)
            for k, (s, fan) in shapes.items()}


def _inputs(seed, c=C, ca=CA):
    rs = np.random.RandomState(seed + 100)
    return (rs.randn(B, T, c).astype(np.float32), rs.randn(B, T, ca).astype(np.float32))


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_stack_reference_bf16_matches_jax_bf16_kernel(seed):
    w = _weights(seed)
    x, c = _inputs(seed)
    jx, js = jax_fused_wavenet_stack(
        jnp.asarray(x), jnp.asarray(c), {k: jnp.asarray(v) for k, v in w.items()},
        DILATIONS, t_tile=128, compute_dtype=jnp.bfloat16, interpret=True)
    jx, js = np.asarray(jx), np.asarray(js)
    with torch.no_grad():
        px, ps = wn.wavenet_stack_reference_bf16(torch.from_numpy(x), torch.from_numpy(c),
                                                 _t(w), DILATIONS)
        qx, qs = wn.wavenet_stack_reference_bf16(torch.from_numpy(x), torch.from_numpy(c),
                                                 _t(w), DILATIONS, sum_dtype=torch.float64)
        fx, fs = wn.wavenet_stack_reference(torch.from_numpy(x), torch.from_numpy(c),
                                            _t(w), DILATIONS)
    assert px.dtype == ps.dtype == torch.float32
    # the residual is bf16-valued
    assert torch.equal(px, px.to(torch.bfloat16).float())
    print(f"seed {seed}: port vs JAX x {_stats(px, jx)}, skip {_stats(ps, js)}; "
          f"float64 sums x {_stats(qx, jx)}, skip {_stats(qs, js)}; "
          f"float32 control x {_stats(fx, jx)}, skip {_stats(fs, js)}")
    assert _close(px, jx, 0.9) and _close(ps, js)
    assert _close(qx, jx, 0.9) and _close(qs, js)
    assert not (_close(fx, jx, 0.9) or _close(fs, js))


def test_stack_wrapper_routes_the_cpu_to_the_bf16_plain_version():
    w = _t(_weights(2))
    x, c = map(torch.from_numpy, _inputs(2))
    before = (wn.fused_wavenet_stack.launches, wn.fused_wavenet_stack.bf16_launches)
    with torch.no_grad():
        got = wn.fused_wavenet_stack(x, c, w, DILATIONS, torch.bfloat16)
        want = wn.wavenet_stack_reference_bf16(x, c, w, DILATIONS)
        # a bf16 x comes back in bf16, as JAX returns x's type
        xb = wn.fused_wavenet_stack(x.to(torch.bfloat16), c, w, DILATIONS, torch.bfloat16)
        # two calls of two layers, skips summed between them as JAX sums them
        cyc = wn.fused_wavenet_cycle(x, c, w, DILATIONS, max_layers_per_call=2,
                                     compute_dtype=torch.bfloat16)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert xb[0].dtype == xb[1].dtype == torch.bfloat16
    assert torch.equal(xb[0].float(), want[0])
    assert torch.equal(cyc[0], want[0])
    torch.testing.assert_close(cyc[1], want[1], rtol=0, atol=1e-5)
    assert (wn.fused_wavenet_stack.launches,
            wn.fused_wavenet_stack.bf16_launches) == before
    with pytest.raises(ValueError, match="compute_dtype"):
        wn.fused_wavenet_stack(x, c, w, DILATIONS, torch.float16)
    leaf = {k: v.clone().requires_grad_() for k, v in w.items()}
    with pytest.raises(RuntimeError, match="inference-only"):
        wn.fused_wavenet_stack(x, c, leaf, DILATIONS, torch.bfloat16)


@pytest.fixture(scope="module")
def jax_params():
    g = jax_model_class(PWG)(**SMALL)
    rs = np.random.RandomState(0)
    z = rs.randn(2, 192, 1).astype(np.float32)
    c = rs.randn(2, 16, 10).astype(np.float32)
    v = g.init(jax.random.key(0), jnp.asarray(z), jnp.asarray(c))
    return jax.tree_util.tree_map(np.asarray, v), z, c


def _port(v, **flags):
    port = get_model_class(PWG)(**SMALL, **flags)
    port.load_state_dict(jax_params_to_state_dict(PWG, SMALL, v))
    port.eval()
    return port


def _ncl(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


def test_generator_bf16_matches_jax(jax_params):
    """The port's generator with ``use_pallas_stack`` and
    ``pallas_stack_bf16`` against JAX's fused bf16 path; the port's float32
    stack as the control."""
    v, z, c = jax_params
    want = np.asarray(jax_model_class(PWG)(**SMALL, **BF16).apply(
        v, jnp.asarray(z), jnp.asarray(c)))
    jax_f32 = np.asarray(jax_model_class(PWG)(**SMALL, use_pallas_stack=True).apply(
        v, jnp.asarray(z), jnp.asarray(c)))
    port = _port(v, **BF16)
    assert port.use_stack and port.stack_bf16 and not port.use_stack_train
    with torch.no_grad():
        got = port(_ncl(z), _ncl(c)).numpy().transpose(0, 2, 1)
        port.remove_weight_norm()
        port.prepare_kernels()
        prepared = port(_ncl(z), _ncl(c)).numpy().transpose(0, 2, 1)
        control = _port(v, use_pallas_stack=True)(_ncl(z), _ncl(c)).numpy().transpose(0, 2, 1)
    print(f"generator bf16: port vs JAX {_stats(got, want)}, prepared "
          f"{_stats(prepared, want)}; float32 control {_stats(control, want)}; "
          f"JAX bf16 vs JAX float32 {_stats(want, jax_f32)}")
    assert got.shape == want.shape == (2, 192, 1)
    assert _close(got, want) and _close(prepared, want)
    assert not _close(control, want)


def test_both_flags_run_jax_float32_path(jax_params):
    """``pallas_stack_bf16`` has no effect under ``use_pallas_stack_train``
    (JAX :174-181): the cycles run in float32, as JAX's do."""
    v, z, c = jax_params
    flags = dict(BF16, use_pallas_stack_train=True)
    want = np.asarray(jax_model_class(PWG)(**SMALL, **flags).apply(
        v, jnp.asarray(z), jnp.asarray(c)))
    port = _port(v, **flags)
    assert port.use_stack_train and not port.stack_bf16
    with torch.no_grad():
        got = port(_ncl(z), _ncl(c)).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # and it trains, as the float32 cycle does
    train = _port(v, **flags).train()
    train(_ncl(z), _ncl(c)).sum().backward()
    assert train.conv_layers[0].conv.weight_g.grad is not None


def test_bf16_stack_is_inference_only(jax_params):
    v, z, c = jax_params
    port = _port(v, **BF16)
    with pytest.raises(RuntimeError, match="inference-only"):
        port(_ncl(z), _ncl(c))
    with torch.inference_mode():
        assert math.isfinite(float(port(_ncl(z), _ncl(c)).sum()))
