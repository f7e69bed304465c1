"""The fused WaveNet kernels' plain versions held against the JAX package.

The same numpy arrays go through ``wavenet_stack_xla`` / ``gated_resblock_xla``
and the Pallas kernels in interpret mode on the JAX side, and through the
port's plain versions and its wrappers on CPU tensors (which take the plain
versions) on the other. Shapes are those of tests/test_wavenet_stack.py and
tests/test_pallas_kernels.py; tolerance 3e-5, the JAX tests' own (float32
sums taken in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.ops.pallas_kernels import wavenet as jax_wavenet  # noqa: E402
from parallelwavegan_tpu.ops.pallas_kernels import wavenet_stack as jax_stack  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import wavenet  # noqa: E402

TOL = 3e-5
KEYS = wavenet.WEIGHT_KEYS


def _weights(rs, n_layers, k=3, cr=8, cg=16, cs=8, ca=10):
    shapes = {"wconv": (n_layers, k, cr, cg), "bconv": (n_layers, cg),
              "waux": (n_layers, ca, cg), "wskip": (n_layers, cg // 2, cs),
              "bskip": (n_layers, cs), "wres": (n_layers, cg // 2, cr),
              "bres": (n_layers, cr)}
    return {key: (rs.randn(*shapes[key]) * 0.2).astype(np.float32) for key in KEYS}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("b,t,dilations,per_call", [
    (2, 300, (1, 2, 4, 8), 10),
    (1, 400, (1, 2, 4, 8, 16, 32), 2),
])
def test_stack_matches_jax(b, t, dilations, per_call):
    rs = np.random.RandomState(len(dilations))
    w = _weights(rs, len(dilations))
    x = rs.randn(b, t, 8).astype(np.float32)
    c = rs.randn(b, t, 10).astype(np.float32)
    x0, s0 = jax_stack.wavenet_stack_xla(jnp.asarray(x), jnp.asarray(c), _j(w),
                                         dilations)
    x1, s1 = jax_stack.fused_wavenet_cycle(
        jnp.asarray(x), jnp.asarray(c), _j(w), dilations, t_tile=128,
        interpret=True, max_layers_per_call=per_call)
    tw = {k: _t(v) for k, v in w.items()}
    with torch.no_grad():
        x2, s2 = wavenet.wavenet_stack_reference(_t(x), _t(c), tw, dilations)
        before = wavenet.fused_wavenet_stack.launches
        x3, s3 = wavenet.fused_wavenet_cycle(_t(x), _t(c), tw, dilations,
                                             max_layers_per_call=per_call)
    assert wavenet.fused_wavenet_stack.launches == before  # CPU: no kernel
    for got, want in ((x2, x0), (s2, s0), (x3, x1), (s3, s1)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("dilation", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_gated_resblock_matches_jax(dilation, causal):
    rs = np.random.RandomState(0)
    arrays = [rs.randn(2, 300, 8), rs.randn(2, 300, 10),
              rs.randn(3, 8, 16) * 0.3, rs.randn(16) * 0.3,
              rs.randn(10, 16) * 0.3, rs.randn(8, 8) * 0.3, rs.randn(8) * 0.3,
              rs.randn(8, 8) * 0.3, rs.randn(8) * 0.3]
    arrays = [a.astype(np.float32) for a in arrays]
    j = [jnp.asarray(a) for a in arrays]
    r0, s0 = jax_wavenet.gated_resblock_xla(*j, dilation=dilation, causal=causal)
    r1, s1 = jax_wavenet.fused_gated_resblock(*j, dilation, causal, 128, True)
    with torch.no_grad():
        r2, s2 = wavenet.gated_resblock_reference(
            *map(_t, arrays), dilation=dilation, causal=causal)
        r3, s3 = wavenet.fused_gated_resblock(*map(_t, arrays),
                                              dilation=dilation, causal=causal)
    for got, want in ((r2, r0), (s2, s0), (r3, r1), (s3, s1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_wrappers_refuse_a_training_forward():
    """The stack wrapper (K3, no VJP in JAX) refuses a forward that needs
    gradients; the block (K5, JAX's custom_vjp) trains, with the plain
    block's gradients."""
    rs = np.random.RandomState(2)
    w = {k: _t(v) for k, v in _weights(rs, 2).items()}
    x = _t(rs.randn(1, 20, 8).astype(np.float32)).requires_grad_()
    c = _t(rs.randn(1, 20, 10).astype(np.float32))
    with pytest.raises(RuntimeError, match="inference-only"):
        wavenet.fused_wavenet_stack(x, c, w, (1, 2))
    with torch.no_grad():
        out, skip = wavenet.fused_wavenet_stack(x, c, w, (1, 2))
    assert out.shape == (1, 20, 8) and skip.shape == (1, 20, 8)
    grads = []
    for fn in (wavenet.fused_gated_resblock, wavenet.gated_resblock_reference):
        leaves = [x.detach().clone().requires_grad_()] + [
            w[k][0].clone().requires_grad_() for k in KEYS]
        r, s = fn(leaves[0], c, *leaves[1:], dilation=2, causal=False)
        ((r ** 2).sum() + s.sum()).backward()
        grads.append([v.grad for v in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_refuse_other_devices():
    w = {k: torch.zeros(v.shape, device="meta")
         for k, v in _weights(np.random.RandomState(0), 1).items()}
    x = torch.zeros(1, 4, 8, device="meta")
    c = torch.zeros(1, 4, 10, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wavenet.fused_wavenet_stack(x, c, w, (1,))
    with pytest.raises(ValueError, match="unsupported device"):
        wavenet.fused_gated_resblock(x, c, *(w[k][0] for k in KEYS))
