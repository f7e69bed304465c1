"""The bf16-resident modes of the TADE kernels K8a/K8b and K9a/K9b on the
CPU: their plain versions (``tade1_reference_bf16``,
``tade2_reference_bf16`` and autograd through them, which the port's
``fused_tade_blocks_train`` runs for a bf16 x on the CPU) held against the
JAX package's ``fused_tade_blocks_train`` with bf16 x and c in interpret
mode (``mxu_bf16``), at the shapes of tests/test_tade_train_kernel.py:170-210:
C 64, B 2, T 64, two blocks at (scale, dilation) (2, 2) and (1, 2),
``t_tile`` 16, float32 weights of scale 0.04, with the softmax gate and
with the sigmoid one.

Both sides round the same operands to bf16 (each conv's source rows and
weights, the stored x2, a, outputs and cotangents) and sum exact products
in float32, in other orders. Where a float32 sum lands within that order's
noise (1e-7) of a bf16 rounding point the two round it apart by one bf16
step, and the chain of roundings spreads that: a step in one conv input
moves its 1152 outputs by about 2e-4 of their size, a few percent of
which then round apart in turn. So the two agree bit for bit in most
elements, but their rms difference is that of the chain, not of the
float32 noise: 3.4e-3 rms|JAX| and 5.3e-3 max|JAX| at most with softmax,
5.8e-3 and 7.2e-3 with sigmoid (on dc, the end of the longest chain). The
port against itself, its convs summed in float64 instead of float32,
differs as much (5.7e-3 rms and 9.9e-3 max). The tests hold:

* every value and gradient to rms|diff| <= 1e-2 rms|JAX| and max|diff|
  <= 2e-2 max|JAX| (the bounds of test_torch_port_melgan_bf16.py, 5e-4
  and 4e-3, are below this chain's own noise);
* the rounding points: the bf16 outputs and input gradients (x_out,
  c_out, dx, dc) equal JAX's bit for bit in at least 60 % of their
  elements on average (measured 87 % with softmax, 72 % with sigmoid),
  which the port's float32 plain version on the same bf16 inputs, rounded
  to bf16, does not reach (48 % and 34 %);
* K9's plain version fed the re-run's residuals, stage by stage
  (``tade1_backward_reference_bf16``: what the card's check uses), equal
  to autograd through the plain forward.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.ops.pallas_kernels.tade_train import (  # noqa: E402
    fused_tade_blocks_train as jax_fused,
)
from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_train as tt  # noqa: E402

C, B, T = 64, 2, 64
SCALES = ((2, 2), (1, 2))  # (scale, dilation) of the two blocks
KEYS = tt.WEIGHTS


BF16_OUTPUTS = ("x_out", "c_out", "dx", "dc")


def _close(got, want) -> bool:
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = g - w
    return (float(np.sqrt((d ** 2).mean())) <= 1e-2 * float(np.sqrt((w ** 2).mean()))
            and float(np.abs(d).max()) <= 2e-2 * float(np.abs(w).max()))


def _equal_share(got: dict, want: dict) -> float:
    """The share of elements of the bf16 outputs and input gradients that
    equal JAX's bit for bit, averaged over the four (``got`` rounded to
    bf16 first)."""
    return float(np.mean([(_bf16(got[k]) == want[k]).mean() for k in BF16_OUTPUTS]))


def _case():
    """(x, c, cotangents of x_out and c_out, blocks) as numpy: the JAX
    test's _rand_block weights (scale 0.04, biases 0.02), x and c of scale
    0.5, unit cotangents."""
    rs = np.random.RandomState(5)
    blocks = []
    for _ in SCALES:
        blk = {}
        for key in td.WEIGHT_KEYS:
            cout = C if key.startswith("aux") else 2 * C
            blk[f"{key}_w"] = (rs.randn(9, C, cout) * 0.04).astype(np.float32)
            blk[f"{key}_b"] = (rs.randn(cout) * 0.02).astype(np.float32)
        blocks.append(blk)
    x = (rs.randn(B, T, C) * 0.5).astype(np.float32)
    c = (rs.randn(B, T, C) * 0.5).astype(np.float32)
    t_out = T * SCALES[0][0] * SCALES[1][0]
    dxo, dco = (rs.randn(2, B, t_out, C)).astype(np.float32)
    return x, c, dxo, dco, blocks


def _bf16(v):
    """numpy float32 of v rounded to bf16, as both packages round it."""
    return torch.from_numpy(v).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module", params=["softmax", "sigmoid"])
def jax_side(request):
    """(gate, case, {name: JAX's value or gradient}), computed once."""
    gate = request.param
    x, c, dxo, dco, blocks = _case()

    def f(xx, cc, ws):
        bl = [dict(w, scale=s, dilation=d) for w, (s, d) in zip(ws, SCALES)]
        return jax_fused(xx, cc, bl, gated_function=gate, min_fused_t=1, t_tile=16,
                         interpret=True)

    ws = [{k: jnp.asarray(v) for k, v in blk.items()} for blk in blocks]
    (xo, co), vjp = jax.vjp(f, jnp.asarray(x).astype(jnp.bfloat16),
                            jnp.asarray(c).astype(jnp.bfloat16), ws)
    dx, dc, dws = vjp((jnp.asarray(dxo).astype(jnp.bfloat16),
                       jnp.asarray(dco).astype(jnp.bfloat16)))
    want = {"x_out": xo, "c_out": co, "dx": dx, "dc": dc}
    for i, dw in enumerate(dws):
        want.update({f"blocks[{i}].{k}": dw[k] for k in KEYS})
    assert xo.dtype == jnp.bfloat16 and dx.dtype == jnp.bfloat16
    return gate, (x, c, dxo, dco, blocks), {
        k: np.asarray(v.astype(jnp.float32)) for k, v in want.items()}


def _port(gate, case, bf16: bool) -> dict:
    """The port's values and gradients by autograd: the CPU path of
    ``fused_tade_blocks_train`` (the bf16 plain versions for a bf16 x),
    or with ``bf16`` False the float32 plain version on the same
    bf16-rounded inputs (the control)."""
    x, c, dxo, dco, blocks = case
    dtype = torch.bfloat16 if bf16 else torch.float32
    xl = torch.from_numpy(_bf16(x)).to(dtype).requires_grad_()
    cl = torch.from_numpy(_bf16(c)).to(dtype).requires_grad_()
    bl = [dict({k: torch.from_numpy(v).requires_grad_() for k, v in blk.items()},
               scale=s, dilation=d) for blk, (s, d) in zip(blocks, SCALES)]
    xo, co = tt.fused_tade_blocks_train(xl, cl, bl, gated_function=gate, min_fused_t=1)
    assert xo.dtype == dtype and co.dtype == dtype
    leaves = [xl, cl] + [blk[k] for blk in bl for k in KEYS]
    grads = torch.autograd.grad((xo, co), leaves, (torch.from_numpy(_bf16(dxo)).to(dtype),
                                                   torch.from_numpy(_bf16(dco)).to(dtype)))
    names = ["dx", "dc"] + [f"blocks[{i}].{k}" for i in range(len(bl)) for k in KEYS]
    out = {"x_out": xo, "c_out": co, **dict(zip(names, grads))}
    return {k: v.detach().float().numpy() for k, v in out.items()}


def test_bf16_plain_versions_match_jax_interpret(jax_side):
    gate, case, want = jax_side
    got = _port(gate, case, True)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and _close(got[name], w), name
    assert _equal_share(got, want) >= 0.6


def test_float32_plain_version_fails_the_bf16_check(jax_side):
    """The control: the float32 plain version on the same bf16 values,
    rounded to bf16, equals JAX's bf16 results in too few elements."""
    gate, case, want = jax_side
    assert _equal_share(_port(gate, case, False), want) < 0.6


@pytest.mark.parametrize("gate", ["softmax", "sigmoid"])
@pytest.mark.parametrize("scale,dilation", [(2, 2), (1, 3)])
def test_bf16_backward_from_residuals_equals_autograd(gate, scale, dilation):
    """K9a's and K9b's plain versions as the kernels compute them (the
    re-run's residuals, ``stage_backward_reference_bf16``, the glue) equal
    autograd through ``tade1_reference_bf16`` / ``tade2_reference_bf16``:
    the input gradients bit for bit, the weight gradients once rounded to
    the weights' bf16 (autograd's cast)."""
    x, c, _, _, blocks = _case()
    b16 = torch.bfloat16
    blk = dict({k: torch.from_numpy(v).to(b16) for k, v in blocks[0].items()},
               scale=scale, dilation=dilation)
    xb, cb = torch.from_numpy(x).to(b16), torch.from_numpy(c).to(b16)
    rs = np.random.RandomState(2)

    def cot(rows):
        return torch.from_numpy(rs.randn(B, rows, C).astype(np.float32)).to(b16)

    with torch.no_grad():
        x2, a = td.tade1_reference_bf16(xb, cb, blk, gate)
    cases = [(tt.tade1_backward_reference, tt.tade1_backward_reference_bf16,
              (xb, cb, blk, gate, cot(T), cot(T)), 2),
             (tt.tade2_backward_reference, tt.tade2_backward_reference_bf16,
              (xb, x2, a, blk, gate, cot(scale * T), cot(scale * T)), 3)]
    for auto, staged, args, n in cases:
        want, got = auto(*args), staged(*args)
        for g, w in zip(got[:n], want[:n]):
            assert g.dtype == torch.bfloat16 and torch.equal(g, w)
        assert sorted(got[n]) == sorted(want[n])
        for k, w in want[n].items():
            assert got[n][k].dtype == torch.float32 and torch.equal(got[n][k].to(b16), w), k


def test_bf16_stage_backward_references_match_autograd_of_the_block():
    """K9a's and K9b's plain versions stage by stage
    (``tade1_backward_reference`` / ``tade2_backward_reference`` on a bf16
    x) compose to the block's (``tade_block_backward_reference``): K9b's
    dx2 and da are K9a's cotangents, and dx is K9a's plus K9b's residual
    term, summed in bf16 as JAX sums them."""
    x, c, dxo, dco, blocks = _case()
    s, d = SCALES[0]
    blk = dict({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in blocks[0].items()},
               scale=s, dilation=d)
    xb, cb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(c).to(torch.bfloat16)
    dxob = torch.from_numpy(dxo[:, :s * T]).to(torch.bfloat16)
    dcob = torch.from_numpy(dco[:, :s * T]).to(torch.bfloat16)
    with torch.no_grad():
        x2, a = td.tade1_reference_bf16(xb, cb, blk)
    dx_res, dx2, da, g2 = tt.tade2_backward_reference(xb, x2, a, blk, "softmax", dxob, dcob)
    dx1, dc, g1 = tt.tade1_backward_reference(xb, cb, blk, "softmax", dx2, da)
    dx, dc_blk, g = tt.tade_block_backward_reference(xb, cb, blk, "softmax", dxob, dcob)
    assert all(v.dtype == torch.bfloat16 for v in (dx_res, dx2, da, dx1, dc, dx))
    assert torch.equal(dx, dx1 + dx_res) and torch.equal(dc, dc_blk)
    for k, v in {**g1, **g2}.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, g[k]), k
