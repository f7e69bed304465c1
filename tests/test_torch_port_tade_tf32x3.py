"""The split-TF32 arithmetic of the K9 kernels (csrc/tade_bwd.cu), emulated
on the CPU and held to float32 autograd of the plain TADE stages.

The kernels multiply on the tensor cores in TF32, splitting each operand
v into hi = tf32(v) and lo = tf32(v - hi) (``cvt.rna``) and forming every
product as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with float32 accumulators
(csrc/mma_tf32x3.cuh); the wrapper splits the weights once per call
(``ops/kernels/tf32x3.py``). Here that split runs in torch on the CPU,
each product a float32 matmul of TF32 values (exact, since two 11-bit
significands multiply into 22 bits), through one stage's backward written
out in the kernels' own decomposition: the gate's VJP in float32, the
three transposed convs as nine per-tap products whose sums are added in
float32 (the chain kernel adds each tap's tile sums into float32 totals),
and the nine-tap weight gradients as one product of the operand's nine
shifted copies side by side against the cotangent, per 32-row group,
added in float32 (the weight-gradient kernel's totals every 32 rows); the
biases are float32 column sums. The sums differ from the card's in their
order and in the tensor cores' accumulation, which rounds toward zero;
chip_smoke.py phase 20 holds the kernels themselves to the same bounds.

StyleMelGAN v1 widths (C = 64, 128-wide gates, K = 9, softmax), random
unit-gain weights, B x T = 2 x 150, cotangents of scale 1 / sqrt(B sT):
stage 1 (D = 1) and stage 2 at D = 1 and 2, scale 1 and 2. Every gradient
within 2e-4 + 1e-3 |plain| and 1e-4 max|plain| of float32 autograd of
``tade1_backward_reference`` / ``tade2_backward_reference``, and each
zeroed gradient rejected. The same decomposition with one TF32 product per
multiply is run beside it and its ratios printed, not asserted (``pytest
-s`` shows them).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_train as tt  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import (  # noqa: E402
    conv_fragments,
    split_tf32,
    to_tf32,
)

C = 64
ROWS_PER_TOTAL = 32  # rows of a weight-gradient tile sum before its float32 total


def mm_split(a, b):
    """a @ b as the kernels form it: three TF32 products, float32 sums."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_one(a, b):
    """a @ b as one TF32 product."""
    return to_tf32(a) @ to_tf32(b)


def _shift(v, s):
    """v[:, u + s] along time, zero outside [0, L)."""
    n = v.shape[1]
    out = torch.zeros_like(v)
    if abs(s) < n:
        if s >= 0:
            out[:, :n - s] = v[:, s:]
        else:
            out[:, -s:] = v[:, :n + s]
    return out


def conv_t(v, w, dil, mm):
    """The transposed 9-tap conv of the chain kernel: sum over taps j of
    v[u + (j - 4) dil] . w[8 - j]^T, each tap one product, the taps'
    products added in float32."""
    b, n, _ = v.shape
    out = 0
    for j in range(9):
        tap = _shift(v, (j - 4) * dil).reshape(b * n, -1)
        out = out + mm(tap, w[8 - j].T)
    return out.reshape(b, n, w.shape[1])


def wgrad(a, cot, dil, mm):
    """(dW (9, 64, N), db (N)): dW[k] = sum_u a[u + (k - 4) dil]^T cot[u], as
    the weight-gradient kernel forms it: the nine shifted copies of a side
    by side (576 columns) against the cotangent, one product per 32-row
    group of each batch item, the groups added in float32."""
    taps = torch.cat([_shift(a, (k - 4) * dil) for k in range(9)], dim=-1)
    total = torch.zeros(taps.shape[-1], cot.shape[-1])
    for r0 in range(0, a.shape[1], ROWS_PER_TOTAL):
        for i in range(a.shape[0]):
            total = total + mm(taps[i, r0:r0 + ROWS_PER_TOTAL].T,
                               cot[i, r0:r0 + ROWS_PER_TOTAL])
    return total.reshape(9, C, -1), cot.sum(dim=(0, 1))


def stage_backward(xr, src, dout, dext, blk, keys, sc, dil, mm):
    """One stage's backward in the kernels' decomposition: the re-run in
    float32 (csrc/tade.cu's Save), dT by the gate's VJP, the chain of
    transposed convs and the weight gradients through ``mm``. Returns
    (dxn at the stage's rate, mean, rstd, dsrc, the stage's weight grads)."""
    aux, g, gc = keys
    mean, rstd = td._stats(xr)
    xn = td._stretch((xr - mean[:, None]) * rstd[:, None], sc)
    ain = td._conv(src, blk[f"{aux}_w"], blk[f"{aux}_b"])
    s, h = td._conv(ain, blk[f"{g}_w"], blk[f"{g}_b"]).chunk(2, dim=-1)
    y = s * xn + h
    t = td._conv(y, blk[f"{gc}_w"], blk[f"{gc}_b"], dil)
    with torch.enable_grad():
        tv = t.detach().requires_grad_()
        (dT,) = torch.autograd.grad(td._gate(tv, "softmax"), tv, dout)
    dy = conv_t(dT, blk[f"{gc}_w"], dil, mm)
    dG = torch.cat([dy * xn, dy], dim=-1)
    da = conv_t(dG, blk[f"{g}_w"], 1, mm) + dext
    dsrc = conv_t(da, blk[f"{aux}_w"], 1, mm)
    grads = {}
    for key, a_op, cot, d in ((gc, y, dT, dil), (g, ain, dG, 1), (aux, src, da, 1)):
        grads[f"{key}_w"], grads[f"{key}_b"] = wgrad(a_op, cot, d, mm)
    return dy * s, mean, rstd, dsrc, grads


def k9a(x, c, blk, dx2, da, mm):
    """K9a's function (dx, dc, grads of aux1, g1, gc1), as the wrapper
    composes it."""
    dxn, mean, rstd, dc, grads = stage_backward(x, c, dx2, da, blk, td.WEIGHT_KEYS[:3],
                                                1, 1, mm)
    return {"dx": tt.instance_norm_backward(dxn, x, mean, rstd), "dc": dc, **grads}


def k9b(x, x2, a, blk, dout, da2, mm):
    """K9b's function (dx, dx2, da, grads of aux2, g2, gc2)."""
    sc, d = int(blk["scale"]), int(blk["dilation"])
    dxn, mean, rstd, dua, grads = stage_backward(x2, td._stretch(a, sc), dout, da2, blk,
                                                 td.WEIGHT_KEYS[3:], sc, d, mm)
    dx2 = tt.instance_norm_backward(tt.stretch_adjoint(dxn, sc), x2, mean, rstd)
    return {"dx": tt.stretch_adjoint(dout, sc), "dx2": dx2,
            "da": tt.stretch_adjoint(dua, sc), **grads}


def _misses(g, r):
    d = (g - r).abs()
    return (not bool((d <= 2e-4 + 1e-3 * r.abs()).all())
            or float(d.max()) > 1e-4 * float(r.abs().max()))


def _case(scale, dilation, b=2, t=150, seed=3):
    rs = np.random.RandomState(seed)

    def randn(*shape, s=1.0):
        return torch.from_numpy((rs.randn(*shape) * s).astype(np.float32))

    # unit-gain convs (chip_smoke.py phase 20's): gradients of order one
    blk = {"scale": scale, "dilation": dilation}
    for key in td.WEIGHT_KEYS:
        cout = C if key.startswith("aux") else 2 * C
        blk[f"{key}_w"] = randn(9, C, cout, s=1 / 24.0)
        blk[f"{key}_b"] = randn(cout, s=0.1)
    x, c = randn(b, t, C), randn(b, t, C)
    u = (b * scale * t) ** -0.5
    return blk, x, c, randn(b, scale * t, C, s=u), randn(b, scale * t, C, s=u)


def _hold(got, one, want):
    for key, r in want.items():
        g = got[key]
        d1 = (one[key] - r).abs()
        print(f"{key}: split TF32 max|diff|/max|plain| = "
              f"{float((g - r).abs().max()) / float(r.abs().max()):.3e}; one TF32 "
              f"product {float(d1.max()) / float(r.abs().max()):.3e}, elements past "
              f"2e-4 + 1e-3|plain|: {float((d1 > 2e-4 + 1e-3 * r.abs()).float().mean()):.2%}, "
              f"misses the check: {_misses(one[key], r)}")
        assert g.shape == r.shape
        assert not _misses(g, r), (key, float((g - r).abs().max()))
        assert _misses(torch.zeros_like(g), r), f"zeroed {key} passed"


@pytest.mark.parametrize("stage,scale,dilation", [
    (1, 1, 1), (2, 1, 2), (2, 2, 2), (2, 2, 1)])
def test_split_tf32_stage_backward_matches_float32_autograd(stage, scale, dilation):
    blk, x, c, dxo, dco = _case(scale, dilation)
    with torch.no_grad():
        x2, a = td.tade1_reference(x, c, blk)
    if stage == 1:
        # stage 1 under stage 2's plain cotangents, as the block's backward
        _, dx2, da, _ = tt.tade2_backward_reference(x, x2, a, blk, "softmax", dxo, dco)
        dx, dc, dw = tt.tade1_backward_reference(x, c, blk, "softmax", dx2, da)
        want = {"dx": dx, "dc": dc, **dw}
        got, one = (k9a(x, c, blk, dx2, da, mm) for mm in (mm_split, mm_one))
    else:
        dx, dx2, da, dw = tt.tade2_backward_reference(x, x2, a, blk, "softmax", dxo, dco)
        want = {"dx": dx, "dx2": dx2, "da": da, **dw}
        got, one = (k9b(x, x2, a, blk, dxo, dco, mm) for mm in (mm_split, mm_one))
    _hold(got, one, want)


def test_conv_fragments_split_the_weights_once():
    """The wrapper's split of a conv's weights: the transposed conv's
    weights Wt[j] = W[8 - j]^T in the B fragments' order, hi and lo exactly
    ``to_tf32``'s, hi + lo within 2^-22 of the weight."""
    w = torch.from_numpy(np.random.RandomState(5).randn(9, C, 2 * C).astype(np.float32))
    f = conv_fragments(w)
    wt = w.flip(0).transpose(1, 2).reshape(-1, C)  # (9 x 128, 64)
    assert f.shape == (wt.shape[0] // 8, C // 8, 32, 4)
    # lane 4 gid + tig of k-step ks and column tile nt: rows 8 ks + 2 tig and
    # 8 ks + 2 tig + 1 of column 8 nt + gid, each as (hi, lo)
    lane = torch.arange(32)
    rows = 8 * torch.arange(f.shape[0])[:, None, None] + 2 * (lane % 4)
    cols = 8 * torch.arange(f.shape[1])[None, :, None] + lane // 4
    hi = to_tf32(wt)
    lo = to_tf32(wt - hi)
    for pair in range(2):
        assert torch.equal(f[..., 2 * pair], hi[rows + pair, cols])
        assert torch.equal(f[..., 2 * pair + 1], lo[rows + pair, cols])
    err = (f[..., 0] + f[..., 1] - wt[rows, cols]).abs()
    assert bool((err <= 2.0 ** -22 * wt[rows, cols].abs()).all())
