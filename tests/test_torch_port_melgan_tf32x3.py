"""The split-TF32 arithmetic of the K7 kernels (csrc/melgan_stack_bwd.cu),
emulated on the CPU and held to float32 autograd of the plain MelGAN stage.

The kernels multiply on the tensor cores in TF32, splitting each operand
v into hi = tf32(v) and lo = tf32(v - hi) (``cvt.rna``) and forming every
product as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with float32 accumulators
(csrc/mma_tf32x3.cuh); the wrapper splits each stack's 2K + 2 weight
matrices once per call (``tf32x3.stack_fragments``). Here the weights are
read back out of that fragment tensor the way the kernels read it (matrix,
k-step, column tile, lane), and each stack's backward is written out in
the kernels' own decomposition, each product a float32 matmul of TF32
values (exact, since two 11-bit significands multiply into 22 bits):

- the dz pass (dz_kernel): z again as one product per tap of the padded
  rows of leaky(x), the taps' sums added in float32, the bias after; h =
  leaky(z); dh = g . W1^T; dz = dh * leaky'(z);
- dx straight onto the rows (dx_kernel): the transposed dilated conv as
  one product per tap of dz's shifted rows, the padding's adjoint as one
  more product per tap whose operand rows are the sums of the dz rows the
  padded positions read (nonzero only on the rows the padding folds onto),
  times leaky'(x), plus g . Ws^T;
- the weight gradients (wgrad_kernel): each a product of the cotangent's
  rows against the operand's, per 32-row group, added in float32 per slab
  of 1,024 rows of a batch item, the slabs in order; biases as float32
  column sums;
- the final conv's backward on the CUDA cores (outconv_bwd_kernel): plain
  float32 products.

The sums differ from the card's in their order and in the tensor cores'
accumulation, which rounds toward zero; chip_smoke.py phase 17 holds the
kernels themselves to the same bounds. MelGAN v1 widths (C = 128, 64 and
32 with the final conv to 1, K = 3 at d = 1, 3, 9, reflect) and one C = 48
replicate case with the final conv to 4, at small T, weights that keep
activations of order one and a cotangent of scale 1 / sqrt(B T), the
inputs moved off the kinks of LeakyReLU as chip_smoke.py does: every
gradient within 2e-4 + 1e-3 |plain| and 1e-4 max|plain| of
``melgan_stacks_backward_reference``, and each zeroed gradient rejected.
The same decomposition with one TF32 product per multiply is run beside it
and its ratios printed, not asserted (``pytest -s`` shows them).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (  # noqa: E402
    _conv,
    melgan_stacks_reference,
)
from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (  # noqa: E402
    STACK_KEYS,
    melgan_stacks_backward_reference,
)
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import (  # noqa: E402
    split_tf32,
    stack_fragments,
    to_tf32,
)

SLOPE = 0.2
ROWS_PER_TOTAL = 32  # rows of a weight-gradient tile sum before its float32 total
SLAB_ROWS = 1024     # rows of one weight-gradient slab
TORCH_MODES = {"reflect": "reflect", "edge": "replicate", "constant": "constant"}


def weights_of(frag):
    """[(hi, lo)] of the 2K + 2 (C, C) matrices of one stack, read out of
    stack_fragments' tensor (2K + 2, C / 8, C / 8, 32, 4) as the kernels
    read it: in k-step ks and column tile nt, lane 4 gid + tig holds (hi,
    lo) of rows 8 ks + 2 tig and 8 ks + 2 tig + 1 of column 8 nt + gid."""
    n, ks, nt = frag.shape[:3]
    ks_i, nt_i, lane = torch.meshgrid(torch.arange(ks), torch.arange(nt),
                                      torch.arange(32), indexing="ij")
    gid, tig = lane // 4, lane % 4
    out = []
    for m in range(n):
        planes = []
        for part in range(2):  # hi, lo
            w = torch.zeros(8 * ks, 8 * nt)
            for pair in range(2):
                w[8 * ks_i + 2 * tig + pair, 8 * nt_i + gid] = frag[m][..., 2 * pair + part]
            planes.append(w)
        out.append(tuple(planes))
    return out


def prod_w(a, w, one):
    """a (rows, C) times a weight matrix given as (hi, lo), as a kernel
    forms it: a split, three TF32 products (one with ``one``)."""
    hi, lo = w
    ah, al = split_tf32(a)
    return ah @ hi if one else al @ hi + ah @ lo + ah @ hi


def prod_split(a, b, one):
    """a @ b with both operands split (the weight gradients)."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return ah @ bh if one else al @ bh + ah @ bl + ah @ bh


def leaky(v):
    return F.leaky_relu(v, SLOPE)


def dleaky(v):
    return torch.where(v >= 0, 1.0, SLOPE)


def pad_row(p, t, pad, mode):
    """csrc/melgan_stack_bwd.cu pad_row: the row padded position p reads,
    or -1 for a zero row."""
    if 0 <= p < t:
        return p
    if p < -pad or p >= t + pad or mode == "constant":
        return -1
    if mode == "reflect":
        return -p if p < 0 else 2 * t - 2 - p
    return 0 if p < 0 else t - 1


def rows_at(v, idx):
    """v[:, idx] along time, index -1 reading a zero row."""
    z = torch.cat([v, torch.zeros_like(v[:, :1])], 1)
    return z[:, [len(z[0]) - 1 if i < 0 else i for i in idx]]


def padded_taps(x, k_taps, dil, mode):
    """Tap k's operand rows: x at the padded position t + k dil - P."""
    t, pad = x.shape[1], (k_taps - 1) // 2 * dil
    return [rows_at(x, [pad_row(u + k * dil - pad, t, pad, mode) for u in range(t)])
            for k in range(k_taps)]


def fold_rows(v, off, pad, mode):
    """The operand rows of the padding's adjoint at one tap: row t gets the
    rows u = q + off of v for the padded positions q that the forward read
    from row t (csrc/melgan_stack_bwd.cu fold_row), zero elsewhere."""
    t = v.shape[1]
    out = torch.zeros_like(v)

    def add(r, u):
        if 0 <= u < t:
            out[:, r] += v[:, u]

    if mode == "reflect":
        for r in range(t):
            if 1 <= r <= pad:
                add(r, off - r)
            if t - 1 - pad <= r <= t - 2:
                add(r, 2 * t - 2 - r + off)
    elif mode == "edge":
        for j in range(1, pad + 1):
            add(0, off - j)
        for j in range(pad):
            add(t - 1, t + j + off)
    return out


def wgrad(cot, op, one):
    """sum_t op[t]^T cot[t] over every row: per 32-row group one product,
    added into a float32 total per slab of 1,024 rows of a batch item; the
    slabs summed in order."""
    b, t, _ = cot.shape
    total = 0
    for item in range(b):
        for s0 in range(0, t, SLAB_ROWS):
            slab = 0
            for r0 in range(s0, min(t, s0 + SLAB_ROWS), ROWS_PER_TOTAL):
                r1 = min(t, r0 + ROWS_PER_TOTAL)
                slab = slab + prod_split(op[item, r0:r1].T, cot[item, r0:r1], one)
            total = total + slab
    return total


def stack_backward(x, g, st, frag, mode, one):
    """One stack's backward in K7's decomposition: (dx, its gradients)."""
    b, t, c = x.shape
    k_taps, dil = st["wd"].shape[0], int(st["dilation"])
    pad = (k_taps - 1) // 2 * dil
    w = weights_of(frag)
    taps = padded_taps(x, k_taps, dil, mode)

    def prod(a, m):
        return prod_w(a.reshape(-1, c), w[m], one).reshape(b, t, c)

    bd = torch.zeros(c) if st["bd"] is None else st["bd"]
    # dz_kernel: z tap by tap into a float32 total, the bias after
    z = sum(prod(leaky(taps[k]), k) for k in range(k_taps)) + bd
    h = leaky(z)
    dz = prod(g, k_taps) * dleaky(z)
    # dx_kernel: the taps, the fold's taps, times leaky'(x), then g . Ws^T
    conv = 0
    for k in range(k_taps):
        off = pad - k * dil
        conv = conv + prod(rows_at(dz, [u + off if 0 <= u + off < t else -1
                                        for u in range(t)]), k_taps + 1 + k)
    for k in range(k_taps):
        conv = conv + prod(fold_rows(dz, pad - k * dil, pad, mode), k_taps + 1 + k)
    dx = conv * dleaky(x) + prod(g, 2 * k_taps + 1)
    grads = {
        "wd": torch.stack([wgrad(dz, leaky(tap), one) for tap in taps]),
        "bd": dz.sum((0, 1)),
        "w1": wgrad(g, h, one)[None],
        "b1": g.sum((0, 1)),
        "ws": wgrad(g, x, one)[None],
        "bs": g.sum((0, 1)),
    }
    return dx, {k: None if k[0] == "b" and st[k] is None else v for k, v in grads.items()}


def outconv_backward(x, y, dy, final, mode):
    """The final conv's backward as outconv_bwd_kernel forms it, float32."""
    fw, fb = final
    b, t, c = x.shape
    k_taps, pad = fw.shape[0], (fw.shape[0] - 1) // 2
    dpre = dy * (1 - y * y)
    taps = padded_taps(x, k_taps, 1, mode)
    dw = torch.stack([(leaky(tap).reshape(-1, c).T @ dpre.reshape(-1, dpre.shape[2]))
                      for tap in taps])
    conv = 0
    for k in range(k_taps):
        off = pad - k
        shifted = rows_at(dpre, [u + off if 0 <= u + off < t else -1 for u in range(t)])
        conv = conv + (shifted + fold_rows(dpre, off, pad, mode)) @ fw[k].T
    return dleaky(x) * conv, (dw, None if fb is None else dpre.sum((0, 1)))


def stage_backward(x, stacks, final, mode, dy, one=False):
    """The stage's backward as melgan_stacks_backward walks it: the stacks'
    inputs re-run in float32, then the final conv and the stacks in
    reverse."""
    xs = [x]
    for i in range(len(stacks)):
        xs.append(melgan_stacks_reference(xs[-1], stacks[i:i + 1], slope=SLOPE,
                                          pad_mode=mode))
    frags = stack_fragments(stacks)
    g, dfinal = dy, None
    if final is not None:
        y = melgan_stacks_reference(xs[-1], [], final=final, slope=SLOPE, pad_mode=mode)
        g, dfinal = outconv_backward(xs[-1], y, dy, final, mode)
    dstacks = [None] * len(stacks)
    for i in reversed(range(len(stacks))):
        g, dstacks[i] = stack_backward(xs[i], g, stacks[i], frags[i], mode, one)
    return g, dstacks, dfinal


def _named(dx, dstacks, dfinal):
    out = {"dx": dx}
    for i, d in enumerate(dstacks):
        out.update({f"stacks[{i}].{k}": v for k, v in d.items() if v is not None})
    for name, v in zip(("final w", "final b"), dfinal or ()):
        if v is not None:
            out[name] = v
    return out


def _misses(g, r):
    d = (g - r).abs()
    return (not bool((d <= 2e-4 + 1e-3 * r.abs()).all())
            or float(d.max()) > 1e-4 * float(r.abs().max()))


def _off_the_kinks(x, stacks, final, mode, rs):
    """x with the rows moved (0.05 N(0, 1) added) where the plain forward
    puts an input of LeakyReLU within 1e-5 of its rms of the kink at 0,
    until none is left: there float32 rounding can put two correct
    computations on the two sides of the kink, where the derivative jumps
    (chip_smoke.py ``_off_the_kinks``)."""
    for _ in range(50):
        near = torch.zeros(x.shape[:2], dtype=torch.bool)

        def mark(v):
            near.logical_or_((v.abs() < 1e-5 * v.pow(2).mean().sqrt()).any(1))

        c = x.transpose(1, 2)
        for st in stacks:
            mark(c)
            p = (st["wd"].shape[0] - 1) // 2 * st["dilation"]
            z = _conv(F.pad(leaky(c), (p, p), mode=TORCH_MODES[mode]), st["wd"], st["bd"],
                      st["dilation"])
            mark(z)
            c = _conv(leaky(z), st["w1"], st["b1"]) + _conv(c, st["ws"], st["bs"])
        if final is not None:
            mark(c)
        rows = near.nonzero()
        if len(rows) == 0:
            return x
        x = x.clone()
        x[rows[:, 0], rows[:, 1]] += torch.from_numpy(
            (0.05 * rs.randn(len(rows), x.shape[2])).astype(np.float32))
    raise AssertionError("could not move the input off the kinks of LeakyReLU")


def _case(c, b, t, dils, mode, out_ch, seed=5):
    """chip_smoke.py phase 17's inputs at a small size: weights that keep
    activations of order one, a cotangent of scale 1 / sqrt(B T)."""
    rs = np.random.RandomState(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))

    stacks = [{"wd": randn(3, c, c, scale=(3 * c) ** -0.5), "bd": randn(c, scale=0.1),
               "w1": randn(1, c, c, scale=c ** -0.5), "b1": randn(c, scale=0.1),
               "ws": randn(1, c, c, scale=c ** -0.5), "bs": randn(c, scale=0.1),
               "dilation": d} for d in dils]
    final = None
    if out_ch is not None:
        final = (randn(7, c, out_ch, scale=(7 * c) ** -0.5), randn(out_ch, scale=0.1))
    x = _off_the_kinks(randn(b, t, c), stacks, final, mode, rs)
    dy = randn(b, t, out_ch or c, scale=(b * t) ** -0.5)
    return x, stacks, final, dy


# MelGAN v1's three fused stages (C = 128, 64, 32; the last with the final
# conv to 1) and a C = 48 replicate case with the final conv to 4
@pytest.mark.parametrize("c,b,t,mode,out_ch", [
    (128, 2, 160, "reflect", None),
    (64, 2, 150, "reflect", None),
    (32, 2, 200, "reflect", 1),
    (48, 2, 100, "edge", 4),
])
def test_split_tf32_stage_backward_matches_float32_autograd(c, b, t, mode, out_ch):
    x, stacks, final, dy = _case(c, b, t, (1, 3, 9), mode, out_ch)
    want = _named(*melgan_stacks_backward_reference(x, stacks, final, SLOPE, mode, dy))
    got = _named(*stage_backward(x, stacks, final, mode, dy))
    one = _named(*stage_backward(x, stacks, final, mode, dy, one=True))
    assert list(got) == list(want)
    worst = max((float((got[k] - want[k]).abs().max()) / float(want[k].abs().max()), k)
                for k in want)
    worst_one = max((float((one[k] - want[k]).abs().max()) / float(want[k].abs().max()), k)
                    for k in want)
    print(f"\nK7 split TF32, C={c} {mode}: worst max|diff| / max|plain| {worst[0]:.2e} "
          f"({worst[1]}); one TF32 product: {worst_one[0]:.2e} ({worst_one[1]})")
    missed = [k for k in want if _misses(got[k], want[k])]
    assert not missed, missed
    rejected = [k for k in want if _misses(torch.zeros_like(want[k]), want[k])]
    assert rejected == list(want)


def test_stack_fragments_split_the_weights_once():
    """stack_fragments holds each stack's Wd[k], W1^T, Wd[k]^T and Ws^T in
    the B fragments' order, hi and lo exactly the split of csrc's to_tf32,
    and splits several stacks in one pass as it would one by one."""
    _, stacks, _, _ = _case(48, 1, 20, (1, 3), "edge", None)
    frags = stack_fragments(stacks)
    for st, f in zip(stacks, frags):
        assert f.shape == (8, 6, 6, 32, 4)
        mats = [*st["wd"], st["w1"][0].T, *st["wd"].transpose(1, 2), st["ws"][0].T]
        for (hi, lo), m in zip(weights_of(f), mats):
            assert torch.equal(hi, to_tf32(m))
            assert torch.equal(lo, to_tf32(m - to_tf32(m)))
    assert torch.equal(stack_fragments(stacks[1:])[0], frags[1])
