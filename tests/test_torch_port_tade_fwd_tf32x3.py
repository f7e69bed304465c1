"""The split-TF32 arithmetic of the forward TADE kernels K8a and K8b
(csrc/tade.cu), emulated on the CPU and held to the float32 plain versions.

The kernels multiply on the tensor cores in TF32, splitting each operand
v into hi = tf32(v) and lo = tf32(v - hi) (``cvt.rna``) and forming every
product as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with float32 accumulators
(csrc/mma_tf32x3.cuh); the wrapper splits each half's three convs once
(``tf32x3.forward_fragments``). Here the weights are read back out of that
fragment tensor the way the kernel reads it (pass, k-step, column tile,
lane; the 128-column convs' columns mapped to channels as the kernel's
epilogue maps them), and each conv is written out in the kernel's own
decomposition: per tap one product of the tap's shifted rows against the
tap's weights (each a float32 matmul of TF32 values, exact, since two
11-bit significands multiply into 22 bits), the taps' sums added into a
float32 total, the bias after; the modulation and the gate in float32.
The sums differ from the card's in their order and in the tensor cores'
accumulation, which rounds toward zero; chip_smoke.py phase 11 holds the
kernels themselves to their plain versions.

StyleMelGAN v1 widths (C = 64, 128-wide gates, K = 9), random unit-gain
weights, B x T = 2 x 150: K8a, and K8b at scale 1 and 2 and dilation 1
and 2, softmax and sigmoid gates, and whole blocks; every output within
2e-4 + 1e-3 |plain| and 1e-4 max|plain| of ``tade1_reference`` /
``tade2_reference`` in float32. The same decomposition with one TF32
product per multiply is run beside it and its ratios printed, not
asserted (``pytest -s`` shows them).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import (  # noqa: E402
    forward_fragments,
    split_tf32,
    to_tf32,
)

C = 64
CONVS = (("aux", 64), ("g", 128), ("gc", 128))  # a half's convs, in pass order


def weights_of(frag):
    """{conv: (hi, lo)} of a half's three convs, gather form (9, 64, N),
    read out of forward_fragments' tensor (5, 72, 8, 32, 4) as the kernel
    reads it: in pass p, k-step kk and column tile nt, lane 4 gid + tig
    holds (hi, lo) of depth rows 8 kk + 2 tig and 8 kk + 2 tig + 1 (tap
    major, 64 channels a tap) of pass column 8 nt + gid. In a 128-column
    conv, column 2 tig + e of its tile NT is half e's channel 8 (NT // 2) +
    2 tig + NT % 2 (csrc/tade.cu pair_channel)."""
    p, kk, nt, lane = torch.meshgrid(*(torch.arange(n) for n in frag.shape[:4]),
                                     indexing="ij")
    gid, tig = lane // 4, lane % 4
    col = 64 * p + 8 * nt + gid
    planes = []
    for part in range(2):  # hi, lo
        m = torch.zeros(9 * C, 5 * 64)
        for pair in range(2):
            m[8 * kk + 2 * tig + pair, col] = frag[..., 2 * pair + part]
        planes.append(m)
    out, c0 = {}, 0
    for name, n in CONVS:
        mats = []
        for m in planes:
            w = m[:, c0:c0 + n]
            if n == 2 * C:
                tile, within = torch.arange(n) // 8, torch.arange(n) % 8
                orig = C * (within % 2) + 8 * (tile // 2) + 2 * (within // 2) + tile % 2
                w = torch.zeros_like(w).index_copy_(1, orig, w)
            mats.append(w.reshape(9, C, n))
        out[name] = tuple(mats)
        c0 += n
    return out


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


def conv(v, w, bias, dil, split: bool):
    """The kernel's 9-tap 'same' conv: per tap k one product of v[u + (k -
    4) dil] against w[k] (three TF32 products, or one), each tap's sum
    added into a float32 total, then the bias."""
    hi, lo = w
    b, n, _ = v.shape
    total = 0
    for k in range(9):
        ah, al = split_tf32(_shift(v, (k - 4) * dil).reshape(b * n, -1))
        tap = (al @ hi[k] + ah @ lo[k]) + ah @ hi[k] if split else ah @ hi[k]
        total = total + tap
    return total.reshape(b, n, -1) + bias


def _modulated(sh, xn):
    s, h = sh.chunk(2, dim=-1)
    return s * xn + h


def k8a(x, c, blk, gate, w, split):
    """K8a's function (x2, a) in the kernel's decomposition, from its
    fragment weights w (``weights_of``)."""
    a = conv(c, w["aux"], blk["aux1_b"], 1, split)
    mean, rstd = td._stats(x)
    y = _modulated(conv(a, w["g"], blk["g1_b"], 1, split),
                   (x - mean[:, None]) * rstd[:, None])
    return td._gate(conv(y, w["gc"], blk["gc1_b"], 1, split), gate), a


def k8b(x, x2, a, blk, gate, w, split):
    """K8b's function (out, a2)."""
    sc, d = int(blk["scale"]), int(blk["dilation"])
    a2 = conv(td._stretch(a, sc), w["aux"], blk["aux2_b"], 1, split)
    mean, rstd = td._stats(x2)
    y2 = _modulated(conv(a2, w["g"], blk["g2_b"], 1, split),
                    td._stretch((x2 - mean[:, None]) * rstd[:, None], sc))
    t2 = conv(y2, w["gc"], blk["gc2_b"], d, split)
    return td._stretch(x, sc) + td._gate(t2, gate), a2


def _block(scale, dilation, seed=3):
    rs = np.random.RandomState(seed)
    # unit-gain convs (chip_smoke.py phase 11's): activations of order one
    blk = {"scale": scale, "dilation": dilation}
    for key in td.WEIGHT_KEYS:
        cout = C if key.startswith("aux") else 2 * C
        blk[f"{key}_w"] = torch.from_numpy((rs.randn(9, C, cout) / 24.0).astype(np.float32))
        blk[f"{key}_b"] = torch.from_numpy((rs.randn(cout) * 0.1).astype(np.float32))
    return blk, rs


def _randn(rs, *shape):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32))


def _misses(g, r):
    d = (g - r).abs()
    return (not bool((d <= 2e-4 + 1e-3 * r.abs()).all())
            or float(d.max()) > 1e-4 * float(r.abs().max()))


def _hold(name, got, one, want):
    r = want
    d1 = (one - r).abs()
    print(f"{name}: split TF32 max|diff|/max|plain| = "
          f"{float((got - r).abs().max()) / float(r.abs().max()):.3e}; one TF32 "
          f"product {float(d1.max()) / float(r.abs().max()):.3e}, elements past "
          f"2e-4 + 1e-3|plain|: {float((d1 > 2e-4 + 1e-3 * r.abs()).float().mean()):.2%}, "
          f"misses the check: {_misses(one, r)}")
    assert got.shape == r.shape
    assert not _misses(got, r), (name, float((got - r).abs().max()))
    assert _misses(torch.zeros_like(got), r), f"zeroed {name} passed"


def _frags(blk, half):
    keys = td.WEIGHT_KEYS[:3] if half == 1 else td.WEIGHT_KEYS[3:]
    return weights_of(forward_fragments(*(blk[f"{k}_w"] for k in keys)))


@pytest.mark.parametrize("half,scale,dilation,gate", [
    (1, 1, 1, "softmax"), (1, 1, 1, "sigmoid"), (2, 1, 1, "softmax"),
    (2, 1, 2, "sigmoid"), (2, 2, 1, "sigmoid"), (2, 2, 2, "softmax")])
def test_split_tf32_half_matches_float32(half, scale, dilation, gate):
    blk, rs = _block(scale, dilation)
    x, c = _randn(rs, 2, 150, C), _randn(rs, 2, 150, C)
    w = _frags(blk, half)
    with torch.no_grad():
        if half == 1:
            want = td.tade1_reference(x, c, blk, gate)
            got, one = (k8a(x, c, blk, gate, w, split) for split in (True, False))
        else:
            x2, a = td.tade1_reference(x, c, blk, gate)
            want = td.tade2_reference(x, x2, a, blk, gate)
            got, one = (k8b(x, x2, a, blk, gate, w, split) for split in (True, False))
    for name, g, o, r in zip(("x2", "a") if half == 1 else ("out", "a2"), got, one, want):
        _hold(f"K8{'ab'[half - 1]} {name}", g, o, r)


@pytest.mark.parametrize("scale,dilation,gate", [(2, 2, "softmax"), (1, 1, "sigmoid")])
def test_split_tf32_block_matches_float32(scale, dilation, gate):
    """A whole block: K8a then K8b on K8a's own (emulated) outputs."""
    blk, rs = _block(scale, dilation, seed=5)
    x, c = _randn(rs, 2, 150, C), _randn(rs, 2, 150, C)
    w1, w2 = _frags(blk, 1), _frags(blk, 2)
    with torch.no_grad():
        want = td.tade_block_reference(x, c, blk, gated_function=gate)
        got, one = ((k8b(x, *k8a(x, c, blk, gate, w1, split), blk, gate, w2, split))
                    for split in (True, False))
    for name, g, o, r in zip(("x_out", "c_out"), got, one, want):
        _hold(f"block {name}", g, o, r)


def test_forward_fragments_split_the_weights_once():
    """The wrapper's split of a half's three convs: hi and lo exactly
    ``to_tf32``'s of each weight, hi + lo within 2^-22 of it, the layout
    that ``weights_of`` (the kernel's reading) turns back into each conv
    in gather form, and the 128-column convs' columns paired, each
    thread's (s_j, h_j) side by side."""
    rs = np.random.RandomState(9)
    ws = [torch.from_numpy(rs.randn(9, C, n).astype(np.float32)) for _, n in CONVS]
    f = forward_fragments(*ws)
    assert f.shape == td.FRAGMENTS_SHAPE == (5, 72, 8, 32, 4)
    assert f.is_contiguous()
    got = weights_of(f)
    for (name, _), w in zip(CONVS, ws):
        hi, lo = split_tf32(w)
        assert torch.equal(got[name][0], hi), name
        assert torch.equal(got[name][1], lo), name
        assert bool(((hi + lo - w).abs() <= 2.0 ** -22 * w.abs()).all()), name
    # pass 1 (g's first 64 columns), k-step 0, column tile 0, lane 0 (gid 0,
    # tig 0): depth row 0 of g's column s_0; column tile 1 holds s_1
    assert f[1, 0, 0, 0, 0] == to_tf32(ws[1][0, 0, 0])
    assert f[1, 0, 1, 0, 0] == to_tf32(ws[1][0, 0, 1])
    assert f[1, 0, 0, 1, 0] == to_tf32(ws[1][0, 2, 0])  # lane 1: tig 1, depth row 2
    assert f[1, 0, 0, 4, 0] == to_tf32(ws[1][0, 0, 64])  # lane 4: gid 1, column h_0
    with pytest.raises(ValueError, match="forward_fragments takes"):
        forward_fragments(ws[1], ws[1], ws[2])


def test_with_fragments_splits_each_half_once():
    blk, _ = _block(2, 2)
    got = td.with_fragments(blk)
    for half, keys in ((1, td.WEIGHT_KEYS[:3]), (2, td.WEIGHT_KEYS[3:])):
        assert torch.equal(got[f"frag{half}"],
                           forward_fragments(*(blk[f"{k}_w"] for k in keys)))
        assert td._fragments(got, half) is got[f"frag{half}"]
    assert all(got[k] is blk[k] for k in blk)
    wide = dict(blk, aux1_w=torch.zeros(9, 80, C))  # the first block's aux width
    assert td.with_fragments(wide) is wide
