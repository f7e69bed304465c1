"""The split-TF32 arithmetic of the K4 kernel (csrc/wavenet_bwd.cu), emulated
on the CPU and held to float32 autograd of the plain gated layers.

The kernel multiplies on the tensor cores in TF32: a float32 value keeps
10 mantissa bits there. It splits each operand v into hi = tf32(v) and
lo = tf32(v - hi) (``cvt.rna``: to nearest, ties away from zero) and
forms every product as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with float32
accumulators (csrc/mma_tf32x3.cuh; ``to_tf32`` is the port's, from
ops/kernels/tf32x3.py). Here that split runs in torch on the
CPU, each product a float32 matmul of TF32 values (exact, since two 11-bit
significands multiply into 22 bits), through one layer's backward written
out in the kernel's own decomposition: z, the gate, dg, dz, dx, dc and the
weight gradients (their column sums in float32, as the kernel's CUDA
cores). The sums differ from the card's: their order, and the tensor
cores' accumulation, which rounds toward zero (the kernel adds it into a
float32 total every 32 rows of a weight gradient; chip_smoke.py phase 14
holds the kernel itself to the same bounds).

Ten layers at Parallel WaveGAN v1 widths and dilations (C = 64, gate 128,
aux 80, d = 1 .. 512, the generator's own initial weights from seed 0),
B x T = 2 x 2048, under chip_smoke.py phase 14's loss: every gradient
within 2e-4 + 1e-3 |plain| and 1e-4 max|plain| of float32 autograd, and
each zeroed gradient rejected. The same decomposition with one TF32
product per multiply is run beside it and its ratios printed, not
asserted (``pytest -s`` shows them).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.wavenet import (  # noqa: E402
    WEIGHT_KEYS,
    gated_resblock_reference,
    wavenet_stack_reference,
)
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import to_tf32  # noqa: E402

SQRT_HALF = 0.5 ** 0.5
V1 = dict(layers=30, stacks=3, residual_channels=64, gate_channels=128,
          skip_channels=64, aux_channels=80, kernel_size=3)


def mm_split(a, b):
    """a @ b as the kernel forms it: three TF32 products, float32 sums."""
    ah, bh = to_tf32(a), to_tf32(b)
    al, bl = to_tf32(a - ah), to_tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_one(a, b):
    """a @ b as one TF32 product."""
    return to_tf32(a) @ to_tf32(b)


def _shift(v, s):
    """v[:, t + s] along T, zero outside [0, T)."""
    t = v.shape[1]
    out = torch.zeros_like(v)
    if abs(s) < t:
        if s >= 0:
            out[:, :t - s] = v[:, s:]
        else:
            out[:, -s:] = v[:, :t + s]
    return out


def layer_backward(x, c, w, dil, dxo, dsk, mm):
    """One layer's backward in the kernel's decomposition, every product
    through ``mm``: (dx_l, dc of this layer, its weight gradients)."""
    b, t, ch = x.shape
    k = w["wconv"].shape[0]
    left = (k - 1) * dil // 2

    def rows(v):
        return v.reshape(b * t, v.shape[-1])

    def prod(a, m):
        return mm(rows(a), m).reshape(b, t, m.shape[1])

    taps = [_shift(x, j * dil - left) for j in range(k)]
    z = sum(prod(taps[j], w["wconv"][j]) for j in range(k))
    z = z + prod(c, w["waux"]) + w["bconv"]
    a, s = torch.tanh(z[..., :ch]), torch.sigmoid(z[..., ch:])
    g = a * s
    # the kernel scales the dxn products' sum once, before dS's products
    dg = prod(dxo, w["wres"].T) * SQRT_HALF + prod(dsk, w["wskip"].T)
    dz = torch.cat([dg * s * (1 - a * a), dg * a * s * (1 - s)], -1)
    dx = dxo * SQRT_HALF + sum(
        prod(_shift(dz, left - j * dil), w["wconv"][j].T) for j in range(k))
    dc = prod(dz, w["waux"].T)
    grads = {
        "wconv": torch.stack([mm(rows(tap).T, rows(dz)) for tap in taps]),
        "bconv": rows(dz).sum(0),
        "waux": mm(rows(c).T, rows(dz)),
        "wskip": mm(rows(g).T, rows(dsk)),
        "bskip": rows(dsk).sum(0),
        "wres": mm(rows(g).T, rows(dxo)) * SQRT_HALF,
        "bres": rows(dxo).sum(0) * SQRT_HALF,
    }
    return dx, dc, grads


def stack_backward(x, c, weights, dilations, dxo, dsk, mm):
    """The chunk's backward as K4 walks it: the layers' inputs re-run in
    float32, then the layers in reverse."""
    xs = [x]
    for layer, d in enumerate(dilations[:-1]):
        xs.append(gated_resblock_reference(
            xs[-1], c, *(weights[k][layer] for k in WEIGHT_KEYS), dilation=d,
            causal=False)[0])
    dc = torch.zeros_like(c)
    dw = {k: torch.zeros_like(v) for k, v in weights.items()}
    dx = dxo
    for layer in reversed(range(len(dilations))):
        w = {k: weights[k][layer] for k in WEIGHT_KEYS}
        dx, dcl, gl = layer_backward(xs[layer], c, w, dilations[layer], dx, dsk, mm)
        dc = dc + dcl
        for k in WEIGHT_KEYS:
            dw[k][layer] = gl[k]
    return {"dx": dx, "dc": dc, **dw}


def _misses(g, r):
    d = (g - r).abs()
    return (not bool((d <= 2e-4 + 1e-3 * r.abs()).all())
            or float(d.max()) > 1e-4 * float(r.abs().max()))


@pytest.fixture(scope="module")
def v1_case():
    gen = get_model_class("ParallelWaveGANGenerator")(
        **V1, generator=torch.Generator().manual_seed(0))
    gen.remove_weight_norm()
    with torch.no_grad():
        all_w, all_d = gen.stack_weights()
    n = V1["layers"] // V1["stacks"]
    weights = {k: v[:n].contiguous() for k, v in all_w.items()}
    dilations = tuple(int(d) for d in all_d[:n])
    rs = np.random.RandomState(0)
    b, t = 2, 2048
    x = torch.from_numpy(rs.randn(b, t, 64).astype(np.float32))
    c = torch.from_numpy(rs.randn(b, t, 80).astype(np.float32))
    # chip_smoke.py phase 14's loss: ((xo^2).mean() + 0.5 (sk^2).mean())
    # C sqrt(B T), so that every gradient is well above the 2e-4 term
    scale = 64 * (b * t) ** 0.5
    xv, cv = x.clone().requires_grad_(), c.clone().requires_grad_()
    wv = {k: v.clone().requires_grad_() for k, v in weights.items()}
    xo, sk = wavenet_stack_reference(xv, cv, wv, dilations)
    loss = ((xo ** 2).mean() + 0.5 * (sk ** 2).mean()) * scale
    want = torch.autograd.grad(loss, [xv, cv, *(wv[k] for k in WEIGHT_KEYS)])
    want = dict(zip(("dx", "dc") + WEIGHT_KEYS, want))
    numel = xo.numel()
    dxo = (xo * (2 * scale / numel)).detach()
    dsk = (sk * (scale / numel)).detach()
    return x, c, weights, dilations, dxo, dsk, want


def test_to_tf32_rounds_as_cvt_rna():
    one = 1.0
    vals = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11), one + 2.0 ** -12,
                         one + 3 * 2.0 ** -12, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + 2.0 ** -10, -(one + 2.0 ** -10), one,
                         one + 2.0 ** -10, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(to_tf32(vals), want)
    v = torch.from_numpy(np.random.RandomState(1).randn(1000).astype(np.float32))
    hi = to_tf32(v)
    assert torch.equal(to_tf32(hi), hi)
    assert float(((v - hi).abs() / v.abs()).max()) <= 2.0 ** -11
    # hi + lo keeps about 21 bits of v
    assert float(((v - hi - to_tf32(v - hi)).abs() / v.abs()).max()) <= 2.0 ** -21


def test_split_tf32_backward_matches_float32_autograd(v1_case):
    x, c, weights, dilations, dxo, dsk, want = v1_case
    got = stack_backward(x, c, weights, dilations, dxo, dsk, mm_split)
    one = stack_backward(x, c, weights, dilations, dxo, dsk, mm_one)
    for key, r in want.items():
        g = got[key]
        d1 = (one[key] - r).abs()
        print(f"{key}: split TF32 max|diff|/max|plain| = "
              f"{float((g - r).abs().max()) / float(r.abs().max()):.3e}; one TF32 "
              f"product {float(d1.max()) / float(r.abs().max()):.3e}, elements "
              f"past 2e-4 + 1e-3|plain|: "
              f"{float((d1 > 2e-4 + 1e-3 * r.abs()).float().mean()):.2%}, "
              f"misses the check: {_misses(one[key], r)}")
        assert g.shape == r.shape
        assert not _misses(g, r), (key, float((g - r).abs().max()))
        assert _misses(torch.zeros_like(g), r), f"zeroed {key} passed"
