"""The split-TF32 arithmetic of the WaveNet layer kernel K3/K5
(csrc/wavenet.cu), emulated on the CPU and held to the float32 plain
version.

The kernel multiplies on the tensor cores in TF32, splitting each operand
v into hi = tf32(v) and lo = tf32(v - hi) (``cvt.rna``) and forming every
product as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with float32 accumulators
(csrc/mma_tf32x3.cuh); the wrapper splits each layer's weights once
(``tf32x3.wavenet_fragments``). Here the weights are read back out of that
fragment tensor the way the kernel reads it (k-step, column tile, lane;
the paired columns mapped to channels as the kernel's epilogue maps them,
Ca's padding rows apart), and the layer is written out in the kernel's
own decomposition: the gate's pre-activation as one sum over the K taps
of x and then c (each product a float32 matmul of TF32 values, exact,
since two 11-bit significands multiply into 22 bits), its bias after,
tanh * sigmoid in float32, then g against [Wskip | Wres]. The sums differ
from the card's in their order and in the tensor cores' accumulation,
which rounds toward zero (the kernel forms each k-step's three products
from zero and adds them into float32); chip_smoke.py phase 4 holds the
kernel itself to its plain version.

Cases: one Parallel WaveGAN v1 cycle (C = 64, aux 80, K = 3, d = 1 ..
512, the generator's own initial weights from seed 0, B x T = 1 x 2048)
and a C = 16 stack (aux 10, K = 5, random biases, causal and not); x_out
and the skip sum within 2e-4 + 1e-3 |plain| and 1e-4 max|plain| of
``wavenet_stack_reference`` in float32. A neighbouring layer's fragments,
and the columns read unpaired, must be rejected. The same decomposition
with one TF32 product per multiply is run beside it and its ratios
printed, not asserted (``pytest -s`` shows them).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import (  # noqa: E402
    split_tf32,
    to_tf32,
    wavenet_depth,
    wavenet_fragments,
)
from parallelwavegan_tpu_torch.ops.kernels.wavenet import (  # noqa: E402
    SQRT_HALF,
    WEIGHT_KEYS,
    gated_resblock_reference,
    wavenet_stack_reference,
    with_fragments,
)

V1 = dict(layers=30, stacks=3, residual_channels=64, gate_channels=128,
          skip_channels=64, aux_channels=80, kernel_size=3)


def weights_of(frag, c, ca, k, paired=True):
    """{wconv (K, C, 2C), waux (Ca, 2C), pad (Ca's padding rows), wout (C,
    2C) = [Wskip | Wres]}, each (hi, lo), of one layer, read out of its
    fragment tensor (depth / 8, C / 4, 32, 4) as the kernel reads it: in
    k-step ks and column tile nt, lane 4 gid + tig holds (hi, lo) of depth rows 8 ks + 2 tig and 8 ks + 2 tig + 1
    of column 8 nt + gid. The kernel's epilogue takes column 2 tig + e of
    tile nt as half e's channel 8 (nt // 2) + 2 tig + nt % 2 (csrc/wavenet.cu
    for_each_pair); ``paired=False`` reads the columns in their natural
    order instead, as a kernel without the pairing would."""
    ks, nt, lane = torch.meshgrid(*(torch.arange(n) for n in frag.shape[:3]),
                                  indexing="ij")
    gid, tig = lane // 4, lane % 4
    col = 8 * nt + gid
    if paired:
        col = c * (gid % 2) + 8 * (nt // 2) + 2 * (gid // 2) + nt % 2
    out = {}
    for part in range(2):  # hi, lo
        m = torch.zeros(frag.shape[0] * 8, 2 * c)
        for pair in range(2):
            m[8 * ks + 2 * tig + pair, col] = frag[..., 2 * pair + part]
        kc = k * c
        for name, v in (("wconv", m[:kc].reshape(k, c, 2 * c)), ("waux", m[kc:kc + ca]),
                        ("pad", m[kc + ca:-c]), ("wout", m[-c:])):
            out.setdefault(name, []).append(v)
    return out


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


def _prod(a, w, split):
    """a (B, T, n) @ w (hi, lo) as the kernel forms it: three TF32 products
    (the two small ones first), or one."""
    hi, lo = w
    ah, al = split_tf32(a)
    return (al @ hi + ah @ lo) + ah @ hi if split else ah @ hi


def layer(x, c, w, biases, dil, causal, split):
    """One layer (x_out, skip) in the kernel's decomposition, from its
    fragment weights w (``weights_of``)."""
    k, ch = w["wconv"][0].shape[0], x.shape[2]
    left = (k - 1) * dil if causal else (k - 1) * dil // 2
    z = 0
    for j in range(k):
        z = z + _prod(_shift(x, j * dil - left), [m[j] for m in w["wconv"]], split)
    z = z + _prod(c, w["waux"], split) + biases["bconv"]
    g = torch.tanh(z[..., :ch]) * torch.sigmoid(z[..., ch:])
    out = _prod(g, w["wout"], split)
    skip = out[..., :ch] + biases["bskip"]
    return (out[..., ch:] + biases["bres"] + x) * SQRT_HALF, skip


def stack(x, c, weights, dilations, frag, split, causal=False, shift_layer=0,
          paired=True):
    """The stack as K3 runs it, layer l reading ``frag[l + shift_layer]``."""
    n_layers, k, ch, _ = weights["wconv"].shape
    ca = weights["waux"].shape[1]
    skips = 0
    for layer_i, d in enumerate(dilations):
        w = weights_of(frag[(layer_i + shift_layer) % n_layers], ch, ca, k, paired)
        biases = {key: weights[key][layer_i] for key in ("bconv", "bskip", "bres")}
        x, s = layer(x, c, w, biases, d, causal, split)
        skips = skips + s
    return x, skips


def _misses(g, r):
    d = (g - r).abs()
    return (not bool((d <= 2e-4 + 1e-3 * r.abs()).all())
            or float(d.max()) > 1e-4 * float(r.abs().max()))


def _hold(name, got, one, want):
    d1 = (one - want).abs()
    peak = float(want.abs().max())
    print(f"{name}: split TF32 max|diff|/max|plain| = "
          f"{float((got - want).abs().max()) / peak:.3e}; one TF32 product "
          f"{float(d1.max()) / peak:.3e}, elements past 2e-4 + 1e-3|plain|: "
          f"{float((d1 > 2e-4 + 1e-3 * want.abs()).float().mean()):.2%}, misses "
          f"the check: {_misses(one, want)}")
    assert got.shape == want.shape
    assert not _misses(got, want), (name, float((got - want).abs().max()))


def _v1_cycle():
    gen = get_model_class("ParallelWaveGANGenerator")(
        **V1, generator=torch.Generator().manual_seed(0))
    gen.remove_weight_norm()
    with torch.no_grad():
        all_w, all_d = gen.stack_weights()
    n = V1["layers"] // V1["stacks"]
    weights = {k: v[:n].contiguous() for k, v in all_w.items()}
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(1, 2048, 64).astype(np.float32))
    c = torch.from_numpy(rs.randn(1, 2048, 80).astype(np.float32))
    return x, c, weights, tuple(int(d) for d in all_d[:n])


def _narrow(n_layers=4, ch=16, ca=10, k=5, seed=4):
    rs = np.random.RandomState(seed)
    shapes = {"wconv": (n_layers, k, ch, 2 * ch), "bconv": (n_layers, 2 * ch),
              "waux": (n_layers, ca, 2 * ch), "wskip": (n_layers, ch, ch),
              "bskip": (n_layers, ch), "wres": (n_layers, ch, ch),
              "bres": (n_layers, ch)}
    fan = {"wconv": k * ch, "waux": ca, "wskip": ch, "wres": ch}
    weights = {key: torch.from_numpy((rs.randn(*shape) * (2.0 / fan.get(key, 50)) ** 0.5)
                                     .astype(np.float32)) for key, shape in shapes.items()}
    x = torch.from_numpy(rs.randn(2, 300, ch).astype(np.float32))
    c = torch.from_numpy(rs.randn(2, 300, ca).astype(np.float32))
    return x, c, weights, (1, 3, 9, 27)[:n_layers]


def _causal_reference(x, c, weights, dilations):
    skips = 0
    for layer_i, d in enumerate(dilations):
        x, s = gated_resblock_reference(
            x, c, *(weights[k][layer_i] for k in WEIGHT_KEYS), dilation=d, causal=True)
        skips = skips + s
    return x, skips


@pytest.mark.parametrize("case,causal", [("v1", False), ("narrow", False),
                                         ("narrow", True)])
def test_split_tf32_layers_match_float32(case, causal):
    x, c, weights, dilations = _v1_cycle() if case == "v1" else _narrow()
    frag = wavenet_fragments(weights)
    with torch.no_grad():
        want = (_causal_reference if causal else wavenet_stack_reference)(
            x, c, weights, dilations)
        got, one = (stack(x, c, weights, dilations, frag, split, causal)
                    for split in (True, False))
        # controls: the next layer's split, and the gate's columns unpaired
        shifted = stack(x, c, weights, dilations, frag, True, causal, shift_layer=1)
        unpaired = stack(x, c, weights, dilations, frag, True, causal, paired=False)
    for name, g, o, r, s, u in zip(("x_out", "skip sum"), got, one, want, shifted,
                                   unpaired):
        _hold(f"{case} causal={causal} {name}", g, o, r)
        assert _misses(s, r), f"{name} passed with a neighbouring layer's fragments"
        assert _misses(u, r), f"{name} passed with the columns unpaired"
        assert _misses(torch.zeros_like(g), r), f"zeroed {name} passed"


@pytest.mark.parametrize("ch,ca,k", [(64, 80, 3), (16, 10, 5)])
def test_wavenet_fragments_split_the_weights_once(ch, ca, k):
    """The wrapper's split: hi and lo exactly ``to_tf32``'s of each weight,
    hi + lo within 2^-22 of it, Ca's padding rows zero, the layout that
    ``weights_of`` (the kernel's reading) turns back into each product, and
    the columns paired, tanh_j beside sigmoid_j and skip_j beside res_j."""
    _, _, w, _ = _narrow(n_layers=2, ch=ch, ca=ca, k=k, seed=9)
    f = wavenet_fragments(w)
    depth = wavenet_depth(ch, ca, k)
    assert depth == k * ch + (ca + 7) // 8 * 8 + ch
    assert f.shape == (2, depth // 8, ch // 4, 32, 4)
    assert f.is_contiguous()
    for layer_i in range(2):
        got = weights_of(f[layer_i], ch, ca, k)
        wout = torch.cat([w["wskip"][layer_i], w["wres"][layer_i]], dim=1)
        for name, v in (("wconv", w["wconv"][layer_i]), ("waux", w["waux"][layer_i]),
                        ("wout", wout)):
            hi, lo = split_tf32(v)
            assert torch.equal(got[name][0], hi), name
            assert torch.equal(got[name][1], lo), name
            assert bool(((hi + lo - v).abs() <= 2.0 ** -22 * v.abs()).all()), name
        assert got["pad"][0].shape == ((ca + 7) // 8 * 8 - ca, 2 * ch)
        assert not bool(got["pad"][0].any() or got["pad"][1].any())
    # k-step 0, tile 0, lane 0 (gid 0, tig 0): wconv[0] row 0 of tanh column 0;
    # lane 4 (gid 1): its sigmoid column C; tile 1: channel 1; lane 1 (tig
    # 1): depth row 2; the first [skip | res] k-step: skip_0, then res_0
    w0, s0 = w["wconv"][0, 0], (k * ch + (ca + 7) // 8 * 8) // 8
    assert f[0, 0, 0, 0, 0] == to_tf32(w0[0, 0])
    assert f[0, 0, 0, 4, 0] == to_tf32(w0[0, ch])
    assert f[0, 0, 1, 0, 0] == to_tf32(w0[0, 1])
    assert f[0, 0, 0, 1, 0] == to_tf32(w0[2, 0])
    assert f[0, 0, 0, 0, 2] == to_tf32(w0[1, 0])  # depth row 2 tig + 1
    assert f[0, s0, 0, 0, 0] == to_tf32(w["wskip"][0, 0, 0])
    assert f[0, s0, 0, 4, 0] == to_tf32(w["wres"][0, 0, 0])
    assert f[1, 0, 0, 0, 0] == to_tf32(w["wconv"][1, 0, 0, 0])


def test_wavenet_fragments_refuse_a_wrong_width():
    _, _, w, _ = _narrow(n_layers=1)
    for key, bad in (("wskip", torch.zeros(1, 16, 8)), ("waux", torch.zeros(1, 10, 24)),
                     ("wconv", torch.zeros(1, 5, 16, 16)), ("wres", torch.zeros(1, 8, 16))):
        with pytest.raises(ValueError, match="wavenet_fragments"):
            wavenet_fragments(dict(w, **{key: bad}))


def test_with_fragments_splits_a_stack_or_a_block_once():
    _, _, w, _ = _narrow(n_layers=2)
    got = with_fragments(w)
    assert torch.equal(got["frag"], wavenet_fragments(w))
    assert all(got[k] is w[k] for k in w)
    blk = {k: v[1] for k, v in w.items()}
    assert torch.equal(with_fragments(blk)["frag"], wavenet_fragments(w)[1])
