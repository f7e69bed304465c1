"""The split-TF32 arithmetic of the HiFi-GAN residual-unit kernel (K1's
MRFs, K2a, K2b; csrc/hifigan_tail.cu ``resunit_tc_kernel``), emulated on
the CPU and held to the float32 plain version.

The kernel multiplies on the tensor cores in TF32, splitting each operand
v into hi = tf32(v) and lo = tf32(v - hi) (``cvt.rna``) and forming every
product as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with float32 accumulators
(csrc/mma_tf32x3.cuh); the wrapper splits each conv's weights once
(``tf32x3.mrf_fragments``). Here the weights are read back out of that
fragment tensor the way the kernel reads it (k-step, column tile, lane;
depth row k C + ci is channel ci of tap k), and each residual unit is
written out in the kernel's decomposition: conv1 as a sum over taps of
leaky(x) shifted by k dil (zero outside [0, T)) times tap k's weights,
each tap's three products a float32 matmul of TF32 values (exact, since
two 11-bit significands multiply into 22 bits) added into a float32 sum,
then b1, leaky and conv2 the same way at dilation 1, then b2 and x. The
sums differ from the card's in their order and in the tensor cores'
accumulation, which rounds toward zero (the kernel forms each k-step's
three products from zero and adds them into float32); chip_smoke.py
phases 2 and 8 hold the kernel itself to its plain version.

Cases: one MRF (K = 3, 7, 11 at dilations 1, 3, 5, random biases) at C =
16 and at C = 32, B = 2, T = 301; the output within 2e-4 + 1e-3 |plain|
and 1e-4 max|plain| of ``hifigan_mrf_reference``. A neighbouring
dilation's fragments, and fragments whose lo halves are zero (one TF32
product per weight), must be rejected; the same decomposition with one
TF32 product per multiply is run beside it and its ratio printed, not
asserted (``pytest -s`` shows it). A bundle that carries the split gives
on the CPU the tail and MRF of JAX's ``hifigan_tail_xla`` and
``hifigan_mrf_xla``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.ops.pallas_kernels.hifigan_mrf import (  # noqa: E402
    hifigan_mrf_xla,
)
from parallelwavegan_tpu.ops.pallas_kernels.hifigan_tail import (  # noqa: E402
    hifigan_tail_xla,
)
from parallelwavegan_tpu_torch.ops.kernels.hifigan_mrf import (  # noqa: E402
    fused_hifigan_mrf,
    hifigan_mrf_reference,
)
from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (  # noqa: E402
    fused_hifigan_tail,
    with_fragments,
)
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import (  # noqa: E402
    mrf_fragments,
    split_tf32,
    to_tf32,
)

SLOPE = 0.1


def _blocks(rs, c, kernels=(3, 7, 11), dilations=(1, 3, 5)):
    """Resblocks with weights of gain about one, so that every unit moves
    its input by as much as the input itself."""
    def w(n, k):
        return torch.from_numpy((rs.randn(n, k, c, c) * (2.0 / (k * c)) ** 0.5)
                                .astype(np.float32))

    def b(n):
        return torch.from_numpy((rs.randn(n, c) * 0.1).astype(np.float32))

    return [{"w1": w(len(dilations), k), "b1": b(len(dilations)),
             "w2": w(len(dilations), k), "b2": b(len(dilations)),
             "dilations": dilations} for k in kernels]


def weights_of(frag, k, c):
    """(hi, lo), each (K, C, C), of one conv, read out of its fragment tensor
    (K C / 8, C / 8, 32, 4) as the kernel reads it: in k-step ks and column
    tile nt, lane 4 gid + tig holds (hi, lo) of depth rows 8 ks + 2 tig and
    8 ks + 2 tig + 1 of column 8 nt + gid; depth row k C + ci is channel ci
    of tap k."""
    ks, nt, lane = torch.meshgrid(*(torch.arange(n) for n in frag.shape[:3]),
                                  indexing="ij")
    gid, tig = lane // 4, lane % 4
    out = []
    for part in range(2):  # hi, lo
        m = torch.zeros(frag.shape[0] * 8, c)
        for pair in range(2):
            m[8 * ks + 2 * tig + pair, 8 * nt + gid] = frag[..., 2 * pair + part]
        out.append(m.reshape(k, c, c))
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


def _conv(a, w, dil, split):
    """'same' conv of a (B, T, C) in the kernel's decomposition: tap k reads
    a shifted by k dil - p, three TF32 products (the two small ones first)
    or one, each tap's sum added into float32."""
    hi, lo = w
    k = hi.shape[0]
    ah, al = split_tf32(a)
    z = 0
    for j in range(k):
        s = j * dil - (k - 1) // 2 * dil
        sh, sl = _shift(ah, s), _shift(al, s)
        z = z + ((sl @ hi[j] + sh @ lo[j]) + sh @ hi[j] if split else sh @ hi[j])
    return z


def mrf(x, blocks, frags, split=True, shift_dil=0):
    """The MRF as the kernel runs it, unit di of each block reading the
    fragments of dilation di + shift_dil."""
    acc = 0
    for blk, (f1, f2) in zip(blocks, frags):
        n, k, c = len(blk["dilations"]), blk["w1"].shape[1], x.shape[2]
        xb = x
        for di, d in enumerate(blk["dilations"]):
            fi = (di + shift_dil) % n
            z = _conv(torch.nn.functional.leaky_relu(xb, SLOPE),
                      weights_of(f1[fi], k, c), d, split) + blk["b1"][di]
            z = _conv(torch.nn.functional.leaky_relu(z, SLOPE),
                      weights_of(f2[fi], k, c), 1, split) + blk["b2"][di]
            xb = xb + z
        acc = acc + xb
    return acc / len(blocks)


def _misses(g, r):
    d = (g - r).abs()
    return (not bool((d <= 2e-4 + 1e-3 * r.abs()).all())
            or float(d.max()) > 1e-4 * float(r.abs().max()))


@pytest.mark.parametrize("c", [16, 32])
def test_split_tf32_mrf_matches_float32(c):
    rs = np.random.RandomState(c)
    blocks = _blocks(rs, c)
    x = torch.from_numpy(rs.randn(2, 301, c).astype(np.float32))
    frags = mrf_fragments(blocks)
    no_lo = [tuple(f.clone().index_fill_(-1, torch.tensor([1, 3]), 0.0) for f in fr)
             for fr in frags]
    with torch.no_grad():
        want = hifigan_mrf_reference(x, blocks, slope=SLOPE)
        got = mrf(x, blocks, frags)
        one = mrf(x, blocks, frags, split=False)
        shifted = mrf(x, blocks, frags, shift_dil=1)
        lo_zeroed = mrf(x, blocks, no_lo)
    peak = float(want.abs().max())
    print(f"C={c}: split TF32 max|diff|/max|plain| = "
          f"{float((got - want).abs().max()) / peak:.3e}; one TF32 product "
          f"{float((one - want).abs().max()) / peak:.3e}, misses the check: "
          f"{_misses(one, want)}; lo halves zeroed "
          f"{float((lo_zeroed - want).abs().max()) / peak:.3e}")
    assert got.shape == want.shape == (2, 301, c)
    assert not _misses(got, want), float((got - want).abs().max())
    assert _misses(shifted, want), "passed with a neighbouring dilation's fragments"
    assert _misses(lo_zeroed, want), "passed with the fragments' lo halves zeroed"
    assert _misses(torch.zeros_like(got), want), "a zero output passed"


@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_mrf_fragments_split_every_block_once(c):
    """The wrapper's split: hi and lo exactly ``to_tf32``'s of each weight,
    hi + lo within 2^-22 of it, in the layout that ``weights_of`` (the
    kernel's reading) turns back into each tap's matrix; one tensor for
    all blocks."""
    rs = np.random.RandomState(5)
    blocks = _blocks(rs, c, kernels=(3, 5), dilations=(1, 2))
    frags = mrf_fragments(blocks)
    assert len(frags) == 2
    base = frags[0][0].untyped_storage().data_ptr()
    for blk, (f1, f2) in zip(blocks, frags):
        k = blk["w1"].shape[1]
        for f, w in ((f1, blk["w1"]), (f2, blk["w2"])):
            assert f.shape == (2, k * c // 8, c // 8, 32, 4) and f.is_contiguous()
            assert f.untyped_storage().data_ptr() == base  # views of one split
            for di in range(2):
                hi, lo = split_tf32(w[di])
                got = weights_of(f[di], k, c)
                assert torch.equal(got[0], hi) and torch.equal(got[1], lo)
                assert bool(((hi + lo - w[di]).abs() <= 2.0 ** -22 * w[di].abs()).all())
    # k-step 0, tile 0, lane 0 (gid 0, tig 0): tap 0, channel 0, column 0; its
    # pair is channel 1; lane 4 (gid 1): column 1; lane 1 (tig 1): channel 2;
    # tile 1: column 8; the last k-step: tap K - 1, channels C - 8 ..
    w = blocks[1]["w2"][1]
    f = frags[1][1][1]
    assert f[0, 0, 0, 0] == to_tf32(w[0, 0, 0])
    assert f[0, 0, 0, 1] == split_tf32(w[0, 0, 0])[1]
    assert f[0, 0, 0, 2] == to_tf32(w[0, 1, 0])
    assert f[0, 0, 4, 0] == to_tf32(w[0, 0, 1])
    assert f[0, 0, 1, 0] == to_tf32(w[0, 2, 0])
    assert f[0, 1, 0, 0] == to_tf32(w[0, 0, 8])
    assert f[-1, 0, 0, 0] == to_tf32(w[-1, c - 8, 0])


@pytest.mark.parametrize("bad", [(3, 3, 8, 8), (3, 3, 48, 48), (3, 3, 32, 16), (3, 32, 32)])
def test_mrf_fragments_refuse_a_width_they_do_not_take(bad):
    blocks = _blocks(np.random.RandomState(0), 32, kernels=(3, 3))
    blocks[1]["w2"] = torch.zeros(bad)
    with pytest.raises(ValueError, match=r"mrf_fragments .*blocks\[1\]\.w2"):
        mrf_fragments(blocks)


def test_with_fragments_adds_the_split_at_the_tensor_core_widths():
    rs = np.random.RandomState(1)
    blocks = _blocks(rs, 32)
    got = with_fragments(blocks)
    for blk, g, (f1, f2) in zip(blocks, got, mrf_fragments(blocks)):
        assert all(g[k] is blk[k] for k in blk)
        assert torch.equal(g["f1"], f1) and torch.equal(g["f2"], f2)
    narrow = _blocks(rs, 8)
    assert with_fragments(narrow) is narrow  # the CUDA cores' width: no split


def _jax(tree):
    if isinstance(tree, dict):
        return {k: (v if k in ("stride", "padding", "dilations") else _jax(v))
                for k, v in tree.items() if k not in ("f1", "f2")}
    if isinstance(tree, list):
        return [_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def test_bundle_with_the_split_matches_jax_on_the_cpu():
    """The CPU path ignores the split: a tail (C0 = 64, pre-MRF, stages at
    32 and 16) and an MRF at C = 32 whose blocks carry it agree with JAX's
    XLA versions at tests/test_torch_port_tail.py's and
    test_torch_port_mrf.py's tolerances."""
    rs = np.random.RandomState(7)
    c0 = 64
    pre = with_fragments(_blocks(rs, c0, kernels=(3, 7)))
    stages = []
    for cin in (c0, c0 // 2):
        stages.append({
            "deconv_w": torch.from_numpy((rs.randn(4, cin, cin // 2) * 0.05)
                                         .astype(np.float32)),
            "deconv_b": torch.from_numpy((rs.randn(cin // 2) * 0.01).astype(np.float32)),
            "stride": 2, "padding": 1, "blocks": with_fragments(_blocks(rs, cin // 2)),
        })
    fw = torch.from_numpy((rs.randn(7, c0 // 4, 1) * 0.05).astype(np.float32))
    fb = torch.from_numpy((rs.randn(1) * 0.01).astype(np.float32))
    x = torch.from_numpy((rs.randn(2, 40, c0) * 0.1).astype(np.float32))
    with torch.no_grad():
        got = fused_hifigan_tail(x, stages, fw, fb, slope=SLOPE, pre_blocks=pre)
    want = hifigan_tail_xla(_jax(x), _jax(stages), _jax(fw), _jax(fb), slope=SLOPE,
                            pre_blocks=_jax(pre))
    assert got.shape == (2, 160, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)

    blocks = with_fragments(_blocks(rs, 32))
    xm = torch.from_numpy(rs.randn(2, 300, 32).astype(np.float32))
    with torch.no_grad():
        got = fused_hifigan_mrf(xm, blocks, slope=SLOPE)
    want = hifigan_mrf_xla(_jax(xm), _jax(blocks), slope=SLOPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_prepare_kernels_keeps_the_split_for_decode():
    """Decode's bundles carry each MRF's split (made once, by
    ``mrf_fragments``); ``tail_weights`` and ``mrf_weights`` alone carry
    none; loading weights drops the bundles."""
    from parallelwavegan_tpu_torch.models import get_model_class

    kw = dict(in_channels=8, channels=128, upsample_scales=(4, 4, 2, 2),
              upsample_kernel_sizes=(8, 8, 4, 4))
    gen = get_model_class("HiFiGANGenerator")(
        **kw, use_pallas_tail=True, generator=torch.Generator().manual_seed(3))
    mrf = get_model_class("HiFiGANGenerator")(**kw, use_pallas_mrf=True)
    for g in (gen, mrf):
        g.remove_weight_norm()
        g.prepare_kernels()
    tail = gen._tail_cache
    widths = [tail["pre_blocks"][0]["w1"].shape[-1]] + [
        st["blocks"][0]["w1"].shape[-1] for st in tail["stages"]]
    assert widths == [32, 16, 8]
    for blocks in [tail["pre_blocks"]] + [st["blocks"] for st in tail["stages"]]:
        c = blocks[0]["w1"].shape[-1]
        if c < 16:  # the CUDA cores' width: no split
            assert all("f1" not in blk for blk in blocks)
            continue
        for blk, (f1, f2) in zip(blocks, mrf_fragments(blocks)):
            assert torch.equal(blk["f1"], f1) and torch.equal(blk["f2"], f2)
    assert all("f1" not in blk for blk in gen.tail_weights()["pre_blocks"])
    assert mrf.mrf_stages == (0, 1, 2, 3)  # widths 64, 32, 16, 8
    assert all("f1" in blk for i in (0, 1, 2) for blk in mrf._mrf_cache[i])
    assert all("f1" not in blk for blk in mrf._mrf_cache[3])
    assert all("f1" not in blk for blk in mrf.mrf_weights(1))
    gen.load_state_dict(gen.state_dict())
    assert gen._tail_cache is None
