"""The split-TF32 arithmetic of the MelGAN stack kernel K6
(csrc/melgan_stack.cu), emulated on the CPU and held to the float32 plain
version and to the JAX package's ``melgan_stacks_xla``.

The kernel multiplies on the tensor cores in TF32, splitting each operand
v into hi = tf32(v) and lo = tf32(v - hi) (``cvt.rna``) and forming every
product as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with float32 accumulators
(csrc/mma_tf32x3.cuh); the wrapper splits each stack's K + 2 weight
matrices Wd[k], W1, Ws once (``tf32x3.stack_forward_fragments``). Here the
weights are read back out of that fragment tensor the way the kernel
reads it (matrix, k-step, column tile, lane), the activations are split,
and each stack is written out in the kernel's own decomposition, each
product a float32 matmul of TF32 values (exact, since two 11-bit
significands multiply into 22 bits):

- z as one product per tap of the padded rows of leaky(x), the taps' sums
  added in float32, the bias after; h = leaky(z);
- out = [h | x] . [W1; Ws] as the sum of W1's product and Ws's, each a
  float32 total, then b1 + bs;
- the final conv (on the CUDA cores in the kernel): plain float32.

The sums differ from the card's in their order and in the tensor cores'
accumulation, which rounds toward zero; chip_smoke.py phase 7 holds the
kernel itself to its plain version. Cases: MB-MelGAN v2's widths (96; 48
with the final conv to 4; dilations 1, 3, 9, 27) and MelGAN v1's (128,
64, 32 with the final conv to 1; dilations 1, 3, 9), small T, every pad
mode, random weights of gain one from a numpy seed (so that every stack's
branch is as large as its input and a TF32 rounding of one operand
shows): within 2e-4 and 1e-4 max|plain| of ``melgan_stacks_reference``
and of ``melgan_stacks_xla``. The same decomposition with one TF32
product per multiply, and with a neighbouring stack's split, must be
rejected (``pytest -s`` prints the ratios).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from parallelwavegan_tpu.ops.pallas_kernels import melgan_stack as jax_ms  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import melgan_stack as k6  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import (  # noqa: E402
    split_tf32,
    stack_forward_fragments,
    to_tf32,
)

SLOPE = 0.2
TORCH_MODES = {"reflect": "reflect", "edge": "replicate", "constant": "constant"}


def weights_of(frag):
    """[(hi, lo)] of the K + 2 (C, C) matrices Wd[0..K-1], W1, Ws of one
    stack, read out of its fragment tensor (K + 2, C / 8, C / 8, 32, 4) as
    the kernel reads it: in k-step ks and column tile nt, lane 4 gid + tig
    holds (hi, lo) of rows 8 ks + 2 tig and 8 ks + 2 tig + 1 of column 8 nt
    + gid."""
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


def prod(a, w, one):
    """a (B, T, C) times a weight matrix given as (hi, lo), as the kernel
    forms it: a split where its fragment is loaded, three TF32 products
    (the two small ones first), or one with ``one``."""
    hi, lo = w
    ah, al = split_tf32(a)
    return ah @ hi if one else (al @ hi + ah @ lo) + ah @ hi


def leaky(v):
    return F.leaky_relu(v, SLOPE)


def emulate(x, stacks, frags, final, mode, one=False):
    """The stage as K6 runs it, stack i reading ``frags[i]``."""
    t = x.shape[1]
    for st, frag in zip(stacks, frags):
        mats = weights_of(frag)
        k, d = st["wd"].shape[0], st["dilation"]
        p = (k - 1) // 2 * d
        xp = F.pad(leaky(x).transpose(1, 2), (p, p), mode=TORCH_MODES[mode]).transpose(1, 2)
        z = 0
        for j in range(k):  # one float32 total per tap
            z = z + prod(xp[:, j * d:j * d + t], mats[j], one)
        h = leaky(z + st["bd"])
        x = prod(h, mats[k], one) + prod(x, mats[k + 1], one) + (st["b1"] + st["bs"])
    if final is not None:
        x = k6.melgan_stacks_reference(x, [], final=final, slope=SLOPE, pad_mode=mode)
    return x


def unit_gain_stacks(rs, c, dilations):
    """Random stacks of gain about one: z and each branch of order one for
    inputs of order one."""

    def t(*shape, scale):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))

    return [{"wd": t(3, c, c, scale=(3 * c) ** -0.5), "bd": t(c, scale=0.1),
             "w1": t(1, c, c, scale=c ** -0.5), "b1": t(c, scale=0.1),
             "ws": t(1, c, c, scale=c ** -0.5), "bs": t(c, scale=0.1),
             "dilation": d} for d in dilations]


def _misses(g, r):
    d = (g - r).abs()
    return float(d.max()) > 2e-4 or float(d.max()) > 1e-4 * float(r.abs().max())


def _ratio(g, r):
    return float((g - r).abs().max()) / float(r.abs().max())


def _jax(x, stacks, final, mode):
    def j(v):
        return None if v is None else jnp.asarray(v.numpy())

    js = [{k: v if k == "dilation" else j(v) for k, v in st.items()} for st in stacks]
    jf = None if final is None else tuple(j(v) for v in final)
    return torch.from_numpy(np.array(jax_ms.melgan_stacks_xla(
        j(x), js, final=jf, slope=SLOPE, pad_mode=mode)))


V2 = (1, 3, 9, 27)
V1 = (1, 3, 9)


# MB-MelGAN v2's stages (96; 48 with the final conv to 4) and MelGAN v1's
# (128, 64, 32 with the final conv to 1), every pad mode
@pytest.mark.parametrize("c,t,dils,out_ch,mode", [
    (96, 120, V2, None, "reflect"), (48, 100, V2, 4, "edge"),
    (128, 64, V1, None, "constant"), (64, 90, V1, None, "reflect"),
    (32, 80, V1, 1, "reflect"), (48, 20, V2, 4, "constant")])
def test_split_tf32_stacks_match_float32_and_jax(c, t, dils, out_ch, mode):
    rs = np.random.RandomState(c + t)
    stacks = unit_gain_stacks(rs, c, dils)
    final = None
    if out_ch is not None:  # gain 0.3: the tanh below saturation
        final = (torch.from_numpy((rs.randn(7, c, out_ch) * 0.3 / (7 * c) ** 0.5)
                                  .astype(np.float32)),
                 torch.from_numpy((rs.randn(out_ch) * 0.1).astype(np.float32)))
    x = torch.from_numpy(rs.randn(2, t, c).astype(np.float32))
    frags = stack_forward_fragments(stacks)
    with torch.no_grad():
        want = k6.melgan_stacks_reference(x, stacks, final=final, slope=SLOPE,
                                          pad_mode=mode)
        got = emulate(x, stacks, frags, final, mode)
        one = emulate(x, stacks, frags, final, mode, one=True)
        shifted = emulate(x, stacks, frags[1:] + frags[:1], final, mode)
    jax_out = _jax(x, stacks, final, mode)
    print(f"C={c} {mode} final={out_ch}: split TF32 {_ratio(got, want):.2e} of "
          f"max|plain| ({_ratio(got, jax_out):.2e} of JAX's); one TF32 product "
          f"{_ratio(one, want):.2e}; a neighbouring stack's split "
          f"{_ratio(shifted, want):.2e}")
    assert got.shape == want.shape == jax_out.shape == (2, t, out_ch or c)
    assert not _misses(got, want), float((got - want).abs().max())
    assert not _misses(got, jax_out), float((got - jax_out).abs().max())
    assert _misses(one, want), "one TF32 product per multiply passed the check"
    assert _misses(shifted, want), "a neighbouring stack's split passed the check"


@pytest.mark.parametrize("c,k", [(96, 3), (48, 3), (16, 5)])
def test_stack_forward_fragments_split_the_weights_once(c, k):
    """The wrapper's split: hi and lo exactly ``to_tf32``'s of each matrix,
    hi + lo within 2^-22 of it, in the layout that ``weights_of`` (the
    kernel's reading) turns back into Wd[k], W1 and Ws; every stack's
    tensor a view of one split, made in one pass."""
    rs = np.random.RandomState(k)
    stacks = unit_gain_stacks(rs, c, (1, 3))
    for st in stacks:
        st["wd"] = torch.from_numpy((rs.randn(k, c, c) / c).astype(np.float32))
    frags = stack_forward_fragments(stacks)
    assert [tuple(f.shape) for f in frags] == [(k + 2, c // 8, c // 8, 32, 4)] * 2
    assert all(f.is_contiguous() for f in frags)
    assert frags[1].data_ptr() == frags[0].data_ptr() + frags[0].numel() * 4
    for st, frag in zip(stacks, frags):
        mats = list(st["wd"]) + [st["w1"][0], st["ws"][0]]
        for i, (m, (hi, lo)) in enumerate(zip(mats, weights_of(frag))):
            want_hi, want_lo = split_tf32(m)
            assert torch.equal(hi, want_hi), i
            assert torch.equal(lo, want_lo), i
            assert bool(((hi + lo - m).abs() <= 2.0 ** -22 * m.abs()).all()), i
    # k-step 0, tile 0, lane 0 (gid 0, tig 0): Wd[0] row 0, column 0; lane 4
    # (gid 1): column 1; lane 1 (tig 1): row 2; the pair's second entry
    # row 1; tile 1: column 8; matrix K: W1
    wd0 = stacks[0]["wd"][0]
    assert frags[0][0, 0, 0, 0, 0] == to_tf32(wd0[0, 0])
    assert frags[0][0, 0, 0, 4, 0] == to_tf32(wd0[0, 1])
    assert frags[0][0, 0, 0, 1, 0] == to_tf32(wd0[2, 0])
    assert frags[0][0, 0, 0, 0, 2] == to_tf32(wd0[1, 0])
    assert frags[0][0, 0, 1, 0, 0] == to_tf32(wd0[0, 8])
    assert frags[0][k, 0, 0, 0, 0] == to_tf32(stacks[0]["w1"][0, 0, 0])
    assert frags[0][k + 1, 0, 0, 0, 0] == to_tf32(stacks[0]["ws"][0, 0, 0])


def test_a_stage_splits_its_weights_once(monkeypatch):
    """``kernel_weights`` reads what ``with_fragments`` put in every stack
    (the split, and the biases packed into one (3, C) tensor, zeros for a
    missing one) and makes nothing; where a stack lacks them, one split of
    all the stacks is made."""
    rs = np.random.RandomState(2)
    stacks = unit_gain_stacks(rs, 32, V2)
    stacks[1]["b1"] = None
    kept = k6.with_fragments(stacks)
    assert all(st["wd"] is s0["wd"] for st, s0 in zip(kept, stacks))
    for st in kept:
        assert st["biases"].shape == (3, 32) and st["biases"].is_contiguous()
        for row, key in enumerate(("bd", "b1", "bs")):
            want = torch.zeros(32) if st[key] is None else st[key]
            assert torch.equal(st["biases"][row], want), key
    calls = []

    def counted(sts):
        calls.append(len(sts))
        return stack_forward_fragments(sts)

    monkeypatch.setattr(k6, "stack_forward_fragments", counted)
    frags, biases = k6.kernel_weights(kept)
    assert calls == []
    assert all(f is st["frag"] and b is st["biases"]
               for f, b, st in zip(frags, biases, kept))
    again, biases_again = k6.kernel_weights(kept[:2] + stacks[2:])
    assert calls == [4]
    assert all(torch.equal(a, b) for a, b in zip(again, frags))
    assert all(torch.equal(a, b) for a, b in zip(biases_again, biases))


def test_stack_forward_fragments_refuse_a_wrong_shape():
    rs = np.random.RandomState(0)
    st = unit_gain_stacks(rs, 32, (1,))[0]
    for key, bad in (("wd", torch.zeros(3, 32, 24)), ("w1", torch.zeros(1, 32, 16)),
                     ("ws", torch.zeros(32, 32))):
        with pytest.raises(ValueError, match="stack_forward_fragments"):
            stack_forward_fragments([dict(st, **{key: bad})])
    with pytest.raises(ValueError, match="multiple of 16"):
        stack_forward_fragments(unit_gain_stacks(rs, 24, (1,)))
