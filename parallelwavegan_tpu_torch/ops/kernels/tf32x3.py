"""Split TF32 on the host side: the rounding of csrc/mma_tf32x3.cuh and
the weight layout that K9's chain kernel (csrc/tade_bwd.cu) reads.

A float32 value v is split into hi = tf32(v) and lo = tf32(v - hi), both
TF32 (10 mantissa bits, rounded as ``cvt.rna``: to nearest, ties away
from zero); a product is then a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on the
tensor cores. ``conv_fragments`` splits a conv's weights once per call and
stores them in the order in which ``mma.sync.m16n8k8`` takes its B
operand, so that the kernel loads a thread's (hi, lo) of both B registers
with one 16-byte shared-memory load and splits only the activations.
"""

from __future__ import annotations

import torch


def to_tf32(v):
    """``cvt.rna.tf32.f32``: v rounded to 10 mantissa bits, to nearest, ties
    away from zero (a float32 with its low 13 bits cleared), by the integer
    add and mask of csrc/mma_tf32x3.cuh ``to_tf32``."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(v):
    """(hi, lo) with v = hi + lo + O(2^-22 |v|), both TF32."""
    hi = to_tf32(v)
    return hi, to_tf32(v - hi)


def conv_fragments(w):
    """A 9-tap conv's gather-form weights w (9, Cin, Cout), Cin and Cout
    multiples of 8, as those of its transposed conv, Wt[j] = w[8 - j]^T,
    flattened to depth K = 9 Cout (tap major), split and laid out as the B
    operands of m16n8k8 TF32 products: (K / 8, Cin / 8, 32, 4), entry [ks,
    nt, lane] = (hi, lo of Wt[8 ks + 2 tig, 8 nt + gid], hi, lo of Wt[8 ks
    + 2 tig + 1, 8 nt + gid]) with lane = 4 gid + tig. Logical depth k = tig
    of a k-step is row 2 tig and k = tig + 4 row 2 tig + 1 (the kernel reads
    its A operand's channels in the same pairs). What csrc/tade_bwd.cu
    takes."""
    n = w.shape[1]
    if n % 8 or w.shape[2] % 8:
        raise ValueError(f"conv_fragments needs widths of multiples of 8, got "
                         f"{tuple(w.shape)}")
    wt = w.detach().flip(0).transpose(1, 2).reshape(-1, n)
    k = wt.shape[0]

    def arrange(x):  # (ks, tig, pair, nt, gid) -> (ks, nt, gid, tig, pair)
        return x.reshape(k // 8, 4, 2, n // 8, 8).permute(0, 3, 4, 1, 2)

    hi, lo = split_tf32(wt)
    return torch.stack([arrange(hi), arrange(lo)], dim=-1).reshape(
        k // 8, n // 8, 32, 4).contiguous()
