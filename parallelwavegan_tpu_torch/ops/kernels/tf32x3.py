"""Split TF32 on the host side: the rounding of csrc/mma_tf32x3.cuh and
the weight layouts that the kernels read (K9's chain kernel in
csrc/tade_bwd.cu, K8a and K8b in csrc/tade.cu, K7's row products in
csrc/melgan_stack_bwd.cu, the MelGAN stack K6 in csrc/melgan_stack.cu, the
WaveNet layer K3/K5 in csrc/wavenet.cu, the HiFi-GAN residual unit of K1
and K2 in csrc/hifigan_tail.cu).

A float32 value v is split into hi = tf32(v) and lo = tf32(v - hi), both
TF32 (10 mantissa bits, rounded as ``cvt.rna``: to nearest, ties away
from zero); a product is then a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on the
tensor cores. ``conv_fragments`` (a transposed conv's weights),
``forward_fragments`` (a forward kernel's three convs),
``stack_fragments`` (the MelGAN stacks' backward products),
``stack_forward_fragments`` (their forward products),
``wavenet_fragments`` (the WaveNet layers' two products) and
``mrf_fragments`` (an MRF's residual-unit convs) split the weights once
per call and store them in the order in which ``mma.sync.m16n8k8``
takes its B operand, so that the kernel loads a thread's (hi, lo) of both
B registers with one 16-byte shared-memory load and splits only the
activations.
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


def _fragments(wk):
    """A (..., K, N) product operand (a stack of them), K and N multiples
    of 8, split and laid out as the B operands of m16n8k8 TF32 products:
    (..., K / 8, N / 8, 32, 4), entry [ks, nt, lane] = (hi, lo of wk[8 ks
    + 2 tig, 8 nt + gid], hi, lo of wk[8 ks + 2 tig + 1, 8 nt + gid]) with
    lane = 4 gid + tig. Logical depth k = tig of a k-step is row 2 tig and
    k = tig + 4 row 2 tig + 1 (the kernels read their A operand's channels
    in the same pairs)."""
    *lead, k, n = wk.shape
    d = len(lead)

    def arrange(x):  # (ks, tig, pair, nt, gid) -> (ks, nt, gid, tig, pair)
        return x.reshape(*lead, k // 8, 4, 2, n // 8, 8).permute(
            *range(d), d, d + 3, d + 4, d + 1, d + 2)

    hi, lo = split_tf32(wk)
    return torch.stack([arrange(hi), arrange(lo)], dim=-1).reshape(
        *lead, k // 8, n // 8, 32, 4)


def conv_fragments(w):
    """A 9-tap conv's gather-form weights w (9, Cin, Cout), Cin and Cout
    multiples of 8, as those of its transposed conv, Wt[j] = w[8 - j]^T,
    flattened to depth K = 9 Cout (tap major), in ``_fragments``' layout:
    (K / 8, Cin / 8, 32, 4). What csrc/tade_bwd.cu takes."""
    n = w.shape[1]
    if n % 8 or w.shape[2] % 8:
        raise ValueError(f"conv_fragments needs widths of multiples of 8, got "
                         f"{tuple(w.shape)}")
    return _fragments(w.detach().flip(0).transpose(1, 2).reshape(-1, n))


def _pair_columns(wk):
    """The n columns (n = 2C, a multiple of 16) of a gated product's (K, n)
    weights, halves [first | second], reordered so that column 8 nt + 2 tig
    + e is original column C e + 8 (nt // 2) + 2 tig + nt % 2: the kernel's
    thread (gid, tig) then holds in one column tile a channel's first-half
    column beside its second-half column ([s | h], [ta | tb], [tanh |
    sigmoid] or [skip | res]), and in the next tile the next channel's. A
    reshape and a copy (an index tensor would be copied to the card on
    every call)."""
    n = wk.shape[-1]
    # original column (e, nt // 2, tig, nt % 2) -> (nt // 2, nt % 2, tig, e)
    return wk.reshape(-1, 2, n // 16, 4, 2).permute(0, 2, 4, 3, 1).reshape(-1, n)


def forward_fragments(aux_w, g_w, gc_w):
    """The three convs of a forward TADE kernel (K8a: aux1, g1, gc1; K8b:
    aux2, g2, gc2), gather-form weights (9, 64, 64), (9, 64, 128) and (9,
    64, 128), as the kernel takes them: each conv w[k] as is, flattened to
    depth 9 x 64 (tap major), the 128-column convs' columns paired
    (``_pair_columns``), all in ``_fragments``' layout and cut into
    passes of 64 columns: (5, 576 / 8, 8, 32, 4), pass 0 aux, 1-2 g, 3-4
    gc. What csrc/tade.cu takes."""
    shapes = [tuple(w.shape) for w in (aux_w, g_w, gc_w)]
    if shapes != [(9, 64, 64), (9, 64, 128), (9, 64, 128)]:
        raise ValueError(f"forward_fragments takes (9, 64, 64), (9, 64, 128), "
                         f"(9, 64, 128), got {shapes}")
    wk = torch.cat([aux_w.detach().reshape(-1, 64), _pair_columns(g_w.detach()),
                    _pair_columns(gc_w.detach())], dim=1)
    f = _fragments(wk)  # (72, 40, 32, 4)
    return f.reshape(f.shape[0], 5, 8, 32, 4).transpose(0, 1).contiguous()


def stack_fragments(stacks):
    """The products of MelGAN ResidualStacks of one width C (gather-form
    ``wd`` (K, C, C), ``w1`` and ``ws`` (1, C, C), C a multiple of 16) as
    K7 takes them, one tensor per stack: its 2K + 2 matrices Wd[k] (z),
    W1^T (dh = g . W1^T), Wd[k]^T (the transposed conv) and Ws^T (g . Ws^T)
    in ``_fragments``' layout, (2K + 2, C / 8, C / 8, 32, 4). All stacks are
    split in one pass. What csrc/melgan_stack_bwd.cu takes."""
    mats = []
    for st in stacks:
        wd, w1, ws = (st[k].detach() for k in ("wd", "w1", "ws"))
        if wd.shape[1] % 16 or wd.shape[1:] != wd.shape[1:][::-1]:
            raise ValueError(f"stack_fragments needs square widths of multiples of 16, "
                             f"got {tuple(wd.shape)}")
        mats += [wd, w1.transpose(1, 2), wd.transpose(1, 2), ws.transpose(1, 2)]
    f = _fragments(torch.cat(mats))
    return list(f.split([2 * st["wd"].shape[0] + 2 for st in stacks]))


def stack_forward_fragments(stacks):
    """The products of MelGAN ResidualStacks of one width C (gather-form
    ``wd`` (K, C, C), ``w1`` and ``ws`` (1, C, C), C a multiple of 16) as
    K6 takes them, one tensor per stack: its K + 2 matrices Wd[k] (z =
    sum_k leaky(x_pad) . Wd[k]), W1 and Ws (out = [leaky(z) | x] . [W1;
    Ws]) in ``_fragments``' layout, (K + 2, C / 8, C / 8, 32, 4): (K + 2) C
    / 8 k-steps of one stream. All stacks are split in one pass, into views
    of one tensor. What csrc/melgan_stack.cu's stack kernel takes; the
    plain version of its split_kernel (``melgan_stack.kernel_weights``)."""
    if not stacks:
        return []
    mats = []
    for st in stacks:
        wd, w1, ws = (st[k].detach() for k in ("wd", "w1", "ws"))
        c = wd.shape[-1]
        if (c % 16 or wd.dim() != 3 or wd.shape[1] != c
                or tuple(w1.shape) != (1, c, c) or tuple(ws.shape) != (1, c, c)):
            raise ValueError(f"stack_forward_fragments needs wd (K, C, C), w1 and ws "
                             f"(1, C, C), C a multiple of 16, got {tuple(wd.shape)}, "
                             f"{tuple(w1.shape)}, {tuple(ws.shape)}")
        mats += [wd, w1, ws]
    f = _fragments(torch.cat(mats))
    return list(f.split([st["wd"].shape[0] + 2 for st in stacks]))


def wavenet_depth(c: int, ca: int, k: int) -> int:
    """Depth of a WaveNet layer's fragment tensor: K taps of C channels, Ca
    zero-padded to a multiple of 8, then C for [Wskip | Wres]."""
    return k * c + (ca + 7) // 8 * 8 + c


def wavenet_matrix(weights):
    """The two products of L WaveNet layers (the stacked gather form of
    ops/kernels/wavenet.py: ``wconv`` (L, K, C, 2C), ``waux`` (L, Ca, 2C),
    ``wskip`` and ``wres`` (L, C, C)) as one matrix of 2C columns per
    layer, (L, ``wavenet_depth``, 2C): the gate's [Wconv[0]; ..;
    Wconv[K-1]; Waux] (Ca zero-padded to a multiple of 8) and [Wskip |
    Wres] below it, columns in their natural order."""
    wconv, waux, wskip, wres = (weights[k].detach() for k in
                                ("wconv", "waux", "wskip", "wres"))
    if wconv.dim() != 4 or wconv.shape[2] % 8 or wconv.shape[3] != 2 * wconv.shape[2]:
        raise ValueError(f"wavenet_fragments needs wconv (L, K, C, 2C), C a multiple "
                         f"of 8, got {tuple(wconv.shape)}")
    n_layers, k, c, n = wconv.shape
    ca = waux.shape[1] if waux.dim() == 3 else -1
    shapes = {"waux": (waux, (n_layers, ca, n)), "wskip": (wskip, (n_layers, c, c)),
              "wres": (wres, (n_layers, c, c))}
    for name, (w, want) in shapes.items():
        if ca < 1 or tuple(w.shape) != want:
            raise ValueError(f"wavenet_fragments: {name} has shape {tuple(w.shape)}, "
                             f"expected {want} for wconv {tuple(wconv.shape)}")
    return torch.cat([wconv.reshape(n_layers, k * c, n),
                      torch.nn.functional.pad(waux, (0, 0, 0, (ca + 7) // 8 * 8 - ca)),
                      torch.cat([wskip, wres], dim=2)], dim=1)


def wavenet_fragments(weights):
    """``wavenet_matrix`` of L WaveNet layers as K3/K5 take it: the columns
    paired (``_pair_columns``: tanh_j beside sigmoid_j, skip_j beside
    res_j), in ``_fragments``' layout, (L, ``wavenet_depth`` / 8, C / 4,
    32, 4). All layers are split in one pass. What csrc/wavenet.cu
    takes."""
    m = wavenet_matrix(weights)
    return _fragments(_pair_columns(m).reshape(m.shape))


MRF_WIDTHS = (16, 32, 64, 128)  # the residual unit's tensor-core widths


def mrf_fragments(blocks):
    """The convs of an MRF's resblocks (gather-form ``w1`` and ``w2`` (n_dil,
    K, C, C) each, C in ``MRF_WIDTHS``) as csrc/hifigan_tail.cu's
    residual-unit kernel takes them: each dilation's conv w[k] flattened to
    depth K C, tap major (row k C + ci, the A operand's rows shifted by k
    dil), in ``_fragments``' layout: one (f1, f2) per block, each (n_dil, K
    C / 8, C / 8, 32, 4). Every block is split in one pass, into views of
    one tensor."""
    mats, steps = [], []
    c = blocks[0]["w1"].shape[-1] if blocks else 0
    for bi, blk in enumerate(blocks):
        for key in ("w1", "w2"):
            w = blk[key].detach()
            if w.dim() != 4 or tuple(w.shape[2:]) != (c, c) or c not in MRF_WIDTHS:
                raise ValueError(f"mrf_fragments takes (n_dil, K, C, C) weights of one "
                                 f"width C in {MRF_WIDTHS}, got blocks[{bi}].{key} of "
                                 f"shape {tuple(w.shape)}")
            mats.append(w.reshape(-1, c))
            steps.append(w.shape[0] * w.shape[1] * c // 8)
    parts = _fragments(torch.cat(mats)).split(steps)
    return [tuple(p.reshape(blk["w1"].shape[0], -1, c // 8, 32, 4)
                  for p in parts[2 * bi:2 * bi + 2]) for bi, blk in enumerate(blocks)]
