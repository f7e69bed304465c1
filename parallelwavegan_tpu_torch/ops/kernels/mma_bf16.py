"""bf16 tensor-core products on the host side: the weight tiles that
Hopper's warpgroup products read in the bf16-resident modes of the WaveNet
stack (K3 in csrc/wavenet_bf16.cu: ``wavenet_wgmma``), the MelGAN stack
kernels (K6 in csrc/melgan_stack_bf16.cu, K7 in
csrc/melgan_stack_bwd_bf16.cu: ``stack_wgmma``), the forward TADE kernels
(K8a/K8b, csrc/tade_bf16.cu: ``tade_forward_wgmma``) and the TADE stage
backward (K9a/K9b, csrc/tade_bwd_bf16.cu: ``tade_conv_wgmma``).

The JAX kernels' bf16 mode (``mxu_bf16``) casts every dot operand to
bf16 and accumulates in float32. Here the weights are rounded to bf16 once
(to nearest even, as ``astype(bfloat16)``) and stored in the order in
which the kernel's product takes its B operand; the activations are
rounded where a kernel forms its operand rows.
"""

from __future__ import annotations

import functools

import torch

from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import _pair_columns, wavenet_matrix


def rounded(v):
    """v rounded to bf16 (to nearest even, as ``astype(bfloat16)``), as
    float32: what the bf16 plain versions take for an operand that JAX
    casts."""
    return v.to(torch.bfloat16).float()


def _check(stacks):
    for st in stacks:
        wd, w1, ws = (st[k] for k in ("wd", "w1", "ws"))
        c = wd.shape[-1]
        if (c % 16 or wd.dim() != 3 or wd.shape[1] != c
                or tuple(w1.shape) != (1, c, c) or tuple(ws.shape) != (1, c, c)):
            raise ValueError(f"bf16 stack tiles need wd (K, C, C), w1 and ws (1, C, "
                             f"C), C a multiple of 16, got {tuple(wd.shape)}, "
                             f"{tuple(w1.shape)}, {tuple(ws.shape)}")


def stack_wgmma(stacks):
    """The bf16 weights of MelGAN ResidualStacks of one width C as K6 and K7
    read them (csrc/melgan_bf16.cuh), one tensor per stack: its K + 2
    matrices Wd[0], .., Wd[K-1], W1, Ws, each rounded to bf16 and cut into
    8 x 8 core matrices of 128 contiguous bytes, (K + 2, C * C) bf16: W[ci][co]
    at (ci // 8) 8 C + (co // 8) 64 + (ci % 8) 8 + co % 8, so that a core's
    row is 8 co values of one ci. The kernels read a tile as B = W through an
    MN-major descriptor and as B = W^T (K7's transposed products) through a
    K-major one; each tile is one bulk copy of 2 C^2 bytes. A permutation of
    8 x 8 blocks, so no index is kept; all stacks in one copy, views of one
    tensor (tests/test_torch_port_melgan_bf16_layout.py reads the tiles
    back as the card does)."""
    if not stacks:
        return []
    _check(stacks)
    c = stacks[0]["wd"].shape[-1]
    mats = torch.cat([st[k].detach().reshape(-1, c, c) for st in stacks
                      for k in ("wd", "w1", "ws")])
    tiles = (mats.to(torch.bfloat16).reshape(-1, c // 8, 8, c // 8, 8)
             .permute(0, 1, 3, 2, 4).reshape(-1, c * c))
    return list(tiles.split([st["wd"].shape[0] + 2 for st in stacks]))


@functools.lru_cache(maxsize=None)
def slope_of(slope: float) -> float:
    """The slope with which LeakyReLU multiplies a bf16 value in the JAX
    package (``_leaky``: ``x * jnp.asarray(slope, x.dtype)``): slope
    rounded to bf16."""
    return float(torch.tensor(slope, dtype=torch.float64).to(torch.bfloat16))


@functools.lru_cache(maxsize=None)
def _wgmma_index(cout: int, device: torch.device) -> torch.Tensor:
    """The flat index into w (9, 64, Cout) of each element of
    ``tade_conv_wgmma``'s tiles (9, Cout / 64, 64 n, 64 stored k), made once
    per width and device: a copy from the host waits for the card."""
    j, kb, n, p = torch.meshgrid(torch.arange(9), torch.arange(cout // 64), torch.arange(64),
                                 torch.arange(64), indexing="ij")
    # the 128-byte swizzle: stored chunk p // 8 of row n holds chunk
    # (p // 8) ^ (n % 8) of B's column n
    k = 64 * kb + 8 * ((p // 8) ^ (n % 8)) + p % 8
    return (((8 - j) * 64 + n) * cout + k).reshape(-1).to(device)


def tade_conv_wgmma(w):
    """A 9-tap conv's gather-form weights w (9, 64, Cout), Cout a multiple
    of 64, as the B tiles of its transposed conv (Wt[j] = w[8 - j]^T:
    depth Cout, 64 columns) for csrc/tade_bwd_bf16.cu's wgmma products:
    rounded to bf16, one tile per tap j and 64 input channels kb of the
    transposed conv, (9, Cout / 64, 64, 64) bf16, tile [j, kb] holding in
    row n the 64 values Wt[j][64 kb .. 64 kb + 63][n] (K-major: B's column
    n is a 128-byte row of its k values) in Hopper's 128-byte swizzle (the
    16-byte chunk c of row n stored as chunk c ^ (n % 8)). Each tile is 8
    KB, one bulk copy; the kernel's descriptor steps 32 bytes a k16 step
    (tests/test_torch_port_tade_bwd_bf16_layout.py reads the tiles back as
    the card does). One gather a call."""
    if w.dim() != 3 or w.shape[0] != 9 or w.shape[1] != 64 or w.shape[2] % 64:
        raise ValueError(f"tade_conv_wgmma needs (9, 64, Cout), Cout a multiple of 64, "
                         f"got {tuple(w.shape)}")
    cout = w.shape[2]
    tiles = w.detach().reshape(-1)[_wgmma_index(cout, w.device)]
    return tiles.to(torch.bfloat16).reshape(9, cout // 64, 64, 64)


@functools.lru_cache(maxsize=None)
def _forward_wgmma_index(device: torch.device) -> torch.Tensor:
    """The flat index into the concatenation of a forward TADE kernel's
    three flattened convs (aux (9, 64, 64), g, gc (9, 64, 128)) of each
    element of ``tade_forward_wgmma``'s tiles (45 tiles, 64 n, 64 stored
    k), made once per device: a copy from the host waits for the card."""
    u, n, p = torch.meshgrid(torch.arange(45), torch.arange(64), torch.arange(64),
                             indexing="ij")
    # tile u: aux tap u, then g's and gc's tap j columns 64 h .. 64 h + 63
    conv = (u >= 9).long() + (u >= 27).long()
    j = torch.where(conv == 0, u, (u - 9 - 18 * (conv - 1)) // 2)
    half = torch.where(conv == 0, 0, (u - 9) % 2)
    # the 128-byte swizzle: stored chunk p // 8 of row n holds chunk
    # (p // 8) ^ (n % 8) of B's column n
    k = 8 * ((p // 8) ^ (n % 8)) + p % 8
    # the 128-column convs' paired column 64 half + n is their column 64 e +
    # 8 (nt // 2) + 2 tig + nt % 2 (tf32x3._pair_columns)
    col = 64 * half + n
    nt, tig, e = col // 8, (col % 8) // 2, col % 2
    orig = 64 * e + 8 * (nt // 2) + 2 * tig + nt % 2
    aux = (j * 64 + k) * 64 + n
    g = 9 * 64 * 64 + (j * 64 + k) * 128 + orig
    gc = g + 9 * 64 * 128
    idx = torch.where(conv == 0, aux, torch.where(conv == 1, g, gc))
    return idx.reshape(-1).to(device)


def tade_forward_wgmma(aux_w, g_w, gc_w):
    """The three convs of a forward TADE kernel in its bf16 mode (K8a:
    aux1, g1, gc1; K8b: aux2, g2, gc2), gather-form (9, 64, 64), (9, 64,
    128), (9, 64, 128), float32 or bf16, as the B tiles of
    csrc/tade_bf16.cu's wgmma products: rounded to bf16, (45, 64, 64) bf16
    in the order the kernel uses them, aux's 9 taps, then g's and gc's taps
    j as two tiles each (columns 0-63, then 64-127: together one 16 KB tile
    of 128 columns). Tile row n holds the 64 values W[j][0 .. 63][n'] (K-major:
    B's column n is a 128-byte row of its k values) in Hopper's 128-byte
    swizzle (the 16-byte chunk c of row n stored as chunk c ^ (n % 8)); n'
    is n for aux and, for g and gc, their column paired as
    ``tf32x3.forward_fragments`` pairs it (``_pair_columns``: column 8 i +
    2 tig of the 128 holds channel 8 (i // 2) + 2 tig + i % 2 of the first
    half, the next column the same channel of the second). One bulk copy
    per tap; tests/test_torch_port_tade_fwd_bf16_layout.py reads the tiles
    back as the card does. One concatenation and one gather a call."""
    shapes = [tuple(w.shape) for w in (aux_w, g_w, gc_w)]
    if shapes != [(9, 64, 64), (9, 64, 128), (9, 64, 128)]:
        raise ValueError(f"tade_forward_wgmma takes (9, 64, 64), (9, 64, 128), "
                         f"(9, 64, 128), got {shapes}")
    flat = torch.cat([w.detach().reshape(-1).to(torch.bfloat16) for w in (aux_w, g_w, gc_w)])
    return flat[_forward_wgmma_index(flat.device)].reshape(45, 64, 64)


def wavenet_depth(c: int, ca: int, k: int) -> int:
    """Depth of a WaveNet layer's bf16 tile: K taps of C channels, Ca
    zero-padded to a multiple of 16, then C for [Wskip | Wres]."""
    return k * c + (ca + 15) // 16 * 16 + c


def wavenet_wgmma(weights):
    """The two products of L WaveNet layers as K3's bf16 mode reads them
    (csrc/wavenet_bf16.cu): ``wavenet_matrix``'s gate [Wconv[0]; ..;
    Wconv[K-1]; Waux] with Waux zero-padded to a multiple of 16 rows and
    [Wskip | Wres] below it, the columns paired as K3 pairs them
    (``_pair_columns``: tanh_j beside sigmoid_j, skip_j beside res_j),
    rounded to bf16 and cut into 8 x 8 core matrices of 128 contiguous
    bytes, (L, ``wavenet_depth`` * 2C) bf16: M[k][n] at (k // 8) 16 C + (n
    // 8) 64 + (k % 8) 8 + n % 8, so that a core's row is 8 columns of one
    k. The kernel reads its k16 step s through an MN-major no-swizzle
    descriptor at 64 C s bytes, cores 32 C bytes apart along K and 128
    along N; each layer's tile is one bulk copy
    (tests/test_torch_port_wavenet_bf16_layout.py reads the tiles back as
    the card does). A permutation of 8 x 8 blocks: no index is kept."""
    m = wavenet_matrix(weights)
    n_layers, _, n = m.shape
    k, c = weights["wconv"].shape[1:3]
    ca = weights["waux"].shape[1]
    head = k * c + (ca + 7) // 8 * 8  # the gate's rows, Ca padded to 8
    depth = wavenet_depth(c, ca, k)
    m = torch.cat([m[:, :head], m.new_zeros(n_layers, depth - m.shape[1], n), m[:, head:]],
                  dim=1)
    m = _pair_columns(m).reshape(m.shape).to(torch.bfloat16)
    return (m.reshape(n_layers, depth // 8, 8, n // 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(n_layers, depth * n).contiguous())
