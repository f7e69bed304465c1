"""csrc/wavenet_bf16.cu, K3's bf16-resident mode on Hopper's warpgroup
products, on the CPU: its layouts and its arithmetic, as the card reads
and sums them.

Layouts. ``mma_bf16.wavenet_wgmma`` lays each layer's two products out as
one tile of 8 x 8 core matrices; the tests read the tiles back through the
kernel's no-swizzle MN-major descriptor arithmetic (k16 step s at 64 C s
bytes, the leading byte offset 32 C the step along K, the stride byte
offset 128 along N, as ops/kernels/probe_melgan_bf16.py measured) as the
bf16-rounded gate [Wconv[0..K-1]; Waux; 0] and [Wskip | Wres], columns
paired, at C = 16 and 64 and Ca = 10 and 80. The stages are emulated byte
by byte as the kernel's cp.async copies fill them for a warpgroup's
64-row tile (x's window of 64 + (K - 1) d rows, or K runs of 64 rows past
d = 64, in the XOR swizzle at C = 64; c's rows Ca16 + 8 elements apart, zeros past Ca), and every warp's
ldmatrix addresses are held to the A fragments of the taps' rows, zeros
outside [0, T), at d = 1, 2, 64 and 512; so is the epilogue's read of x[t]
from the window's middle tap.

Arithmetic. ``k3_bf16_emulate`` computes a stack as the kernel does: 64-row
tiles whose windows come through the kernel's row mapping; the gate one
float32 chain of k16 steps (the taps' in order, then c's), each step's
product exact; the gate on the chain plus bconv (the kernel's branch-free
tanh and sigmoid), g rounded to bf16; [Wskip
| Wres] one chain of C / 16 steps; the skip (skip + s) + bskip and x_out
bf16((r + bres + x) sqrt(1/2)). It is held to the plain version
(``wavenet_stack_reference_bf16``) by the card's phase-30 rules (each layer
on the plain version's input: rms|diff| <= 1e-3 rms|plain|, max|diff| <=
1e-2 max|plain| and x bit-equal in at least 99 % of its elements; the whole
stack: x bit-equal in at least 25 %, the skip within 2.5e-3 rms and 1e-2
max), and to JAX's ``fused_wavenet_stack(compute_dtype=jnp.bfloat16,
interpret=True)`` by tests/test_torch_port_pwg_bf16.py's rule (rms|diff| <=
1e-4 rms|JAX|, max|diff| <= 1e-3 max|JAX|, x bit-equal in at least 90 %).
With g left unrounded (the control) the emulation fails the layer rule at
every layer.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.ops.pallas_kernels.wavenet_stack import (  # noqa: E402
    fused_wavenet_stack as jax_fused_wavenet_stack,
)
from parallelwavegan_tpu_torch.ops.kernels import mma_bf16, tf32x3  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import wavenet as wn  # noqa: E402

BF16 = torch.bfloat16
TILE = 64  # kWM: rows of a warpgroup's tile (wgmma's m64)
K = 3
SQRT_HALF = math.sqrt(0.5)


def _rb(v):
    return v.to(BF16).float()


def _weights(n_layers, c, ca, seed):
    rs = np.random.RandomState(seed)
    shapes = {"wconv": ((n_layers, K, c, 2 * c), K * c), "bconv": ((n_layers, 2 * c), 0),
              "waux": ((n_layers, ca, 2 * c), ca), "wskip": ((n_layers, c, c), c),
              "bskip": ((n_layers, c), 0), "wres": ((n_layers, c, c), c),
              "bres": ((n_layers, c), 0)}
    return {k: torch.from_numpy((rs.randn(*s) * (0.1 if fan == 0 else fan ** -0.5))
                                .astype(np.float32)) for k, (s, fan) in shapes.items()}


def _inputs(b, t, c, ca, seed):
    rs = np.random.RandomState(seed + 100)
    return (torch.from_numpy(rs.randn(b, t, c).astype(np.float32)),
            torch.from_numpy(rs.randn(b, t, ca).astype(np.float32)))


# ---------------------------------------------------------------------------
# (a) the weight tiles, read back as the card reads them
# ---------------------------------------------------------------------------


def _read_b(mem, start, lbo, sbo, n):
    """B (16 x n) as an MN-major no-swizzle wgmma descriptor reads it from
    mem (2-byte units): element (k, j) at start + (k // 8) lbo + (j // 8)
    sbo + (k % 8) 16 + (j % 8) 2 bytes. n is 32 or 128, one wgmma width,
    as ``mma_cols`` issues it."""
    k = torch.arange(16)[:, None]
    j = torch.arange(n)[None, :]
    byte = start + (k // 8) * lbo + (j // 8) * sbo + (k % 8) * 16 + (j % 8) * 2
    return mem[(byte // 2).reshape(-1)].reshape(16, n)


def _tile_matrix(tiles, layer, depth, c):
    """A layer's (depth, 2C) matrix, paired columns, read k16 step by k16
    step through the kernel's descriptors (step s at 64 C s bytes, cores
    32 C bytes apart along K and 128 along N)."""
    return torch.cat([_read_b(tiles[layer], 64 * c * s, 32 * c, 128, 2 * c)
                      for s in range(depth // 16)])


def _natural(paired, c):
    """Undo ``_pair_columns``: paired column 8 nt + 2 tig + e holds natural
    column C e + 8 (nt // 2) + 2 tig + nt % 2."""
    lead = paired.shape[:-1]
    out = paired.reshape(*lead, c // 8, 2, 4, 2)
    d = len(lead)
    return out.permute(*range(d), d + 3, d, d + 2, d + 1).reshape(*lead, 2 * c)


@pytest.mark.parametrize("c,ca", [(16, 10), (16, 80), (64, 10), (64, 80)])
def test_weight_tiles_read_back_through_the_descriptor(c, ca):
    """Each layer's tile of ``wavenet_wgmma`` read through the kernel's
    MN-major descriptor is the bf16-rounded [Wconv[0]; ..; Wconv[K-1]; Waux;
    0; Wskip | Wres], its columns paired as the float32 split pairs them;
    ``with_tiles_bf16`` keeps the same tensor."""
    n_layers = 2
    w = _weights(n_layers, c, ca, seed=c + ca)
    tiles = mma_bf16.wavenet_wgmma(w)
    depth = mma_bf16.wavenet_depth(c, ca, K)
    assert depth % 16 == 0 and depth == K * c + -(-ca // 16) * 16 + c
    assert tiles.dtype == BF16 and tuple(tiles.shape) == (n_layers, depth * 2 * c)
    for layer in range(n_layers):
        paired = _tile_matrix(tiles, layer, depth, c)
        gate = torch.cat([w["wconv"][layer].reshape(K * c, 2 * c), w["waux"][layer],
                          torch.zeros(depth - K * c - ca - c, 2 * c)])
        want = torch.cat([gate, torch.cat([w["wskip"][layer], w["wres"][layer]], dim=1)])
        assert torch.equal(_natural(paired, c), want.to(BF16))
        assert torch.equal(paired, tf32x3._pair_columns(want).to(BF16))
    kept = wn.with_tiles_bf16(w)
    assert torch.equal(kept["tiles_bf16"], tiles) and kept["wconv"] is w["wconv"]


# ---------------------------------------------------------------------------
# (b) the stages and the operands' addresses
# ---------------------------------------------------------------------------


def _xoff(r, q, c):
    """Byte offset of chunk q of x's row r in a stage (Geo<C>::xoff)."""
    if c == 64:
        return r * 128 + ((q ^ (r & 7)) << 4)
    return r * 2 * (c + 8) + (q << 4)


def _geometry(d):
    """(whole, rows, left) of a launch at dilation d."""
    whole = d <= TILE
    return whole, TILE + (K - 1) * d if whole else K * TILE, (K - 1) * d // 2


def _stage(x, c, t0, d):
    """The stage the kernel's cp.async copies fill for the tile at t0 (one
    batch item's x (T, C) and c (T, Ca)): (x memory, c memory), 2-byte
    units; x's row r is position t0 + r - left (whole) or t0 + (r // 64) d
    + r % 64 - left, zero outside [0, T); c's row r channel ch at r (Ca16 +
    8) + ch, zero past Ca and T."""
    t_len, ch = x.shape
    ca = c.shape[1]
    whole, rows, left = _geometry(d)
    row_b = 128 if ch == 64 else 2 * (ch + 8)
    xm = torch.full((rows * row_b // 2,), float("nan"))
    for r in range(rows):
        t = (t0 + r if whole else t0 + (r // TILE) * d + r % TILE) - left
        for q in range(ch // 8):
            o = _xoff(r, q, ch) // 2
            xm[o:o + 8] = x[t, 8 * q:8 * q + 8] if 0 <= t < t_len else 0.0
    ca16 = -(-ca // 16) * 16
    cm = torch.zeros(TILE * (ca16 + 8))
    for r in range(min(TILE, t_len - t0)):
        cm[r * (ca16 + 8): r * (ca16 + 8) + ca] = c[t0 + r]
    return xm, cm


def _ldmatrix(mem, byte_of_lane):
    """ldmatrix.x4: lane l gives the byte address of a 16-byte row of matrix
    l // 8; lane 4 g + t receives (row g, elements 2 t, 2 t + 1) of each
    matrix. Returns (32 lanes, 4 registers, 2 values)."""
    regs = torch.empty(32, 4, 2)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            o = byte_of_lane[8 * i + g] // 2 + 2 * t
            regs[lane, i] = mem[o:o + 2]
    return regs


def _a_fragment(a):
    """wgmma's A registers of a 16 x 16 tile a, lane 4 g + t: a0 = a[g][2 t,
    2 t + 1], a1 = a[g + 8][..], a2 = a[g][2 t + 8, ..], a3 = a[g + 8][2 t +
    8, ..]."""
    regs = torch.empty(32, 4, 2)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            regs[lane, i] = a[g + dr, 2 * t + dk: 2 * t + dk + 2]
    return regs


@pytest.mark.parametrize("d", [1, 2, 64, 512])
@pytest.mark.parametrize("c", [16, 64])
def test_operands_read_the_taps_rows(c, d):
    """Every warp's ldmatrix rows (lane l: the tap's row shift k d, or k 64
    past d = 64, + 16 warp + l % 16, chunk 2 j + l // 16) give the A
    fragment of x[t0 + 16 warp + m + k d - left][16 j + kk], zeros outside
    [0, T); c's (row 16 warp + l % 16, channel 16 j + 8 (l // 16)) that of
    c[t0 + 16 warp + m][16 j + kk], zeros past Ca = 10 and T; and the
    epilogue's 4-byte read at the middle tap's row gives x[t0 + r][ch, ch +
    1]. At t0 = 0, an inner tile and a ragged last one of T = 700."""
    t_len, ca = 700, 10
    rs = np.random.RandomState(d + c)
    # distinct values, exact in float32 (the emulation copies, never rounds)
    x = torch.from_numpy(rs.permutation(t_len * c).reshape(t_len, c).astype(np.float32) + 1)
    cv = torch.from_numpy(rs.permutation(t_len * ca).reshape(t_len, ca).astype(np.float32) + 1)
    whole, _, left = _geometry(d)
    xpad = torch.zeros(t_len + 2 * 1024 + TILE, c)
    xpad[1024:1024 + t_len] = x
    cpad = torch.zeros(t_len + TILE, 16)
    cpad[:t_len, :ca] = cv
    for t0 in (0, 256, 640):
        xm, cm = _stage(x, cv, t0, d)
        for warp in range(4):
            for tap in range(K):
                base = tap * d if whole else tap * TILE
                for j in range(c // 16):
                    got = _ldmatrix(xm, [_xoff(base + 16 * warp + (ln & 15), 2 * j + (ln >> 4), c)
                                         for ln in range(32)])
                    p0 = 1024 + t0 + 16 * warp + tap * d - left
                    want = _a_fragment(xpad[p0:p0 + 16, 16 * j:16 * j + 16])
                    assert torch.equal(got, want), (t0, warp, tap, j)
            got = _ldmatrix(cm, [2 * ((16 * warp + (ln & 15)) * 24 + 8 * (ln >> 4))
                                 for ln in range(32)])
            want = _a_fragment(cpad[t0 + 16 * warp: t0 + 16 * warp + 16])
            assert torch.equal(got, want), (t0, warp)
        xmid = left if whole else (K // 2) * TILE
        for r in range(0, TILE, 5):
            if t0 + r >= t_len:
                continue
            for ch in range(0, c, 2):
                o = (_xoff(xmid + r, ch // 8, c) + 2 * (ch % 8)) // 2
                assert torch.equal(xm[o:o + 2], x[t0 + r, ch:ch + 2]), (t0, r, ch)


# ---------------------------------------------------------------------------
# (c) the arithmetic
# ---------------------------------------------------------------------------


def tanh_k3(a):
    """The kernel's branch-free tanh in float32 (exp exact here, ex2.approx
    on the card): the Taylor polynomial to a^7 below |a| = 1/8, else (1 -
    e) / (1 + e) with e = exp(-2 |a|)."""
    t, a2 = a.abs(), a * a
    e = torch.exp(-2 * t)
    big = torch.copysign((1 - e) / (1 + e), a)
    small = a * a2 * (a2 * (a2 * (-17 / 315) + 2 / 15) - 1 / 3) + a
    return torch.where(t < 0.125, small, big)


def sigmoid_k3(v):
    """The kernel's sigmoid, 1 / (1 + exp(-v)), in float32."""
    return 1 / (1 + torch.exp(-v))


def k3_bf16_emulate(x, c, weights, dilations, round_g: bool = True):
    """The kernel's arithmetic for a stack of layers on x (B, T, C) and c (B,
    T, Ca), float32 -> (x_out, skip), float32 (x_out bf16-valued): the
    weights read from ``wavenet_wgmma``'s tiles; per layer and 64-row tile
    the window gathered by the kernel's row mapping (zeros outside [0, T)),
    the gate one float32 chain over the k16 steps (the taps in order, then
    c's Ca16 / 16), each step's 64 x 16 x 2C product exact; z = chain +
    bconv; g = tanh_k3(z_t) sigmoid_k3(z_s), rounded to bf16 (unless
    ``round_g`` is False: the control); [Wskip | Wres] one chain of C / 16
    steps; skip = s + bskip at layer 0, else (skip + s) + bskip; x_out =
    bf16(((r + bres) + x[t]) sqrt(1/2)), x[t] from the window's middle tap."""
    b, t_len, ch = x.shape
    ca = c.shape[2]
    ca16 = -(-ca // 16) * 16
    depth = mma_bf16.wavenet_depth(ch, ca, K)
    tiles = mma_bf16.wavenet_wgmma(weights)
    n_tiles = -(-t_len // TILE)
    xv = _rb(x)
    cv = torch.zeros(b, n_tiles * TILE, ca16)
    cv[:, :t_len, :ca] = _rb(c)
    ct = cv.reshape(b * n_tiles, TILE, ca16)
    t0 = torch.arange(n_tiles) * TILE
    skip = None
    for layer, d in enumerate(dilations):
        m = _tile_matrix(tiles, layer, depth, ch).double()
        whole, rows, left = _geometry(d)
        r = torch.arange(rows)
        off = r - left if whole else (r // TILE) * d + r % TILE - left
        pos = t0[:, None] + off[None, :]  # (tiles, rows)
        ok = (pos >= 0) & (pos < t_len)
        win = xv[:, pos.clamp(0, t_len - 1)] * ok[None, :, :, None]
        win = win.reshape(b * n_tiles, rows, ch)
        acc = torch.zeros(b * n_tiles, TILE, 2 * ch)
        for s in range(depth // 16 - ch // 16):
            if s < K * ch // 16:
                tap, j = divmod(s, ch // 16)
                base = tap * d if whole else tap * TILE
                a = win[:, base:base + TILE, 16 * j:16 * j + 16]
            else:
                j = s - K * ch // 16
                a = ct[:, :, 16 * j:16 * j + 16]
            acc = acc + (a.double() @ m[16 * s:16 * s + 16]).float()
        z = _natural(acc, ch) + weights["bconv"][layer]
        g = tanh_k3(z[..., :ch]) * sigmoid_k3(z[..., ch:])
        g = _rb(g) if round_g else g
        out = torch.zeros_like(acc)
        s0 = depth // 16 - ch // 16
        for s in range(ch // 16):
            a = g[..., 16 * s:16 * s + 16].double()
            out = out + (a @ m[16 * (s0 + s):16 * (s0 + s + 1)]).float()
        out = _natural(out, ch)
        sk = out[..., :ch]
        sk = sk + weights["bskip"][layer] if skip is None else (skip + sk) + weights["bskip"][layer]
        xmid = left if whole else (K // 2) * TILE
        xt = win[:, xmid:xmid + TILE]
        xo = _rb(((out[..., ch:] + weights["bres"][layer]) + xt) * SQRT_HALF)
        skip = sk
        xv = xo.reshape(b, n_tiles * TILE, ch)[:, :t_len]
    return xv, skip.reshape(b, n_tiles * TILE, ch)[:, :t_len]


def _stats(got, want):
    """(rms|diff| / rms|want|, max|diff| / max|want|, share bit-equal)."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = g - w
    return (float(np.sqrt((d ** 2).mean() / (w ** 2).mean())),
            float(np.abs(d).max() / np.abs(w).max()), float((g == w).mean()))


def _layer_ok(got, want) -> bool:
    """Phase 30's layer rule: x and skip within 1e-3 rms and 1e-2 max of the
    plain version's, x bit-equal in at least 99 % of its elements."""
    sx, ss = _stats(got[0], want[0]), _stats(got[1], want[1])
    return (sx[0] <= 1e-3 and sx[1] <= 1e-2 and ss[0] <= 1e-3 and ss[1] <= 1e-2
            and sx[2] >= 0.99)


def _cycle_ok(got, want) -> bool:
    """Phase 30's whole-stack rule: x bit-equal in at least 25 %, the skip
    within 2.5e-3 rms and 1e-2 max of the plain version's."""
    sx, ss = _stats(got[0], want[0]), _stats(got[1], want[1])
    return sx[2] >= 0.25 and ss[0] <= 2.5e-3 and ss[1] <= 1e-2


# (C, Ca, B, T, dilations): PWG v1's widths with the window's halo past both
# ends and the taps' runs (d = 256), and phase 30's ragged C = 16, Ca = 10
CASES = [(64, 80, 2, 700, (1, 2, 64, 256)), (16, 10, 3, 777, (1, 8, 128, 512))]


@pytest.mark.parametrize("ch,ca,b,t,dils", CASES)
def test_emulation_holds_to_the_plain_version_by_phase_30(ch, ca, b, t, dils):
    w = _weights(len(dils), ch, ca, seed=ch + ca)
    x, c = _inputs(b, t, ch, ca, seed=ch)
    xl = x
    for li, d in enumerate(dils):
        pl = {k: v[li:li + 1] for k, v in w.items()}
        want = wn.wavenet_stack_reference_bf16(xl, c, pl, (d,))
        got = k3_bf16_emulate(xl, c, pl, (d,))
        assert _layer_ok(got, want), (li, d, _stats(got[0], want[0]), _stats(got[1], want[1]))
        # the control: g left unrounded
        assert not _layer_ok(k3_bf16_emulate(xl, c, pl, (d,), round_g=False), want), (li, d)
        xl = want[0]
    got = k3_bf16_emulate(x, c, w, dils)
    want = wn.wavenet_stack_reference_bf16(x, c, w, dils)
    assert torch.equal(got[0], _rb(got[0]))
    assert _cycle_ok(got, want), (_stats(got[0], want[0]), _stats(got[1], want[1]))


@pytest.mark.parametrize("ch,ca,b,t,dils", [(16, 8, 2, 300, (1, 2, 4, 8)),
                                            (64, 80, 2, 700, (64, 256))])
def test_emulation_holds_to_jax_bf16_kernel(ch, ca, b, t, dils):
    """Against JAX's bf16 ``fused_wavenet_stack`` in interpret mode, by
    tests/test_torch_port_pwg_bf16.py's rule: tests/test_torch_port_pwg_bf16.py's
    stack, and two PWG v1-wide layers whose windows and runs cross both
    ends."""
    w = _weights(len(dils), ch, ca, seed=7 * ch + ca)
    x, c = _inputs(b, t, ch, ca, seed=3)
    jx, js = jax_fused_wavenet_stack(
        jnp.asarray(x.numpy()), jnp.asarray(c.numpy()),
        {k: jnp.asarray(v.numpy()) for k, v in w.items()}, dils, t_tile=128,
        compute_dtype=jnp.bfloat16, interpret=True)
    gx, gs = k3_bf16_emulate(x, c, w, dils)
    sx, ss = _stats(gx, np.asarray(jx)), _stats(gs, np.asarray(js))
    assert sx[0] <= 1e-4 and sx[1] <= 1e-3 and sx[2] >= 0.9, sx
    assert ss[0] <= 1e-4 and ss[1] <= 1e-3, ss
