"""csrc/melgan_stack_bf16.cu and csrc/melgan_stack_bwd_bf16.cu, the
bf16-resident modes of the MelGAN stack kernels (K6, K7) on Hopper's
warpgroup products, on the CPU: their layouts and their arithmetic, as the
card reads and sums them.

Layouts. ``mma_bf16.stack_wgmma`` lays each of a stack's K + 2 matrices
out as one tile of 8 x 8 core matrices (csrc/melgan_bf16.cuh); the tests
read the tiles back through the kernels' no-swizzle descriptor arithmetic
(the leading byte offset the step along K, the stride byte offset along
N, as ops/kernels/probe_melgan_bf16.py measured on the card, and
``mma_cols``' cut of N = C into wgmma widths) as Wd[k], W1 and Ws (K6,
MN-major) and as their transposes (K7, K-major) at C = 16, 48, 64, 96 and
128. The row products' A is read by ldmatrix at the tap's row shift, the
weight gradients' A by ldmatrix.trans from the job's windows and their B
(the cotangent) from the staged core matrices: each is emulated lane by
lane with the kernels' address formulas, at d = 1, 3, 9 and 27, as are
each pad mode's source rows.

Arithmetic. ``k6_emulate`` and ``k7_emulate`` compute a stage as the
kernels do, block by block: 128-row tiles whose window rows come through
``pad_row``, rounded to bf16 once; each tap's product a float32 total; h,
dz and the cotangents between stacks stored as bf16, each with float32
column sums of its unrounded rows per tile, summed by ``colsum_kernel``'s
order for the biases; dz's first and last P rows kept in float32 for the
padding's adjoint, summed per tap and rounded once; the weight gradients
in 64-row steps added into float32 totals within the kernel's chunks, the
chunks' slabs summed in order. They are held to the plain versions
(``stacks_forward_bf16``, and ``melgan_stacks_backward_reference_bf16``
fed the emulated chain) by the card's phase-25 rule (rms|diff| <= 1e-3
rms|plain|, max|diff| <= 1e-2 max|plain|), and at C = 64 to JAX's
``fused_melgan_stacks`` / ``fused_melgan_stacks_train`` in interpret mode
(``mxu_bf16``) by tests/test_torch_port_melgan_bf16.py's rule. With h's
rounding left out (the control) the emulation fails the phase-25 rule.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.ops.pallas_kernels.melgan_stack import (  # noqa: E402
    fused_melgan_stacks as jax_stacks,
)
from parallelwavegan_tpu.ops.pallas_kernels.melgan_stack_train import (  # noqa: E402
    fused_melgan_stacks_train as jax_stacks_train,
)
from parallelwavegan_tpu_torch.ops.kernels import melgan_stack as k6  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as k7  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import mma_bf16  # noqa: E402

BF16 = torch.bfloat16
SLOPE = 0.2
KEYS = k7.STACK_KEYS

# the kernels' constants (csrc/melgan_bf16.cuh, csrc/melgan_stack_bwd_bf16.cu)
TILE = 128          # kM: rows of a row-product block
STEP = 64           # kWS: rows of a weight-gradient step
SMS = 132
O_ROWS_F = 16384    # kORowsF: the final conv's backward takes 16384 / C rows a block


def _rb(v):
    return v.to(BF16).float()


def _leaky(v, s):
    return torch.where(v >= 0, v, v * s)


def _close(got, want, max_rel=1e-2) -> bool:
    """Phase 25's rule."""
    d, w = got.float() - want.float(), want.float()
    return (float(d.pow(2).mean().sqrt()) <= 1e-3 * float(w.pow(2).mean().sqrt())
            and float(d.abs().max()) <= max_rel * float(w.abs().max()))


# ---------------------------------------------------------------------------
# (a) layouts, read back as the card reads them
# ---------------------------------------------------------------------------


def _pieces(n):
    """``mma_cols``' cut of N columns into wgmma widths, (first column,
    width) each."""
    out, n0 = [], 0
    while n0 < n:
        w = next(p for p in (128, 64, 32, 16) if n - n0 >= p)
        out.append((n0, w))
        n0 += w
    return out


def _read_b(mem, start, lbo, sbo, k_major: bool, n):
    """B (16 x n) as a wgmma with a no-swizzle descriptor (start address,
    leading byte offset lbo along K, stride byte offset sbo along N) reads
    it from mem (bf16, 2-byte units), as ``mma_cols`` issues it: each
    piece's descriptor start n0 / 8 sbo bytes on."""
    k = torch.arange(16)[:, None]
    out = torch.empty(16, n, dtype=mem.dtype)
    for n0, w in _pieces(n):
        j = torch.arange(w)[None, :]
        core = start + (n0 // 8) * sbo + (k // 8) * lbo + (j // 8) * sbo
        inner = (j % 8) * 16 + (k % 8) * 2 if k_major else (k % 8) * 16 + (j % 8) * 2
        out[:, n0:n0 + w] = mem[((core + inner) // 2).reshape(-1)].reshape(16, w)
    return out


def _stacks(c, dils, seed, k=3, bias=True, scale=1.0):
    rs = np.random.RandomState(seed)

    def t(*shape, s):
        return torch.from_numpy((rs.randn(*shape) * s).astype(np.float32))

    return [{"wd": t(k, c, c, s=scale * (k * c) ** -0.5), "w1": t(1, c, c, s=scale * c ** -0.5),
             "ws": t(1, c, c, s=scale * c ** -0.5),
             "bd": t(c, s=0.1) if bias else None, "b1": t(c, s=0.1) if bias else None,
             "bs": t(c, s=0.1) if bias else None, "dilation": d} for d in dils]


@pytest.mark.parametrize("c", [16, 48, 64, 96, 128])
def test_weight_tiles_read_back_through_the_descriptors(c):
    """Each tile of ``stack_wgmma`` read through K6's MN-major descriptor
    (k16 step s at 32 C s bytes, cores 16 C bytes apart along ci and 128
    along co) gives B[k][n] = bf16(W[16 s + k][n]), and through K7's
    K-major one (step s at 256 s bytes, cores 128 bytes apart along co and
    16 C along ci) B[k][n] = bf16(W[n][16 s + k]): Wd[0 .. K-1], W1, Ws."""
    stacks = _stacks(c, (1, 3), seed=c, k=5)
    tiles = mma_bf16.stack_wgmma(stacks)
    assert [tuple(t.shape) for t in tiles] == [(7, c * c)] * 2
    assert all(t.dtype == BF16 for t in tiles)
    for st, tile in zip(stacks, tiles):
        mats = list(st["wd"]) + [st["w1"][0], st["ws"][0]]
        for m, w in enumerate(mats):
            mem = tile[m]
            for s in range(c // 16):
                fwd = _read_b(mem, 32 * c * s, 16 * c, 128, False, c)
                assert torch.equal(fwd, w[16 * s:16 * s + 16].to(BF16)), (m, s)
                tr = _read_b(mem, 256 * s, 128, 16 * c, True, c)
                assert torch.equal(tr, w[:, 16 * s:16 * s + 16].T.to(BF16)), (m, s)


def _ldmatrix(mem, addrs, trans: bool):
    """ldmatrix.x4 (.trans) over a 2-D array mem of (row, column) element
    addresses: lane l gives addrs[l], the first element of a 16-byte row of
    matrix l // 8. The registers of lane 4 g + t, each two values: (row g,
    elements 2 t, 2 t + 1) of the matrix, or with trans (rows 2 t, 2 t + 1,
    element g)."""
    regs = torch.empty(32, 4, 2, dtype=mem.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            if trans:
                pts = [addrs[8 * i + 2 * t], addrs[8 * i + 2 * t + 1]]
                regs[lane, i] = torch.stack([mem[r, cc + g] for r, cc in pts])
            else:
                r, cc = addrs[8 * i + g]
                regs[lane, i] = mem[r, cc + 2 * t: cc + 2 * t + 2]
    return regs


def _a_fragment(a):
    """wgmma's A registers of a 16 x 16 tile a, lane 4 g + t: a0 = a[g][2 t,
    2 t + 1], a1 = a[g + 8][..], a2 = a[g][2 t + 8, ..], a3 = a[g + 8][2 t +
    8, ..]."""
    regs = torch.empty(32, 4, 2, dtype=a.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            regs[lane, i] = a[g + dr, 2 * t + dk: 2 * t + dk + 2]
    return regs


@pytest.mark.parametrize("d", [1, 3, 9, 27])
def test_operands_read_the_taps_rows(d):
    """``row_product``'s ldmatrix rows (lane l: row 16 warp + l % 16 + k d,
    column 16 s + 8 (l // 16), rows C + 8 apart) give each warp the A
    fragment of win[16 warp + m + k d][16 s + kk]; the weight gradients'
    ldmatrix.trans rows (lane l: row seg_off + l % 8 + 8 (l // 16) + 16 s,
    column ci0 + 8 ((l // 8) % 2)) the A fragment of X^T, X the window's
    rows from the segment's offset; and the staged cotangent (the 16 bytes
    of row r, channels 8 j .. at (r // 8) 16 C + 128 j + 16 (r % 8)) read
    through the MN-major descriptor (step s at 32 C s bytes, 16 C along K,
    128 along N) is cot[16 s + k][n]."""
    c, k = 48, 3
    ld = c + 8
    rows = TILE + 2 * d
    win = torch.arange(rows * ld, dtype=torch.float32).reshape(rows, ld)
    for warp in (0, 5, 7):
        for tap in range(k):
            for s in range(c // 16):
                addrs = [(16 * warp + (lane & 15) + tap * d, 16 * s + (lane >> 4) * 8)
                         for lane in range(32)]
                r0 = 16 * warp + tap * d
                want = _a_fragment(win[r0:r0 + 16, 16 * s:16 * s + 16])
                assert torch.equal(_ldmatrix(win, addrs, False), want), (warp, tap, s)
    wrows = STEP + 2 * d
    xs = torch.arange(wrows * ld, dtype=torch.float32).reshape(wrows, ld)
    for seg_off in (0, d, 2 * d):
        for ci0 in range(0, c, 16):
            for s in range(4):
                addrs = [(seg_off + (lane & 7) + ((lane >> 4) << 3) + 16 * s,
                          ci0 + ((lane >> 3) & 1) * 8) for lane in range(32)]
                r0 = seg_off + 16 * s
                want = _a_fragment(xs[r0:r0 + 16, ci0:ci0 + 16].T.contiguous())
                assert torch.equal(_ldmatrix(xs, addrs, True), want), (seg_off, ci0, s)
    cot = torch.randn(STEP, c, generator=torch.Generator().manual_seed(d))
    mem = torch.full((STEP * c,), float("nan"))
    for e in range(STEP * (c // 8)):  # the kernel's staging loop
        r, j = e // (c // 8), e % (c // 8)
        o = (r >> 3) * 16 * c + j * 128 + (r & 7) * 16
        mem[o // 2:o // 2 + 8] = cot[r, 8 * j:8 * j + 8]
    for s in range(4):
        assert torch.equal(_read_b(mem, 32 * c * s, 16 * c, 128, False, c),
                           cot[16 * s:16 * s + 16]), s


def pad_row(p, t, pad, mode):
    """csrc/melgan_bf16.cuh's pad_row over a tensor of padded positions: the
    row each reads, -1 for a zero row."""
    inside = (p >= 0) & (p < t)
    far = (p < -pad) | (p >= t + pad)
    if mode == "reflect":
        src = torch.where(p < 0, -p, 2 * t - 2 - p)
    else:
        src = torch.where(p < 0, torch.zeros_like(p), torch.full_like(p, t - 1))
    if mode == "constant":
        far = torch.ones_like(far)
    return torch.where(inside, p, torch.where(far, -torch.ones_like(p), src))


def _rows(v, idx):
    """v (B, T, C) at rows idx (-1: zeros)."""
    out = v[:, idx.clamp(min=0)]
    return torch.where((idx >= 0)[None, :, None], out, torch.zeros_like(out))


@pytest.mark.parametrize("mode", ["reflect", "edge", "constant"])
def test_pad_rows_are_the_padding(mode):
    """The rows the window's padded positions -P .. T + P - 1 read are
    F.pad's, and positions further out read zeros."""
    t, pad = 40, 27
    x = torch.randn(1, t, 3, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(-pad - 5, t + pad + 5)
    got = _rows(x, pad_row(pos, t, pad, mode))
    want = k6._pad_cl(x, pad, k6._pad_mode(mode))
    assert torch.equal(got[:, 5:-5], want)
    assert not got[:, :5].any() and not got[:, -5:].any()


# ---------------------------------------------------------------------------
# (b) the kernels' arithmetic, block by block
# ---------------------------------------------------------------------------


def _bias(v, c):
    return torch.zeros(c) if v is None else v.float()


def k6_emulate(x, stacks, final, mode):
    """The stage as K6's bf16 kernel computes it: {"xs": each stack's input,
    "outs": each stack's output (float32, the chain K7's re-run keeps), "y":
    the stage's float32 output (the final conv's tanh, or the last
    stack's)}."""
    b, t, c = x.shape
    chain, out = x.float(), {"xs": [], "outs": []}
    for i, st in enumerate(stacks):
        k, d = st["wd"].shape[0], int(st["dilation"])
        pad = (k - 1) // 2 * d
        s = mma_bf16.slope_of(SLOPE) if i == 0 else SLOPE
        wd, w1, ws = _rb(st["wd"]), _rb(st["w1"][0]), _rb(st["ws"][0])
        bd, b1, bs = (_bias(st[key], c) for key in ("bd", "b1", "bs"))
        nxt = torch.empty(b, t, c)
        for t0 in range(0, t, TILE):
            pos = torch.arange(t0 - pad, t0 + TILE + pad)
            win = _rb(_leaky(_rows(chain, pad_row(pos, t, pad, mode)), s))
            tot = None
            for kk in range(k):  # a tap's product, retired into float32 totals
                acc = win[:, kk * d:kk * d + TILE] @ wd[kk]
                tot = acc if tot is None else tot + acc
            hz = _rb(_leaky(tot + bd, SLOPE))
            skip = _rb(_rows(chain, pad_row(torch.arange(t0, t0 + TILE), t, 0, "constant")))
            tot = hz @ w1 + b1
            nxt[:, t0:t0 + TILE] = (tot + (skip @ ws + bs))[:, :min(TILE, t - t0)]
        out["xs"].append(chain)
        out["outs"].append(nxt)
        chain = nxt
    out["y"] = chain
    if final is not None:
        fw, fb = final
        pf = (fw.shape[0] - 1) // 2
        tf = _rb(k6._pad_cl(_leaky(chain, SLOPE), pf, k6._pad_mode(mode)))
        out["y"] = torch.tanh(k6._conv_cl(tf, _rb(fw), _bias(fb, fw.shape[-1]), 1, t))
    return out


def _colsum(rows):
    """colsum_kernel's order: row r into the sum of r % 32, those in turn."""
    parts = [rows[w::32].sum(0) if len(rows[w::32]) else torch.zeros(rows.shape[1])
             for w in range(32)]
    out = torch.zeros(rows.shape[1])
    for p in parts:
        out = out + p
    return out


def _tile_sums(v):
    """(B tiles, C): each 128-row tile's column sums of v (B, T, C)."""
    b, t, c = v.shape
    return torch.stack([v[i, t0:t0 + TILE].sum(0) for i in range(b)
                        for t0 in range(0, t, TILE)])


def _chunks(b, t, c, k):
    """The weight gradients' chunk rows (csrc/melgan_stack_bwd_bf16.cu
    plan_of)."""
    jobs = math.ceil(k * c / 128) + math.ceil(2 * c / 128)
    target = SMS * (2 if c <= 64 else 1)
    per_item = math.ceil(target / (jobs * b))
    return math.ceil(math.ceil(t / per_item) / STEP) * STEP


def _wgrad(ops, cot, chunk):
    """sum_t ops[s][t]^T cot[t] for each segment s, as the kernel sums it:
    64-row steps added into float32 totals per chunk, the chunks' slabs (item
    by item, chunk by chunk) summed in order. ops are (B, T, C) rows
    aligned with cot's."""
    b, t, _ = cot.shape
    out = [None] * len(ops)
    for item in range(b):
        for cs in range(0, t, chunk):
            tot = [None] * len(ops)
            for r0 in range(cs, min(t, cs + chunk), STEP):
                r1 = min(r0 + STEP, cs + chunk, t)
                for s, op in enumerate(ops):
                    acc = op[item, r0:r1].T @ cot[item, r0:r1]
                    tot[s] = acc if tot[s] is None else tot[s] + acc
            out = [tt if o is None else o + tt for o, tt in zip(out, tot)]
    return out


def _fold_rows(dzf, t, pad, off, mode, c):
    """{row t: the float32 sum of the dz rows the padded positions folded
    onto t read at a tap (padded position q reads dz row q + off)} (csrc's
    stage_fold), over dzf (B, T, C) of which only rows < P and >= T - P are
    read."""
    out = {}

    def add(r, u):
        if 0 <= u < t:
            assert u < pad or u >= t - pad  # only the kept float32 rows
            out[r] = out.get(r, torch.zeros(dzf.shape[0], c)) + dzf[:, u]

    for r in range(t):
        if mode == "reflect":
            if 1 <= r <= pad:
                add(r, off - r)
            if t - 1 - pad <= r <= t - 2:
                add(r, 2 * t - 2 - r + off)
        elif mode == "edge":
            if r == 0:
                for j in range(1, pad + 1):
                    add(r, off - j)
            if r == t - 1:
                for j in range(pad):
                    add(r, t + j + off)
    return out


def k7_emulate(x, stacks, final, mode, dy, fwd, control=None):
    """(dx bf16, dstacks, dfinal): K7's bf16 kernels on K6's emulated chain
    ``fwd``. control "h unrounded" leaves h = leaky(z) in float32 as dW1's
    operand (a rounding left out)."""
    b, t, c = x.shape
    dfinal, g, gsum = None, dy.float(), None
    if final is not None:  # the final conv's backward (CUDA cores): its values
        fw, fb = final
        pf = (fw.shape[0] - 1) // 2
        dpre = dy.float() * (1 - fwd["y"] ** 2)
        tf = _rb(k6._pad_cl(_leaky(fwd["outs"][-1], SLOPE), pf, k6._pad_mode(mode)))
        dfinal = (k7._wgrad_bf16(tf, dpre, 1, t, fw.shape[0]),
                  None if fb is None else dpre.sum((0, 1)))
        gf = k7._conv_t_bf16(dpre, fw, 1, pf, k6._pad_mode(mode)) * k7._dleaky(
            fwd["outs"][-1], SLOPE)
        rows = O_ROWS_F // c  # its blocks' column sums
        gsum = torch.stack([gf[i, t0:t0 + rows].sum(0) for i in range(b)
                            for t0 in range(0, t, rows)])
        g = _rb(gf)
    dstacks = [None] * len(stacks)
    for i in reversed(range(len(stacks))):
        st = stacks[i]
        k, d = st["wd"].shape[0], int(st["dilation"])
        pad = (k - 1) // 2 * d
        s = mma_bf16.slope_of(SLOPE) if i == 0 else SLOPE
        xi = fwd["xs"][i]
        wd, w1, ws = _rb(st["wd"]), _rb(st["w1"][0]), _rb(st["ws"][0])
        bd = _bias(st["bd"], c)
        gb = _rb(g)
        if gsum is None:  # the stage's dy: dz's kernel sums its bf16 values
            gsum = _tile_sums(gb)
        # dz_bf16_kernel, tile by tile
        h, dz = torch.empty(b, t, c), torch.empty(b, t, c)
        for t0 in range(0, t, TILE):
            n = min(TILE, t - t0)
            pos = torch.arange(t0 - pad, t0 + TILE + pad)
            win = _rb(_leaky(_rows(xi, pad_row(pos, t, pad, mode)), s))
            tot = None
            for kk in range(k):
                acc = win[:, kk * d:kk * d + TILE] @ wd[kk]
                tot = acc if tot is None else tot + acc
            z = (tot + bd)[:, :n]
            h[:, t0:t0 + n] = _leaky(z, SLOPE)
            dz[:, t0:t0 + n] = (gb[:, t0:t0 + n] @ w1.T) * k7._dleaky(z, SLOPE)
        dzb = _rb(dz)
        hb = h if control == "h unrounded" else _rb(h)
        dzsum = _tile_sums(dz)
        # wgrad_bf16_kernel: the taps' rows and [h | x] against the cotangents
        chunk = _chunks(b, t, c, k)
        xp = _rb(_leaky(_rows(xi, pad_row(torch.arange(-pad, t + pad), t, pad, mode)), s))
        dwd = _wgrad([xp[:, kk * d:kk * d + t] for kk in range(k)], dzb, chunk)
        dw1, dws = _wgrad([hb, _rb(xi)], gb, chunk)
        db = _colsum(gsum)
        dstacks[i] = {"wd": torch.stack(dwd), "bd": _colsum(dzsum), "w1": dw1[None],
                      "b1": db, "ws": dws[None], "bs": db.clone()}
        for key in ("bd", "b1", "bs"):
            if st[key] is None:
                dstacks[i][key] = None
        # dx_bf16_kernel, tile by tile, the fold from dz's float32 rows
        folds = [_fold_rows(dz, t, pad, pad - kk * d, mode, c) for kk in range(k)]
        gx = torch.empty(b, t, c)
        for t0 in range(0, t, TILE):
            n = min(TILE, t - t0)
            pos = torch.arange(t0 - pad, t0 + TILE + pad)
            win = _rows(dzb, torch.where((pos >= 0) & (pos < t), pos, -torch.ones_like(pos)))
            tot = None
            for kk in range(k):
                acc = win[:, 2 * pad - kk * d:2 * pad - kk * d + TILE] @ wd[kk].T
                fold = torch.zeros(b, TILE, c)
                for r, v in folds[kk].items():
                    if t0 <= r < t0 + TILE:
                        fold[:, r - t0] = _rb(v)
                if any(t0 <= r < t0 + TILE for r in folds[kk]):
                    acc = acc + fold @ wd[kk].T
                tot = acc if tot is None else tot + acc
            tot = tot[:, :n] * k7._dleaky(xi[:, t0:t0 + n], SLOPE)
            gx[:, t0:t0 + n] = tot + gb[:, t0:t0 + n] @ ws.T
        g, gsum = gx, _tile_sums(gx)
    return g.to(BF16), dstacks, dfinal


def _grads(dx, dstacks, dfinal):
    out = [("dx", dx)] + [(f"stacks[{i}].{k}", d[k]) for i, d in enumerate(dstacks)
                          for k in KEYS if d[k] is not None]
    return out + list(zip(("final w", "final b"), dfinal or ()))


# (C, B, T, pad mode, dilations, final conv's outputs, biases): v1's
# widths, T not a multiple of the tile at B > 1, d = 27 (v2's P), K = 7 at
# d = 9, the narrowest width with T below the pad, zero padding
CASES = [
    (64, 2, 300, "reflect", (1, 3, 9), 1, True, 3),
    (48, 2, 200, "edge", (1, 3, 9, 27), 0, True, 3),
    (32, 1, 150, "reflect", (9,), 4, True, 7),
    (16, 3, 5, "edge", (1, 3, 9), 2, True, 3),
    (96, 1, 130, "constant", (1, 3), 0, False, 3),
]


def _case(c, b, t, dils, out_ch, bias, k, seed=5):
    stacks = _stacks(c, dils, seed, k=k, bias=bias, scale=2.0)
    rs = np.random.RandomState(seed + 1)
    final = None
    if out_ch:
        final = (torch.from_numpy((rs.randn(7, c, out_ch) / (7 * c) ** 0.5).astype(np.float32)),
                 torch.from_numpy((rs.randn(out_ch) * 0.1).astype(np.float32)))
    x = torch.from_numpy(rs.randn(b, t, c).astype(np.float32)).to(BF16)
    dy = torch.from_numpy(rs.randn(b, t, out_ch or c).astype(np.float32)).to(BF16)
    return stacks, final, x, dy


@pytest.mark.parametrize("c,b,t,mode,dils,out_ch,bias,k", CASES)
def test_emulated_kernels_match_the_plain_versions(c, b, t, mode, dils, out_ch, bias, k):
    stacks, final, x, dy = _case(c, b, t, dils, out_ch, bias, k)
    fwd = k6_emulate(x, stacks, final, mode)
    want = k6.stacks_forward_bf16(x, stacks, final, SLOPE, mode)["y"]
    assert _close(fwd["y"], want)
    got = _grads(*k7_emulate(x, stacks, final, mode, dy, fwd))
    ref = _grads(*k7.melgan_stacks_backward_reference_bf16(
        x, stacks, final, SLOPE, mode, dy, fwd["outs"]))
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (name, g), (_, r) in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert _close(g, r), (name, float((g.float() - r.float()).abs().max()))


def test_control_h_unrounded_fails():
    """With h's rounding left out, dW1 moves past the rule."""
    stacks, final, x, dy = _case(*CASES[0][:3], *CASES[0][4:])
    mode = CASES[0][3]
    fwd = k6_emulate(x, stacks, final, mode)
    ref = dict(_grads(*k7.melgan_stacks_backward_reference_bf16(
        x, stacks, final, SLOPE, mode, dy, fwd["outs"])))
    good = dict(_grads(*k7_emulate(x, stacks, final, mode, dy, fwd)))
    bad = dict(_grads(*k7_emulate(x, stacks, final, mode, dy, fwd, control="h unrounded")))
    assert all(_close(good[n], ref[n]) for n in ref)
    assert not all(_close(bad[n], ref[n]) for n in ref)
    assert not _close(bad["stacks[0].w1"], ref["stacks[0].w1"])


def _jax_close(got, want) -> bool:
    """tests/test_torch_port_melgan_bf16.py's rule."""
    d, w = np.asarray(got, np.float32) - np.asarray(want, np.float32), np.asarray(
        want, np.float32)
    return (float(np.sqrt((d ** 2).mean())) <= 5e-4 * float(np.sqrt((w ** 2).mean()))
            and float(np.abs(d).max()) <= 4e-3 * float(np.abs(w).max()))


def test_emulated_kernels_match_jax_interpret():
    """At C = 64 (B 2, T 256, d 1, 3, 9, reflect, the final conv to 1):
    the emulation against JAX's bf16 kernels in interpret mode on the core
    rows [R, T - R), the gradients under a cotangent zero on the first and
    last R rows (tests/test_torch_port_melgan_bf16.py)."""
    c, b, t = 64, 2, 256
    rs = np.random.RandomState(7)

    def w(k, cin, cout):
        return (rs.randn(k, cin, cout) * 0.1).astype(np.float32)

    npst = [{"wd": w(3, c, c), "bd": (rs.randn(c) * 0.05).astype(np.float32),
             "w1": w(1, c, c), "b1": (rs.randn(c) * 0.05).astype(np.float32),
             "ws": w(1, c, c), "bs": (rs.randn(c) * 0.05).astype(np.float32),
             "dilation": 3 ** j} for j in range(3)]
    npfin = (w(7, c, 1), (rs.randn(1) * 0.05).astype(np.float32))
    x = (rs.randn(b, t, c) * 0.5).astype(np.float32)
    r = 16  # the receptive radius with the final conv
    u = np.random.RandomState(8).randn(b, t, 1).astype(np.float32)
    u[:, :r] = u[:, t - r:] = 0.0
    js = [{kk: (jnp.asarray(v) if kk != "dilation" else v) for kk, v in s.items()} for s in npst]
    jf = tuple(jnp.asarray(v) for v in npfin)

    def f(xx, ws):
        sts = [dict(st, **wk) for st, wk in zip(js, ws["stacks"])]
        return jax_stacks_train(xx, sts, final=ws["final"], pad_mode="reflect", t_tile=32,
                                interpret=True)

    ws = {"stacks": [{kk: st[kk] for kk in KEYS} for st in js], "final": jf}
    y_j, vjp = jax.vjp(f, jnp.asarray(x).astype(jnp.bfloat16), ws)
    dx_j, dw_j = vjp(jnp.asarray(u).astype(jnp.bfloat16))
    want = [("dx", np.asarray(dx_j.astype(jnp.float32)))]
    for i, d in enumerate(dw_j["stacks"]):
        want += [(f"stacks[{i}].{kk}", np.asarray(d[kk])) for kk in KEYS]
    want += [("final w", np.asarray(dw_j["final"][0])), ("final b", np.asarray(dw_j["final"][1]))]
    y_inf = np.asarray(jax_stacks(jnp.asarray(x).astype(jnp.bfloat16), js, final=jf,
                                  pad_mode="reflect", t_tile=32, interpret=True)
                       .astype(jnp.float32))

    stacks = [{kk: (torch.from_numpy(v) if kk != "dilation" else v) for kk, v in s.items()}
              for s in npst]
    final = tuple(torch.from_numpy(v) for v in npfin)
    xb, ub = torch.from_numpy(x).to(BF16), torch.from_numpy(u).to(BF16)
    fwd = k6_emulate(xb, stacks, final, "reflect")
    core = slice(r, t - r)
    y = fwd["y"].to(BF16).float().numpy()
    assert _jax_close(y[:, core], y_inf[:, core])
    assert _jax_close(y[:, core], np.asarray(y_j.astype(jnp.float32))[:, core])
    got = _grads(*k7_emulate(xb, stacks, final, "reflect", ub, fwd))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, wv) in zip(got, want):
        g = g.float().numpy()
        assert g.shape == wv.shape and _jax_close(g, wv), name

