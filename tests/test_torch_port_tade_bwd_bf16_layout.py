"""csrc/tade_bwd_bf16.cu, the bf16-resident mode of the TADE stage backward
(K9a, K9b) on Hopper's warpgroup products, on the CPU: its layouts and its
arithmetic, as the card reads and sums them.

Layouts. ``mma_bf16.tade_conv_wgmma`` lays each tap's 64 input channels
of a transposed conv out as one wgmma B tile, K-major in the 128-byte
swizzle; the tests read the tiles back through the kernel's descriptor
arithmetic (a tile 1024-aligned, 32 bytes a k16 step, rows 128 bytes and
atoms 1024 bytes apart, address bits 4-6 XOR bits 7-9) for each tap and
each swizzle phase. The chain's A operand is read by ldmatrix at the tap's
row shift; the weight gradients' A by ldmatrix.trans at the tap's shift
and their B (the cotangent) through an MN-major 128-byte-swizzle
descriptor from the kernel's staged atoms: each is emulated lane by
lane, with the kernel's own address formulas, at dilations 1-4.

Arithmetic. ``emulate_stage`` computes one stage as the kernels do: the
gate's VJP in float32; dT, dG and da' rounded to bf16 once, each the
operand of its transposed conv and of its weight gradient; every
transposed conv a float32 total over its nine taps, a tap's product over
bf16 operands in float32; each bias the float32 column sums of the
unrounded cotangent over 112-row tiles, summed tile by tile within a
weight-gradient chunk and chunk by chunk after; each weight gradient
float32 totals of 64-row steps within a chunk (the kernel's ``plan_of``),
the chunks' slabs summed in order. It is held to
``stage_backward_reference_bf16`` (the same roundings, other float32
orders) by the card's phase-28 rule (rms|diff| <= 1e-3 rms|plain|,
max|diff| <= 1e-2 max|plain|) and, through the block's glue, to JAX's
``fused_tade_blocks_train`` in interpret mode (``_run_tade1_bwd`` /
``_run_tade2_bwd`` with ``mxu_bf16``) by tests/test_torch_port_tade_bf16.py's
rule for a bf16 chain (1e-2 rms, 2e-2 max: the two frameworks round
different elements apart). With one rounding point moved (a cotangent
left in float32) the emulation fails the phase-28 rule.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.ops.pallas_kernels.tade_train import (  # noqa: E402
    fused_tade_blocks_train as jax_fused,
)
from parallelwavegan_tpu_torch.ops.kernels import mma_bf16  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_train as tt  # noqa: E402

C = 64
BF16 = torch.bfloat16

# the kernels' constants (csrc/tade_bwd_bf16.cu)
TILE = 112        # kTO: rows of a chain block
STEP = 64         # kGS: rows of a weight-gradient step
QUANTUM = 448     # kGQuantum
JOBS, SMS = 8, 132
LD2, LD1 = 2 * C + 8, C + 8  # bf16 row strides of the chain's shared rows


def _rb(v):
    return v.to(BF16).float()


# ---------------------------------------------------------------------------
# (a) layouts, read back as the card reads them
# ---------------------------------------------------------------------------


def _sw128(addr):
    """The 128-byte swizzle of a shared-memory byte address."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _unswizzle(tiles):
    """(..., 64, 64) tiles with each row's 16-byte chunk c at c ^ (row % 8)
    put back in order."""
    *lead, n, k = tiles.shape
    out = torch.empty_like(tiles).reshape(*lead, n, 8, 8)
    src = tiles.reshape(*lead, n, 8, 8)
    for row in range(n):
        for c in range(8):
            out[..., row, c, :] = src[..., row, c ^ (row % 8), :]
    return out.reshape(tiles.shape)


@pytest.mark.parametrize("cout", [64, 128])
def test_wgmma_weight_tiles_read_back_as_the_transposed_conv(cout):
    """Each tile [j, kb] of ``tade_conv_wgmma`` read through the chain's
    K-major 128-byte-swizzle descriptor (start = tile + 32 ks, row n at
    (n // 8) 1024 + (n % 8) 128, chunk k // 8) gives B[k][n] =
    bf16(w[8 - j][n][64 kb + 16 ks + k]) for every tap, k16 step and n;
    every swizzle phase n % 8 moves its chunks (phase 0 none)."""
    rs = np.random.RandomState(3)
    w = torch.from_numpy(rs.randn(9, C, cout).astype(np.float32))
    tiles = mma_bf16.tade_conv_wgmma(w)
    assert tiles.shape == (9, cout // 64, 64, 64) and tiles.dtype == BF16
    flat = tiles.reshape(9, cout // 64, -1)  # 2-byte units of each 8 KB tile
    k = torch.arange(16)[:, None]
    n = torch.arange(64)[None, :]
    for ks in range(4):
        addr = 32 * ks + (n // 8) * 1024 + (n % 8) * 128 + (k // 8) * 16 + (k % 8) * 2
        got = flat[:, :, (_sw128(addr) // 2).reshape(-1)].reshape(9, cout // 64, 16, 64)
        for j in range(9):
            for kb in range(cout // 64):
                want = w[8 - j, :, 64 * kb + 16 * ks: 64 * kb + 16 * ks + 16].T.to(BF16)
                assert torch.equal(got[j, kb], want), (j, kb, ks)
    plain = w.flip(0).to(BF16).reshape(9, C, cout // 64, 64).transpose(1, 2)
    for phase in range(8):
        rows = tiles[:, :, phase::8].reshape(-1, 8, 8)
        moved = not torch.equal(rows, plain[:, :, phase::8].reshape(-1, 8, 8))
        assert moved == (phase != 0), phase
    assert torch.equal(_unswizzle(tiles), plain)


def _ldmatrix(mem, addrs, trans: bool):
    """ldmatrix.x4 (.trans) over a 2-D bf16 array mem indexed by (row,
    column) element addresses: lane l gives addrs[l] (the first element of a
    16-byte row of matrix l // 8). The four registers of lane 4 g + t, each
    two bf16 values: (row g, elements 2 t, 2 t + 1) of the matrix, or with
    trans (rows 2 t, 2 t + 1, element g)."""
    regs = torch.empty(32, 4, 2, dtype=mem.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            if trans:
                pts = [addrs[8 * i + 2 * t], addrs[8 * i + 2 * t + 1]]
                regs[lane, i] = torch.stack([mem[r, c + g] for r, c in pts])
            else:
                r, c = addrs[8 * i + g]
                regs[lane, i] = mem[r, c + 2 * t: c + 2 * t + 2]
    return regs


def _a_fragment(a):
    """wgmma's (and mma.m16n8k16's) A registers of a 16 x 16 tile a, lane
    4 g + t: a0 = a[g][2 t, 2 t + 1], a1 = a[g + 8][..], a2 = a[g][2 t + 8,
    ..], a3 = a[g + 8][2 t + 8, ..]."""
    regs = torch.empty(32, 4, 2, dtype=a.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            regs[lane, i] = a[g + dr, 2 * t + dk: 2 * t + dk + 2]
    return regs


@pytest.mark.parametrize("dilation", [1, 2, 3, 4])
def test_chain_a_operand_reads_the_taps_row_shift(dilation):
    """conv9's ldmatrix rows (lane l: row 16 warp + l % 16 + j D, column
    64 kb + 16 ks + 8 (l // 16), rows LD2 apart) give each warp the A
    fragment of act[16 warp + m + j D][64 kb + 16 ks + k]: the transposed
    conv's tap j at dilation D."""
    rows = 128 + 8 * dilation
    act = torch.arange(rows * LD2, dtype=torch.float32).reshape(rows, LD2)
    for warp in (0, 5, 7):
        for j in (0, 4, 8):
            for kb, ks in ((0, 0), (1, 3)):
                addrs = [(16 * warp + (lane & 15) + j * dilation,
                          kb * 64 + ks * 16 + (lane >> 4) * 8) for lane in range(32)]
                r0, c0 = 16 * warp + j * dilation, 64 * kb + 16 * ks
                want = _a_fragment(act[r0: r0 + 16, c0: c0 + 16])
                assert torch.equal(_ldmatrix(act, addrs, False), want), (warp, j, kb, ks)


def _stage_cotangent(cot):
    """The weight-gradient kernel's staging of a step's (64, n) cotangent
    rows into MN-major 128-byte-swizzle atoms: the 16-byte chunk of row t
    and columns 8 cb .. at (cb / 8) 8192 + (t / 8) 1024 + (t % 8) 128 + 16
    ((cb % 8) ^ (t % 8)) bytes, in the kernel's loop order (lane pairs on
    the 16-byte blocks of one row)."""
    n = cot.shape[1]
    mem = torch.full((STEP * n,), float("nan"))
    for e in range(STEP * n // 8):
        r, cb = (e >> 1) % STEP, 2 * ((e >> 1) // STEP) + (e & 1)
        o = (cb >> 3) * STEP * 128 + (r >> 3) * 1024 + (r & 7) * 128 + (((cb & 7) ^ (r & 7)) << 4)
        mem[o // 2: o // 2 + 8] = cot[r, 8 * cb: 8 * cb + 8]
    return mem


@pytest.mark.parametrize("dilation", [1, 2, 3, 4])
def test_wgrad_operands_read_back_as_the_taps_product(dilation):
    """The weight gradients' operands for tap k: A = X_k^T from
    ldmatrix.trans (lane l: row (l % 8) + 8 (l // 16) + 16 ks + k d of the
    staged operand rows, column 16 w4 + 8 ((l // 8) % 2)) is the A fragment
    of x[t + (k - 4) d][ci]; B from the staged cotangent through the
    MN-major 128-byte-swizzle descriptor (start 2048 ks, leading byte
    offset 8192 between 64-column atoms, stride byte offset 1024 between 8
    k rows) is cot[16 ks + k][n]."""
    rs = np.random.RandomState(dilation)
    rows = STEP + 8 * dilation
    xs = torch.from_numpy(rs.randn(rows, LD1).astype(np.float32))  # x_s: row q = t + 4 d
    for w4 in (0, 3):
        for tap in (0, 5, 8):
            for ks in (0, 3):
                addrs = [((lane & 7) + ((lane >> 4) << 3) + tap * dilation + 16 * ks,
                          16 * w4 + ((lane >> 3) & 1) * 8) for lane in range(32)]
                # A[ci][t] = x[t + (tap - 4) d][ci] = x_s[t + tap d][ci]
                a = xs[16 * ks + tap * dilation: 16 * ks + tap * dilation + 16,
                       16 * w4: 16 * w4 + 16].T
                assert torch.equal(_ldmatrix(xs, addrs, True), _a_fragment(a)), (w4, tap, ks)
    for n in (64, 128):
        cot = torch.from_numpy(rs.randn(STEP, n).astype(np.float32))
        mem = _stage_cotangent(cot)
        k = torch.arange(16)[:, None]
        col = torch.arange(n)[None, :]
        for ks in range(4):
            addr = (2048 * ks + (col // 64) * STEP * 128 + ((col % 64) // 8) * 16 + (col % 8) * 2
                    + (k // 8) * 1024 + (k % 8) * 128)
            got = mem[(_sw128(addr) // 2).reshape(-1)].reshape(16, n)
            assert torch.equal(got, cot[16 * ks: 16 * ks + 16]), (n, ks)


# ---------------------------------------------------------------------------
# (b) the kernels' arithmetic, emulated
# ---------------------------------------------------------------------------


def _plan(b: int, rows: int) -> tuple:
    """(chunk, chunks per item) of csrc/tade_bwd_bf16.cu's plan_of."""
    per_item = -(-2 * SMS // (JOBS * b))
    chunk = -(-(-(-rows // per_item)) // QUANTUM) * QUANTUM
    return chunk, -(-rows // chunk)


def _gate_vjp(t, dout, gate: str):
    """csrc/tade.cuh gate_vjp on whole rows, float32."""
    ta, tb = t.chunk(2, dim=-1)
    g = dout.float()
    th = torch.tanh(tb)
    if gate == "softmax":
        p = torch.softmax(ta, dim=-1)
        u = g * th
        dta = p * (u - (u * p).sum(dim=-1, keepdim=True))
    else:
        p = torch.sigmoid(ta)
        dta = g * th * p * (1 - p)
    return torch.cat([dta, g * p * (1 - th * th)], dim=-1)


def _conv_t(cot, w, d: int):
    """The chain's transposed conv: rows of bf16 cot (B, L, Cout) against
    Wt[j] = bf16(w[8 - j])^T, one float32 product a tap added into a float32
    total in tap order; rows outside [0, L) zero."""
    b, rows, _ = cot.shape
    pad = torch.nn.functional.pad(cot, (0, 0, 4 * d, 4 * d))
    tot = torch.zeros(b, rows, w.shape[1])
    for j in range(9):
        tot = tot + pad[:, j * d: j * d + rows] @ _rb(w[8 - j]).T
    return tot


def _wgrad(x, cot, d: int, chunk: int):
    """dW[k] = sum_t x[t + (k - 4) d]^T cot[t] as the weight-gradient kernel
    sums it: float32 totals of 64-row steps per chunk of each item, then the
    chunks' slabs in order (item-major)."""
    b, rows, n = cot.shape
    pad = torch.nn.functional.pad(x.float(), (0, 0, 4 * d, 4 * d))
    out = torch.zeros(9, C, n)
    for i in range(b):
        for c0 in range(0, rows, chunk):
            slab = torch.zeros(9, C, n)
            for r0 in range(c0, min(rows, c0 + chunk), STEP):
                r1 = min(rows, c0 + chunk, r0 + STEP)
                xs = torch.stack([pad[i, r0 + k * d: r1 + k * d] for k in range(9)])
                slab = slab + xs.transpose(1, 2) @ cot[i, r0:r1]
            out = out + slab
    return out


def _bias(v, chunk: int):
    """The float32 column sums of v (B, L, n): per 112-row tile, the tiles of
    a chunk in order, then the chunks' slabs in order."""
    b, rows, n = v.shape
    out = torch.zeros(n)
    for i in range(b):
        for c0 in range(0, rows, chunk):
            s = torch.zeros(n)
            for t0 in range(c0, min(rows, c0 + chunk), TILE):
                s = s + v[i, t0: t0 + TILE].sum(dim=0)
            out = out + s
    return out


def emulate_stage(t, dout, sv, xr, mean, rstd, dext, blk, keys, y, ain, src, scale: int,
                  dilation: int, gated_function: str, keep_float: str = ""):
    """One call of csrc/tade_bwd_bf16.cu, as ``stage_backward_reference_bf16``
    takes and returns it (dxn, da', dsrc, weight grads); ``keep_float``
    "dT" or "dG" leaves that cotangent unrounded (a control)."""
    aux, g, gc = keys
    b, rows, _ = dout.shape
    chunk, _ = _plan(b, rows)
    dT = _gate_vjp(t.float(), dout, gated_function)
    dTb = dT if keep_float == "dT" else _rb(dT)
    dy = _conv_t(dTb, blk[f"{gc}_w"], dilation)
    xn = td._stretch((xr.float() - mean[:, None]) * rstd[:, None], scale)
    dG = torch.cat([dy * xn, dy], dim=-1)
    dGb = dG if keep_float == "dG" else _rb(dG)
    da = _conv_t(dGb, blk[f"{g}_w"], 1) + dext.float()
    dab = _rb(da)
    dsrc = _conv_t(dab, blk[f"{aux}_w"], 1)
    grads = {f"{gc}_w": _wgrad(y, dTb, dilation, chunk), f"{gc}_b": _bias(dT, chunk),
             f"{g}_w": _wgrad(ain, dGb, 1, chunk), f"{g}_b": _bias(dG, chunk),
             f"{aux}_w": _wgrad(src, dab, 1, chunk), f"{aux}_b": _bias(da, chunk)}
    return (dy * sv).to(BF16), da.to(BF16), dsrc.to(BF16), grads


def _phase28_close(got, want) -> bool:
    g, w = got.float(), want.float()
    d = g - w
    return (float(d.pow(2).mean().sqrt()) <= 1e-3 * float(w.pow(2).mean().sqrt())
            and float(d.abs().max()) <= 1e-2 * float(w.abs().max()))


def _block(rs, scale: int, dilation: int):
    """A unit-gain block in bf16 (the card's phase-28 weights, N(0, 1 / 24)
    convs, biases 0.1)."""
    blk = {"scale": scale, "dilation": dilation}
    for key in td.WEIGHT_KEYS:
        cout = C if key.startswith("aux") else 2 * C
        blk[f"{key}_w"] = torch.from_numpy((rs.randn(9, C, cout) / 24).astype(np.float32))
        blk[f"{key}_b"] = torch.from_numpy((rs.randn(cout) * 0.1).astype(np.float32))
    return {k: v.to(BF16) if torch.is_tensor(v) else v for k, v in blk.items()}


def _stage_case(b, t_len, scale, dilation, seed):
    """(x, c, x2, a, blk, dout, da2) in bf16: the block's input, K8a's plain
    outputs and unit cotangents of stage 2."""
    rs = np.random.RandomState(seed)
    blk = _block(rs, scale, dilation)

    def randn(*shape, s=1.0):
        return torch.from_numpy((rs.randn(*shape) * s).astype(np.float32)).to(BF16)

    x, c = randn(b, t_len, C), randn(b, t_len, C)
    with torch.no_grad():
        x2, a = td.tade1_reference_bf16(x, c, blk, "softmax")
    u = (b * scale * t_len) ** -0.5
    return x, c, x2, a, blk, randn(b, scale * t_len, C, s=u), randn(b, scale * t_len, C, s=u)


def _stages(case, gate, stage, fed=None):
    """K9b then K9a with ``stage`` as the stage backward, fed the plain
    re-runs, K9a on K9b's dx2 and da (or on ``fed``'s, K9b's outputs of
    another run: stage by stage, as the card's phase 28 holds them):
    (K9b's outputs, K9a's outputs)."""
    x, c, x2, a, blk, dout, da2 = case
    got2 = tt._backward2(x, x2, a, blk, gate, dout, da2, tt.tade2_rerun_reference_bf16, stage)
    dx2, da = (fed or got2)[1:3]
    got1 = tt._backward1(x, c, blk, gate, dx2, da, tt.tade1_rerun_reference_bf16, stage)
    return got2, got1


def _outputs(got2, got1):
    out = {"dx res": got2[0], "dx2": got2[1], "da": got2[2], "dx": got1[0], "dc": got1[1]}
    return {**out, **got2[3], **got1[2]}


@pytest.mark.parametrize("gate,scale,dilation", [
    ("softmax", 2, 2), ("sigmoid", 1, 3), ("softmax", 1, 1), ("sigmoid", 2, 4)])
def test_emulated_kernels_match_the_plain_version(gate, scale, dilation):
    """K9b and K9a with the emulated stage backward against
    ``stage_backward_reference_bf16`` on the same re-runs, stage by stage,
    by the phase-28 rule, at B = 2 and 500 frames (stage 2 at 1000 rows at scale 2: whole
    and ragged 112-row tiles, 448-row chunks)."""
    case = _stage_case(2, 500, scale, dilation, seed=11 + dilation)
    got2, got1 = _stages(case, gate, emulate_stage)
    want = _outputs(*_stages(case, gate, tt.stage_backward_reference_bf16, fed=got2))
    got = _outputs(got2, got1)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _phase28_close(g, w), (name, float((g.float() - w.float()).abs().max()))
        assert not _phase28_close(torch.zeros_like(g), w), name


@pytest.mark.parametrize("keep_float", ["dT", "dG"])
def test_a_cotangent_left_in_float32_fails_the_check(keep_float):
    """The control: the emulation with one rounding point moved (dT or dG
    not rounded to bf16 before its transposed conv and weight gradient)
    fails the phase-28 rule against the plain version."""
    case = _stage_case(2, 500, 2, 2, seed=13)

    def moved(*args):
        return emulate_stage(*args, keep_float=keep_float)

    got2, got1 = _stages(case, "softmax", moved)
    want = _outputs(*_stages(case, "softmax", tt.stage_backward_reference_bf16, fed=got2))
    got = _outputs(got2, got1)
    assert not all(_phase28_close(got[k], w) for k, w in want.items())


def _jax_close(got, want) -> bool:
    """tests/test_torch_port_tade_bf16.py's rule for the bf16 chain against
    JAX."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = g - w
    return (float(np.sqrt((d ** 2).mean())) <= 1e-2 * float(np.sqrt((w ** 2).mean()))
            and float(np.abs(d).max()) <= 2e-2 * float(np.abs(w).max()))


@pytest.mark.parametrize("gate", ["softmax", "sigmoid"])
def test_emulated_kernels_match_jax_interpret(gate):
    """One block's backward, K9b then K9a on the emulated stage, against
    JAX's ``fused_tade_blocks_train`` VJP on bf16 x and c in interpret mode
    (``_run_tade2_bwd`` and ``_run_tade1_bwd`` with ``mxu_bf16``), at B = 2,
    T = 64, scale 2, dilation 2 (the JAX test's weights, scale 0.04)."""
    rs = np.random.RandomState(5)
    b, t_len, scale, dilation = 2, 64, 2, 2
    w32 = {}
    for key in td.WEIGHT_KEYS:
        cout = C if key.startswith("aux") else 2 * C
        w32[f"{key}_w"] = (rs.randn(9, C, cout) * 0.04).astype(np.float32)
        w32[f"{key}_b"] = (rs.randn(cout) * 0.02).astype(np.float32)
    x, c = ((rs.randn(b, t_len, C) * 0.5).astype(np.float32) for _ in range(2))
    dxo, dco = (rs.randn(b, scale * t_len, C).astype(np.float32) for _ in range(2))

    def f(xx, cc, ws):
        return jax_fused(xx, cc, [dict(ws, scale=scale, dilation=dilation)],
                         gated_function=gate, min_fused_t=1, t_tile=16, interpret=True)

    import jax

    ws = {k: jnp.asarray(v) for k, v in w32.items()}
    _, vjp = jax.vjp(f, jnp.asarray(x).astype(jnp.bfloat16),
                     jnp.asarray(c).astype(jnp.bfloat16), ws)
    jdx, jdc, jdw = vjp((jnp.asarray(dxo).astype(jnp.bfloat16),
                         jnp.asarray(dco).astype(jnp.bfloat16)))
    want = {"dx": jdx, "dc": jdc, **jdw}

    blk = dict({k: torch.from_numpy(v) for k, v in w32.items()}, scale=scale,
               dilation=dilation)
    xb, cb = torch.from_numpy(x).to(BF16), torch.from_numpy(c).to(BF16)
    with torch.no_grad():
        x2, a = td.tade1_reference_bf16(xb, cb, blk, gate)
    case = (xb, cb, x2, a, blk, torch.from_numpy(dxo).to(BF16), torch.from_numpy(dco).to(BF16))
    got2, got1 = _stages(case, gate, emulate_stage)
    got = {"dx": got1[0] + got2[0], "dc": got1[1], **got2[3], **got1[2]}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape and _jax_close(g, w), (name, float(np.abs(g - w).max()))
