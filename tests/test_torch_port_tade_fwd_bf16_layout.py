"""csrc/tade_bf16.cu, the bf16-resident mode of the forward TADE kernels (K8a,
K8b) and their Save variant on Hopper's warpgroup products, on the CPU: its
layouts and its arithmetic, as the card reads and sums them.

Layouts. ``mma_bf16.tade_forward_wgmma`` lays each tap's weights out as
one wgmma B tile per stage of the kernel's ring, K-major in the 128-byte
swizzle, 64 columns for aux and 128 for g and gc, their columns paired (s_j
beside h_j, ta_j beside tb_j); the tests read each stage back through the
kernel's descriptor arithmetic (a stage 1024-aligned, 32 bytes a k16 step,
rows 128 bytes and atoms 1024 bytes apart, address bits 4-6 XOR bits 7-9)
for each tap, width and swizzle phase. The kernel's staging of the source rows (K8b's stretch applied,
zeros outside the rows) and its ldmatrix addresses at the tap's row shift
are emulated lane by lane with the kernel's own formulas, at dilations 1-4
and scales 1 and 2.

Arithmetic. ``emulate_half`` runs one kernel block by block as the card
does: the source rows staged, each conv a float32 total over its nine taps
of a tap's product over bf16 operands (the B tiles read back as above),
a' and y rounded to bf16 once as the next conv's operand, the biases, the
modulation (one fused multiply-add), the gate and the residual in float32;
with Save it returns the re-run's y, s, t and up(a). It is held to
``tade{1,2}_reference_bf16`` and ``tade{1,2}_rerun_reference_bf16`` (the
same roundings, other float32 orders) by the card's phase-28 rule
(rms|diff| <= 1e-3 rms|plain|, max|diff| <= 1e-2 max|plain|) and, one block
K8a then K8b, to JAX's ``fused_tade_blocks_train`` in interpret mode
(``_run_tade1`` / ``_run_tade2`` with ``mxu_bf16``) by
tests/test_torch_port_tade_bf16.py's rule for a bf16 chain (1e-2 rms, 2e-2
max). With a' or y kept in float32 (one rounding point left out) the
emulation fails the phase-28 rule.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.ops.pallas_kernels.tade_train import (  # noqa: E402
    fused_tade_blocks_train as jax_fused,
)
from parallelwavegan_tpu_torch.ops.kernels import mma_bf16  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_train as tt  # noqa: E402

C = 64
BF16 = torch.bfloat16

# the kernel's constants (csrc/tade_bf16.cu)
M = 192       # kM: rows of each product, three warpgroups of 64
LD = C + 8    # kLd: bf16 row stride of the staged rows


def _rb(v):
    return v.to(BF16).float()


def _to(d: int) -> int:
    """Geo<D>::kTO: the output rows of a block."""
    return M - 8 - 8 * d


# ---------------------------------------------------------------------------
# (a) layouts, read back as the card reads them
# ---------------------------------------------------------------------------


def _sw128(addr):
    """The 128-byte swizzle of a shared-memory byte address."""
    return addr ^ (((addr >> 7) & 7) << 4)


TILE = 64 * 64  # bf16 of one 8 KB tile


def _read_taps(tiles):
    """(aux (9, 64 k, 64 n), g (9, 64, 128), gc (9, 64, 128)), float32: each
    tap's B as the kernel reads it from its stage of the ring, through the
    K-major 128-byte-swizzle descriptor (k16 step ks at the stage's start +
    32 ks bytes, column n at (n // 8) 1024 + (n % 8) 128, the k values'
    16-byte chunk k // 8, the address swizzled): the stage holds aux's tap
    j (tile j, n < 64) or g's and gc's tap j (tiles 9 + 2 j, 10 + 2 j and
    27 + 2 j, 28 + 2 j, copied together: n < 128)."""
    flat = tiles.reshape(-1)  # 2-byte units
    k = torch.arange(16)[:, None]

    def tap(first: int, n_cols: int):
        stage = flat[first * TILE: first * TILE + n_cols * 64]
        n = torch.arange(n_cols)[None, :]
        out = torch.empty(64, n_cols)
        for ks in range(4):
            addr = 32 * ks + (n // 8) * 1024 + (n % 8) * 128 + (k // 8) * 16 + (k % 8) * 2
            out[16 * ks: 16 * ks + 16] = stage[(_sw128(addr) // 2).reshape(-1)].reshape(
                16, n_cols).float()
        return out

    return (torch.stack([tap(j, 64) for j in range(9)]),
            torch.stack([tap(9 + 2 * j, 128) for j in range(9)]),
            torch.stack([tap(27 + 2 * j, 128) for j in range(9)]))


def _channel(i: int, tig: int) -> int:
    """csrc/tade_bf16.cu pair_channel: the channel of column 8 i + 2 tig (and
    + 1), i < 16, of a 128-column conv."""
    return 8 * (i // 2) + 2 * tig + i % 2


def _weights(rs, cout_scale: float = 1 / 24):
    return [torch.from_numpy((rs.randn(9, C, n) * cout_scale).astype(np.float32))
            for n in (C, 2 * C, 2 * C)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wgmma_weight_tiles_read_back_as_the_forward_convs(dtype):
    """Each tap's stage read through the kernel's descriptor gives B[k][n] =
    bf16(aux[j][k][n]) for aux (width 64), and for the 128-column convs g
    and gc column n = 8 i + 2 tig + c the channel ``_channel(i, tig)`` of
    half c (c = 0: s or ta, 1: h or tb), so that a thread holds s_j beside
    h_j and channel j + 1 in the next column tile; every swizzle phase n %
    8 other than 0 moves its chunks."""
    rs = np.random.RandomState(3)
    aux, g, gc = (w.to(dtype) for w in _weights(rs))
    tiles = mma_bf16.tade_forward_wgmma(aux, g, gc)
    assert tiles.shape == (45, 64, 64) and tiles.dtype == BF16
    b_aux, b_g, b_gc = _read_taps(tiles)
    assert torch.equal(b_aux, aux.to(BF16).float())
    for b, w in ((b_g, g), (b_gc, gc)):
        seen = set()
        for i in range(16):
            for tig in range(4):
                for c in range(2):
                    ch = _channel(i, tig)
                    seen.add(c * C + ch)
                    assert torch.equal(b[:, :, 8 * i + 2 * tig + c],
                                       w[:, :, c * C + ch].to(BF16).float()), (i, tig, c)
        assert len(seen) == 2 * C  # every column, once
    plain = aux.to(BF16).transpose(1, 2)  # (j, n, k), unswizzled
    for phase in range(1, 8):
        rows = tiles[:9, phase::8].reshape(-1, 8, 8)
        assert not torch.equal(rows, plain[:, phase::8].reshape(-1, 8, 8)), phase
    assert torch.equal(tiles[:9, 0::8], plain[:, 0::8])


def _stage(src, t0: int, d: int, scale: int):
    """The kernel's staging of one block's source rows (its cp.async loop,
    lane by lane): row u of xs (kLd apart) holds src[(s0 + u) / scale],
    s0 = t0 - 4D - 8, zeros outside [0, L)."""
    t_in = src.shape[0]
    length = scale * t_in
    s0 = t0 - 4 * d - 8
    xs = torch.full(((M + 8 * max(d, 1)) * LD,), float("nan"))
    for e in range((M + 8) * (C // 8)):
        u, c8 = e >> 3, (e & 7) * 8
        pos = s0 + u
        ok = 0 <= pos < length
        xs[u * LD + c8: u * LD + c8 + 8] = src[pos // scale, c8: c8 + 8] if ok else 0.0
    return xs.reshape(-1, LD)


def _ldmatrix(mem, addrs):
    """ldmatrix.x4 over a 2-D bf16 array mem of (row, column) element
    addresses: lane l gives addrs[l], the first element of a 16-byte row of
    matrix l // 8; lane 4 g + t gets (row g, elements 2 t, 2 t + 1) of each."""
    regs = torch.empty(32, 4, 2, dtype=mem.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            r, c = addrs[8 * i + g]
            regs[lane, i] = mem[r, c + 2 * t: c + 2 * t + 2]
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


@pytest.mark.parametrize("dilation,scale", [(1, 1), (2, 2), (3, 2), (4, 1)])
def test_a_operand_reads_the_taps_row_shift(dilation, scale):
    """conv9's ldmatrix rows (lane l: row 16 warp + l % 16 + j DD, column 16
    ks + 8 (l // 16), rows kLd apart) over the staged source rows give each
    warp the A fragment of up(src)[s0 + 16 warp + m + j][16 ks + k] (the aux
    conv, DD = 1; zeros outside [0, L)), and over any buffer the fragment
    of rows 16 warp + m + j D (the gated conv over y, DD = D), for a block
    at the start, in the middle and at the ragged end."""
    rs = np.random.RandomState(dilation)
    t_in = 150
    src = torch.from_numpy(rs.randn(t_in, C).astype(np.float32))
    length = scale * t_in
    up = td._stretch(src[None], scale)[0]
    to = _to(dilation)
    for t0 in (0, to, (length - 1) // to * to):
        xs = _stage(src, t0, dilation, scale)
        s0 = t0 - 4 * dilation - 8
        want_rows = torch.zeros(M + 8, C)
        for u in range(M + 8):
            if 0 <= s0 + u < length:
                want_rows[u] = up[s0 + u]
        for warp in (0, 5, 11):
            for j in (0, 4, 8):
                for ks in (0, 3):
                    addrs = [(16 * warp + (lane & 15) + j, ks * 16 + (lane >> 4) * 8)
                             for lane in range(32)]
                    r0 = 16 * warp + j
                    want = _a_fragment(want_rows[r0: r0 + 16, 16 * ks: 16 * ks + 16])
                    assert torch.equal(_ldmatrix(xs, addrs), want), (t0, warp, j, ks)
    ys = torch.arange((M + 8 * dilation) * LD, dtype=torch.float32).reshape(-1, LD)
    for warp in (0, 11):
        for j in (1, 8):
            addrs = [(16 * warp + (lane & 15) + j * dilation, 16 + (lane >> 4) * 8)
                     for lane in range(32)]
            r0 = 16 * warp + j * dilation
            assert torch.equal(_ldmatrix(ys, addrs), _a_fragment(ys[r0: r0 + 16, 16:32]))


# ---------------------------------------------------------------------------
# (b) the kernels' arithmetic, emulated
# ---------------------------------------------------------------------------


# the columns of a 128-column conv holding (first half, second half) of
# channel q, q in 0 .. 63
_FIRST = torch.empty(C, dtype=torch.long)
for _i in range(16):
    for _tig in range(4):
        _FIRST[_channel(_i, _tig)] = 8 * _i + 2 * _tig
_SECOND = _FIRST + 1


def _conv_rows(rows, bmats, dd: int):
    """The block's M x N product: a float32 total over the nine taps of
    rows[m + j dd] @ B[j], one tap's product at a time."""
    tot = torch.zeros(M, bmats.shape[-1])
    for j in range(9):
        tot = tot + rows[j * dd: j * dd + M] @ bmats[j]
    return tot


def _halves(bmats, rows, dd: int, bias):
    """A 128-column conv over rows, as (first half, second half) (M, 64) by
    channel, + bias."""
    tot = _conv_rows(rows, bmats, dd)
    return tot[:, _FIRST] + bias[:C], tot[:, _SECOND] + bias[C:]


def emulate_half(src, xm, xr, mean, rstd, blk, half: int, gate: str, save: bool,
                 keep_float: str = ""):
    """One launch of csrc/tade_bf16.cu, K8a (``half`` 1: src c, xm x) or K8b
    (2: src a, xm x2, xr the residual x), block by block: the forward's
    (out, a') or with ``save`` the re-run's (a', y, s, t, up(a) or None),
    as ``tade{1,2}_reference_bf16`` and ``tade{1,2}_rerun_reference_bf16``
    return them. ``keep_float`` "a" or "y" leaves that operand unrounded
    in shared memory (a control)."""
    keys = td.WEIGHT_KEYS[:3] if half == 1 else td.WEIGHT_KEYS[3:]
    scale = 1 if half == 1 else int(blk["scale"])
    d = 1 if half == 1 else int(blk["dilation"])
    b_aux, b_g, b_gc = _read_taps(mma_bf16.tade_forward_wgmma(*(blk[f"{k}_w"] for k in keys)))
    aux_b, g_b, gc_b = (blk[f"{k}_b"].float() for k in keys)
    b_items, t_in, _ = src.shape
    length = scale * t_in
    to = _to(d)
    out = torch.zeros(b_items, length, C)
    a_out, y_out, s_out = (torch.zeros(b_items, length, C) for _ in range(3))
    t_out = torch.zeros(b_items, length, 2 * C)
    for b in range(b_items):
        for t0 in range(0, length, to):
            y0 = t0 - 4 * d
            a0 = y0 - 4
            own = torch.arange(to)
            own = own[t0 + own < length]
            pos = t0 + own
            xs = _stage(src[b].float(), t0, d, scale)[:M + 8, :C]
            # a' = aux(src) + bias, zero outside [0, L)
            rows = a0 + torch.arange(M)
            inside = ((rows >= 0) & (rows < length))[:, None]
            av = torch.where(inside, _conv_rows(xs, b_aux, 1) + aux_b, 0.0)
            a_s = torch.zeros(M + 8, C)
            a_s[:M] = av if keep_float == "a" else _rb(av)
            a_out[b, pos] = _rb(av[4 * d + 4 + own])
            # y = s * (xm - mean) * rstd + h, zero outside [0, L) and past
            # the rows the gated conv reads
            s, h = _halves(b_g, a_s, 1, g_b)
            rows = y0 + torch.arange(M)
            inside = ((rows >= 0) & (rows < length) & (torch.arange(M) < to + 8 * d))[:, None]
            xv = xm[b, rows.clamp(0, length - 1) // scale].float()
            xn = (xv - mean[b]) * rstd[b]
            y = torch.where(inside, (s.double() * xn.double() + h.double()).float(), 0.0)
            ys = torch.zeros(M + 8 * d, C)
            ys[:M] = y if keep_float == "y" else _rb(y)
            ta, tb = _halves(b_gc, ys, d, gc_b)
            if save:
                y_out[b, pos] = _rb(y[4 * d + own])
                s_out[b, pos] = s[4 * d + own]
                t_out[b, pos] = torch.cat([ta, tb], dim=1)[own]
                continue
            if gate == "softmax":
                e = torch.exp(ta - ta.max(dim=1, keepdim=True).values)
                p = e * (1.0 / e.sum(dim=1, keepdim=True))
            else:
                p = 1.0 / (1.0 + torch.exp(-ta))
            g = (p * torch.tanh(tb))[own]
            if half == 2:
                g = xr[b, pos // scale].float() + g
            out[b, pos] = g
    if save:
        ua = td._stretch(src, scale) if scale == 2 else None
        return a_out.to(BF16), y_out.to(BF16), s_out, t_out, *([ua] if half == 2 else [])
    return out.to(BF16), a_out.to(BF16)


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


def _case(b, t_len, scale, dilation, seed):
    """(x, c, x2, a, blk) in bf16, x2 and a K8a's plain outputs."""
    rs = np.random.RandomState(seed)
    blk = _block(rs, scale, dilation)
    x, c = (torch.from_numpy(rs.randn(b, t_len, C).astype(np.float32)).to(BF16)
            for _ in range(2))
    with torch.no_grad():
        x2, a = td.tade1_reference_bf16(x, c, blk, "softmax")
    return x, c, x2, a, blk


def _outputs(case, gate, keep_float: str = ""):
    """{name: (emulated, plain)} of K8a and K8b, forward and Save, on the
    same inputs (K8b on the plain K8a's x2 and a)."""
    x, c, x2, a, blk = case
    m1, r1 = td._stats(x.float())
    m2, r2 = td._stats(x2.float())
    pairs = {}
    with torch.no_grad():
        got = emulate_half(c, x, None, m1, r1, blk, 1, gate, False, keep_float)
        want = td.tade1_reference_bf16(x, c, blk, gate)
        pairs.update({f"K8a {n}": (g, w) for n, g, w in zip(("x2", "a"), got, want)})
        got = emulate_half(a, x2, x, m2, r2, blk, 2, gate, False, keep_float)
        want = td.tade2_reference_bf16(x, x2, a, blk, gate)
        pairs.update({f"K8b {n}": (g, w) for n, g, w in zip(("out", "a2"), got, want)})
        got = emulate_half(c, x, None, m1, r1, blk, 1, gate, True, keep_float)
        want = tt.tade1_rerun_reference_bf16(x, c, blk, gate, m1, r1)
        pairs.update({f"K8a re-run {n}": (g, w) for n, g, w in zip("ayst", got, want)})
        got = emulate_half(a, x2, x, m2, r2, blk, 2, gate, True, keep_float)
        want = tt.tade2_rerun_reference_bf16(x, x2, a, blk, gate, m2, r2)
        pairs.update({f"K8b re-run {n}": (g, w) for n, g, w in zip(("a2", "y", "s", "t", "ua"),
                                                                      got, want)
                      if w is not None})
    return pairs


@pytest.mark.parametrize("gate,scale,dilation", [
    ("softmax", 2, 2), ("sigmoid", 1, 3), ("softmax", 1, 1), ("sigmoid", 2, 4)])
def test_emulated_kernels_match_the_plain_versions(gate, scale, dilation):
    """K8a, K8b and their Save variant as the kernel computes them, against
    their plain versions by the phase-28 rule, at B = 2 and 300 frames (K8b
    at 600 rows at scale 2: whole and ragged tiles, a tile at each end)."""
    pairs = _outputs(_case(2, 300, scale, dilation, seed=11 + dilation), gate)
    assert len(pairs) == 12 + (scale == 2)
    for name, (g, w) in pairs.items():
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _phase28_close(g, w), (name, float((g.float() - w.float()).abs().max()))
        assert not _phase28_close(torch.zeros_like(g), w), name


def test_emulated_kernels_at_a_length_below_one_tile():
    """T = 40 < TO: one block, rows past the end dropped."""
    pairs = _outputs(_case(1, 40, 2, 2, seed=7), "softmax")
    for name, (g, w) in pairs.items():
        assert _phase28_close(g, w), name


@pytest.mark.parametrize("keep_float", ["a", "y"])
def test_an_operand_left_in_float32_fails_the_check(keep_float):
    """The control: the emulation with a' or y kept in float32 as the next
    conv's operand (one rounding point left out) fails the phase-28 rule
    against the plain versions."""
    pairs = _outputs(_case(2, 300, 2, 2, seed=13), "softmax", keep_float)
    assert not all(_phase28_close(g, w) for g, w in pairs.values())


STAT_ROWS = 512  # kStatRows: rows of a statistics chunk


def _stats_emulated(x):
    """csrc/tade_bf16.cu's statistics of a bf16 x (B, T, 64), in float32 as
    its kernels sum them: each chunk of 512 rows by two passes (64 row
    lanes, each every 64th row, then the lanes in order: the chunk's mean,
    then its squared deviations from that mean), the chunks merged in order
    (the whole mean from the chunks' means by their rows, then each chunk's
    squared deviations plus its rows times its mean's squared distance);
    (mean, 1 / sqrt(var + 1e-5))."""
    b, t_len, _ = x.shape
    xf = x.float()
    means, m2s, rows = [], [], []
    for r0 in range(0, t_len, STAT_ROWS):
        chunk = xf[:, r0: r0 + STAT_ROWS]
        n = chunk.shape[1]
        pad = torch.nn.functional.pad(chunk, (0, 0, 0, -n % 64))
        lanes = pad.reshape(b, -1, 64, C)  # (B, rows / 64, lane, C)
        mean = lanes.sum(dim=1).sum(dim=1) / n
        dev = torch.where(torch.arange(pad.shape[1])[None, :, None] < n,
                          pad - mean[:, None], 0.0).reshape(b, -1, 64, C)
        means.append(mean)
        m2s.append((dev * dev).sum(dim=1).sum(dim=1))
        rows.append(float(n))
    m = sum(mu * n for mu, n in zip(means, rows)) / t_len
    m2 = sum(q + (mu - m) ** 2 * n for q, mu, n in zip(m2s, means, rows))
    return m, torch.rsqrt((m2 / t_len).clamp_min(0.0) + 1e-5)


@pytest.mark.parametrize("b,t_len", [(2, 1001), (3, 50), (1, 2048)])
def test_statistics_from_bf16_rows_match_the_float32_statistics(b, t_len):
    """The statistics kernel's arithmetic (``_stats_emulated``) against
    ``_stats`` of the float32 copy that the wrapper no longer makes, within
    float32 rounding, on rows far from zero mean (where a one-pass sum of
    squares would cancel)."""
    rs = np.random.RandomState(t_len)
    x = torch.from_numpy((rs.randn(b, t_len, C) * 0.3 + 4.0).astype(np.float32)).to(BF16)
    mean, rstd = _stats_emulated(x)
    want_mean, want_rstd = td._stats(x.double())
    assert torch.allclose(mean.double(), want_mean, rtol=2e-6, atol=0)
    assert torch.allclose(rstd.double(), want_rstd, rtol=2e-5, atol=0)
    got32 = td._stats(x.float())
    assert torch.allclose(rstd, got32[1], rtol=2e-5, atol=0)


def _jax_close(got, want) -> bool:
    """tests/test_torch_port_tade_bf16.py's rule for the bf16 chain against
    JAX."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = g - w
    return (float(np.sqrt((d ** 2).mean())) <= 1e-2 * float(np.sqrt((w ** 2).mean()))
            and float(np.abs(d).max()) <= 2e-2 * float(np.abs(w).max()))


@pytest.mark.parametrize("gate", ["softmax", "sigmoid"])
def test_emulated_kernels_match_jax_interpret(gate):
    """One block, the emulated K8a then K8b, against JAX's
    ``fused_tade_blocks_train`` on bf16 x and c in interpret mode
    (``_run_tade1`` and ``_run_tade2`` with ``mxu_bf16``), at B = 2, T = 64,
    scale 2, dilation 2 (the JAX test's weights, scale 0.04)."""
    rs = np.random.RandomState(5)
    b, t_len, scale, dilation = 2, 64, 2, 2
    w32 = {}
    for key in td.WEIGHT_KEYS:
        cout = C if key.startswith("aux") else 2 * C
        w32[f"{key}_w"] = (rs.randn(9, C, cout) * 0.04).astype(np.float32)
        w32[f"{key}_b"] = (rs.randn(cout) * 0.02).astype(np.float32)
    x, c = ((rs.randn(b, t_len, C) * 0.5).astype(np.float32) for _ in range(2))
    ws = {k: jnp.asarray(v) for k, v in w32.items()}
    xo, co = jax_fused(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(c).astype(jnp.bfloat16),
                       [dict(ws, scale=scale, dilation=dilation)], gated_function=gate,
                       min_fused_t=1, t_tile=16, interpret=True)

    blk = dict({k: torch.from_numpy(v) for k, v in w32.items()}, scale=scale,
               dilation=dilation)
    xb, cb = torch.from_numpy(x).to(BF16), torch.from_numpy(c).to(BF16)
    with torch.no_grad():
        x2, a = emulate_half(cb, xb, None, *td._stats(xb.float()), blk, 1, gate, False)
        out, a2 = emulate_half(a, x2, xb, *td._stats(x2.float()), blk, 2, gate, False)
    for name, g, w in (("x_out", out, xo), ("c_out", a2, co)):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape and _jax_close(g, w), (name, float(np.abs(g - w).max()))
    assert jax.default_backend() == "cpu"
