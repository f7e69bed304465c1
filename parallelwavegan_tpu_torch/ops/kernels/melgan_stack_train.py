"""The differentiable fused MelGAN stage: K6 forward, K7 backward.

Counterpart of parallelwavegan_tpu/ops/pallas_kernels/melgan_stack_train.py
(``_stacks_core`` :342-377, ``fused_melgan_stacks_train`` :380,
``_run_stacks_bwd`` :247). Layout and weight form are those of
``ops/kernels/melgan_stack.py``: x (B, T, C), each stack a dict of
gather-form weights ``wd`` (K, C, C), ``w1`` and ``ws`` (1, C, C), biases
``bd``, ``b1``, ``bs`` (or None) and ``dilation``; ``final`` is ``(w (K,
C, out), b)`` for the trailing act -> conv -> tanh.

``melgan_stacks_train`` is a ``torch.autograd.Function``: its forward is
the K6 kernel on a CUDA tensor and ``melgan_stacks_reference`` on a CPU
tensor, and it saves only the stage's input and weights, the JAX residual
``(x, ws)`` (:349-354), so each stage is a recompute checkpoint; on a CUDA
tensor it also keeps what K6 read of the weights (their split and packed
biases, ``melgan_stack.kernel_weights``: one split per forward). Its
backward is ``melgan_stacks_backward``: for a CUDA tensor it re-runs K6
from the saved input on that split, keeping every stack's input in
device memory, then runs the final conv's backward and walks the stacks
in reverse through the hand-written K7 kernel (csrc/melgan_stack_bwd.cu: one
``melgan_outconv_bwd`` call of two CUDA kernels, then one
``melgan_stack_bwd`` call of four per stack, its products split TF32 on
the tensor cores against weights that ``tf32x3.stack_fragments`` splits
once per call); for a CPU tensor it runs
``melgan_stacks_backward_reference``. A CUDA tensor never takes the plain
path. K6 pads inside the kernel and K7 applies the padding's adjoint, so
the gradient is exact over the whole sequence: the JAX wrapper's zero-pad
core and its autodiff of the XLA twin on 3R-sample edge windows
(:21-29, :403-408) are not carried over, and neither is ``t_tile``.

A bf16 x runs the JAX kernel's bf16-resident mode (``mxu_bf16``,
:253-289, with the shared ``_apply_conv_t``/``_conv_wgrads`` of
tade_train.py:173-210): K6's bf16 mode forward (and re-run), and a
backward whose products take bf16 operands where JAX casts them (the
cotangents dz and g, the padded leaky(x), leaky(z), x and the weights)
and sum in float32; the bias gradients sum the unrounded cotangents; dx
comes back bf16 and every weight gradient in its weight's type, as
JAX's ``_core_bwd`` casts them (:363-371). Its plain version is
``melgan_stacks_backward_reference_bf16``, written with its own roundings
(JAX's backward rounds dz and the weights again, which autograd of the
bf16 forward would not); on the card the hand-written bf16 kernels
(csrc/melgan_stack_bwd_bf16.cu, on Hopper's warpgroup products, reading
the tiles that the forward laid out for K6, ``ctx.split``). Every reader
of h, dz and the cotangent between stacks rounds it to bf16 first, so the
kernels store them as bf16, each with the float32 column sums of its
unrounded rows (the bias gradients). The padding's adjoint, which JAX
leaves to its XLA twin on the edge windows, sums the cotangent rows that
the padded positions read in float32 and rounds the sum once, per tap, as
one more operand row of the transposed conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from parallelwavegan_tpu_torch.ops.kernels import build, mma_bf16
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import stack_fragments
from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
    _MODES,
    _bf,
    _bias,
    _check_cuda_inputs,
    _f32,
    _pad_mode,
    _run_cuda,
    _run_cuda_bf16,
    kernel_weights,
    kernel_weights_bf16,
    melgan_stacks_reference,
    melgan_stacks_reference_bf16,
    stacks_forward_bf16,
)

STACK_KEYS = ("wd", "bd", "w1", "b1", "ws", "bs")


def melgan_stacks_backward_reference(x, stacks, final, slope, pad_mode, dy):
    """Plain backward of ``melgan_stacks_reference``: (dx, dstacks,
    dfinal) for the cotangent dy of its output, by autograd; a bias that is
    None gets None."""

    def leaf(v):
        return None if v is None else v.detach().requires_grad_()

    with torch.enable_grad():
        xv = leaf(x)
        sv = [{k: st[k] if k == "dilation" else leaf(st[k]) for k in st}
              for st in stacks]
        fv = None if final is None else tuple(leaf(v) for v in final)
        y = melgan_stacks_reference(xv, sv, final=fv, slope=slope,
                                    pad_mode=pad_mode)
        leaves = [xv] + [st[k] for st in sv for k in STACK_KEYS] + list(fv or ())
        used = [v for v in leaves if v is not None]
        grads = iter(torch.autograd.grad(y, used, dy, allow_unused=True))
    got = [None if v is None else next(grads) for v in leaves]
    got = [g if g is not None or v is None else torch.zeros_like(v)
           for g, v in zip(got, leaves)]
    dx, rest = got[0], got[1:]
    dstacks = [dict(zip(STACK_KEYS, rest[6 * i:6 * i + 6])) for i in range(len(stacks))]
    dfinal = None if final is None else tuple(rest[6 * len(stacks):])
    return dx, dstacks, dfinal


def _dleaky(v, slope: float):
    """1 at v >= 0, else slope (the JAX kernels' _dleaky)."""
    return torch.where(v >= 0, 1.0, slope)


def _fold(e, pad: int, t: int, mode: str):
    """The padding's adjoint of the cotangents e (B, t + 2 pad, C) of the
    padded positions -pad .. t + pad - 1, the interior left out: at each
    row of x, the float32 sum of the rows of the positions that read it
    (``mode`` is torch's pad name)."""
    out = e.new_zeros(e.shape[0], t, e.shape[2])
    if pad == 0 or mode == "constant":
        return out
    left, right = e[:, :pad], e[:, pad + t:]
    if mode == "reflect":  # -j reads row j, t + j reads row t - 2 - j
        out[:, 1:pad + 1] += left.flip(1)
        out[:, t - 1 - pad:t - 1] += right.flip(1)
    else:  # replicate: rows 0 and t - 1
        out[:, 0] += left.sum(1)
        out[:, t - 1] += right.sum(1)
    return out


def _conv_t_bf16(g, w, dil: int, pad: int, mode: str):
    """The transposed conv of g (B, T, Cout) through w (K, Cin, Cout) in the
    bf16 mode: sum over taps k of bf16(G_k) . bf16(w[k])^T, where G_k's row
    t is g[t + pad - k dil] and, as an operand row of its own, the float32
    sum of the rows that tap k reads for the padded positions folded onto
    t (``_fold``); each rounded to bf16 once."""
    t = g.shape[1]
    wb = _bf(w)
    gp = F.pad(g, (0, 0, 2 * pad, 2 * pad))
    out = None
    for k in range(w.shape[0]):
        s = k * dil - pad  # tap k at output row u reads padded position u + s
        e = gp[:, pad - s:pad - s + t + 2 * pad]  # e[:, q + pad] = g[q - s]
        wt = wb[k].transpose(0, 1)
        term = _bf(e[:, pad:pad + t]) @ wt + _bf(_fold(e, pad, t, mode)) @ wt
        out = term if out is None else out + term
    return out


def _wgrad_bf16(tp, g, dil: int, t: int, k: int):
    """(K, Cin, Cout): sum over rows of bf16 operands, tap k's rows of the
    padded input tp (already rounded) against bf16(g)."""
    gb = _bf(g)
    return torch.stack([torch.einsum("btc,bto->co", tp[:, i * dil:i * dil + t], gb)
                        for i in range(k)])


def melgan_stacks_backward_reference_bf16(x, stacks, final, slope, pad_mode, dy,
                                          inputs=None):
    """Plain backward of K6's bf16-resident mode (the JAX
    ``_kernel_stacks_bwd`` with ``mxu_bf16``): (dx bf16, dstacks, dfinal)
    with float32 weight gradients, for the bf16 cotangent dy of the stage's
    output; a bias that is None gets None. Every product rounds its
    operands to bf16 where JAX casts them and sums in float32; the bias
    gradients are sums of the unrounded cotangents. ``inputs`` as
    ``stacks_forward_bf16`` takes them (K7's re-run's, to hold its backward
    stack by stack)."""
    mode = _pad_mode(pad_mode)
    t = x.shape[1]
    fwd = stacks_forward_bf16(x, stacks, final, slope, pad_mode, inputs)
    dfinal = None
    if final is not None:
        fw, fb = final
        y = fwd["y"]
        dpre = dy.float() * (1 - y * y)
        dfinal = (_wgrad_bf16(fwd["tf"], dpre, 1, t, fw.shape[0]),
                  None if fb is None else dpre.sum((0, 1)))
        g = _conv_t_bf16(dpre, fw, 1, (fw.shape[0] - 1) // 2, mode) * _dleaky(
            fwd["xf"], slope)
    else:
        g = dy.float()
    dstacks = [None] * len(stacks)
    for i in reversed(range(len(stacks))):
        st = stacks[i]
        k, d = st["wd"].shape[0], int(st["dilation"])
        xi, z = fwd["xs"][i], fwd["zs"][i]
        gb, db = _bf(g), g.sum((0, 1))
        dz = (gb @ _bf(st["w1"][0]).transpose(0, 1)) * _dleaky(z, slope)
        dstacks[i] = {
            "wd": _wgrad_bf16(fwd["ts"][i], dz, d, t, k),
            "bd": dz.sum((0, 1)),
            "w1": torch.einsum("btc,bto->co", _bf(F.leaky_relu(z, slope)), gb)[None],
            "b1": db,
            "ws": torch.einsum("btc,bto->co", _bf(xi), gb)[None],
            "bs": db.clone()}
        for key in ("bd", "b1", "bs"):
            if st[key] is None:
                dstacks[i][key] = None
        g = (_conv_t_bf16(dz, st["wd"], d, (k - 1) // 2 * d, mode) * _dleaky(xi, slope)
             + gb @ _bf(st["ws"][0]).transpose(0, 1))
    return g.to(torch.bfloat16), dstacks, dfinal


def melgan_stacks_backward(x, stacks, final, slope, pad_mode, dy, fwd_split=None):
    """(dx, dstacks, dfinal) of one stage for the cotangent dy of its
    output; a bias that is None gets None. ``fwd_split`` is what K6's
    re-run reads, ``melgan_stack.kernel_weights(stacks)`` as the forward
    made it (made here when not given).

    A CUDA tensor goes through K7 (the widths and pad modes of
    ``fused_melgan_stacks``, stack and final kernels odd up to 7, the final
    conv to at most 4 channels; float32, contiguous) and raises on anything
    it does not take; ``melgan_stacks_backward.launches`` counts one per
    stack and one for ``final`` (``.launches_by_width`` at each stage width
    C). K6 re-runs the stage from x first (counted
    in ``fused_melgan_stacks.launches``). A CPU tensor goes through
    ``melgan_stacks_backward_reference``. A bf16 x (and dy) runs the
    bf16-resident mode (``melgan_stacks_backward_reference_bf16`` on the
    CPU; ``.bf16_launches`` counts its launches on the card), dx bf16 and
    the weight gradients float32; ``fwd_split`` is then
    ``melgan_stack.kernel_weights_bf16(stacks)``.
    """
    _pad_mode(pad_mode)
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        fn = melgan_stacks_backward_reference_bf16 if bf16 else melgan_stacks_backward_reference
        return fn(x, stacks, final, slope, pad_mode, dy)
    if x.device.type != "cuda":
        raise ValueError(f"melgan_stacks_backward: unsupported device {x.device}")
    _check_cuda_inputs(x, stacks, final, pad_mode)
    b, t, c = x.shape
    out_ch = c if final is None else final[0].shape[-1]
    build.check_tensor("dy", dy, x.device, (b, t, out_ch),
                       dtypes=build.BF16 if bf16 else (torch.float32,))
    for i, st in enumerate(stacks):
        if st["wd"].shape[0] > 7:
            raise ValueError(f"stacks[{i}]: K7 takes kernel sizes up to 7")
    if final is not None and (final[0].shape[0] > 7 or out_ch > 4):
        raise ValueError("final: K7 takes kernel sizes up to 7 and at most 4 outputs")
    if not stacks and final is None:
        return dy, [], None
    if dy.data_ptr() % 16:  # the stacks stage their rows in 16-byte pieces
        dy = dy.clone()
    return _backward_cuda(x, stacks, final, slope, pad_mode, dy, fwd_split)


def _backward_cuda(x, stacks, final, slope, pad_mode, dy, fwd_split):
    """K7 on the card (``melgan_stacks_backward``'s inputs, checked): K6
    re-runs the stage from x, keeping every stack's input and, with the
    final conv, its output y; then one ``melgan_outconv_bwd`` call and one
    ``melgan_stack_bwd`` call per stack in reverse. A bf16 x goes to
    ``_backward_bf16``."""
    if x.dtype == torch.bfloat16:
        return _backward_bf16(x, stacks, final, slope, pad_mode, dy, fwd_split)
    b, t, c = x.shape
    out_ch = c if final is None else final[0].shape[-1]
    xs = [x]
    split = kernel_weights(stacks) if fwd_split is None else fwd_split
    if final is None:
        _run_cuda(x, stacks[:-1], None, slope, pad_mode, xs, (split[0][:-1], split[1][:-1]))
    else:
        y = _run_cuda(x, stacks, final, slope, pad_mode, xs, split)
    lib = build.load()
    dev, stream = build.launch_target(x)
    mode = _MODES[pad_mode][1]
    queries = [lib.query("melgan_stack_bwd_part_floats", b, t, c, st["wd"].shape[0],
                         int(st["dilation"])) for st in stacks]
    if final is not None:
        kf = final[0].shape[0]
        queries.append(lib.query("melgan_outconv_bwd_part_floats", b, t, c,
                                 out_ch, kf))
    if min(queries) < 0:
        raise ValueError(f"(B, T, C) = ({b}, {t}, {c}) needs too large a partial buffer")
    n_part = max(queries)
    part = torch.empty(n_part, device=x.device)
    bufs = [torch.empty_like(x) for _ in range(2)]
    g, n_out = dy, 0
    dfinal = None
    if final is not None:
        fw, fb = final
        dw, db = torch.empty(fw.shape, device=x.device), torch.empty(out_ch, device=x.device)
        lib.call("melgan_outconv_bwd", xs[-1].data_ptr(), y.data_ptr(),
                 dy.data_ptr(), bufs[0].data_ptr(), part.data_ptr(), fw.data_ptr(),
                 dw.data_ptr(), db.data_ptr(), n_part, b, t, c, out_ch, kf, mode,
                 slope, dev, stream)
        _count(c, False)
        g, n_out = bufs[0], 1
        dfinal = (dw, None if fb is None else db)
    dz, h = torch.empty_like(x), torch.empty_like(x)
    frags = stack_fragments(stacks) if stacks else []
    dstacks = [None] * len(stacks)
    for i in reversed(range(len(stacks))):
        st = stacks[i]
        dst = bufs[n_out % 2]
        d = _grad_buffers(st, c, x.device)
        bd = _bias(_f32(st["bd"]), c, dz).detach().contiguous()
        lib.call("melgan_stack_bwd", xs[i].data_ptr(), g.data_ptr(),
                 dst.data_ptr(), dz.data_ptr(), h.data_ptr(), part.data_ptr(),
                 frags[i].data_ptr(), bd.data_ptr(),
                 *(d[k].data_ptr() for k in STACK_KEYS), n_part, b, t, c,
                 st["wd"].shape[0], int(st["dilation"]), mode, slope, dev, stream)
        _count(c, False)
        dstacks[i] = _stack_grads(st, d)
        g, n_out = dst, n_out + 1
    return g, dstacks, dfinal


def _grad_buffers(st, c: int, device) -> dict:
    d = {k: torch.empty(st[k].shape, device=device) for k in ("wd", "w1", "ws")}
    d.update({k: torch.empty(c, device=device) for k in ("bd", "b1", "bs")})
    return d


def _stack_grads(st, d) -> dict:
    return {k: None if k[0] == "b" and st[k] is None else d[k] for k in STACK_KEYS}


def _backward_bf16(x, stacks, final, slope, pad_mode, dy, fwd_split):
    """K7's bf16-resident mode on the card (csrc/melgan_stack_bwd_bf16.cu):
    K6's bf16 mode re-runs the stage from x on the forward's tiles
    (``fwd_split``, ``melgan_stack.kernel_weights_bf16``; made here when not
    given), keeping every stack's input and the final conv's output in
    float32; then one ``melgan_outconv_bwd_bf16`` call and one
    ``melgan_stack_bwd_bf16`` call per stack in reverse, on the same tiles.
    The cotangent between them is bf16 with the float32 column sums of its
    unrounded rows per tile (``gsum``; the stage's dy has none: the first
    stack's call sums it); the stage's dx is bf16."""
    b, t, c = x.shape
    out_ch = c if final is None else final[0].shape[-1]
    tiles, biases = kernel_weights_bf16(stacks) if fwd_split is None else fwd_split
    xs = [x]
    if final is None:
        _run_cuda_bf16(x, stacks[:-1], None, slope, pad_mode, xs, (tiles[:-1], biases[:-1]),
                       keep_f32=True)
    else:
        y = _run_cuda_bf16(x, stacks, final, slope, pad_mode, xs, (tiles, biases),
                           keep_f32=True)
    lib = build.load()
    dev, stream = build.launch_target(x)
    mode = _MODES[pad_mode][1]
    queries = [lib.query("melgan_stack_bwd_bf16_part_floats", b, t, c, st["wd"].shape[0],
                         int(st["dilation"])) for st in stacks]
    if final is not None:
        kf = final[0].shape[0]
        queries.append(lib.query("melgan_outconv_bwd_bf16_part_floats", b, t, c, out_ch, kf))
    if min(queries) < 0:
        raise ValueError(f"(B, T, C) = ({b}, {t}, {c}) needs too large a partial buffer")
    n_part = max(queries)
    rows = lib.query("melgan_bf16_sum_rows", b, t, c, 0)
    rows_f = lib.query("melgan_bf16_sum_rows", b, t, c, 1) if final is not None else 0
    # float32 scratch in one piece: the kernels' partial buffer, two sets of
    # the stacks' column sums (in turn) and the final conv's
    part, *sums = torch.empty(n_part + (2 * rows + rows_f) * c, device=x.device).split(
        [n_part, rows * c, rows * c, rows_f * c])
    sums = [v.view(-1, c) for v in sums]
    cot = [torch.empty_like(x) for _ in range(2)]  # bf16 cotangents, in turn
    grads = _grad_views(stacks, final, x.device)
    g, gsum, gsum_rows = dy, None, 0
    dfinal = None
    if final is not None:
        fw, fb = final
        dw, db = grads[-1]
        w = _bf(fw.detach()).contiguous()  # held until the launch is queued
        g, gsum, gsum_rows = cot[0], sums[2], rows_f
        lib.call("melgan_outconv_bwd_bf16", xs[-1].data_ptr(), y.data_ptr(), dy.data_ptr(),
                 g.data_ptr(), gsum.data_ptr(), part.data_ptr(), w.data_ptr(), dw.data_ptr(),
                 db.data_ptr(), n_part, b, t, c, out_ch, kf, mode, slope, dev, stream)
        _count(c, True)
        dfinal = (dw, None if fb is None else db)
    # bf16 scratch in one piece: dz, h = leaky(z), and the weight gradients'
    # operands bf16(leaky(x)) and bf16(x)
    dz, h, xl, xb = torch.empty((4, b, t, c), device=x.device, dtype=x.dtype).unbind()
    # x's signs for dx, a byte per 8 channels, the rows rounded up to the
    # kernels' 128-row tiles
    xsign = torch.empty(b * -(-t // 128) * 128 * c // 8, device=x.device, dtype=torch.uint8)
    slope_x = mma_bf16.slope_of(slope)
    dstacks = [None] * len(stacks)
    for i in reversed(range(len(stacks))):
        st = stacks[i]
        dst = cot[1] if g is cot[0] else cot[0]
        dxsum = None if i == 0 else sums[1] if gsum is sums[0] else sums[0]
        d = grads[i]
        lib.call("melgan_stack_bwd_bf16", xs[i].data_ptr(), g.data_ptr(),
                 None if gsum is None else gsum.data_ptr(), gsum_rows, dst.data_ptr(),
                 None if dxsum is None else dxsum.data_ptr(), dz.data_ptr(), h.data_ptr(),
                 xl.data_ptr(), xb.data_ptr(), xsign.data_ptr(), part.data_ptr(), n_part,
                 tiles[i].data_ptr(),
                 biases[i][0].data_ptr(), *(d[k].data_ptr() for k in STACK_KEYS), b, t, c,
                 st["wd"].shape[0], int(st["dilation"]), mode, slope,
                 slope_x if i == 0 else slope, int(i == 0), dev, stream)
        _count(c, True)
        dstacks[i] = _stack_grads(st, d)
        g, gsum, gsum_rows = dst, dxsum, rows
    return g, dstacks, dfinal


def _grad_views(stacks, final, device) -> list:
    """Every stack's gradient buffers ({key: tensor}, as ``_grad_buffers``)
    and then, with ``final``, the final conv's (dw, db), in a few
    allocations: one per kind of weight where the stacks' kernel sizes
    agree (the views by ``unbind``, one op each)."""
    if len({st["wd"].shape for st in stacks}) > 1:
        out = [_grad_buffers(st, st["wd"].shape[-1], device) for st in stacks]
    else:
        n = len(stacks)
        k, c = stacks[0]["wd"].shape[0], stacks[0]["wd"].shape[-1]
        wd = torch.empty((n, k, c, c), device=device).unbind()
        w1, ws = torch.empty((2, n, 1, c, c), device=device).unbind()
        bd, b1, bs = torch.empty((3, n, c), device=device).unbind()
        out = [dict(zip(STACK_KEYS, v)) for v in zip(wd, bd, w1.unbind(), b1, ws.unbind(), bs)]
    if final is not None:
        out.append((torch.empty(final[0].shape, device=device),
                    torch.empty(final[0].shape[-1], device=device)))
    return out


def _count(c: int, bf16: bool) -> None:
    melgan_stacks_backward.launches += 1
    melgan_stacks_backward.bf16_launches += int(bf16)
    by_width = melgan_stacks_backward.launches_by_width
    by_width[c] = by_width.get(c, 0) + 1


melgan_stacks_backward.launches = 0
melgan_stacks_backward.bf16_launches = 0
melgan_stacks_backward.launches_by_width = {}


class melgan_stacks_train(torch.autograd.Function):  # noqa: N801 (JAX name)
    """Differentiable stage: (x, (dilations, has_final, slope, pad_mode),
    *every stack's weights in ``STACK_KEYS`` order, then the final conv's
    (w, b) when there is one) -> the stage's output."""

    @staticmethod
    def forward(ctx, x, meta, *weights):
        ctx.meta = meta
        ctx.save_for_backward(x, *weights)
        ctx.split = None
        stacks, final = _unflatten(meta, weights)
        slope, pad_mode = meta[2], meta[3]
        bf16 = x.dtype == torch.bfloat16
        if x.device.type == "cpu":
            fn = melgan_stacks_reference_bf16 if bf16 else melgan_stacks_reference
            return fn(x, stacks, final=final, slope=slope, pad_mode=pad_mode)
        _check_cuda_inputs(x, stacks, final, pad_mode)
        # the backward's re-run reads the forward's weights too
        if bf16:
            ctx.split = kernel_weights_bf16(stacks)
            return _run_cuda_bf16(x, stacks, final, slope, pad_mode, split=ctx.split)
        ctx.split = kernel_weights(stacks)
        return _run_cuda(x, stacks, final, slope, pad_mode, split=ctx.split)

    @staticmethod
    def backward(ctx, dy):
        x, *weights = ctx.saved_tensors
        stacks, final = _unflatten(ctx.meta, weights)
        dx, dstacks, dfinal = melgan_stacks_backward(
            x, stacks, final, ctx.meta[2], ctx.meta[3], dy.contiguous(), ctx.split)
        grads = [d[k] for d in dstacks for k in STACK_KEYS] + list(dfinal or ())
        # each gradient in its input's type, as JAX's _core_bwd casts them
        grads = [None if g is None else g.to(w.dtype) for g, w in zip(grads, weights)]
        return (dx.to(x.dtype), None, *grads)


def _unflatten(meta, weights):
    dilations, has_final = meta[0], meta[1]
    stacks = [dict(zip(STACK_KEYS, weights[6 * i:6 * i + 6]), dilation=d)
              for i, d in enumerate(dilations)]
    final = tuple(weights[6 * len(dilations):]) if has_final else None
    return stacks, final


def fused_melgan_stacks_train(x, stacks, *, final=None, slope: float = 0.2,
                              pad_mode: str = "reflect", t_tile: int = 512):
    """Differentiable ResidualStacks of one stage, then optionally the
    trailing act -> conv -> tanh: x (B, T, C) -> (B, T, C), or (B, T,
    out); the values of ``fused_melgan_stacks``. ``t_tile`` is the TPU
    kernel's tile, accepted for config compatibility and without effect."""
    _pad_mode(pad_mode)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_melgan_stacks_train: unsupported device {x.device}")
    meta = (tuple(int(st["dilation"]) for st in stacks), final is not None,
            float(slope), pad_mode)
    weights = [st[k] for st in stacks for k in STACK_KEYS] + list(final or ())
    return melgan_stacks_train.apply(x, meta, *weights)

