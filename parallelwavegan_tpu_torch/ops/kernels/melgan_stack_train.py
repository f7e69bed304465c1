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
"""

from __future__ import annotations

import torch

from parallelwavegan_tpu_torch.ops.kernels import build
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import stack_fragments
from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
    _MODES,
    _bias,
    _check_cuda_inputs,
    _pad_mode,
    _run_cuda,
    kernel_weights,
    melgan_stacks_reference,
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


def melgan_stacks_backward(x, stacks, final, slope, pad_mode, dy, fwd_split=None):
    """(dx, dstacks, dfinal) of one stage for the cotangent dy of its
    output; a bias that is None gets None. ``fwd_split`` is what K6's
    re-run reads, ``melgan_stack.kernel_weights(stacks)`` as the forward
    made it (made here when not given).

    A CUDA tensor goes through K7 (the widths and pad modes of
    ``fused_melgan_stacks``, stack and final kernels odd up to 7, the final
    conv to at most 4 channels; float32, contiguous) and raises on anything
    it does not take; ``melgan_stacks_backward.launches`` counts one per
    stack and one for ``final``. K6 re-runs the stage from x first (counted
    in ``fused_melgan_stacks.launches``). A CPU tensor goes through
    ``melgan_stacks_backward_reference``.
    """
    _pad_mode(pad_mode)
    if x.device.type == "cpu":
        return melgan_stacks_backward_reference(x, stacks, final, slope,
                                                pad_mode, dy)
    if x.device.type != "cuda":
        raise ValueError(f"melgan_stacks_backward: unsupported device {x.device}")
    _check_cuda_inputs(x, stacks, final, pad_mode)
    b, t, c = x.shape
    out_ch = c if final is None else final[0].shape[-1]
    build.check_tensor("dy", dy, x.device, (b, t, out_ch))
    for i, st in enumerate(stacks):
        if st["wd"].shape[0] > 7:
            raise ValueError(f"stacks[{i}]: K7 takes kernel sizes up to 7")
    if final is not None and (final[0].shape[0] > 7 or out_ch > 4):
        raise ValueError("final: K7 takes kernel sizes up to 7 and at most 4 outputs")
    if not stacks and final is None:
        return dy, [], None
    if dy.data_ptr() % 16:  # the stacks stage their rows in 16-byte pieces
        dy = dy.clone()
    # the input of every stack and of the final conv, re-run through K6;
    # with the final conv its output y too (its backward reads 1 - y^2)
    xs = [x]
    fwd_frags, fwd_biases = kernel_weights(stacks) if fwd_split is None else fwd_split
    if final is None:
        _run_cuda(x, stacks[:-1], None, slope, pad_mode, xs,
                  (fwd_frags[:-1], fwd_biases[:-1]))
    else:
        y = _run_cuda(x, stacks, final, slope, pad_mode, xs, (fwd_frags, fwd_biases))
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
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    g, n_out = dy, 0
    dfinal = None
    if final is not None:
        fw, fb = final
        dw, db = torch.empty_like(fw), torch.empty(out_ch, device=x.device)
        lib.call("melgan_outconv_bwd", xs[-1].data_ptr(), y.data_ptr(),
                 dy.data_ptr(), bufs[0].data_ptr(), part.data_ptr(), fw.data_ptr(),
                 dw.data_ptr(), db.data_ptr(), n_part, b, t, c, out_ch, kf, mode,
                 slope, dev, stream)
        melgan_stacks_backward.launches += 1
        g, n_out = bufs[0], 1
        dfinal = (dw, None if fb is None else db)
    dz, h = torch.empty_like(x), torch.empty_like(x)
    frags = stack_fragments(stacks) if stacks else []
    dstacks = [None] * len(stacks)
    for i in reversed(range(len(stacks))):
        st = stacks[i]
        dst = bufs[n_out % 2]
        d = {k: torch.empty_like(st[k]) for k in ("wd", "w1", "ws")}
        d.update({k: torch.empty(c, device=x.device) for k in ("bd", "b1", "bs")})
        lib.call("melgan_stack_bwd", xs[i].data_ptr(), g.data_ptr(),
                 dst.data_ptr(), dz.data_ptr(), h.data_ptr(), part.data_ptr(),
                 frags[i].data_ptr(), _bias(st["bd"], c, x).data_ptr(),
                 *(d[k].data_ptr() for k in STACK_KEYS), n_part, b, t, c,
                 st["wd"].shape[0], int(st["dilation"]), mode, slope, dev, stream)
        melgan_stacks_backward.launches += 1
        dstacks[i] = {k: None if k[0] == "b" and st[k] is None else d[k]
                      for k in STACK_KEYS}
        g, n_out = dst, n_out + 1
    return g, dstacks, dfinal


melgan_stacks_backward.launches = 0


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
        if x.device.type == "cpu":
            return melgan_stacks_reference(x, stacks, final=final, slope=slope,
                                           pad_mode=pad_mode)
        _check_cuda_inputs(x, stacks, final, pad_mode)
        ctx.split = kernel_weights(stacks)  # the backward's re-run reads it too
        return _run_cuda(x, stacks, final, slope, pad_mode, split=ctx.split)

    @staticmethod
    def backward(ctx, dy):
        x, *weights = ctx.saved_tensors
        stacks, final = _unflatten(ctx.meta, weights)
        dx, dstacks, dfinal = melgan_stacks_backward(
            x, stacks, final, ctx.meta[2], ctx.meta[3], dy.contiguous(), ctx.split)
        grads = [d[k] for d in dstacks for k in STACK_KEYS] + list(dfinal or ())
        return (dx, None, *grads)


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

