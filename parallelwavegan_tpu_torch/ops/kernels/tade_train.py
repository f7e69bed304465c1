"""The differentiable fused StyleMelGAN TADEResBlock: K8 forward, K9 backward.

Counterpart of parallelwavegan_tpu/ops/pallas_kernels/tade_train.py
(``tade_block_train`` :659, ``_block_bwd`` :674-703,
``fused_tade_blocks_train`` :709). Layout and weight form are those of
``ops/kernels/tade_decode.py``: x (B, T, 64), c (B, T, Ca), a block a dict
of gather-form weights (``WEIGHTS``), ``scale`` and ``dilation``.

``tade_block_train`` is a ``torch.autograd.Function``: its forward is
K8a then K8b on a CUDA tensor and ``tade_block_reference`` on a CPU
tensor, and it saves the JAX residuals x, c, x2 and a (:654). Its backward
is ``tade_block_backward``, in the JAX order: K9b (stage 2), the instance
norm's backward on x2, K9a (stage 1), the instance norm's backward on x
plus the stretch adjoint of dx_out for the residual. For a CUDA tensor
each of K9a and K9b is one re-run of its K8 kernel from the residuals
(keeping the gated conv's input, the modulation's scale and the gate's
pre-activations, csrc/tade.cu's Save; in the bf16 mode csrc/tade_bf16.cu's)
and one call of csrc/tade_bwd.cu
(the transposed convs in one kernel, the weight gradients in a kernel and
its reduce, every product split TF32 on the tensor cores, the weights
split once per call by ``tf32x3.conv_fragments``; in the bf16 mode
csrc/tade_bwd_bf16.cu, the same three kernels on Hopper's warpgroup
products, the weights laid out once per call by
``mma_bf16.tade_conv_wgmma``); the instance norms'
backward and the stretch adjoint are torch reductions between the
launches, as they are XLA glue in JAX (:90-120). For a CPU tensor it is
``tade_block_backward_reference``, autograd through the plain block. A
CUDA tensor never takes the plain path. The TPU lane packing and tiling
(``t_tile``) do not carry over.

A bf16 x runs the kernels' bf16-resident mode, as JAX's
``fused_tade_blocks_train`` turns on ``mxu_bf16`` for one (:776): c and
the cotangents are cast to bf16 (:680-684); K8 and K9 keep activations,
residuals and cotangents bf16 in memory, round every product's operands
to bf16 and sum in float32 (the weights rounded once per call by
``mma_bf16.tade_forward_wgmma`` / ``tade_conv_wgmma``), the
weight gradients float32 until autograd casts them to the weights' dtype
(:702). Its plain versions are autograd through ``tade1_reference_bf16``
and ``tade2_reference_bf16``, which round where JAX's reverse kernels
round; the CPU runs them.
"""

from __future__ import annotations

import torch

from parallelwavegan_tpu_torch.layers.tade import GATES
from parallelwavegan_tpu_torch.ops.kernels import build, mma_bf16
from parallelwavegan_tpu_torch.ops.kernels.tade_decode import _conv as tade_conv
from parallelwavegan_tpu_torch.ops.kernels.tade_decode import (
    C,
    WEIGHT_KEYS,
    _biases,
    _check_cuda_inputs,
    _entry,
    _fragments,
    _ptrs,
    _gate,
    _rb,
    _stats,
    _stretch,
    conv_vjp_bf16,
    fused_tade_blocks,
    gated,
    instance_norm_backward,
    run_module,
    tade1_cuda,
    tade1_reference,
    tade1_reference_bf16,
    tade2_cuda,
    tade2_reference,
    tade2_reference_bf16,
    tade_block_reference,
)
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import conv_fragments

# every weight and bias of a block, in the order tade_block_train takes them
WEIGHTS = tuple(f"{k}{s}" for k in WEIGHT_KEYS for s in ("_w", "_b"))

# ---------------------------------------------------------------------------
# plain versions: autograd through the plain forward
# ---------------------------------------------------------------------------


def _grads(inputs: dict, outputs_of, cotangents) -> dict:
    """Gradients of ``outputs_of(leaves)`` for ``cotangents`` (cast to the
    outputs' dtypes, as JAX casts them to bf16 in the bf16 mode), by the
    leaves' names (zeros for a leaf the outputs do not reach)."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_() for k, v in inputs.items()}
        outs = outputs_of(leaves)
        cots = [g.to(o.dtype) for g, o in zip(cotangents, outs)]
        got = torch.autograd.grad(outs, list(leaves.values()), cots, allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), got)}


def _blk_with(blk, leaves):
    return {**blk, **{k: leaves[k] for k in WEIGHTS if k in leaves}}


def tade1_backward_reference(x, c, blk, gated_function, dx2, da):
    """Plain backward of ``tade1_reference`` (K9a's function; for a bf16 x
    of ``tade1_reference_bf16``) for the cotangents dx2 and da of its
    outputs: (dx, dc, grads of aux1, g1, gc1)."""
    fwd = tade1_reference_bf16 if x.dtype == torch.bfloat16 else tade1_reference
    g = _grads({"x": x, "c": c, **{k: blk[k] for k in WEIGHTS[:6]}},
               lambda v: fwd(v["x"], v["c"], _blk_with(blk, v), gated_function), (dx2, da))
    return g.pop("x"), g.pop("c"), g


def tade2_backward_reference(x, x2, a, blk, gated_function, dout, da2):
    """Plain backward of ``tade2_reference`` (K9b's function; for a bf16 x
    of ``tade2_reference_bf16``) for the cotangents dout and da2 of its
    outputs: (dx, dx2, da, grads of aux2, g2, gc2)."""
    fwd = tade2_reference_bf16 if x.dtype == torch.bfloat16 else tade2_reference
    g = _grads({"x": x, "x2": x2, "a": a, **{k: blk[k] for k in WEIGHTS[6:]}},
               lambda v: fwd(v["x"], v["x2"], v["a"], _blk_with(blk, v), gated_function),
               (dout, da2))
    return g.pop("x"), g.pop("x2"), g.pop("a"), g


def tade_block_backward_reference(x, c, blk, gated_function, dxo, dco):
    """Plain backward of ``tade_block_reference`` (bf16 for a bf16 x) for
    the cotangents dxo and dco of its outputs: (dx, dc, the 12 weight and
    bias grads)."""
    g = _grads({"x": x, "c": c, **{k: blk[k] for k in WEIGHTS}},
               lambda v: tade_block_reference(v["x"], v["c"], _blk_with(blk, v),
                                              gated_function=gated_function),
               (dxo, dco))
    return g.pop("x"), g.pop("c"), g


# ---------------------------------------------------------------------------
# plain versions of the bf16 mode's pieces, fed the kernels' residuals
# ---------------------------------------------------------------------------


def tade1_rerun_reference_bf16(x, c, blk, gated_function, mean, rstd):
    """Plain version of K8a's bf16 re-run (``tade1_rerun_cuda`` on a bf16
    x): (a, y, s, t), a and y bf16, s and t float32."""
    a = _conv_bf16(c, blk["aux1_w"], blk["aux1_b"], 1)
    s, h = _conv_bf16(a, blk["g1_w"], blk["g1_b"], 1).chunk(2, dim=-1)
    y = s * ((x.float() - mean[:, None]) * rstd[:, None]) + h
    t = _conv_bf16(y, blk["gc1_w"], blk["gc1_b"], 1)
    return a.to(torch.bfloat16), y.to(torch.bfloat16), s, t


def tade2_rerun_reference_bf16(x, x2, a, blk, gated_function, mean, rstd):
    """Plain version of K8b's bf16 re-run (``tade2_rerun_cuda`` on a bf16
    x): (a2, y, s, t, ua) at the output rate, ua None at scale 1."""
    sc, d = int(blk["scale"]), int(blk["dilation"])
    ua = _stretch(a, sc)
    a2 = _conv_bf16(ua, blk["aux2_w"], blk["aux2_b"], 1)
    s, h = _conv_bf16(a2, blk["g2_w"], blk["g2_b"], 1).chunk(2, dim=-1)
    y = s * _stretch((x2.float() - mean[:, None]) * rstd[:, None], sc) + h
    t = _conv_bf16(y, blk["gc2_w"], blk["gc2_b"], d)
    return a2.to(torch.bfloat16), y.to(torch.bfloat16), s, t, ua if sc == 2 else None


def _conv_bf16(v, w, b, d):
    """``_ConvBF16``'s forward without its autograd."""
    return tade_conv(_rb(v), _rb(w), b.detach().float(), d)


def stage_backward_reference_bf16(t, dout, sv, xr, mean, rstd, dext, blk, keys, y, ain,
                                  src, scale: int, dilation: int, gated_function: str):
    """Plain version of one call of csrc/tade_bwd.cu's bf16 stage backward
    (``_stage_cuda`` on a bf16 dout), on the same inputs, the re-run's
    residuals among them: (dxn, da', dsrc, weight grads), dxn and dsrc
    bf16, da' and the grads float32. JAX's reverse kernel's roundings
    (tade_train.py:173-208): each transposed conv and weight gradient on
    bf16 operands summed in float32, each bias gradient the float32 sum of
    its unrounded cotangent."""
    aux, g, gc = keys
    with torch.enable_grad():
        tl = t.detach().float().requires_grad_()
        (dT,) = torch.autograd.grad(_gate(tl, gated_function), tl, dout.float())
    xn = _stretch((xr.float() - mean[:, None]) * rstd[:, None], scale)
    dy, dw_gc = conv_vjp_bf16(y, blk[f"{gc}_w"], dT, dilation)
    dG = torch.cat([dy * xn, dy], dim=-1)
    dxn = (dy * sv).to(torch.bfloat16)
    dg, dw_g = conv_vjp_bf16(ain, blk[f"{g}_w"], dG, 1)
    da = dg + dext.float()
    dsrc, dw_aux = conv_vjp_bf16(src, blk[f"{aux}_w"], da, 1)
    grads = {f"{gc}_w": dw_gc, f"{gc}_b": dT.sum(dim=(0, 1)), f"{g}_w": dw_g,
             f"{g}_b": dG.sum(dim=(0, 1)), f"{aux}_w": dw_aux, f"{aux}_b": da.sum(dim=(0, 1))}
    return dxn, da, dsrc.to(torch.bfloat16), grads


def tade1_backward_reference_bf16(x, c, blk, gated_function, dx2, da, rerun=None):
    """K9a's bf16 function as the kernel computes it, from a re-run's
    residuals: ``rerun`` = (a, y, s, t) of ``tade1_rerun_cuda`` (the
    kernel's own, which holds K9a stage by stage: the bf16 chain of a
    second forward would move values by its own roundings) or, None, of
    ``tade1_rerun_reference_bf16``; then ``stage_backward_reference_bf16``
    and the instance norm's backward. (dx, dc, grads of aux1, g1, gc1)."""
    return _backward1(x, c, blk, gated_function, dx2, da, rerun or tade1_rerun_reference_bf16,
                      stage_backward_reference_bf16)


def tade2_backward_reference_bf16(x, x2, a, blk, gated_function, dout, da2, rerun=None):
    """K9b's bf16 function as the kernel computes it, from ``rerun`` =
    (a2, y, s, t, ua) of ``tade2_rerun_cuda`` or, None, of
    ``tade2_rerun_reference_bf16``. (dx, dx2, da, grads of aux2, g2, gc2)."""
    return _backward2(x, x2, a, blk, gated_function, dout, da2,
                      rerun or tade2_rerun_reference_bf16, stage_backward_reference_bf16)


# ---------------------------------------------------------------------------
# glue between the launches (XLA glue in JAX too)
# ---------------------------------------------------------------------------


def stretch_adjoint(z, scale: int):
    """Adjoint of the nearest x``scale`` stretch along time: each group of
    ``scale`` rows summed, in z's dtype (JAX :148-160; bf16 in the bf16
    mode)."""
    if scale == 1:
        return z
    b, rows, c = z.shape
    return z.view(b, rows // scale, scale, c).sum(dim=2)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _stage_cuda(t, dout, sv, xr, mean, rstd, dext, blk, keys, y, ain, src,
                scale: int, dilation: int, gated_function: str):
    """One call of csrc/tade_bwd.cu's tade_stage_bwd or, for a bf16 dout,
    of csrc/tade_bwd_bf16.cu's tade_stage_bwd_bf16: (dxn, da', dsrc, weight
    grads); dxn, da' and dsrc in dout's dtype, the weight grads float32."""
    b, rows, _ = dout.shape
    bf16 = dout.dtype == torch.bfloat16
    lib = build.load()
    dev, stream = build.launch_target(dout)
    entry = _entry("tade_stage_bwd", dout)
    n_part = lib.query(f"{entry}_part_floats", b, rows)
    if n_part < 0:
        raise ValueError(f"(B, L) = ({b}, {rows}) needs too large a partial buffer")
    part = torch.empty(n_part, device=dout.device)
    wide = [torch.empty(b, rows, 2 * C, device=dout.device, dtype=dout.dtype) for _ in range(2)]
    dxn, da, dsrc = (torch.empty_like(dout) for _ in range(3))
    aux, g, gc = keys
    grads = {f"{k}{s}": torch.empty(blk[f"{k}{s}"].shape, device=dout.device)
             for k in keys for s in ("_w", "_b")}
    # the transposed convs' weights split into TF32 hi and lo in fragment
    # order (or rounded to bf16 in wgmma's tiles), held until the launch is
    # queued: a freed one could be reused
    layout = mma_bf16.tade_conv_wgmma if bf16 else conv_fragments
    wts = [layout(blk[f"{k}_w"]) for k in (gc, g, aux)]
    lib.call(entry, t.data_ptr(), dout.data_ptr(), sv.data_ptr(),
             xr.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dext.data_ptr(),
             *(w.data_ptr() for w in wts), y.data_ptr(), ain.data_ptr(), src.data_ptr(),
             wide[0].data_ptr(), wide[1].data_ptr(), dxn.data_ptr(), da.data_ptr(),
             dsrc.data_ptr(),
             *(grads[f"{k}{s}"].data_ptr() for k in (gc, g, aux) for s in ("_w", "_b")),
             part.data_ptr(), n_part, b, rows, scale, dilation,
             GATES.index(gated_function), dev, stream)
    return dxn, da, dsrc, grads


def _check_cotangent(name, v, x, rows):
    build.check_tensor(name, v, x.device, (x.shape[0], rows, C), align=16,
                       dtypes=(x.dtype,))


def tade1_rerun_cuda(x, c, blk, gated_function, mean, rstd):
    """K8a's re-run for K9a (the Save variant of csrc/tade.cu or, for a bf16
    x, of csrc/tade_bf16.cu), from x's statistics mean and rstd: (a, y, s,
    t), the aux conv's output, the gated conv's input (both in x's dtype),
    the modulation's scale (B, T, 64) and the gated conv's pre-activations
    (B, T, 128) (both float32). A bf16 re-run counts in
    ``fused_tade_blocks.bf16_rerun_launches_k8a``."""
    bf16 = x.dtype == torch.bfloat16
    lib = build.load()
    dev, stream = build.launch_target(x)
    a, y = torch.empty_like(x), torch.empty_like(x)
    s = torch.empty(x.shape, device=x.device)
    t = torch.empty(x.shape[0], x.shape[1], 2 * C, device=x.device)
    wf, bias = _fragments(blk, 1, bf16), _biases(blk, 1)  # held until the launch is queued
    lib.call(_entry("tade1", x), x.data_ptr(), c.data_ptr(), mean.data_ptr(),
             rstd.data_ptr(), None, a.data_ptr(), wf.data_ptr(), *_ptrs(bias), y.data_ptr(),
             s.data_ptr(), t.data_ptr(), x.shape[0], x.shape[1],
             GATES.index(gated_function), dev, stream)
    fused_tade_blocks.bf16_rerun_launches_k8a += int(bf16)
    return a, y, s, t


def tade2_rerun_cuda(x, x2, a, blk, gated_function, mean, rstd):
    """K8b's re-run for K9b, from x2's statistics: (a2, y, s, t, ua) at the
    output rate, ua the stretched a at scale 2 (None at scale 1); a2, y and
    ua in x's dtype, s and t float32. A bf16 re-run counts in
    ``fused_tade_blocks.bf16_rerun_launches_k8b``."""
    bf16 = x.dtype == torch.bfloat16
    lib = build.load()
    dev, stream = build.launch_target(x)
    b, t_len, _ = x.shape
    sc = int(blk["scale"])
    a2, y = (torch.empty(b, sc * t_len, C, device=x.device, dtype=x.dtype) for _ in range(2))
    s = torch.empty(b, sc * t_len, C, device=x.device)
    t = torch.empty(b, sc * t_len, 2 * C, device=x.device)
    ua = torch.empty_like(a2) if sc == 2 else None
    wf, bias = _fragments(blk, 2, bf16), _biases(blk, 2)
    lib.call(_entry("tade2", x), x.data_ptr(), x2.data_ptr(), a.data_ptr(),
             mean.data_ptr(), rstd.data_ptr(), None, a2.data_ptr(), wf.data_ptr(),
             *_ptrs(bias),
             y.data_ptr(), s.data_ptr(), t.data_ptr(),
             None if ua is None else ua.data_ptr(), b, t_len, sc, int(blk["dilation"]),
             GATES.index(gated_function), dev, stream)
    fused_tade_blocks.bf16_rerun_launches_k8b += int(bf16)
    return a2, y, s, t, ua


def tade1_backward_cuda(x, c, blk, gated_function, dx2, da):
    """K9a on the card: the stats of x, K8a's re-run, one call of
    tade_stage_bwd and the instance norm's backward. (dx, dc, grads of
    aux1, g1, gc1), those of ``tade1_backward_reference``."""
    _check_cuda_inputs(x, c, blk)
    t_len = x.shape[1]
    _check_cotangent("dx2", dx2, x, t_len)
    _check_cotangent("da", da, x, t_len)
    out = _backward1(x, c, blk, gated_function, dx2, da, tade1_rerun_cuda, _stage_cuda)
    tade_block_backward.launches_k9a += 1
    tade_block_backward.bf16_launches_k9a += int(x.dtype == torch.bfloat16)
    return out


def _backward1(x, c, blk, gated_function, dx2, da, rerun, stage):
    """K9a's steps: x's statistics, the re-run (a function, or its
    outputs), the stage backward and the instance norm's backward."""
    xf = x.float()
    mean, rstd = _stats(xf)
    a, y, s, t = rerun(x, c, blk, gated_function, mean, rstd) if callable(rerun) else rerun
    dxn, _, dc, grads = stage(t, dx2, s, x, mean, rstd, da, blk, WEIGHT_KEYS[:3], y, a, c,
                              1, 1, gated_function)
    return instance_norm_backward(dxn.float(), xf, mean, rstd).to(x.dtype), dc, grads


def tade2_backward_cuda(x, x2, a, blk, gated_function, dout, da2):
    """K9b on the card: the stats of x2, K8b's re-run, one call of
    tade_stage_bwd, the stretch adjoints and the instance norm's backward.
    (dx, dx2, da, grads of aux2, g2, gc2), those of
    ``tade2_backward_reference``."""
    _check_cuda_inputs(x, a, blk)
    build.check_tensor("x2", x2, x.device, x.shape, align=16, dtypes=(x.dtype,))
    t_len = x.shape[1]
    sc, d = int(blk["scale"]), int(blk["dilation"])
    rows = sc * t_len
    _check_cotangent("dout", dout, x, rows)
    _check_cotangent("da2", da2, x, rows)
    out = _backward2(x, x2, a, blk, gated_function, dout, da2, tade2_rerun_cuda, _stage_cuda)
    tade_block_backward.launches_k9b += 1
    tade_block_backward.bf16_launches_k9b += int(x.dtype == torch.bfloat16)
    return out


def _backward2(x, x2, a, blk, gated_function, dout, da2, rerun, stage):
    """K9b's steps: x2's statistics, the re-run (a function, or its
    outputs), the stage backward, the stretch adjoints (of bf16 rows in the
    bf16 mode, as JAX's host glue sums them) and the instance norm's
    backward."""
    sc, d = int(blk["scale"]), int(blk["dilation"])
    x2f = x2.float()
    mean, rstd = _stats(x2f)
    a2, y, s, t, ua = (rerun(x, x2, a, blk, gated_function, mean, rstd) if callable(rerun)
                       else rerun)
    dxn, _, dua, grads = stage(t, dout, s, x2, mean, rstd, da2, blk, WEIGHT_KEYS[3:], y, a2,
                               a if ua is None else ua, sc, d, gated_function)
    dx2 = instance_norm_backward(stretch_adjoint(dxn, sc).float(), x2f, mean,
                                 rstd).to(x.dtype)
    return stretch_adjoint(dout, sc), dx2, stretch_adjoint(dua, sc), grads


# ---------------------------------------------------------------------------
# the block's backward and autograd Function
# ---------------------------------------------------------------------------


def tade_block_backward(x, c, x2, a, blk, gated_function, dxo, dco):
    """(dx, dc, the 12 weight and bias grads) of one block for the
    cotangents dxo and dco of (x_out, c_out), from the residuals x, c, x2
    and a. A CUDA tensor goes through K9b then K9a (float32 or bf16,
    contiguous, width 64, scale 1 or 2, dilation 1-4; anything else
    raises); ``tade_block_backward.launches_k9a`` and ``.launches_k9b``
    count their calls, ``.bf16_launches_k9a`` and ``.bf16_launches_k9b``
    those in the bf16 mode (a bf16 x; dxo and dco are cast to bf16, as JAX
    casts them). A CPU tensor goes through
    ``tade_block_backward_reference``."""
    if gated_function not in GATES:
        raise ValueError(f"{gated_function} is not supported.")
    if x.dtype == torch.bfloat16:
        dxo, dco = dxo.to(x.dtype), dco.to(x.dtype)
    if x.device.type == "cpu":
        return tade_block_backward_reference(x, c, blk, gated_function, dxo, dco)
    if x.device.type != "cuda":
        raise ValueError(f"tade_block_backward: unsupported device {x.device}")
    dx_res, dx2, da, g2 = tade2_backward_cuda(x, x2, a, blk, gated_function, dxo, dco)
    dx, dc, g1 = tade1_backward_cuda(x, c, blk, gated_function, dx2, da)
    return dx + dx_res, dc, {**g1, **g2}


tade_block_backward.launches_k9a = 0
tade_block_backward.launches_k9b = 0
tade_block_backward.bf16_launches_k9a = 0
tade_block_backward.bf16_launches_k9b = 0


class tade_block_train(torch.autograd.Function):  # noqa: N801 (JAX name)
    """Differentiable fused block: (x, c, (scale, dilation, gate), *the
    weights in ``WEIGHTS`` order) -> (x_out, c_out), in x's dtype (bf16:
    the bf16-resident mode, c bf16 too). The gradients come back in the
    inputs' dtypes (the weights' float32 grads cast by autograd, as JAX
    casts them at :702)."""

    @staticmethod
    def forward(ctx, x, c, meta, *weights):
        blk = dict(zip(WEIGHTS, weights), scale=meta[0], dilation=meta[1])
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            x2, a = tade1_reference_bf16(x, c, blk, meta[2])
            out, a2 = tade2_reference_bf16(x, x2, a, blk, meta[2])
        elif x.device.type == "cpu":
            x2, a = tade1_reference(x, c, blk, meta[2])
            out, a2 = tade2_reference(x, x2, a, blk, meta[2])
        else:
            x2, a = tade1_cuda(x, c, blk, meta[2])
            out, a2 = tade2_cuda(x, x2, a, blk, meta[2])
        ctx.meta = meta
        ctx.save_for_backward(x, c, x2, a, *weights)
        return out, a2

    @staticmethod
    def backward(ctx, dxo, dco):
        x, c, x2, a, *weights = ctx.saved_tensors
        scale, dilation, gated_function = ctx.meta
        blk = dict(zip(WEIGHTS, weights), scale=scale, dilation=dilation)
        dx, dc, dw = tade_block_backward(x, c, x2, a, blk, gated_function,
                                         dxo.contiguous(), dco.contiguous())
        return (dx, dc, None, *(dw[k] for k in WEIGHTS))


def fused_tade_blocks_train(x, c, blocks, *, gated_function: str = "softmax",
                            min_fused_t: int = 1024):
    """Differentiable stack of TADEResBlocks, the values of
    ``fused_tade_blocks``: x (B, T0, 64), c (B, T0, Ca) -> (x, c) at T0
    times the product of the scales. Blocks the train gate passes
    (``tade_decode.gated(train=True)``: T >= ``min_fused_t``, T even, scale
    1 or 2, aux width 64) are ``tade_block_train``; the others run their
    module's forward (``blk["module"]``), under autograd as it is. With
    gradients off (the D phase's re-run of G, eval, decode) each gated
    block is K8a then K8b alone. A bf16 x (``mixed_precision``) runs the
    gated blocks in the kernels' bf16-resident mode, c cast to bf16 as JAX
    casts it (:680-683)."""
    if gated_function not in GATES:
        raise ValueError(f"{gated_function} is not supported.")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_tade_blocks_train: unsupported device {x.device}")
    for i, blk in enumerate(blocks):
        if gated(x.shape[1], blk, min_fused_t=min_fused_t, train=True):
            meta = (int(blk["scale"]), int(blk["dilation"]), gated_function)
            if x.dtype == torch.bfloat16:
                c = c.to(torch.bfloat16)
            x, c = tade_block_train.apply(x, c, meta, *(blk[k] for k in WEIGHTS))
        else:
            x, c = run_module(i, blk, x, c)
    return x, c
