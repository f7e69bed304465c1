"""The differentiable fused WaveNet cycle: K3 forward, K4 backward.

Counterpart of parallelwavegan_tpu/ops/pallas_kernels/wavenet_stack_train.py
(``wavenet_stack_train`` :337-365, ``fused_wavenet_cycle_train``
:368-387, ``_stack_bwd_pallas`` :187). Layout and weight form are those of
``ops/kernels/wavenet.py``: x (B, T, C_r), c (B, T, C_a) and the dict of
stacked per-layer weights of ``WEIGHT_KEYS``.

``wavenet_stack_train`` is a ``torch.autograd.Function``: its forward is
the K3 kernel (``_run_layers``) on a CUDA tensor, ``wavenet_stack_reference``
on a CPU tensor, and it saves only the chunk's (x, c, weights), as the JAX
``custom_vjp`` does (:346-350), so each call of ``fused_wavenet_cycle_train``
is a recompute checkpoint. On a CUDA tensor it also keeps the weights'
split for K3 (``tf32x3.wavenet_fragments``, made once per forward since the
weights change every step; 1.7 MB for five v1 layers): the backward's
re-run of K3 reads it instead of splitting the same weights again. Its
backward is ``wavenet_stack_backward``: for a CUDA tensor it re-runs K3
from the saved input, keeping every layer's input in device memory, then
walks the layers in reverse through the hand-written K4 kernel (csrc/wavenet_bwd.cu, one ``wavenet_layer_bwd``
call of four CUDA kernels per layer, their products on the tensor cores
in split TF32); for a CPU tensor it runs
``wavenet_stack_backward_reference``. A CUDA tensor never takes the plain
path.

Under mixed precision (a bf16 x) it computes as the JAX package's K3/K4
path does with its default ``compute_dtype`` (float32): the chunk's inputs,
weights and cotangents are widened to float32 and run through the float32
kernels (wavenet_stack_train.py:223-238), the outputs come back in x's
type (wavenet_stack.py:269-271), and dx, dc and the weight gradients in
their inputs' types (:361-362). K3's bf16-resident mode
(``pallas_stack_bf16``) is decode only, as in JAX, which gives it no VJP
and ignores the flag under ``use_pallas_stack_train``: this cycle always
runs float32.
"""

from __future__ import annotations

import torch

from parallelwavegan_tpu_torch.ops.kernels import build
from parallelwavegan_tpu_torch.ops.kernels.wavenet import (
    WEIGHT_KEYS,
    _check_cuda_inputs,
    _device_of,
    _run_layers,
    fused_wavenet_stack,
    wavenet_stack_reference,
    with_fragments,
)


def wavenet_stack_backward_reference(x, c, weights, dilations, dxo, dsk):
    """Plain backward of ``wavenet_stack_reference``: (dx, dc, dweights)
    for the cotangents dxo of x_out and dsk of the skip sum, by autograd."""
    with torch.enable_grad():
        xv = x.detach().requires_grad_()
        cv = c.detach().requires_grad_()
        wv = {k: weights[k].detach().requires_grad_() for k in WEIGHT_KEYS}
        xo, sk = wavenet_stack_reference(xv, cv, wv, dilations)
        grads = torch.autograd.grad(
            (xo, sk), (xv, cv, *(wv[k] for k in WEIGHT_KEYS)), (dxo, dsk),
            allow_unused=True)
    dx, dc, *dw = (torch.zeros_like(v) if g is None else g
                   for g, v in zip(grads, (xv, cv, *(wv[k] for k in WEIGHT_KEYS))))
    return dx, dc, dict(zip(WEIGHT_KEYS, dw))


def wavenet_stack_backward(x, c, weights, dilations, dxo, dsk):
    """(dx, dc, dweights) of one chunk of gated layers for the cotangents
    dxo of x_out and dsk of the skip sum.

    A CUDA tensor goes through K4, one ``wavenet_layer_bwd`` call per layer
    (the widths of ``fused_wavenet_stack``, C_a <= 128, kernel size <= 7;
    float32, contiguous), after K3's re-run of the layer inputs (on
    ``weights["frag"]`` where given), and raises on anything it does not
    take; ``wavenet_stack_backward.launches`` counts those calls. A CPU
    tensor goes through ``wavenet_stack_backward_reference``.
    """
    if _device_of(x, "wavenet_stack_backward") == "cpu":
        return wavenet_stack_backward_reference(x, c, weights, dilations, dxo, dsk)
    n_layers = len(dilations)
    _check_cuda_inputs(x, c, weights, n_layers)
    b, t, ch = x.shape
    ca, k = c.shape[2], weights["wconv"].shape[1]
    if ca > 128:
        raise ValueError(f"aux width {ca} is more than the backward kernel's 128")
    if k > 7:
        raise ValueError(f"kernel size {k} is more than the backward kernel's 7")
    build.check_tensor("dxo", dxo, x.device, x.shape)
    build.check_tensor("dsk", dsk, x.device, x.shape)
    # x_0 .. x_{L-1}: the chunk input and every later layer's input, re-run
    # through K3 (counted in fused_wavenet_stack.launches)
    xs = [x]
    _run_layers(x, c, weights, dilations[:-1], False, fused_wavenet_stack, xs)
    lib = build.load()
    dev, stream = build.launch_target(x)
    n_part = lib.query("wavenet_bwd_part_floats", b, t, ch, ca, k)
    if n_part < 0:
        raise ValueError(f"(B, T) = ({b}, {t}) needs too large a partial buffer")
    part = torch.empty(n_part, device=x.device)
    dz = torch.empty(b, t, 2 * ch, device=x.device)
    g = torch.empty_like(x)
    dc = torch.empty_like(c)
    dw = {key: torch.empty_like(weights[key]) for key in WEIGHT_KEYS}
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    dx_next = dxo
    for i, layer in enumerate(reversed(range(n_layers))):
        dst = bufs[i % 2]
        lib.call("wavenet_layer_bwd", xs[layer].data_ptr(), c.data_ptr(),
                 dx_next.data_ptr(), dsk.data_ptr(), dst.data_ptr(),
                 dc.data_ptr(), dz.data_ptr(), g.data_ptr(), part.data_ptr(),
                 *(weights[key][layer].data_ptr()
                   for key in ("wconv", "bconv", "waux", "wskip", "wres")),
                 *(dw[key][layer].data_ptr() for key in WEIGHT_KEYS),
                 n_part, b, t, ch, ca, k, int(dilations[layer]), int(i > 0),
                 dev, stream)
        wavenet_stack_backward.launches += 1
        dx_next = dst
    return dx_next, dc, dw


wavenet_stack_backward.launches = 0


class wavenet_stack_train(torch.autograd.Function):  # noqa: N801 (JAX name)
    """Differentiable chunk of gated layers: (x, c, dilations, *weights in
    ``WEIGHT_KEYS`` order) -> (x_out, skip_sum)."""

    @staticmethod
    def forward(ctx, x, c, dilations, *weights):
        ctx.dilations = dilations
        ctx.frag = None
        ctx.save_for_backward(x, c, *weights)
        out_type = x.dtype
        x, c, weights = _widened(x, c, weights)
        w = dict(zip(WEIGHT_KEYS, weights))
        if _device_of(x, "wavenet_stack_train") == "cpu":
            outs = wavenet_stack_reference(x, c, w, dilations)
        else:
            _check_cuda_inputs(x, c, w, len(dilations))
            w = with_fragments(w)
            ctx.frag = w["frag"]
            outs = _run_layers(x, c, w, dilations, False, fused_wavenet_stack)
        return tuple(v.to(out_type) for v in outs)

    @staticmethod
    def backward(ctx, dxo, dsk):
        saved = ctx.saved_tensors
        x, c, weights = _widened(saved[0], saved[1], saved[2:])
        dx, dc, dw = wavenet_stack_backward(
            x, c, dict(zip(WEIGHT_KEYS, weights), frag=ctx.frag), ctx.dilations,
            dxo.float().contiguous(), dsk.float().contiguous())
        grads = (dx, dc, *(dw[k] for k in WEIGHT_KEYS))
        # each in its input's type, as JAX's _train_bwd casts them
        return tuple(g.to(v.dtype) for g, v in zip(grads[:2], saved[:2])) + (None,) + tuple(
            g.to(v.dtype) for g, v in zip(grads[2:], saved[2:]))


def _widened(x, c, weights):
    """(x, c, weights) in float32: JAX's K3/K4 compute a bf16 chunk in
    float32 (``compute_dtype``)."""
    if x.dtype != torch.bfloat16:
        return x, c, weights
    return x.float(), c.float(), [w.float() for w in weights]


def fused_wavenet_cycle_train(x, c, weights, dilations, *,
                              max_layers_per_call: int = 10):
    """A dilation cycle as differentiable calls of at most
    ``max_layers_per_call`` layers, skips summed between calls
    (wavenet_stack_train.py:368-387); the chunk boundaries are the
    recompute checkpoints."""
    skips = None
    for s in range(0, len(dilations), max_layers_per_call):
        e = min(s + max_layers_per_call, len(dilations))
        x, sk = wavenet_stack_train.apply(
            x, c, tuple(int(d) for d in dilations[s:e]),
            *(weights[k][s:e] for k in WEIGHT_KEYS))
        skips = sk if skips is None else skips + sk
    return x, skips
