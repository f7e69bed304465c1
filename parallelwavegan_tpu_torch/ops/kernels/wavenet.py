"""Fused WaveNet gated layers: a dilation cycle (K3) and one block (K5).

Counterparts of parallelwavegan_tpu/ops/pallas_kernels/wavenet_stack.py
(``wavenet_stack_xla`` :35, ``fused_wavenet_cycle`` :175,
``fused_wavenet_stack`` :199) and wavenet.py (``gated_resblock_xla`` :40,
``fused_gated_resblock`` :280). The public functions keep the JAX layout
and weight form, so a test can feed the same arrays to both packages: x
is (B, T, C_r), c is (B, T, C_a), and a stack's weights are the dict of
stacked per-layer arrays of ``wavenet_stack_xla``: wconv (L, K, C_r, C_g),
bconv (L, C_g), waux (L, C_a, C_g), wskip (L, C_g/2, C_s), bskip (L, C_s),
wres (L, C_g/2, C_r), bres (L, C_r).

For a CUDA tensor the wrappers run the hand-written kernel
(csrc/wavenet.cu, every product split TF32 on the tensor cores), one
launch per layer; K5 is its one-layer call with the causal flag. The
kernel reads each layer's weights split into TF32 hi and lo in the mma
fragments' order (``tf32x3.wavenet_fragments``): a weights dict may carry
that split as ``frag`` (``with_fragments``, which decode's
``prepare_kernels`` calls once), else each call makes it. For a CPU
tensor they run the plain PyTorch versions below. A CUDA tensor never
takes the plain forward. The TPU tiling knobs (``t_tile``) and the
whole-cycle VMEM residency do not carry over. The
stack wrappers are inference-only, as the JAX ``fused_wavenet_stack`` has
no VJP, so a forward that would need gradients raises; the differentiable
cycle is ``ops/kernels/wavenet_train.py`` (K3 forward, K4 backward). The
block (K5) trains as the JAX ``fused_gated_resblock`` does
(wavenet.py:292-313): its backward is autograd of the plain block on the
saved inputs.

``compute_dtype=torch.bfloat16`` is K3's bf16-resident mode, the JAX
``fused_wavenet_stack(..., compute_dtype=jnp.bfloat16)``
(wavenet_stack.py:199, casts at :240-253, bf16 scratch at :291-292), which
the JAX generator runs for ``pallas_stack_bf16``: x (when a call starts),
c and the weights rounded to bf16, the biases and every sum float32, g
rounded to bf16 before [Wskip | Wres], the skip summed in float32 and the
residual rounded to bf16 at every layer; both outputs come back in x's
type. Its plain version is ``wavenet_stack_reference_bf16`` (float32
products of the operands rounded where JAX rounds them). On the card it
is csrc/wavenet_bf16.cu on Hopper's warpgroup products: x stays bf16
through all the layers of a call and c is cast once, the weights are
rounded once into wgmma's tiles (``mma_bf16.wavenet_wgmma``, kept as
``tiles_bf16`` by ``with_tiles_bf16``), and one host call
(``wavenet_stack_bf16``) queues every layer's launch. Bound at PWG v1 (one
10-layer cycle, T = 131,072): 0.114 ms of bf16 products at 989 TFLOP/s
against 89 MB of the cycle's own inputs and outputs (0.027 ms at 3.35
TB/s), so bound by operations; the launch per layer moves about 1.2 GB
(0.36 ms), most of it the float32 skip's read and write, which the TPU
kernel keeps in VMEM for the whole cycle. Inference-only, as in JAX.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from parallelwavegan_tpu_torch.ops.kernels import build, mma_bf16
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import (
    wavenet_depth,
    wavenet_fragments,
)

SQRT_HALF = math.sqrt(0.5)
WEIGHT_KEYS = ("wconv", "bconv", "waux", "wskip", "bskip", "wres", "bres")

# ---------------------------------------------------------------------------
# plain versions (ports of gated_resblock_xla / wavenet_stack_xla)
# ---------------------------------------------------------------------------


def gated_resblock_reference(x, c, conv_kernel, conv_bias, aux_kernel,
                             skip_kernel, skip_bias, res_kernel, res_bias, *,
                             dilation: int, causal: bool):
    """Plain gated block: (residual_out (B, T, C_r), skip_out (B, T, C_s))."""
    k = conv_kernel.shape[0]
    pad = (k - 1) * dilation
    left = pad if causal else pad // 2
    xp = F.pad(x.transpose(1, 2), (left, pad - left))
    z = F.conv1d(xp, conv_kernel.permute(2, 1, 0), conv_bias,
                 dilation=dilation).transpose(1, 2)
    if c is not None and aux_kernel is not None:
        z = z + c @ aux_kernel
    half = z.shape[-1] // 2
    g = torch.tanh(z[..., :half]) * torch.sigmoid(z[..., half:])
    s = g @ skip_kernel
    if skip_bias is not None:
        s = s + skip_bias
    r = g @ res_kernel
    if res_bias is not None:
        r = r + res_bias
    return (r + x) * SQRT_HALF, s


def wavenet_stack_reference(x, c, weights, dilations):
    """Plain sequence of gated blocks -> (x_out, skip_sum)."""
    skips = 0.0
    for layer, d in enumerate(dilations):
        x, s = gated_resblock_reference(
            x, c, *(weights[k][layer] for k in WEIGHT_KEYS),
            dilation=int(d), causal=False)
        skips = skips + s
    return x, skips


_bf = mma_bf16.rounded


def wavenet_stack_reference_bf16(x, c, weights, dilations, sum_dtype=torch.float32,
                                 round_g: bool = True):
    """Plain version of K3's bf16-resident mode (the JAX ``_kernel`` with
    ``compute_dtype=bfloat16``, wavenet_stack.py:59-172, whose casts it
    copies) -> (x_out, skip_sum), both in x's type: x, c and the weights
    wconv, waux, wskip, wres rounded to bf16, their products exact and
    summed in ``sum_dtype`` (float32 as JAX; float64 measures how far the
    order of the sums moves the result), the biases added in float32; per
    layer g = tanh(z_t) sigmoid(z_s) rounded to bf16, the skip summed in
    float32 and the new residual ((g . Wres + bres + x) sqrt(1/2)) rounded
    to bf16. Rows outside [0, T) read as zero at every layer. ``round_g``
    False leaves g unrounded: a control that a check of the bf16 mode must
    reject."""
    wd = {k: _bf(weights[k].float()).to(sum_dtype) for k in ("wconv", "waux", "wskip", "wres")}
    xv, cv = _bf(x.float()), _bf(c.float()).to(sum_dtype)
    skips = 0.0
    for layer, d in enumerate(dilations):
        wconv = wd["wconv"][layer]
        pad = (wconv.shape[0] - 1) * int(d)
        xp = F.pad(xv.to(sum_dtype).transpose(1, 2), (pad // 2, pad - pad // 2))
        z = F.conv1d(xp, wconv.permute(2, 1, 0), dilation=int(d)).transpose(1, 2)
        z = (z.float() + weights["bconv"][layer].float()).to(sum_dtype)
        z = (z + cv @ wd["waux"][layer]).float()
        half = z.shape[-1] // 2
        g = torch.tanh(z[..., :half]) * torch.sigmoid(z[..., half:])
        g = (_bf(g) if round_g else g).to(sum_dtype)
        # JAX's association: (skip_acc + g . Wskip) + bskip
        skips = (skips + (g @ wd["wskip"][layer]).float()) + weights["bskip"][layer].float()
        r = (g @ wd["wres"][layer]).float() + weights["bres"][layer].float()
        xv = _bf((r + xv) * SQRT_HALF)
    return xv.to(x.dtype), skips.to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_WIDTHS = (16, 64)  # residual = skip = gate / 2, instantiated in wavenet.cu


def _check_cuda_inputs(x, c, weights, n_layers, bf16: bool = False) -> None:
    """bf16: the bf16 mode's operands, x and c bf16, the weights float32 or
    bf16 (rounded either way) beside float32 biases and bf16
    ``tiles_bf16``."""
    if x.dim() != 3 or c is None or c.dim() != 3:
        raise ValueError("x and c must be (B, T, C) tensors")
    b, t, ch = x.shape
    ca = c.shape[2]
    if ch not in _WIDTHS:
        raise ValueError(f"residual width {ch} is not one of {_WIDTHS}")
    if weights["wconv"].dim() != 4:
        raise ValueError("wconv must be (L, K, C_r, C_g)")
    k = weights["wconv"].shape[1]
    shapes = {
        "wconv": (n_layers, k, ch, 2 * ch), "bconv": (n_layers, 2 * ch),
        "waux": (n_layers, ca, 2 * ch), "wskip": (n_layers, ch, ch),
        "bskip": (n_layers, ch), "wres": (n_layers, ch, ch),
        "bres": (n_layers, ch),
    }
    # x and the weights' split are copied in 16-byte pieces, the biases
    # read in 8-byte pieces
    act = build.BF16 if bf16 else (torch.float32,)
    build.check_tensor("x", x, x.device, (b, t, ch), align=16, dtypes=act)
    build.check_tensor("c", c, x.device, (b, t, ca), align=4, dtypes=act)
    for key in WEIGHT_KEYS:
        if weights.get(key) is None:
            raise ValueError(f"the kernel needs {key} (bias=True, aux input)")
        kinds = build.EITHER if bf16 and key[0] == "w" else (torch.float32,)
        build.check_tensor(key, weights[key], x.device, shapes[key], align=8,
                           dtypes=kinds)
    if bf16:
        if weights.get("tiles_bf16") is not None:
            build.check_tensor(
                "tiles_bf16", weights["tiles_bf16"], x.device,
                (n_layers, mma_bf16.wavenet_depth(ch, ca, k) * 2 * ch), align=16,
                dtypes=build.BF16)
    elif weights.get("frag") is not None:
        build.check_tensor("frag", weights["frag"], x.device,
                           (n_layers, wavenet_depth(ch, ca, k) // 8, ch // 4, 32, 4),
                           align=16)


def with_fragments(weights):
    """``weights`` (a stack's, or one block's unstacked) with the split the
    kernel reads (``frag``), for a decode that runs the same weights many
    times. The split is as stale as the weights it was made from: make it
    again after they change."""
    if weights["wconv"].dim() == 4:
        return dict(weights, frag=wavenet_fragments(weights))
    one = {k: weights[k][None] for k in ("wconv", "waux", "wskip", "wres")}
    return dict(weights, frag=wavenet_fragments(one)[0])


def with_tiles_bf16(weights):
    """``weights`` (a stack's) with the bf16 mode's weights rounded to bf16
    in the kernel's tiles (``tiles_bf16``, ``mma_bf16.wavenet_wgmma``), for
    a decode that runs the same weights many times; as stale as the weights
    it was made from."""
    return dict(weights, tiles_bf16=mma_bf16.wavenet_wgmma(weights))


def _run_layers(x, c, weights, dilations, causal: bool, counter, outs=None):
    """One kernel launch per layer on the current stream; x ping-pongs
    between two buffers, skip is written by the first layer and added to
    by the others. The weights' split is ``weights["frag"]`` where given,
    else made here, once for all the layers. Given a list ``outs``, each
    layer writes a buffer of its own and appends it to ``outs``.
    ``counter.launches`` counts the launches."""
    lib = build.load()
    dev, stream = build.launch_target(x)
    b, t, ch = x.shape
    ca, k = c.shape[2], weights["wconv"].shape[1]
    frag = weights.get("frag")
    if frag is None:  # held until the launches are queued
        frag = wavenet_fragments(weights)
    skip = torch.empty_like(x, dtype=torch.float32)
    n_bufs = len(dilations) if outs is not None else min(2, len(dilations))
    bufs = [torch.empty_like(x) for _ in range(n_bufs)]
    src = x
    for layer, d in enumerate(dilations):
        dst = bufs[layer % n_bufs]
        lib.call("wavenet_layer", src.data_ptr(), c.data_ptr(), dst.data_ptr(),
                 skip.data_ptr(), frag[layer].data_ptr(),
                 *(weights[key][layer].data_ptr()
                   for key in ("bconv", "bskip", "bres")),
                 b, t, ch, ca, k, int(d), int(causal), int(layer > 0), dev,
                 stream)
        counter.launches += 1
        src = dst
    if outs is not None:
        outs.extend(bufs)
    return src, skip


def _run_stack_bf16(x, c, weights, dilations, counter):
    """The bf16 mode's layers (x and c bf16, the skip float32) as one host
    call, ``wavenet_stack_bf16``, which queues one launch per layer on the
    current stream, x ping-ponging between two buffers; on
    ``weights["tiles_bf16"]`` or the tiles made here. ``counter.bf16_calls``
    counts the host calls; ``counter.launches`` and
    ``counter.bf16_launches`` the launches."""
    lib = build.load()
    dev, stream = build.launch_target(x)
    b, t, ch = x.shape
    ca, k = c.shape[2], weights["wconv"].shape[1]
    tiles = weights.get("tiles_bf16")
    if tiles is None:  # held until the launches are queued
        tiles = mma_bf16.wavenet_wgmma(weights)
    n = len(dilations)
    skip = torch.empty_like(x, dtype=torch.float32)
    bufs = [torch.empty_like(x) for _ in range(min(2, n))]
    dils = (ctypes.c_int * n)(*(int(d) for d in dilations))
    lib.call("wavenet_stack_bf16", x.data_ptr(), c.data_ptr(), bufs[0].data_ptr(),
             bufs[-1].data_ptr(), skip.data_ptr(), tiles.data_ptr(),
             *(weights[key].data_ptr() for key in ("bconv", "bskip", "bres")),
             dils, n, b, t, ch, ca, k, dev, stream)
    counter.bf16_calls += 1
    counter.launches += n
    counter.bf16_launches += n
    return bufs[(n - 1) % 2], skip


def _device_of(x, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def fused_wavenet_stack(x, c, weights, dilations, compute_dtype=torch.float32):
    """Gated layers of one dilation cycle -> (x_out (B, T, C_r), skip_sum
    (B, T, C_s)).

    A CUDA tensor goes through the hand-written kernel, one launch per
    layer (C_r = C_s = C_g / 2 in {16, 64}, any C_a and kernel size;
    float32, contiguous; the split ``frag`` of ``with_fragments`` used
    where the dict has it) and raises on anything it does not take; a CPU
    tensor goes through ``wavenet_stack_reference``.
    ``compute_dtype=torch.bfloat16`` is the bf16-resident mode (module
    docstring), one host call for all the layers: x float32 or bf16, the
    outputs in x's type, the rounded weights ``tiles_bf16`` of
    ``with_tiles_bf16`` used where the dict has them; on a CPU tensor
    ``wavenet_stack_reference_bf16``. ``fused_wavenet_stack.launches``
    counts the kernel launches, ``.bf16_launches`` those of the bf16 mode
    and ``.bf16_calls`` its host calls. ``build.check_grid``
    refuses, on any device, a batch or a length that the kernel's grid
    cannot take.
    """
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    bf16 = compute_dtype == torch.bfloat16
    build.refuse_training("the fused WaveNet stack (K3, backward K4)",
                          [x, c, *weights.values()])
    if x.dim() == 3:
        build.check_grid("fused_wavenet_stack", x.shape[0], x.shape[1])
    if _device_of(x, "fused_wavenet_stack") == "cpu":
        if bf16:
            return wavenet_stack_reference_bf16(x, c, weights, dilations)
        return wavenet_stack_reference(x, c, weights, dilations)
    if not bf16:
        _check_cuda_inputs(x, c, weights, len(dilations))
        return _run_layers(x, c, weights, dilations, False, fused_wavenet_stack)
    xb, cb = x.to(torch.bfloat16).contiguous(), c.to(torch.bfloat16).contiguous()
    _check_cuda_inputs(xb, cb, weights, len(dilations), bf16=True)
    xo, skip = _run_stack_bf16(xb, cb, weights, dilations, fused_wavenet_stack)
    return xo.to(x.dtype), skip.to(x.dtype)


fused_wavenet_stack.launches = 0
fused_wavenet_stack.bf16_launches = 0
fused_wavenet_stack.bf16_calls = 0


def fused_wavenet_cycle(x, c, weights, dilations, *,
                        max_layers_per_call: int = 10, compute_dtype=torch.float32):
    """A dilation cycle as calls of at most ``max_layers_per_call`` layers
    of ``fused_wavenet_stack``, skips summed between calls as the JAX
    package does (wavenet_stack.py:175-196), in ``compute_dtype``. The
    generator does not chunk: it runs all its layers through one
    ``fused_wavenet_stack`` call."""
    skips = None
    for s in range(0, len(dilations), max_layers_per_call):
        e = min(s + max_layers_per_call, len(dilations))
        chunk = {k: v[s:e] for k, v in weights.items()}
        x, sk = fused_wavenet_stack(x, c, chunk, dilations[s:e], compute_dtype)
        skips = sk if skips is None else skips + sk
    return x, skips


class _GatedResblock(torch.autograd.Function):
    """(x, c, dilation, causal, frag, *block weights in ``WEIGHT_KEYS``
    order) -> (residual_out, skip_out): the kernel (or, on the CPU, the
    plain block) forward, on the weights' split ``frag`` (made here when
    None); the backward is autograd of ``gated_resblock_reference`` on the
    saved inputs, the JAX ``_bwd`` (wavenet.py:305-310)."""

    @staticmethod
    def forward(ctx, x, c, dilation, causal, frag, *args):
        ctx.block = (dilation, causal)
        ctx.save_for_backward(x, c, *args)
        if x.device.type == "cpu":
            return gated_resblock_reference(x, c, *args, dilation=dilation,
                                            causal=causal)
        weights = {k: None if v is None else v[None]
                   for k, v in zip(WEIGHT_KEYS, args)}
        weights["frag"] = None if frag is None else frag[None]
        _check_cuda_inputs(x, c, weights, 1)
        return _run_layers(x, c, weights, (dilation,), causal,
                           fused_gated_resblock)

    @staticmethod
    def backward(ctx, dres, dskip):
        dilation, causal = ctx.block
        leaves = [None if v is None else v.detach().requires_grad_()
                  for v in ctx.saved_tensors]
        with torch.enable_grad():
            out = gated_resblock_reference(*leaves, dilation=dilation,
                                           causal=causal)
            used = [v for v in leaves if v is not None]
            grads = iter(torch.autograd.grad(out, used, (dres, dskip),
                                             allow_unused=True))
        dx, dc, *dw = (None if v is None else next(grads) for v in leaves)
        return (dx, dc, None, None, None, *dw)


def fused_gated_resblock(x, c, conv_kernel, conv_bias, aux_kernel,
                         skip_kernel, skip_bias, res_kernel, res_bias,
                         dilation: int = 1, causal: bool = False, fragments=None):
    """One gated block -> (residual_out, skip_out), causal or not.

    A CUDA tensor goes through the kernel's one-layer call (the widths of
    ``fused_wavenet_stack``; biases and c required) on ``fragments``, the
    block's split (``wavenet_fragments`` of its weights stacked as one
    layer, first axis dropped), made per call when None; a CPU tensor goes
    through ``gated_resblock_reference``. Differentiable in every input
    but ``fragments``: the backward is autograd of the plain block, as in
    JAX. ``fused_gated_resblock.launches`` counts the kernel launches.
    ``build.check_grid`` refuses, on any device, a batch or a length that
    the kernel's grid cannot take.
    """
    _device_of(x, "fused_gated_resblock")
    if x.dim() == 3:
        build.check_grid("fused_gated_resblock", x.shape[0], x.shape[1])
    return _GatedResblock.apply(x, c, int(dilation), bool(causal), fragments,
                                conv_kernel, conv_bias, aux_kernel, skip_kernel,
                                skip_bias, res_kernel, res_bias)


fused_gated_resblock.launches = 0
