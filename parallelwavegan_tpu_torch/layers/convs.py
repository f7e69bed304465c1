"""Weight- or spectrally normalised convolutions (PyTorch, (B, C, T) and
(B, C, H, W) layouts).

Counterpart of parallelwavegan_tpu/layers/convs.py:78-341. Weight norm is
the legacy ``torch.nn.utils.weight_norm`` at dim 0, which keeps upstream's
``weight_g``/``weight_v`` state-dict keys. On torch's native layouts dim 0
is the output channel of a conv and the input channel of a transposed
conv, the same norm groups as the JAX package. For decode the norm is
folded into a plain weight (``remove_weight_norm``), as upstream does. On
bf16 parameters (mixed precision's cast copies) the weight is JAX's
formula in bf16, g * v / (|v| + 1e-12) (:97-105), whose roundings differ
from torch's v * (g / |v|) by a scale of each output channel.

Spectral norm (``apply_spectral_norm``) computes what the JAX package's
``_NormalizedKernel`` computes (:106-142) under upstream's keys
``weight_orig``, ``weight_u`` and ``weight_v``: the weight reshaped to
(dim0, -1), one power iteration (v <- W^T u / |W^T u|, u <- W v / |W v|,
each norm plus 1e-12) on every train-mode forward, with or without grad,
none in eval mode, and the weight W / (u . W v + 1e-12) with u and v held
constant, so the gradient reaches W through sigma as well. JAX starts its
iteration from ``jax.random.key(W.shape[1])`` and runs one at init; the
port runs that one at init from the module's generator, so the two starts
differ and tests carry (u, v) across.

Initialisation follows the JAX package: torch's default
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases, or N(0, std)
weights where the caller asks for it (the Parallel WaveGAN modules take
``kaiming_normal_relu_std`` and zero biases,
parallelwavegan_tpu/layers/residual_block.py:26-40; MelGAN takes N(0,
0.02) for every conv and deconv with the default uniform biases, the JAX
``normal_init(0.02)`` kernel and ``torch_conv_init`` bias); every draw
comes from the explicit ``torch.Generator`` passed in.

``get_pad`` builds the three pad layers MelGAN reaches by name, as
upstream's ``getattr(torch.nn, pad)(amount, **pad_params)`` does, so that
a flat ``nn.Sequential`` keeps upstream's indices. ``CausalConv1d`` and
``CausalConvTranspose1d`` are the causal MelGAN's convs under upstream's
keys (``conv.*``, ``deconv.*``): the first pads (K - 1) * dilation on the
left only in the given pad mode (the JAX package's causal pad,
parallelwavegan_tpu/layers/residual_stack.py:95-97; upstream pads both
sides and trims, which gives the same output), the second replicates one
frame on the left, runs the full transposed conv and trims ``stride``
samples from both ends (JAX convs.py:281-306).
"""

from __future__ import annotations

import importlib
import math
import warnings

import torch
import torch.nn.functional as F
from torch import nn


PAD_MODES = {  # upstream pad layer -> the JAX package's jnp.pad mode
    "ReflectionPad1d": "reflect",
    "ReplicationPad1d": "edge",
    "ConstantPad1d": "constant",
}


def get_pad(name: str, amount: int, params: dict | None = None) -> nn.Module:
    """Upstream's pad layer ``name`` of ``amount`` samples per side.
    ``ConstantPad1d`` pads with ``params["value"]``, 0 when not given, as
    the JAX package does (residual_stack.py:58-60)."""
    if name not in PAD_MODES:
        raise ValueError(f"pad {name!r} is not supported")
    params = dict(params or {})
    if name == "ConstantPad1d":
        return nn.ConstantPad1d(amount, params.get("value", 0.0))
    return getattr(nn, name)(amount, **params)


def kaiming_normal_relu_std(fan_in: int) -> float:
    """Std of torch's ``kaiming_normal_(nonlinearity='relu')``: sqrt(2/fan_in)."""
    return math.sqrt(2.0 / fan_in)


def _init_(conv: nn.Module, fan_in: int, generator, normal_std,
           zero_bias: bool = False) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        if normal_std is None:
            conv.weight.uniform_(-bound, bound, generator=generator)
        else:
            conv.weight.normal_(0.0, normal_std, generator=generator)
        if conv.bias is not None:
            if zero_bias:
                conv.bias.zero_()
            else:
                conv.bias.uniform_(-bound, bound, generator=generator)


_WeightNorm = importlib.import_module("torch.nn.utils.weight_norm").WeightNorm


def norm_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight norm's weight at dim 0 from (v, g): torch's in float32; on
    bf16 JAX's g * v / (|v| + 1e-12), each op rounded to bf16 as XLA rounds
    it (the squares' sum taken in float32)."""
    if v.dtype != torch.bfloat16:
        return torch._weight_norm(v, g, 0)
    n = (v * v).sum(tuple(range(1, v.dim())), keepdim=True).sqrt()
    return g * v / (n + 1e-12)


class _WeightNormHook(_WeightNorm):
    """torch's legacy weight-norm hook (its keys and its
    ``remove_weight_norm``), computing ``norm_weight``."""

    def compute_weight(self, module: nn.Module) -> torch.Tensor:
        return norm_weight(getattr(module, self.name + "_v"),
                           getattr(module, self.name + "_g"))


def apply_weight_norm(module: nn.Module) -> nn.Module:
    """Legacy weight norm at dim 0 (upstream's ``weight_g``/``weight_v``)."""
    with warnings.catch_warnings():
        # the parametrizations API would rename the keys upstream uses
        warnings.simplefilter("ignore", FutureWarning)
        torch.nn.utils.weight_norm(module, dim=0)
    for hook in module._forward_pre_hooks.values():
        if type(hook) is _WeightNorm:
            hook.__class__ = _WeightNormHook
    return module


def remove_weight_norm(module: nn.Module) -> None:
    """Fold weight norm into plain weights in every submodule."""
    for m in module.modules():
        if hasattr(m, "weight_g"):
            torch.nn.utils.remove_weight_norm(m)


def _normalize(vec: torch.Tensor) -> torch.Tensor:
    return vec / (torch.linalg.vector_norm(vec) + 1e-12)


def _spectral_weight(module: nn.Module, inputs) -> None:
    """Forward pre-hook: ``module.weight`` from ``weight_orig`` and the
    power-iteration vectors, one iteration first in train mode. A bf16
    ``weight_orig`` (mixed precision's cast parameters) is read in float32,
    as JAX promotes bf16 @ float32 (convs.py:140-156): the iteration and
    sigma run in float32 on the bf16 values, (u, v) stay float32, and the
    weight divided by sigma is cast back to bf16 (a float64 one stays float64)."""
    w = module.weight_orig
    acc = torch.promote_types(w.dtype, torch.float32)
    w_mat = w.reshape(w.shape[0], -1).to(acc)
    if module.training:
        with torch.no_grad():
            v = _normalize(w_mat.t() @ module.weight_u)
            u = _normalize(w_mat @ v)
            module.weight_u.copy_(u)
            module.weight_v.copy_(v)
    else:
        # copies: a later train-mode forward updates the buffers in place
        u, v = module.weight_u.clone(), module.weight_v.clone()
    sigma = torch.dot(u, w_mat @ v)
    module.weight = (w.to(acc) / (sigma + 1e-12)).to(w.dtype)


def apply_spectral_norm(module: nn.Module,
                        generator: torch.Generator | None = None) -> nn.Module:
    """Spectral norm of ``module.weight`` at dim 0, under upstream's keys;
    u starts from N(0, 1) draws of ``generator`` and one power iteration
    runs at once, as the JAX package's init runs one."""
    w = module.weight.detach()
    del module._parameters["weight"]
    module.register_parameter("weight_orig", nn.Parameter(w))
    w_mat = w.reshape(w.shape[0], -1)
    u0 = torch.randn(w_mat.shape[0], generator=generator, dtype=w.dtype)
    v = _normalize(w_mat.t() @ _normalize(u0.to(w.device)))
    module.register_buffer("weight_u", _normalize(w_mat @ v))
    module.register_buffer("weight_v", v)
    module.weight = w  # a plain attribute, recomputed before every forward
    module.register_forward_pre_hook(_spectral_weight)
    return module


def _apply_norm(module: nn.Module, use_weight_norm: bool,
                use_spectral_norm: bool, generator) -> None:
    if use_weight_norm and use_spectral_norm:
        raise ValueError("Either use use_weight_norm or use_spectral_norm.")
    if use_weight_norm:
        apply_weight_norm(module)
    elif use_spectral_norm:
        apply_spectral_norm(module, generator)


def effective_weight(conv: nn.Module) -> torch.Tensor:
    """The weight a forward pass would use, recomputed from (g, v)."""
    if hasattr(conv, "weight_g"):
        return norm_weight(conv.weight_v, conv.weight_g)
    return conv.weight


class Conv1d(nn.Conv1d):
    """Conv1d with optional weight or spectral norm. ``padding`` is 'same'
    (zero padding, odd kernel), an int (0: valid), or 'causal' ((K-1)*dilation
    zeros on the left only); ``stride`` and ``groups`` as torch's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 *, dilation: int = 1, padding: int | str = "same",
                 stride: int = 1, groups: int = 1,
                 bias: bool = True, use_weight_norm: bool = True,
                 use_spectral_norm: bool = False,
                 normal_std: float | None = None, zero_bias: bool = False,
                 generator: torch.Generator | None = None):
        if padding == "same":
            pad = (kernel_size - 1) // 2 * dilation
        elif padding == "causal":
            pad = 0
        else:
            pad = int(padding)
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         dilation=dilation, padding=pad, groups=groups, bias=bias)
        self.causal_pad = (kernel_size - 1) * dilation if padding == "causal" else 0
        _init_(self, in_channels // groups * kernel_size, generator, normal_std,
               zero_bias)
        _apply_norm(self, use_weight_norm, use_spectral_norm, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.causal_pad:
            x = F.pad(x, (self.causal_pad, 0))
        return super().forward(x)

    def gather_weight(self) -> torch.Tensor:
        """Effective weight in the JAX gather form (K, Cin, Cout)."""
        return effective_weight(self).permute(2, 1, 0)


class Conv1d1x1(Conv1d):
    """1x1 Conv1d (upstream's ``Conv1d1x1``)."""

    def __init__(self, in_channels: int, out_channels: int, *, bias: bool = True,
                 use_weight_norm: bool = True, normal_std: float | None = None,
                 zero_bias: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__(in_channels, out_channels, 1, padding=0, bias=bias,
                         use_weight_norm=use_weight_norm, normal_std=normal_std,
                         zero_bias=zero_bias, generator=generator)


class ConvTranspose1d(nn.ConvTranspose1d):
    """ConvTranspose1d with torch length math and optional weight norm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, *, padding: int = 0, output_padding: int = 0,
                 bias: bool = True, use_weight_norm: bool = True,
                 normal_std: float | None = None,
                 generator: torch.Generator | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=padding, output_padding=output_padding,
                         bias=bias)
        _init_(self, in_channels * kernel_size, generator, normal_std)
        if use_weight_norm:
            apply_weight_norm(self)

    def gather_weight(self) -> torch.Tensor:
        """Effective weight in the JAX gather form (K, Cin, Cout): torch's
        (Cin, Cout, K) scatter weight flipped along K
        (parallelwavegan_tpu/ops/conv.py:104-141)."""
        return effective_weight(self).permute(2, 0, 1).flip(0)


class Conv2d(nn.Conv2d):
    """Conv2d with optional weight or spectral norm for the period
    discriminators (the JAX package's ``Conv2dP``, :309-341), torch's
    default uniform init; weight norm's ``weight_g`` is (Cout, 1, 1, 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple,
                 *, stride: tuple = (1, 1), padding: tuple = (0, 0),
                 bias: bool = True, use_weight_norm: bool = True,
                 use_spectral_norm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__(in_channels, out_channels, tuple(kernel_size),
                         stride=tuple(stride), padding=tuple(padding), bias=bias)
        _init_(self, in_channels * math.prod(kernel_size), generator, None)
        _apply_norm(self, use_weight_norm, use_spectral_norm, generator)


class CausalConv1d(nn.Module):
    """A valid Conv1d after a left pad of (K - 1) * dilation in ``pad``
    (one of ``PAD_MODES``' layers, with ``pad_params``): length kept."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *,
                 dilation: int = 1, pad: str = "ConstantPad1d",
                 pad_params: dict | None = None, **conv_kw):
        super().__init__()
        if pad not in PAD_MODES:
            raise ValueError(f"pad {pad!r} is not supported")
        mode = {"reflect": "reflect", "edge": "replicate", "constant": "constant"}
        self.mode = mode[PAD_MODES[pad]]
        self.value = (pad_params or {}).get("value", 0.0) if self.mode == "constant" else None
        self.amount = (kernel_size - 1) * dilation
        self.conv = Conv1d(in_channels, out_channels, kernel_size, dilation=dilation,
                           padding=0, **conv_kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.amount:
            x = F.pad(x, (self.amount, 0), mode=self.mode, value=self.value)
        return self.conv(x)


class CausalConvTranspose1d(nn.Module):
    """(B, Cin, T) -> (B, Cout, T * stride + K - 2 * stride)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, **deconv_kw):
        super().__init__()
        self.stride = stride
        self.deconv = ConvTranspose1d(in_channels, out_channels, kernel_size, stride,
                                      **deconv_kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.deconv(F.pad(x, (1, 0), mode="replicate"))
        return y[:, :, self.stride:-self.stride]
