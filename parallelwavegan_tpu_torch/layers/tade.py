"""StyleMelGAN TADE layers (PyTorch, (B, C, T) layout).

Counterpart of parallelwavegan_tpu/layers/tade.py: ``instance_norm_1d``
(torch's InstanceNorm1d without affine: per (batch, channel) over time,
biased variance, eps 1e-5), ``TADELayer`` (normalised x modulated by conv
features of the nearest-upsampled conditioning c) and ``TADEResBlock``
(two TADE layers, each followed by a gated conv with a softmax-over-
channels or sigmoid gate times tanh, plus the upsampled residual). The
submodules are upstream's, so the state-dict keys are
``tade1.aux_conv.0``, ``tade1.gated_conv.0``, ``gated_conv1``,
``tade2.aux_conv.0``, ``tade2.gated_conv.0`` and ``gated_conv2``
(parallelwavegan_tpu/convert/torch_checkpoint.py:267-286). Every conv
carries legacy weight norm unless ``use_weight_norm`` is off, and is
initialised N(0, 0.02) as upstream's ``reset_parameters`` does.

``TADEResBlock.folded_weights`` is the counterpart of the JAX
``collect_weights=True`` path: the effective weights in the gather form
(K, Cin, Cout) that ``ops/kernels/tade_decode.py`` and
``ops/kernels/tade_train.py`` take, detached for decode or in the
autograd graph for training.
"""

from __future__ import annotations

import torch
from torch import nn

from parallelwavegan_tpu_torch.layers.convs import Conv1d
from parallelwavegan_tpu_torch.layers.upsample import stretch_time

INIT_STD = 0.02  # upstream StyleMelGAN's N(0, 0.02) conv weights
GATES = ("softmax", "sigmoid")


def instance_norm_1d(x: torch.Tensor, eps: float = 1e-5, dim: int = -1) -> torch.Tensor:
    """Normalise x over ``dim`` (time) per batch item and channel."""
    var, mean = torch.var_mean(x, dim=dim, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def gate(xa: torch.Tensor, xb: torch.Tensor, gated_function: str,
         dim: int = 1) -> torch.Tensor:
    """softmax over channels (or sigmoid) of xa, times tanh(xb)."""
    if gated_function == "softmax":
        return torch.softmax(xa, dim=dim) * torch.tanh(xb)
    if gated_function == "sigmoid":
        return torch.sigmoid(xa) * torch.tanh(xb)
    raise ValueError(f"{gated_function} is not supported.")


def _conv(cin, cout, k, *, dilation=1, bias=True, use_weight_norm=True,
          generator=None):
    return Conv1d(cin, cout, k, dilation=dilation, bias=bias,
                  use_weight_norm=use_weight_norm, normal_std=INIT_STD,
                  generator=generator)


class TADELayer(nn.Module):
    """x (B, C, T), c (B, aux, T / s) -> (y (B, C, sT), aux_conv(up(c)))."""

    def __init__(self, in_channels: int = 64, aux_channels: int = 80,
                 kernel_size: int = 9, bias: bool = True,
                 upsample_factor: int = 2, upsample_mode: str = "nearest",
                 use_weight_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if upsample_mode != "nearest":
            raise ValueError("only nearest upsampling is supported")
        self.upsample_factor = upsample_factor
        kw = dict(bias=bias, use_weight_norm=use_weight_norm, generator=generator)
        self.aux_conv = nn.Sequential(_conv(aux_channels, in_channels, kernel_size, **kw))
        self.gated_conv = nn.Sequential(
            _conv(in_channels, in_channels * 2, kernel_size, **kw))

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        x = instance_norm_1d(x)
        c = self.aux_conv(stretch_time(c, self.upsample_factor))
        cg1, cg2 = self.gated_conv(c).chunk(2, dim=1)
        return cg1 * stretch_time(x, self.upsample_factor) + cg2, c


class TADEResBlock(nn.Module):
    """x (B, C, T), c (B, aux, T) -> (x (B, C, sT), c (B, C, sT))."""

    def __init__(self, in_channels: int = 64, aux_channels: int = 80,
                 kernel_size: int = 9, dilation: int = 2, bias: bool = True,
                 upsample_factor: int = 2, upsample_mode: str = "nearest",
                 gated_function: str = "softmax", use_weight_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if gated_function not in GATES:
            raise ValueError(f"{gated_function} is not supported.")
        self.gated_function = gated_function
        self.upsample_factor = upsample_factor
        self.dilation = dilation
        kw = dict(bias=bias, use_weight_norm=use_weight_norm, generator=generator)
        tade = dict(in_channels=in_channels, kernel_size=kernel_size,
                    upsample_mode=upsample_mode, **kw)
        self.tade1 = TADELayer(aux_channels=aux_channels, upsample_factor=1, **tade)
        self.gated_conv1 = _conv(in_channels, in_channels * 2, kernel_size, **kw)
        self.tade2 = TADELayer(aux_channels=in_channels,
                               upsample_factor=upsample_factor, **tade)
        self.gated_conv2 = _conv(in_channels, in_channels * 2, kernel_size,
                                 dilation=dilation, **kw)

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        residual = x
        x, c = self.tade1(x, c)
        x = gate(*self.gated_conv1(x).chunk(2, dim=1), self.gated_function)
        x, c = self.tade2(x, c)
        x = gate(*self.gated_conv2(x).chunk(2, dim=1), self.gated_function)
        return stretch_time(residual, self.upsample_factor) + x, c

    def folded_weights(self, differentiable: bool = False) -> dict:
        """The dict ``tade_block_xla`` takes (layers/tade.py:140-165 of the
        JAX package): gather-form weights, zero biases where the convs
        have none, ``scale`` and ``dilation``; ``module`` is this block,
        for the blocks that the fused path's gate leaves out. The weights
        are detached (decode) unless ``differentiable``: then they are
        gathered in the autograd graph, so the gradients that the fused
        train path gives them reach ``weight_g``/``weight_v`` and the
        biases."""

        def conv(m):
            w = m.gather_weight()
            b = torch.zeros_like(w[0, 0]) if m.bias is None else m.bias
            if not differentiable:
                w, b = w.detach(), b.detach()
            return w.contiguous(), b.contiguous()

        out = {"scale": self.upsample_factor, "dilation": self.dilation,
               "module": self}
        for name, m in (("aux1", self.tade1.aux_conv[0]), ("g1", self.tade1.gated_conv[0]),
                        ("gc1", self.gated_conv1), ("aux2", self.tade2.aux_conv[0]),
                        ("g2", self.tade2.gated_conv[0]), ("gc2", self.gated_conv2)):
            out[f"{name}_w"], out[f"{name}_b"] = conv(m)
        return out
