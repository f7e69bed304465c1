"""Residual blocks (PyTorch, (B, C, T) layout).

* ``WaveNetResidualBlock``: counterpart of
  parallelwavegan_tpu/layers/residual_block.py:43-238, the gated block of
  Parallel WaveGAN with local conditioning. Keys are upstream's ``conv``,
  ``conv1x1_aux``, ``conv1x1_skip`` and ``conv1x1_out``. With
  ``use_pallas`` and the JAX gate (:69-71: c given, bias on) the block
  runs through ``fused_gated_resblock``, which also trains.
* ``HiFiGANResidualBlock``: counterpart of :241-320, per dilation, act ->
  dilated conv [-> act -> conv] with an additive residual. Submodules are
  ``nn.Sequential(act, conv)`` so the state-dict keys are upstream's
  ``convs1.{m}.1.*`` / ``convs2.{m}.1.*``. With ``use_causal_conv`` (U-Net
  HiFi-GAN's causal MRFs) each conv pads (K - 1) * dilation zeros on the
  left only, the JAX ``padding="causal"``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_tpu_torch.layers.convs import (
    Conv1d,
    Conv1d1x1,
    effective_weight,
    kaiming_normal_relu_std,
)
from parallelwavegan_tpu_torch.ops.kernels.mma_bf16 import slope_of
from parallelwavegan_tpu_torch.ops.kernels.wavenet import (
    WEIGHT_KEYS,
    fused_gated_resblock,
)


class LeakyReLU(nn.LeakyReLU):
    """``torch.nn.LeakyReLU`` that, on a bf16 input (mixed precision),
    multiplies by the slope rounded to bf16, as the JAX package's
    ``negative_slope * x`` does in x's type (layers/convs.py:32-33): the
    product of two bf16 values is exact in float32 and rounded once.
    float32 inputs are torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return F.leaky_relu(x, slope_of(self.negative_slope), self.inplace)


def get_activation(name: str, params: dict | None) -> nn.Module:
    """Upstream builds activations as ``getattr(torch.nn, name)(**params)``
    (LeakyReLU as the subclass above)."""
    if name == "LeakyReLU":
        return LeakyReLU(**(params or {}))
    return getattr(nn, name)(**(params or {}))


class WaveNetResidualBlock(nn.Module):
    """x (B, C_r, T), c (B, C_a, T) or None -> (residual (B, C_r, T), skip
    (B, C_s, T)); the residual output is scaled by sqrt(1/2)."""

    def __init__(self, kernel_size: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64,
                 aux_channels: int = 80, dropout: float = 0.0,
                 dilation: int = 1, bias: bool = True,
                 use_causal_conv: bool = False, use_weight_norm: bool = True,
                 use_pallas: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout = dropout
        self.dilation = dilation
        self.use_causal_conv = use_causal_conv
        self.use_fused = use_pallas and bias
        kw = dict(use_weight_norm=use_weight_norm, generator=generator)
        half = gate_channels // 2
        self.conv = Conv1d(
            residual_channels, gate_channels, kernel_size, dilation=dilation,
            padding="causal" if use_causal_conv else "same", bias=bias,
            normal_std=kaiming_normal_relu_std(kernel_size * residual_channels),
            zero_bias=True, **kw)
        self.conv1x1_aux = None
        if aux_channels > 0:
            self.conv1x1_aux = Conv1d1x1(
                aux_channels, gate_channels, bias=False,
                normal_std=kaiming_normal_relu_std(aux_channels), **kw)
        self.conv1x1_skip = Conv1d1x1(
            half, skip_channels, bias=bias,
            normal_std=kaiming_normal_relu_std(half), zero_bias=True, **kw)
        self.conv1x1_out = Conv1d1x1(
            half, residual_channels, bias=bias,
            normal_std=kaiming_normal_relu_std(half), zero_bias=True, **kw)

    def forward(self, x: torch.Tensor, c: torch.Tensor | None,
                weights: dict | None = None):
        """``weights``: this block's ``gather_weights()``, prepared once
        for decode (with the kernel's split ``frag`` on the card); the fused
        path gathers them itself when not given, in the autograd graph when
        gradients are on."""
        if self.use_fused and c is not None:
            x = F.dropout(x, p=self.dropout, training=self.training)
            w = weights or self.gather_weights(torch.is_grad_enabled())
            r, s = fused_gated_resblock(
                x.transpose(1, 2).contiguous(), c.transpose(1, 2).contiguous(),
                *(w[k] for k in WEIGHT_KEYS), dilation=self.dilation,
                causal=self.use_causal_conv, fragments=w.get("frag"))
            return r.transpose(1, 2), s.transpose(1, 2)
        residual = x
        x = F.dropout(x, p=self.dropout, training=self.training)
        x = self.conv(x)
        if c is not None:
            x = x + self.conv1x1_aux(c)
        xa, xb = x.chunk(2, dim=1)
        x = torch.tanh(xa) * torch.sigmoid(xb)
        s = self.conv1x1_skip(x)
        x = (self.conv1x1_out(x) + residual) * math.sqrt(0.5)
        return x, s

    def gather_weights(self, differentiable: bool = False) -> dict:
        """Effective weights in the JAX gather form of ``collect_weights``
        (residual_block.py:126-176): wconv (K, C_r, C_g), bconv (C_g), waux
        (C_a, C_g), wskip (C_g/2, C_s), bskip, wres (C_g/2, C_r), bres.
        Without biases (``bias=False``) the biases are zeros, which the
        stack kernel adds to the same result. They are detached unless
        ``differentiable``: then they stay in the autograd graph, so the
        gradients of the gathered weights reach ``weight_g``/``weight_v``."""

        def w1x1(conv):
            return effective_weight(conv)[:, :, 0].t()

        def bias(conv, w):
            return torch.zeros_like(w[0]) if conv.bias is None else conv.bias

        w = {"wconv": self.conv.gather_weight(), "waux": w1x1(self.conv1x1_aux),
             "wskip": w1x1(self.conv1x1_skip), "wres": w1x1(self.conv1x1_out)}
        w["bconv"] = bias(self.conv, w["wconv"][0])
        w["bskip"] = bias(self.conv1x1_skip, w["wskip"])
        w["bres"] = bias(self.conv1x1_out, w["wres"])
        return {k: (w[k] if differentiable else w[k].detach()).contiguous()
                for k in WEIGHT_KEYS}


class HiFiGANResidualBlock(nn.Module):
    """One MRF resblock: x (B, C, T) -> (B, C, T)."""

    def __init__(self, kernel_size: int = 3, channels: int = 512,
                 dilations: Sequence[int] = (1, 3, 5), bias: bool = True,
                 use_additional_convs: bool = True,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 use_weight_norm: bool = True, use_causal_conv: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        params = nonlinear_activation_params or {"negative_slope": 0.1}
        self.dilations = tuple(int(d) for d in dilations)
        self.use_additional_convs = use_additional_convs
        conv_kw = dict(bias=bias, use_weight_norm=use_weight_norm,
                       padding="causal" if use_causal_conv else "same",
                       generator=generator)
        self.convs1 = nn.ModuleList()
        if use_additional_convs:
            self.convs2 = nn.ModuleList()
        for d in self.dilations:
            self.convs1.append(nn.Sequential(
                get_activation(nonlinear_activation, params),
                Conv1d(channels, channels, kernel_size, dilation=d, **conv_kw),
            ))
            if use_additional_convs:
                self.convs2.append(nn.Sequential(
                    get_activation(nonlinear_activation, params),
                    Conv1d(channels, channels, kernel_size, **conv_kw),
                ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.dilations)):
            xt = self.convs1[i](x)
            if self.use_additional_convs:
                xt = self.convs2[i](xt)
            x = xt + x
        return x

    def gather_weights(self) -> dict:
        """Effective weights in the dict form of the JAX
        ``collect_weights=True`` path (residual_block.py:288-296):
        w1/w2 (n_dil, K, C, C), b1/b2 (n_dil, C), dilations."""

        def stack(convs):
            w = torch.stack([seq[1].gather_weight() for seq in convs])
            b = torch.stack([seq[1].bias for seq in convs])
            return w.detach().contiguous(), b.detach().contiguous()

        out = {"dilations": self.dilations}
        out["w1"], out["b1"] = stack(self.convs1)
        if self.use_additional_convs:
            out["w2"], out["b2"] = stack(self.convs2)
        return out
