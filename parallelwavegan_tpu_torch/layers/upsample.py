"""Mel upsampling networks of the Parallel WaveGAN generator (PyTorch).

Counterpart of parallelwavegan_tpu/layers/upsample.py:29-168 in
upstream's own form: the mel (B, C, T) is a one-channel image (B, 1, C,
T), stretched along time by nearest neighbour and smoothed by a bias-free
(F, 2s+1) Conv2d whose taps start at 1 / prod(kernel). The module list
``up_layers`` holds [Stretch2d, Conv2d, (activation)] per scale, so the
state-dict keys are upstream's ``upsample.up_layers.{2i+1 or 3i+1}.*``
(parallelwavegan_tpu/convert/torch_checkpoint.py:247-254). Inside the
generator every conv carries weight norm, as upstream's
``apply_weight_norm`` puts it on the Conv2d too.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_tpu_torch.layers.convs import (
    Conv1d,
    apply_weight_norm,
    kaiming_normal_relu_std,
)
from parallelwavegan_tpu_torch.layers.residual_block import get_activation


def stretch_time(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of the last (time) axis by ``scale``."""
    return x if scale == 1 else x.repeat_interleave(scale, dim=-1)


class Stretch2d(nn.Module):
    """Upstream's Stretch2d as UpsampleNetwork uses it (nearest, y_scale 1):
    (B, 1, C, T) -> (B, 1, C, T*x_scale)."""

    def __init__(self, x_scale: int):
        super().__init__()
        self.x_scale = x_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stretch_time(x, self.x_scale)


class SmoothConv2d(nn.Conv2d):
    """Bias-free (F, 2s+1) Conv2d over (B, 1, C, T), taps 1 / (F (2s+1)).
    Time is padded (s, s), or (2s, 0) when causal (upsample.py:90-95)."""

    def __init__(self, scale: int, freq_axis_kernel_size: int = 1,
                 use_causal_conv: bool = False):
        tk = 2 * scale + 1
        super().__init__(1, 1, (freq_axis_kernel_size, tk),
                         padding=((freq_axis_kernel_size - 1) // 2, 0),
                         bias=False)
        self.time_pad = (2 * scale, 0) if use_causal_conv else (scale, scale)
        with torch.no_grad():
            self.weight.fill_(1.0 / (freq_axis_kernel_size * tk))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.pad(x, self.time_pad))


class UpsampleNetwork(nn.Module):
    """(B, C, T) -> (B, C, T * prod(upsample_scales))."""

    def __init__(self, upsample_scales: Sequence[int],
                 nonlinear_activation: str | None = None,
                 nonlinear_activation_params: dict | None = None,
                 interpolate_mode: str = "nearest",
                 freq_axis_kernel_size: int = 1,
                 use_causal_conv: bool = False,
                 use_weight_norm: bool = False):
        super().__init__()
        if interpolate_mode != "nearest":
            raise ValueError("only nearest interpolation is supported")
        assert (freq_axis_kernel_size - 1) % 2 == 0
        self.up_layers = nn.ModuleList()
        for scale in upsample_scales:
            self.up_layers.append(Stretch2d(scale))
            conv = SmoothConv2d(scale, freq_axis_kernel_size, use_causal_conv)
            if use_weight_norm:
                apply_weight_norm(conv)
            self.up_layers.append(conv)
            if nonlinear_activation is not None:
                self.up_layers.append(get_activation(
                    nonlinear_activation, nonlinear_activation_params))

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        c = c.unsqueeze(1)
        for f in self.up_layers:
            c = f(c)
        return c.squeeze(1)


class ConvInUpsampleNetwork(nn.Module):
    """Context conv over the pre-padded mel, then ``UpsampleNetwork``:
    (B, C, T' + 2 w) -> (B, C, T' * prod(upsample_scales)), w =
    ``aux_context_window``. The context conv is valid (no padding): the
    caller edge-pads the mel by w frames on each side (upsample.py:143-158)."""

    def __init__(self, upsample_scales: Sequence[int],
                 nonlinear_activation: str | None = None,
                 nonlinear_activation_params: dict | None = None,
                 interpolate_mode: str = "nearest",
                 freq_axis_kernel_size: int = 1, aux_channels: int = 80,
                 aux_context_window: int = 0, use_causal_conv: bool = False,
                 use_weight_norm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.aux_context_window = aux_context_window
        self.use_causal_conv = use_causal_conv
        k = aux_context_window + 1 if use_causal_conv else 2 * aux_context_window + 1
        self.conv_in = Conv1d(
            aux_channels, aux_channels, k, padding=0, bias=False,
            use_weight_norm=use_weight_norm,
            normal_std=kaiming_normal_relu_std(k * aux_channels),
            generator=generator)
        self.upsample = UpsampleNetwork(
            upsample_scales, nonlinear_activation, nonlinear_activation_params,
            interpolate_mode, freq_axis_kernel_size, use_causal_conv,
            use_weight_norm)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        c = self.conv_in(c)
        if self.use_causal_conv and self.aux_context_window > 0:
            c = c[:, :, : -self.aux_context_window]
        return self.upsample(c)
