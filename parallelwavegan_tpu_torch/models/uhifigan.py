"""U-Net HiFi-GAN generator (PyTorch, (B, C, T) layout).

Counterpart of parallelwavegan_tpu/models/uhifigan.py:32-176: the sine
excitation (B, 1, T) runs down an encoder of MRFs (``HiFiGANResidualBlock``
sums over ``resblock_kernel_sizes``, averaged) and strided convs that
double the width at each of ``downsample_scales`` (padding scale // 2 +
scale % 2), the mel (B, in_channels, T / prod(downsample_scales)) enters
at the bottleneck through ``hidden_conv``, and the way up concatenates
each encoder stage's output before act -> ConvTranspose1d (padding
scale // 2 + scale % 2, output padding scale % 2, so that odd scales
such as 5 and 3 keep lengths) -> MRF; then LeakyReLU(0.01) -> output conv
-> tanh. Every conv and deconv outside the MRFs starts N(0, 0.01) (the
JAX ``normal_init(0.01)``), the MRFs' convs from torch's default uniform,
with weight norm on all of them. The causal generator (``use_causal_conv``)
runs ``CausalConv1d`` in and out and at the bottleneck, strided convs
with (K - 1) zeros on the left, ``CausalConvTranspose1d`` up and causal
MRFs, as JAX's.

Dropout (``dropout``) follows the input conv's activation and each
downsample's, in train mode, with its masks drawn from the
``torch.Generator`` the forward is given (``layers/duration.py dropout``:
the training step seeds it by (seed, step, stream)); ``deterministic``
turns it off in train mode, as JAX's ``deterministic=not train`` does in
the D phase's re-run of G, and eval mode is the identity. No kernel runs
here: JAX's U-Net HiFi-GAN calls no Pallas code.

The keys are those JAX's converter reads (convert/torch_checkpoint.py:
289-315): ``input_conv.0.*``, ``downsamples_mrf.{n}.*``,
``downsamples.{i}.0.*``, ``hidden_conv.*``, ``upsamples.{i}.1.*``,
``upsamples_mrf.{n}.*`` and ``output_conv.1.*`` (the causal convs one
level down, ``.conv`` / ``.deconv``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from parallelwavegan_tpu_torch.layers.convs import (
    CausalConv1d,
    CausalConvTranspose1d,
    Conv1d,
    ConvTranspose1d,
    remove_weight_norm,
)
from parallelwavegan_tpu_torch.layers.duration import dropout
from parallelwavegan_tpu_torch.layers.residual_block import (
    HiFiGANResidualBlock,
    LeakyReLU,
    get_activation,
)


class UHiFiGANGenerator(nn.Module):
    """(excitation (B, out_channels, T), mel (B, in_channels, T')) -> wave
    (B, out_channels, T' * prod(upsample_scales))."""

    requires_noise_input = False
    requires_aux_input = True

    def __init__(
        self,
        in_channels: int = 80,
        out_channels: int = 1,
        channels: int = 512,
        kernel_size: int = 7,
        downsample_scales: Sequence[int] = (8, 8, 2, 2),
        downsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        upsample_scales: Sequence[int] = (8, 8, 2, 2),
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
        dropout: float = 0.3,
        use_additional_convs: bool = True,
        bias: bool = True,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: dict | None = None,
        use_causal_conv: bool = False,
        use_weight_norm: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        act_params = nonlinear_activation_params or {"negative_slope": 0.1}
        self.upsample_scales = tuple(int(s) for s in upsample_scales)
        self.dropout = dropout
        self.num_blocks = len(resblock_kernel_sizes)
        conv_kw = dict(bias=bias, use_weight_norm=use_weight_norm, normal_std=0.01,
                       generator=generator)

        def conv(cin, cout):  # a k-tap conv that keeps the length
            if use_causal_conv:
                return CausalConv1d(cin, cout, kernel_size, **conv_kw)
            return Conv1d(cin, cout, kernel_size, padding="same", **conv_kw)

        def mrf(ch):
            return [HiFiGANResidualBlock(
                kernel_size=k, channels=ch, dilations=d, bias=bias,
                use_additional_convs=use_additional_convs,
                nonlinear_activation=nonlinear_activation,
                nonlinear_activation_params=act_params, use_weight_norm=use_weight_norm,
                use_causal_conv=use_causal_conv, generator=generator)
                for k, d in zip(resblock_kernel_sizes, resblock_dilations)]

        self.act = get_activation(nonlinear_activation, act_params)
        self.input_conv = nn.Sequential(conv(out_channels, channels))
        ch = channels
        self.downsamples_mrf, self.downsamples = nn.ModuleList(), nn.ModuleList()
        for s, k in zip(downsample_scales, downsample_kernel_sizes):
            self.downsamples_mrf.extend(mrf(ch))
            self.downsamples.append(nn.Sequential(Conv1d(
                ch, ch * 2, k, stride=s,
                padding="causal" if use_causal_conv else s // 2 + s % 2, **conv_kw)))
            ch *= 2
        self.hidden_conv = conv(in_channels, ch)
        self.upsamples, self.upsamples_mrf = nn.ModuleList(), nn.ModuleList()
        for s, k in zip(self.upsample_scales, upsample_kernel_sizes):
            if use_causal_conv:
                deconv = CausalConvTranspose1d(ch * 2, ch // 2, k, s, **conv_kw)
            else:
                deconv = ConvTranspose1d(ch * 2, ch // 2, k, s, padding=s // 2 + s % 2,
                                         output_padding=s % 2, **conv_kw)
            self.upsamples.append(nn.Sequential(
                get_activation(nonlinear_activation, act_params), deconv))
            self.upsamples_mrf.extend(mrf(ch // 2))
            ch //= 2
        self.output_conv = nn.Sequential(
            LeakyReLU(negative_slope=0.01), conv(ch, out_channels), nn.Tanh())

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_scales)

    def _mrf(self, blocks: nn.ModuleList, i: int, x: torch.Tensor) -> torch.Tensor:
        cs = 0.0
        for j in range(self.num_blocks):
            cs = cs + blocks[i * self.num_blocks + j](x)
        return cs / self.num_blocks

    def forward(self, excitation: torch.Tensor, c: torch.Tensor,
                generator: torch.Generator | None = None,
                deterministic: bool = False) -> torch.Tensor:
        train = self.training and not deterministic

        def act_drop(x):
            return dropout(self.act(x), self.dropout, train, generator)

        hidden = act_drop(self.input_conv(excitation))
        skips = []
        for i, down in enumerate(self.downsamples):
            hidden = act_drop(down(self._mrf(self.downsamples_mrf, i, hidden)))
            skips.append(hidden)
        x = self.hidden_conv(c)
        for i, up in enumerate(self.upsamples):
            x = up(torch.cat([x, skips[-1 - i]], dim=1))
            x = self._mrf(self.upsamples_mrf, i, x)
        return self.output_conv(x)

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)

    def prepare_kernels(self) -> None:
        """No kernel runs in this generator: nothing to prepare."""
