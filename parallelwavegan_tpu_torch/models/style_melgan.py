"""StyleMelGAN generator (PyTorch, (B, C, T) layout).

Counterpart of parallelwavegan_tpu/models/style_melgan.py:39-228: noise z
(B, in_channels, Tz) upsampled by ``noise_upsample`` (per scale s a
ConvTranspose1d with kernel 2s, stride s, padding s//2 + s%2,
output_padding s%2, then the activation, LeakyReLU(0.2) by default), nine
TADEResBlocks that inject the mel (aux width ``aux_channels`` for block 0,
``channels`` after it), then a k-tap output conv and tanh. The keys are
upstream's: ``noise_upsample.{2i}``, ``blocks.{i}.*`` and
``output_conv.0``. Every conv and deconv is initialised N(0, 0.02) and
carries weight norm unless ``use_weight_norm`` is off.

``use_pallas_tade`` or ``use_pallas_tade_train`` (the JAX flag names) with
``channels == 64`` (the JAX gate, :108-137) runs the blocks through
``fused_tade_blocks``: blocks of input length at least
``pallas_tade_min_t`` (or, with the train flag, ``pallas_tade_train_min_t``
and the train wrapper's even-length and scale checks) whose aux width is
64 run the hand-written CUDA kernels K8a/K8b on a GPU (their plain
PyTorch version on the CPU); the rest, block 0 always, run their own
forward. Their backward (K9) is not ported, so under either flag a
forward that needs gradients raises. ``pallas_tade_tile`` and
``pallas_tade_train_tile`` are TPU tile sizes, accepted for config
compatibility and without effect. ``DiscreteSymbolStyleMelGANGenerator``
and the random-window discriminator are not ported yet (ROADMAP.md M17).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

from parallelwavegan_tpu_torch.layers.convs import (
    Conv1d,
    ConvTranspose1d,
    remove_weight_norm,
)
from parallelwavegan_tpu_torch.layers.residual_block import get_activation
from parallelwavegan_tpu_torch.layers.tade import INIT_STD, TADEResBlock
from parallelwavegan_tpu_torch.ops.kernels.tade_decode import fused_tade_blocks


class StyleMelGANGenerator(nn.Module):
    """(mel (B, aux_channels, T'), z (B, in_channels, Tz)) -> wave (B,
    out_channels, T' * prod(upsample_scales)), with T' = Tz *
    prod(noise_upsample_scales)."""

    def __init__(
        self,
        in_channels: int = 128,
        aux_channels: int = 80,
        channels: int = 64,
        out_channels: int = 1,
        kernel_size: int = 9,
        dilation: int = 2,
        bias: bool = True,
        noise_upsample_scales: Sequence[int] = (11, 2, 2, 2),
        noise_upsample_activation: str = "LeakyReLU",
        noise_upsample_activation_params: dict | None = None,
        upsample_scales: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2, 1),
        upsample_mode: str = "nearest",
        gated_function: str = "softmax",
        use_weight_norm: bool = True,
        use_pallas_tade: bool = False,
        pallas_tade_tile: int = 1024,
        pallas_tade_min_t: int = 4096,
        use_pallas_tade_train: bool = False,
        pallas_tade_train_tile: int = 512,
        pallas_tade_train_min_t: int = 1024,
        device: torch.device | str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.noise_upsample_scales = tuple(int(s) for s in noise_upsample_scales)
        self.upsample_scales = tuple(int(s) for s in upsample_scales)
        self.gated_function = gated_function
        kw = dict(bias=bias, use_weight_norm=use_weight_norm, generator=generator)
        act_params: Any = noise_upsample_activation_params or {"negative_slope": 0.2}
        layers, cin = [], in_channels
        for s in self.noise_upsample_scales:
            layers += [ConvTranspose1d(cin, channels, 2 * s, s, padding=s // 2 + s % 2,
                                       output_padding=s % 2, normal_std=INIT_STD, **kw),
                       get_activation(noise_upsample_activation, act_params)]
            cin = channels
        self.noise_upsample = nn.Sequential(*layers)
        self.blocks = nn.ModuleList(
            TADEResBlock(in_channels=channels,
                         aux_channels=aux_channels if i == 0 else channels,
                         kernel_size=kernel_size, dilation=dilation,
                         upsample_factor=s, upsample_mode=upsample_mode,
                         gated_function=gated_function, **kw)
            for i, s in enumerate(self.upsample_scales))
        self.output_conv = nn.Sequential(
            Conv1d(channels, out_channels, kernel_size, normal_std=INIT_STD, **kw),
            nn.Tanh())
        self.use_fused = (use_pallas_tade or use_pallas_tade_train) and channels == 64
        self.fused_train = use_pallas_tade_train
        self.min_fused_t = (pallas_tade_train_min_t if use_pallas_tade_train
                            else pallas_tade_min_t)
        self._kernel_cache = None
        if device is not None:
            self.to(device)

    @property
    def noise_upsample_factor(self) -> int:
        return math.prod(self.noise_upsample_scales)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_scales)

    def forward(self, c: torch.Tensor, z: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Where z is None it is drawn as (B, in_channels, 1) from
        ``generator``, the training case (c then holds
        ``noise_upsample_factor`` frames)."""
        if z is None:
            z = torch.randn(c.shape[0], self.in_channels, 1, generator=generator,
                            device=c.device, dtype=c.dtype)
        x = self.noise_upsample(z)
        if self.use_fused:
            x, c = self.run_blocks_fused(x, c)
        else:
            for blk in self.blocks:
                x, c = blk(x, c)
        return self.output_conv(x)

    def run_blocks_fused(self, x: torch.Tensor, c: torch.Tensor):
        """The TADE blocks through ``fused_tade_blocks``: (B, C, T) in and out."""
        w = self._kernel_cache or self.block_weights()
        y, cy = fused_tade_blocks(
            x.transpose(1, 2).contiguous(), c.transpose(1, 2).contiguous(), w,
            gated_function=self.gated_function, min_fused_t=self.min_fused_t,
            train=self.fused_train)
        return y.transpose(1, 2), cy.transpose(1, 2)

    def block_weights(self) -> list:
        """Every block's folded weights, as ``fused_tade_blocks`` takes them."""
        return [blk.folded_weights() for blk in self.blocks]

    def prepare_kernels(self) -> None:
        """Fold the blocks' weights once, for decode. Call it after the
        weights are loaded, folded and on their device; loading weights or
        moving the module afterwards drops them again."""
        self._kernel_cache = self.block_weights() if self.use_fused else None

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)
        self._kernel_cache = None

    def _apply(self, fn, *args, **kwargs):
        self._kernel_cache = None
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._kernel_cache = None
        return super().load_state_dict(*args, **kwargs)
