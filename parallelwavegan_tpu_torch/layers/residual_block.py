"""HiFi-GAN MRF residual block (PyTorch, (B, C, T) layout).

Counterpart of parallelwavegan_tpu/layers/residual_block.py:241-320: per
dilation, act -> dilated conv [-> act -> conv] with an additive residual.
Submodules are ``nn.Sequential(act, conv)`` so the state-dict keys are
upstream's ``convs1.{m}.1.*`` / ``convs2.{m}.1.*``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from parallelwavegan_tpu_torch.layers.convs import Conv1d


def get_activation(name: str, params: dict | None) -> nn.Module:
    """Upstream builds activations as ``getattr(torch.nn, name)(**params)``."""
    return getattr(nn, name)(**(params or {}))


class HiFiGANResidualBlock(nn.Module):
    """One MRF resblock: x (B, C, T) -> (B, C, T)."""

    def __init__(self, kernel_size: int = 3, channels: int = 512,
                 dilations: Sequence[int] = (1, 3, 5), bias: bool = True,
                 use_additional_convs: bool = True,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 use_weight_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        params = nonlinear_activation_params or {"negative_slope": 0.1}
        self.dilations = tuple(int(d) for d in dilations)
        self.use_additional_convs = use_additional_convs
        conv_kw = dict(bias=bias, use_weight_norm=use_weight_norm,
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
