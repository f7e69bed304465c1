"""MelGAN residual stack (PyTorch, (B, C, T) layout).

Counterpart of parallelwavegan_tpu/layers/residual_stack.py:33-117: act
-> pad -> dilated conv -> act -> 1x1 conv, plus a 1x1 skip conv of the
input. The submodules are upstream's ``stack = Sequential(act, pad,
conv, act, conv)`` and ``skip_layer``, so the state-dict keys are
``stack.2.*``, ``stack.4.*`` and ``skip_layer.*`` (the non-causal map of
parallelwavegan_tpu/convert/torch_checkpoint.py:185-193). The three pad
layers of the JAX package (``_PAD_MODES``) are taken. The causal stack
(``use_causal_conv``, JAX :94-97) is upstream's ``stack = Sequential(act,
CausalConv1d, act, conv)``, keys ``stack.1.conv.*``, ``stack.3.*`` and
``skip_layer.*`` (the causal map, :185-190): the dilated conv sees
(K - 1) * dilation samples of the stack's pad on the left only.
"""

from __future__ import annotations

import torch
from torch import nn

from parallelwavegan_tpu_torch.layers.convs import CausalConv1d, Conv1d, get_pad
from parallelwavegan_tpu_torch.layers.residual_block import get_activation

INIT_STD = 0.02  # N(0, 0.02) conv weights, the JAX normal_init(0.02)


class ResidualStack(nn.Module):
    """c (B, C, T) -> stack(c) + skip_layer(c), (B, C, T)."""

    def __init__(self, kernel_size: int = 3, channels: int = 32,
                 dilation: int = 1, bias: bool = True,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 pad: str = "ReflectionPad1d", pad_params: dict | None = None,
                 use_causal_conv: bool = False, use_weight_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        params = nonlinear_activation_params or {"negative_slope": 0.2}
        self.dilation = dilation
        kw = dict(bias=bias, use_weight_norm=use_weight_norm,
                  normal_std=INIT_STD, generator=generator)
        if use_causal_conv:
            dilated = [CausalConv1d(channels, channels, kernel_size, dilation=dilation,
                                    pad=pad, pad_params=pad_params, **kw)]
        else:
            assert (kernel_size - 1) % 2 == 0, "even kernel size unsupported"
            dilated = [get_pad(pad, (kernel_size - 1) // 2 * dilation, pad_params),
                       Conv1d(channels, channels, kernel_size, dilation=dilation,
                              padding=0, **kw)]
        self.stack = nn.Sequential(
            get_activation(nonlinear_activation, params),
            *dilated,
            get_activation(nonlinear_activation, params),
            Conv1d(channels, channels, 1, padding=0, **kw),
        )
        self.skip_layer = Conv1d(channels, channels, 1, padding=0, **kw)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.stack(c) + self.skip_layer(c)

    def gather_weights(self, differentiable: bool = False) -> dict:
        """Effective weights in the JAX ``collect_weights`` form
        (residual_stack.py:62-80): wd (K, C, C), w1 and ws (1, C, C), their
        biases (zeros without ``bias``) and the dilation. They are detached
        unless ``differentiable``: then they stay in the autograd graph, so
        the gradients of the gathered weights reach ``weight_g``/``weight_v``."""

        def conv(m):
            w = m.gather_weight()
            b = torch.zeros_like(w[0, 0]) if m.bias is None else m.bias
            if not differentiable:
                w, b = w.detach(), b.detach()
            return w.contiguous(), b.contiguous()

        out = {"dilation": self.dilation}
        (out["wd"], out["bd"]), (out["w1"], out["b1"]), (out["ws"], out["bs"]) = (
            conv(self.stack[2]), conv(self.stack[4]), conv(self.skip_layer))
        return out
