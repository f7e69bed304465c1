"""MelGAN generator (PyTorch, (B, C, T) layout), also Multi-band MelGAN's.

Counterpart of parallelwavegan_tpu/models/melgan.py:39-230, non-causal:
a k-tap input conv, per upsample scale act -> ConvTranspose1d ->
``stacks`` ResidualStacks at dilations ``stack_kernel_size ** j``, then
act -> k-tap output conv [-> tanh]. Multi-band MelGAN is this generator
with ``out_channels`` sub-bands, synthesised outside the model by PQMF
(``utils/model.py``). The layers are upstream's one flat
``self.melgan = nn.Sequential(...)`` (pad, conv, then per scale act,
deconv, stacks, then act, pad, conv, tanh), so a state dict of this
module is an upstream checkpoint (index map in
parallelwavegan_tpu/convert/torch_checkpoint.py:153-207). Every conv and
deconv is initialised N(0, 0.02), the JAX ``normal_init(0.02)``.

``use_pallas_stacks`` or ``use_pallas_stacks_train`` (the JAX flag names)
under the JAX gate (:81-87, :145: not causal, LeakyReLU, pad not constant
or constant 0), per upsample stage of at most 128 channels, runs the
stage's ResidualStacks through the hand-written CUDA kernels on a GPU and
their plain PyTorch versions on the CPU. On the last stage, with
``use_final_nonlinear_activation``, the trailing act -> out conv -> tanh
folds into the same call (:182-200). Wider stages, the input conv and the
deconvs stay on cuDNN, as JAX leaves them to XLA. With
``use_pallas_stacks_train`` and gradients on (training) a fused stage is
``fused_melgan_stacks_train`` (:169-176): K6 forward, K7 backward, a
recompute checkpoint whose weight gradients flow through weight norm to
``weight_g``/``weight_v``. Otherwise (decode, eval, the D phase's re-run
of G under ``torch.no_grad()``) it is ``fused_melgan_stacks`` (K6), which
gives the same values; that wrapper is inference-only, as JAX's, so
``use_pallas_stacks`` with gradients on raises. ``prepare_kernels`` keeps
each fused stage's weights, on the card with K6's split of them, so a
decode splits nothing per utterance.
``pallas_stacks_train_tile`` is a TPU tile size, accepted for config
compatibility and without effect. The causal generator
(``use_causal_conv``, JAX :92-130, :203-210) is upstream's causal
Sequential: ``CausalConv1d`` in and out (keys ``melgan.0.conv``,
``melgan.{last}.conv``), ``CausalConvTranspose1d`` per scale
(``melgan.{i}.deconv``) and causal ResidualStacks; it runs no kernel, as
the JAX gate (:82-83) requires a non-causal generator.

``MelGANDiscriminator`` (JAX :233-322, upstream's keys ``layers.0.1``,
``layers.{i}.0``, ``layers.{last}``) is the base discriminator of
StyleMelGAN's random-window discriminator and of
``MelGANMultiScaleDiscriminator``: a reflect-padded input conv of
prod(kernel_sizes) taps, strided grouped convs, two final convs, N(0,
0.02) weights and weight norm; its output is the list of every layer's
features. ``MelGANMultiScaleDiscriminator`` (JAX :354-403, keys
``discriminators.{i}.layers.*``) runs ``scales`` of them, each on the
wave average-pooled once more than the last (torch's ``avg_pool1d``,
which computes JAX's :325-351; AvgPool1d(4, 2, 1,
count_include_pad=False) unless ``downsample_pooling_params`` say
otherwise), and returns their lists.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_tpu_torch.layers.convs import (
    PAD_MODES,
    CausalConv1d,
    CausalConvTranspose1d,
    Conv1d,
    ConvTranspose1d,
    get_pad,
    remove_weight_norm,
)
from parallelwavegan_tpu_torch.layers.residual_block import get_activation
from parallelwavegan_tpu_torch.layers.residual_stack import (
    INIT_STD,
    ResidualStack,
)
from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
    fused_melgan_stacks,
    with_fragments,
)
from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
    fused_melgan_stacks_train,
)


class MelGANGenerator(nn.Module):
    """mel (B, in_channels, T) -> wave (B, out_channels, T * prod(scales))."""

    def __init__(
        self,
        in_channels: int = 80,
        out_channels: int = 1,
        kernel_size: int = 7,
        channels: int = 512,
        bias: bool = True,
        upsample_scales: Sequence[int] = (8, 8, 2, 2),
        stack_kernel_size: int = 3,
        stacks: int = 3,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: dict | None = None,
        pad: str = "ReflectionPad1d",
        pad_params: dict | None = None,
        use_final_nonlinear_activation: bool = True,
        use_weight_norm: bool = True,
        use_causal_conv: bool = False,
        use_pallas_stacks: bool = False,
        use_pallas_stacks_train: bool = False,
        pallas_stacks_train_tile: int = 512,
        device: torch.device | str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        assert channels >= math.prod(upsample_scales)
        assert channels % (2 ** len(upsample_scales)) == 0
        if not use_causal_conv:
            assert (kernel_size - 1) % 2 == 0, "even kernel size unsupported"
        act_params = nonlinear_activation_params or {"negative_slope": 0.2}
        self.upsample_scales = tuple(int(s) for s in upsample_scales)
        self.use_final_nonlinear_activation = use_final_nonlinear_activation
        self.slope = act_params.get("negative_slope", 0.01)
        self.pad_mode = PAD_MODES.get(pad)
        conv_kw = dict(bias=bias, use_weight_norm=use_weight_norm,
                       normal_std=INIT_STD, generator=generator)

        def act():
            return get_activation(nonlinear_activation, act_params)

        def conv(cin, cout):  # [pad, conv], or the causal conv
            if use_causal_conv:
                return [CausalConv1d(cin, cout, kernel_size, pad=pad,
                                     pad_params=pad_params, **conv_kw)]
            return [get_pad(pad, (kernel_size - 1) // 2, pad_params),
                    Conv1d(cin, cout, kernel_size, padding=0, **conv_kw)]

        def deconv(cin, cout, s):
            if use_causal_conv:
                return CausalConvTranspose1d(cin, cout, s * 2, s, **conv_kw)
            return ConvTranspose1d(cin, cout, s * 2, s, padding=s // 2 + s % 2,
                                   output_padding=s % 2, **conv_kw)

        layers = conv(in_channels, channels)
        self._head = len(layers)
        self._stages = []  # (act, deconv, [stacks]) indices per scale
        for i, s in enumerate(self.upsample_scales):
            ch = channels // (2 ** (i + 1))
            first = len(layers)
            layers += [act(), deconv(channels // (2 ** i), ch, s)]
            layers += [ResidualStack(
                kernel_size=stack_kernel_size, channels=ch,
                dilation=stack_kernel_size ** j, bias=bias,
                nonlinear_activation=nonlinear_activation,
                nonlinear_activation_params=act_params, pad=pad,
                pad_params=pad_params, use_causal_conv=use_causal_conv,
                use_weight_norm=use_weight_norm,
                generator=generator) for j in range(stacks)]
            self._stages.append((first, first + 1, list(range(first + 2, len(layers)))))
        self._tail = len(layers)  # act, [pad,] conv[, tanh]
        layers += [act(), *conv(ch, out_channels)]
        if use_final_nonlinear_activation:
            layers += [nn.Tanh()]
        self.melgan = nn.Sequential(*layers)

        fuse_ok = (
            (use_pallas_stacks or use_pallas_stacks_train)
            and not use_causal_conv
            and nonlinear_activation == "LeakyReLU"
            and (self.pad_mode != "constant"
                 or (pad_params or {}).get("value", 0.0) == 0.0))
        # stages whose ResidualStacks run through fused_melgan_stacks
        self.fused_stages = tuple(
            i for i in range(len(self.upsample_scales))
            if fuse_ok and channels // (2 ** (i + 1)) <= 128)
        self.use_stacks_train = use_pallas_stacks_train
        self._kernel_cache = None
        if device is not None:
            self.to(device)

    @property
    def upsample_factor(self) -> int:
        f = 1
        for s in self.upsample_scales:
            f *= s
        return f

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        m = self.melgan
        for j in range(self._head):
            c = m[j](c)
        last = len(self._stages) - 1
        for i, (a, d, stack_ids) in enumerate(self._stages):
            c = m[d](m[a](c))
            if i not in self.fused_stages:
                for j in stack_ids:
                    c = m[j](c)
                continue
            if self.use_stacks_train and torch.is_grad_enabled():
                w, fn = self.stage_weights(i, differentiable=True), fused_melgan_stacks_train
            else:
                # decode's float32 weights, never under mixed precision's bf16
                # parameters (which stage_weights reads)
                cache = self._kernel_cache if c.dtype == torch.float32 else None
                w = (cache or {}).get(i) or self.stage_weights(i)
                fn = fused_melgan_stacks
            y = fn(c.transpose(1, 2).contiguous(), w["stacks"], final=w["final"],
                   slope=self.slope, pad_mode=self.pad_mode)
            c = y.transpose(1, 2)
            if i == last and w["final"] is not None:
                return c
        for j in range(self._tail, len(m)):
            c = m[j](c)
        return c

    def stage_weights(self, i: int, differentiable: bool = False) -> dict:
        """Stage ``i``'s folded weights in the form of
        ``fused_melgan_stacks``: the stacks' gather-form dicts and, on the
        last stage with ``use_final_nonlinear_activation``, the output conv
        as ``final``; ``differentiable`` keeps them in the autograd graph."""
        stacks = [self.melgan[j].gather_weights(differentiable)
                  for j in self._stages[i][2]]
        final = None
        if i == len(self._stages) - 1 and self.use_final_nonlinear_activation:
            conv = self.melgan[self._tail + 2]
            w = conv.gather_weight()
            b = torch.zeros_like(w[0, 0]) if conv.bias is None else conv.bias
            if not differentiable:
                w, b = w.detach(), b.detach()
            final = (w.contiguous(), b.contiguous())
        return {"stacks": stacks, "final": final}

    def prepare_kernels(self) -> None:
        """Gather the fused stages' folded weights once, for decode, and on
        the card split them once for K6 (``melgan_stack.with_fragments``).
        Call it after the weights are loaded, folded and on their device;
        loading weights or moving the module afterwards drops them again."""

        def split(w):
            if not w["stacks"] or not w["stacks"][0]["wd"].is_cuda:
                return w
            return dict(w, stacks=with_fragments(w["stacks"]))

        self._kernel_cache = {i: split(self.stage_weights(i)) for i in self.fused_stages}

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)
        self._kernel_cache = None

    def _apply(self, fn, *args, **kwargs):
        self._kernel_cache = None
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._kernel_cache = None
        return super().load_state_dict(*args, **kwargs)


class MelGANDiscriminator(nn.Module):
    """wave (B, in_channels, T) -> [every layer's output], the last (B,
    out_channels, T / prod(downsample_scales))."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        kernel_sizes: Sequence[int] = (5, 3),
        channels: int = 16,
        max_downsample_channels: int = 1024,
        bias: bool = True,
        downsample_scales: Sequence[int] = (4, 4, 4, 4),
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: dict | None = None,
        pad: str = "ReflectionPad1d",
        pad_params: dict | None = None,
        use_weight_norm: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if len(kernel_sizes) != 2 or kernel_sizes[0] % 2 == 0 or kernel_sizes[1] % 2 == 0:
            raise ValueError(f"kernel_sizes must be two odd sizes, got {kernel_sizes}")
        act_params = nonlinear_activation_params or {"negative_slope": 0.2}
        kw = dict(bias=bias, use_weight_norm=use_weight_norm, normal_std=INIT_STD,
                  generator=generator)

        def act():
            return get_activation(nonlinear_activation, act_params)

        k0 = math.prod(kernel_sizes)
        layers = [nn.Sequential(get_pad(pad, (k0 - 1) // 2, pad_params),
                                Conv1d(in_channels, channels, k0, padding=0, **kw), act())]
        in_chs = channels
        for s in downsample_scales:
            out_chs = min(in_chs * s, max_downsample_channels)
            layers.append(nn.Sequential(
                Conv1d(in_chs, out_chs, s * 10 + 1, stride=s, padding=s * 5,
                       groups=in_chs // 4, **kw), act()))
            in_chs = out_chs
        out_chs = min(in_chs * 2, max_downsample_channels)
        layers.append(nn.Sequential(Conv1d(in_chs, out_chs, kernel_sizes[0], **kw), act()))
        layers.append(Conv1d(out_chs, out_channels, kernel_sizes[1], **kw))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> list:
        outs = []
        for f in self.layers:
            x = f(x)
            outs.append(x)
        return outs


class MelGANMultiScaleDiscriminator(nn.Module):
    """wave (B, in_channels, T) -> one ``MelGANDiscriminator`` list of
    features per scale, scale i on the wave pooled i times."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        scales: int = 3,
        downsample_pooling: str = "AvgPool1d",
        downsample_pooling_params: dict | None = None,
        kernel_sizes: Sequence[int] = (5, 3),
        channels: int = 16,
        max_downsample_channels: int = 1024,
        bias: bool = True,
        downsample_scales: Sequence[int] = (4, 4, 4, 4),
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: dict | None = None,
        pad: str = "ReflectionPad1d",
        pad_params: dict | None = None,
        use_weight_norm: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if downsample_pooling != "AvgPool1d":
            raise ValueError(f"downsample_pooling {downsample_pooling!r} is not "
                             "supported: the JAX package pools with AvgPool1d alone")
        self.pool_params = {"kernel_size": 4, "stride": 2, "padding": 1,
                            "count_include_pad": False}
        self.pool_params.update(downsample_pooling_params or {})
        self.discriminators = nn.ModuleList([MelGANDiscriminator(
            in_channels=in_channels, out_channels=out_channels,
            kernel_sizes=kernel_sizes, channels=channels,
            max_downsample_channels=max_downsample_channels, bias=bias,
            downsample_scales=downsample_scales,
            nonlinear_activation=nonlinear_activation,
            nonlinear_activation_params=nonlinear_activation_params, pad=pad,
            pad_params=pad_params, use_weight_norm=use_weight_norm,
            generator=generator) for _ in range(scales)])

    def forward(self, x: torch.Tensor) -> list:
        outs = []
        for i, d in enumerate(self.discriminators):
            if i:  # JAX's avg_pool1d (:325-351) is torch's AvgPool1d
                x = F.avg_pool1d(x, **self.pool_params)
            outs.append(d(x))
        return outs
