"""HiFi-GAN generator and discriminators (PyTorch, (B, C, T) layout).

Counterpart of parallelwavegan_tpu/models/hifigan.py:137-631. Submodule
names and ``nn.Sequential`` nesting reproduce upstream's state-dict keys
(``input_conv.*``, ``upsamples.{i}.1.*``, ``blocks.{j}.convs{1,2}.{m}.1.*``,
``output_conv.1.*``), so a state dict of this module is an upstream
checkpoint and ``parallelwavegan_tpu``'s ``load_model`` reads it.

Kernel flags keep the JAX names so that configs are shared:

* ``use_pallas_tail``, under the JAX gate (:203-221, with the discrete
  trunk's kernel test, models/discrete.py:111-116): the last two stride-2
  stages and the output conv run through ``fused_hifigan_tail``.
* ``use_pallas_mrf``, under the JAX gate (:290-313: not causal,
  ``use_additional_convs``, ``bias``, stage width at most
  ``pallas_mrf_max_channels``) and a LeakyReLU activation (the kernel
  computes LeakyReLU): each such stage's MRF runs through
  ``fused_hifigan_mrf``. On v1 with the default maximum of 64 that is
  stages 2 and 3. The tail takes precedence over it, as in JAX.

Either runs the hand-written CUDA kernel on a GPU and its plain PyTorch
version on the CPU. ``pallas_mrf_tile`` and ``pallas_tail_tile`` are the
TPU kernels' tile sizes: they are accepted for config compatibility and
have no effect here.

``use_causal_conv`` (JAX :152, :179-186, :252-261, :284, :322-330) builds
upstream's causal generator: ``CausalConv1d`` input and output convs
(``input_conv.conv.*``, ``output_conv.1.conv.*``),
``CausalConvTranspose1d`` upsamples (``upsamples.{i}.1.deconv.*``) and
causal resblocks. JAX sends it through neither kernel (:205, :292), so
with ``use_pallas_tail`` or ``use_pallas_mrf`` set it takes the plain
path, as there.

The five discriminators (JAX :367-631) keep upstream's state-dict keys
(``convs.{j}.0.*`` and ``output_conv.*`` of a period discriminator,
``layers.{j}.0.*`` and the last ``layers.{n}.*`` of a scale discriminator,
nested under ``discriminators.{i}``, and ``msd.``/``mpd.`` in the
combined one), the keys the JAX converter translates
(convert/torch_checkpoint.py:82-122, 437-469). Each returns a list of
every layer's output per discriminator, the last entry the final output.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

import torch.nn.functional as F

from parallelwavegan_tpu_torch.layers.convs import (
    CausalConv1d,
    CausalConvTranspose1d,
    Conv1d,
    Conv2d,
    ConvTranspose1d,
    remove_weight_norm,
)
from parallelwavegan_tpu_torch.layers.residual_block import (
    LeakyReLU,
    HiFiGANResidualBlock,
    get_activation,
)
from parallelwavegan_tpu_torch.ops.kernels.hifigan_mrf import (
    fused_hifigan_mrf,
)
from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
    fused_hifigan_tail,
    with_fragments,
)


class HiFiGANGenerator(nn.Module):
    """mel (B, in_channels, T) -> wave (B, out_channels, T * prod(scales))."""

    def __init__(
        self,
        in_channels: int = 80,
        out_channels: int = 1,
        channels: int = 512,
        kernel_size: int = 7,
        upsample_scales: Sequence[int] = (8, 8, 2, 2),
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
        use_additional_convs: bool = True,
        bias: bool = True,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: dict | None = None,
        use_causal_conv: bool = False,
        use_weight_norm: bool = True,
        use_pallas_mrf: bool = False,
        pallas_mrf_tile: int = 1536,
        pallas_mrf_max_channels: int = 64,
        use_pallas_tail: bool = False,
        pallas_tail_tile: int = 1024,
        device: torch.device | str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        assert kernel_size % 2 == 1, "Kernel size must be odd number."
        assert len(upsample_scales) == len(upsample_kernel_sizes)
        assert len(resblock_dilations) == len(resblock_kernel_sizes)
        act_params = nonlinear_activation_params or {"negative_slope": 0.1}
        self.upsample_scales = tuple(int(s) for s in upsample_scales)
        self.num_blocks = len(resblock_kernel_sizes)
        # without weight norm the reference's N(0, 0.01) reset is effective
        normal_std = None if use_weight_norm else 0.01
        conv_kw = dict(bias=bias, use_weight_norm=use_weight_norm,
                       normal_std=normal_std, generator=generator)

        conv = CausalConv1d if use_causal_conv else Conv1d
        self.input_conv = conv(in_channels, channels, kernel_size, **conv_kw)
        self.upsamples = nn.ModuleList()
        self.blocks = nn.ModuleList()
        for i, (s, k) in enumerate(zip(upsample_scales, upsample_kernel_sizes)):
            ch = channels // (2 ** (i + 1))
            pad, out_pad = self.deconv_padding(k, s)
            if use_causal_conv:
                deconv = CausalConvTranspose1d(channels // (2 ** i), ch, k, s, **conv_kw)
            else:
                deconv = ConvTranspose1d(channels // (2 ** i), ch, k, s, padding=pad,
                                         output_padding=out_pad, **conv_kw)
            self.upsamples.append(nn.Sequential(
                get_activation(nonlinear_activation, act_params), deconv))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilations):
                self.blocks.append(HiFiGANResidualBlock(
                    kernel_size=rk, channels=ch, dilations=rd, bias=bias,
                    use_additional_convs=use_additional_convs,
                    nonlinear_activation=nonlinear_activation,
                    nonlinear_activation_params=act_params,
                    use_weight_norm=use_weight_norm, use_causal_conv=use_causal_conv,
                    generator=generator,
                ))
        # official impl uses the default LeakyReLU slope (0.01) here
        self.output_conv = nn.Sequential(
            LeakyReLU(),
            conv(channels // (2 ** len(upsample_scales)), out_channels,
                 kernel_size, **conv_kw),
            nn.Tanh(),
        )

        n_up = len(self.upsample_scales)
        self.tail_from = None
        if (
            use_pallas_tail
            and not use_causal_conv
            and use_additional_convs
            and bias
            and out_channels == 1
            and nonlinear_activation == "LeakyReLU"
            and n_up >= 2
            and all(s == 2 for s in self.upsample_scales[-2:])
            # the kernel's stages give s * T samples, which the discrete
            # trunk's (K - s) // 2 padding gives only for K == 2s
            and all(k == 2 * s for s, k in zip(self.upsample_scales[-2:],
                                               upsample_kernel_sizes[-2:]))
        ):
            c_tail = channels // (2 ** (n_up - 2))
            # the same gate as the JAX generator: tail entry width a
            # power of two <= 128
            if c_tail <= 128 and (c_tail & (c_tail - 1)) == 0:
                self.tail_from = n_up - 2
        self.slope = act_params.get("negative_slope", 0.1)
        # stages whose MRF runs through fused_hifigan_mrf
        self.mrf_stages = tuple(
            i for i in range(n_up)
            if use_pallas_mrf and not use_causal_conv and use_additional_convs and bias
            and nonlinear_activation == "LeakyReLU"
            and channels // (2 ** (i + 1)) <= pallas_mrf_max_channels)
        self._tail_cache = None
        self._mrf_cache = None
        if device is not None:
            self.to(device)

    @staticmethod
    def deconv_padding(kernel_size: int, scale: int) -> tuple:
        """(padding, output_padding) of a stage's transposed conv: s // 2 +
        s % 2 and s % 2, for a kernel of 2s (upstream's HiFi-GAN)."""
        assert kernel_size == 2 * scale
        return scale // 2 + scale % 2, scale % 2

    @property
    def upsample_factor(self) -> int:
        f = 1
        for s in self.upsample_scales:
            f *= s
        return f

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        c = self.input_conv(c)
        nb = self.num_blocks
        if self.tail_from == 0:
            return self._fused_tail(c)
        for i in range(len(self.upsample_scales)):
            c = self.upsamples[i](c)
            if self.tail_from is not None and i == self.tail_from - 1:
                # this stage's MRF folds into the tail at the entry rate
                return self._fused_tail(c)
            if i in self.mrf_stages:
                c = self._fused_mrf(c, i)
                continue
            cs = self.blocks[i * nb](c)
            for j in range(1, nb):
                cs = cs + self.blocks[i * nb + j](c)
            c = cs / nb
        return self.output_conv(c)

    def _fused_mrf(self, c: torch.Tensor, i: int) -> torch.Tensor:
        blocks = (self._mrf_cache or {}).get(i) or self.mrf_weights(i)
        y = fused_hifigan_mrf(c.transpose(1, 2).contiguous(), blocks,
                              slope=self.slope)
        return y.transpose(1, 2)

    def mrf_weights(self, i: int, fragments: bool = False) -> list:
        """Stage ``i``'s resblocks in the block form of
        ``fused_hifigan_mrf``, from the current effective weights; with
        ``fragments``, also their split for the tensor cores
        (``with_fragments``)."""
        nb = self.num_blocks
        blocks = [self.blocks[i * nb + j].gather_weights() for j in range(nb)]
        return with_fragments(blocks) if fragments else blocks

    def _fused_tail(self, c: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled():
            # the kernel has no backward and the bundle is detached: a
            # training forward would silently drop the tail's gradients
            raise RuntimeError("use_pallas_tail is inference-only: run the "
                               "forward under torch.inference_mode()")
        w = self._tail_cache or self.tail_weights()
        y = fused_hifigan_tail(
            c.transpose(1, 2).contiguous(), w["stages"], w["final_w"],
            w["final_b"], slope=self.slope, pre_blocks=w["pre_blocks"],
        )
        return y.transpose(1, 2)

    def tail_weights(self, fragments: bool = False) -> dict:
        """The weight bundle of ``fused_hifigan_tail`` in the JAX gather
        form (hifigan_tail.py:86-90), from the current effective weights;
        with ``fragments``, each MRF's blocks also carry their split for the
        tensor cores (``with_fragments``)."""
        tf = self.tail_from

        def blocks(i):
            return self.mrf_weights(i, fragments)

        stages = []
        for i in range(tf, len(self.upsample_scales)):
            deconv = self.upsamples[i][1]
            stages.append({
                "deconv_w": deconv.gather_weight().detach().contiguous(),
                "deconv_b": deconv.bias.detach().contiguous(),
                "stride": deconv.stride[0],
                "padding": deconv.padding[0],
                "blocks": blocks(i),
            })
        out_conv = self.output_conv[1]
        return {
            "pre_blocks": blocks(tf - 1) if tf > 0 else None,
            "stages": stages,
            "final_w": out_conv.gather_weight().detach().contiguous(),
            "final_b": out_conv.bias.detach().contiguous(),
        }

    def prepare_kernels(self) -> None:
        """Build the tail and MRF weight bundles once, for decode, with the
        residual units' weights split for the tensor cores. Call it after
        the weights are loaded, folded and on their device; loading weights
        or moving the module afterwards drops the bundles again."""
        self._tail_cache = (self.tail_weights(fragments=True)
                            if self.tail_from is not None else None)
        self._mrf_cache = {i: self.mrf_weights(i, fragments=True)
                           for i in self.mrf_stages}

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)
        self._tail_cache = self._mrf_cache = None

    def _apply(self, fn, *args, **kwargs):
        self._tail_cache = self._mrf_cache = None
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._tail_cache = self._mrf_cache = None
        return super().load_state_dict(*args, **kwargs)


def _leaky(name: str, params: dict | None) -> nn.Module:
    return get_activation(name, params or {"negative_slope": 0.1})


class HiFiGANPeriodDiscriminator(nn.Module):
    """wave (B, in_channels, T) -> [every layer's output]: T is reflect-padded
    to a multiple of ``period`` and folded to (B, C, T / period, period);
    the last entry is the output conv's, flattened to (B, -1)."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        period: int = 3,
        kernel_sizes: Sequence[int] = (5, 3),
        channels: int = 32,
        downsample_scales: Sequence[int] = (3, 3, 3, 3, 1),
        max_downsample_channels: int = 1024,
        bias: bool = True,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: dict | None = None,
        use_weight_norm: bool = True,
        use_spectral_norm: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.period = period
        kw = dict(bias=bias, use_weight_norm=use_weight_norm,
                  use_spectral_norm=use_spectral_norm, generator=generator)
        k0, k1 = kernel_sizes
        self.convs = nn.ModuleList()
        in_chs, out_chs = in_channels, channels
        for scale in downsample_scales:
            self.convs.append(nn.Sequential(
                Conv2d(in_chs, out_chs, (k0, 1), stride=(scale, 1),
                       padding=((k0 - 1) // 2, 0), **kw),
                _leaky(nonlinear_activation, nonlinear_activation_params)))
            in_chs, out_chs = out_chs, min(out_chs * 4, max_downsample_channels)
        # kernel (k1 - 1, 1) with padding (k1 - 1) // 2: the JAX package's
        # (and upstream's) output conv
        self.output_conv = Conv2d(in_chs, out_channels, (k1 - 1, 1),
                                  padding=((k1 - 1) // 2, 0), **kw)

    def forward(self, x: torch.Tensor) -> list:
        b, c, t = x.shape
        if t % self.period:
            x = F.pad(x, (0, self.period - t % self.period), "reflect")
            t = x.shape[-1]
        x = x.reshape(b, c, t // self.period, self.period)
        outs = []
        for layer in self.convs:
            x = layer(x)
            outs.append(x)
        outs.append(torch.flatten(self.output_conv(x), 1))
        return outs


class HiFiGANMultiPeriodDiscriminator(nn.Module):
    """One period discriminator per entry of ``periods``."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 discriminator_params: dict | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        params = dict(discriminator_params or {})
        self.discriminators = nn.ModuleList(
            HiFiGANPeriodDiscriminator(**dict(params, period=p), generator=generator)
            for p in periods)

    def forward(self, x: torch.Tensor) -> list:
        return [d(x) for d in self.discriminators]


class HiFiGANScaleDiscriminator(nn.Module):
    """wave (B, in_channels, T) -> [every layer's output]: a conv, strided
    grouped convs (groups 4, times 4 per layer up to ``max_groups``), a
    conv and the output conv."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        kernel_sizes: Sequence[int] = (15, 41, 5, 3),
        channels: int = 128,
        max_downsample_channels: int = 1024,
        max_groups: int = 16,
        bias: bool = True,
        downsample_scales: Sequence[int] = (2, 2, 4, 4, 1),
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: dict | None = None,
        use_weight_norm: bool = True,
        use_spectral_norm: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if len(kernel_sizes) != 4 or any(k % 2 == 0 for k in kernel_sizes):
            raise ValueError(f"kernel_sizes must be four odd sizes, got {kernel_sizes}")
        kw = dict(bias=bias, use_weight_norm=use_weight_norm,
                  use_spectral_norm=use_spectral_norm, generator=generator)

        def act():
            return _leaky(nonlinear_activation, nonlinear_activation_params)

        k0, k1, k2, k3 = kernel_sizes
        layers = [nn.Sequential(Conv1d(in_channels, channels, k0, **kw), act())]
        in_chs = out_chs = channels
        groups = 4
        for scale in downsample_scales:
            layers.append(nn.Sequential(
                Conv1d(in_chs, out_chs, k1, stride=scale, padding=(k1 - 1) // 2,
                       groups=groups, **kw), act()))
            in_chs, out_chs = out_chs, min(out_chs * 2, max_downsample_channels)
            groups = min(groups * 4, max_groups)
        out_chs = min(in_chs * 2, max_downsample_channels)
        layers.append(nn.Sequential(Conv1d(in_chs, out_chs, k2, **kw), act()))
        layers.append(Conv1d(out_chs, out_channels, k3, **kw))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> list:
        outs = []
        for f in self.layers:
            x = f(x)
            outs.append(x)
        return outs


def _pool_params(key: str, pooling: str, params: dict | None) -> dict:
    """torch's AvgPool1d(4, 2, 2) updated by ``params``, the one pooling
    the JAX package computes (its ``avg_pool1d``, :549, whatever ``key``
    names); any other pooling, or another argument, raises."""
    if pooling != "AvgPool1d":
        raise ValueError(f"{key}: {pooling!r} is not supported, only AvgPool1d")
    pool = {"kernel_size": 4, "stride": 2, "padding": 2}
    unknown = set(params or {}) - set(pool)
    if unknown:
        raise ValueError(f"{key}_params: {sorted(unknown)} are not supported")
    return dict(pool, **(params or {}))


class HiFiGANMultiScaleDiscriminator(nn.Module):
    """``scales`` scale discriminators, the input average-pooled (padding
    counted) between them; with ``follow_official_norm`` the first uses
    spectral norm and the rest weight norm."""

    def __init__(self, scales: int = 3, downsample_pooling: str = "AvgPool1d",
                 downsample_pooling_params: dict | None = None,
                 discriminator_params: dict | None = None,
                 follow_official_norm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.pool = _pool_params("downsample_pooling", downsample_pooling,
                                 downsample_pooling_params)
        params = dict(discriminator_params or {})
        self.discriminators = nn.ModuleList()
        for i in range(scales):
            p = dict(params)
            if follow_official_norm:
                p.update(use_weight_norm=i != 0, use_spectral_norm=i == 0)
            self.discriminators.append(
                HiFiGANScaleDiscriminator(**p, generator=generator))

    def forward(self, x: torch.Tensor) -> list:
        outs = []
        for i, d in enumerate(self.discriminators):
            if i:
                x = F.avg_pool1d(x, **self.pool, count_include_pad=True)
            outs.append(d(x))
        return outs


class HiFiGANMultiScaleMultiPeriodDiscriminator(nn.Module):
    """The multi-scale discriminator's outputs, then the multi-period
    discriminator's."""

    def __init__(self, scales: int = 3,
                 scale_downsample_pooling: str = "AvgPool1d",
                 scale_downsample_pooling_params: dict | None = None,
                 scale_discriminator_params: dict | None = None,
                 follow_official_norm: bool = True,
                 periods: Sequence[int] = (2, 3, 5, 7, 11),
                 period_discriminator_params: dict | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        _pool_params("scale_downsample_pooling", scale_downsample_pooling,
                     scale_downsample_pooling_params)
        self.msd = HiFiGANMultiScaleDiscriminator(
            scales, scale_downsample_pooling, scale_downsample_pooling_params,
            scale_discriminator_params, follow_official_norm, generator=generator)
        self.mpd = HiFiGANMultiPeriodDiscriminator(
            periods, period_discriminator_params, generator=generator)

    def forward(self, x: torch.Tensor) -> list:
        return self.msd(x) + self.mpd(x)
