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
``channels == 64`` (the JAX gate, :108-137) runs the blocks through the
fused path: blocks of input length at least ``pallas_tade_min_t`` (or,
with the train flag, ``pallas_tade_train_min_t`` and the train wrapper's
even-length and scale checks) whose aux width is 64 run the hand-written
CUDA kernels K8a/K8b on a GPU (their plain PyTorch version on the CPU);
the rest, block 0 always, run their own forward. ``use_pallas_tade_train``
sends the blocks through ``fused_tade_blocks_train`` (:114-120), with
gradients on or off, as JAX does: K8 forward, K9a/K9b backward, with the
weights gathered in the autograd graph under grad so that the gradients
reach ``weight_g``/``weight_v``. ``use_pallas_tade`` alone sends them
through the inference-only ``fused_tade_blocks``, so it raises with
gradients on, as in JAX.
``pallas_tade_tile`` and ``pallas_tade_train_tile`` are TPU tile sizes,
accepted for config compatibility and without effect.

``StyleMelGANDiscriminator`` (:330-399) is the random-window
discriminator: ``repeats`` passes over windows of ``window_sizes``, each
cut at a random start in [0, T - size), split into sub-bands by PQMF
(``pqmf_params``; one band means none) and judged by its own
``MelGANDiscriminator``, whose parameters every repeat shares. The starts
are drawn from an explicit CPU ``torch.Generator``, so that cutting needs
no device sync, or given as ``starts``.

``DiscreteSymbolStyleMelGANGenerator`` (:232-327) takes unit ids (B, 2, T)
(the speaker id in channel 1 of the first frame) for the mel: ``emb``
(width ``aux_channels``) and ``spk_emb``, added (which needs
``spk_emb_dim == aux_channels``) or concatenated, feed this trunk, whose
keys sit at the root as upstream's (JAX convert/torch_checkpoint.py:380-385).
At the shipped hubert scales (5, 2, 2, 2, 2, 2, 2, 1, 1) block 0 has an
aux width of 128, so the kernels' gate (width 64) leaves it to its own
forward at any length.
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
from parallelwavegan_tpu_torch.models.discrete import embed_symbols, embedding
from parallelwavegan_tpu_torch.models.melgan import MelGANDiscriminator
from parallelwavegan_tpu_torch.ops.kernels.tade_decode import (
    fused_tade_blocks,
    with_fragments,
)
from parallelwavegan_tpu_torch.ops.kernels.tade_train import fused_tade_blocks_train
from parallelwavegan_tpu_torch.ops.pqmf import PQMF


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
        """The TADE blocks through the fused path: (B, C, T) in and out."""
        x, c = x.transpose(1, 2).contiguous(), c.transpose(1, 2).contiguous()
        kw = dict(gated_function=self.gated_function, min_fused_t=self.min_fused_t)
        if torch.is_grad_enabled():  # never the folded cache: it is detached
            w = self.block_weights(differentiable=True)
        else:
            w = self._kernel_cache or self.block_weights()
        run = fused_tade_blocks_train if self.fused_train else fused_tade_blocks
        y, cy = run(x, c, w, **kw)
        return y.transpose(1, 2), cy.transpose(1, 2)

    def block_weights(self, differentiable: bool = False) -> list:
        """Every block's folded weights, as the fused path takes them;
        ``differentiable`` keeps them in the autograd graph."""
        return [blk.folded_weights(differentiable) for blk in self.blocks]

    def prepare_kernels(self) -> None:
        """Fold the blocks' weights once, for decode, and on the card split
        them once for the TADE kernels (``tade_decode.with_fragments``).
        Call it after the weights are loaded, folded and on their device;
        loading weights or moving the module afterwards drops them again."""
        if not self.use_fused:
            self._kernel_cache = None
            return
        self._kernel_cache = [with_fragments(w) if w["g1_w"].is_cuda else w
                              for w in self.block_weights()]

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)
        self._kernel_cache = None

    def _apply(self, fn, *args, **kwargs):
        self._kernel_cache = None
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._kernel_cache = None
        return super().load_state_dict(*args, **kwargs)


class DiscreteSymbolStyleMelGANGenerator(StyleMelGANGenerator):
    """(ids (B, 2, T'), z (B, in_channels, Tz)) -> wave (B, out_channels,
    T' * prod(upsample_scales)), T' = Tz * prod(noise_upsample_scales); z
    drawn as (B, in_channels, 1) from ``generator`` where it is None."""

    def __init__(self, in_channels: int = 128, aux_channels: int = 128,
                 channels: int = 64, out_channels: int = 1, num_embs: int = 100,
                 num_spk_embs: int = 128, spk_emb_dim: int = 128,
                 concat_spk_emb: bool = False, **kwargs):
        if not concat_spk_emb and aux_channels != spk_emb_dim:
            raise ValueError(f"adding the speaker embedding needs spk_emb_dim "
                             f"{spk_emb_dim} == aux_channels {aux_channels}")
        device = kwargs.pop("device", None)
        trunk_aux = aux_channels + spk_emb_dim if concat_spk_emb else aux_channels
        super().__init__(in_channels=in_channels, aux_channels=trunk_aux,
                         channels=channels, out_channels=out_channels, **kwargs)
        generator = kwargs.get("generator")
        self.emb = embedding(num_embs, aux_channels, generator)
        self.spk_emb = embedding(num_spk_embs, spk_emb_dim, generator)
        self.concat_spk_emb = concat_spk_emb
        if device is not None:
            self.to(device)

    def forward(self, c: torch.Tensor, z: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cond = embed_symbols(c, self.emb, self.spk_emb, self.concat_spk_emb)
        return super().forward(cond, z, generator)


# the JAX package's defaults for the base discriminators (:358-369)
_D_DEFAULTS = {
    "out_channels": 1, "kernel_sizes": [5, 3], "channels": 16,
    "max_downsample_channels": 512, "bias": True, "downsample_scales": [4, 4, 4, 1],
    "nonlinear_activation": "LeakyReLU",
    "nonlinear_activation_params": {"negative_slope": 0.2},
    "pad": "ReflectionPad1d", "pad_params": {},
}


class StyleMelGANDiscriminator(nn.Module):
    """wave (B, 1, T) -> one feature list per window, ``repeats *
    len(window_sizes)`` of them, each a ``MelGANDiscriminator``'s output."""

    def __init__(
        self,
        repeats: int = 2,
        window_sizes: Sequence[int] = (512, 1024, 2048, 4096),
        pqmf_params: Sequence[Sequence] = (
            (1, None, None, None),
            (2, 62, 0.26700, 9.0),
            (4, 62, 0.14200, 9.0),
            (8, 62, 0.07949, 9.0),
        ),
        discriminator_params: dict | None = None,
        use_weight_norm: bool = True,
        device: torch.device | str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if len(window_sizes) != len(pqmf_params):
            raise ValueError("window_sizes and pqmf_params differ in length")
        sizes = {ws // p[0] for ws, p in zip(window_sizes, pqmf_params)}
        if len(sizes) != 1:
            raise ValueError(f"every window must give one length per band, got {sizes}")
        self.repeats = repeats
        self.window_sizes = tuple(int(ws) for ws in window_sizes)
        params = dict(_D_DEFAULTS, **(discriminator_params or {}))
        self.discriminators = nn.ModuleList(
            MelGANDiscriminator(**dict(params, in_channels=p[0]),
                                use_weight_norm=use_weight_norm, generator=generator)
            for p in pqmf_params)
        self.pqmfs = [None if p[0] == 1 else PQMF(*p) for p in pqmf_params]
        if device is not None:
            self.to(device)

    def draw_starts(self, length: int, generator: torch.Generator | None = None) -> list:
        """``repeats * len(window_sizes)`` window starts, each uniform in
        [0, length - size), from ``generator`` (a CPU one) or torch's
        global CPU generator."""
        return [int(torch.randint(0, length - ws, (), generator=generator))
                for _ in range(self.repeats) for ws in self.window_sizes]

    def forward(self, x: torch.Tensor, starts=None,
                generator: torch.Generator | None = None) -> list:
        """``starts`` (``repeats * len(window_sizes)`` ints) pins the
        windows; without it they are drawn (``draw_starts``)."""
        if starts is None:
            starts = self.draw_starts(x.shape[-1], generator)
        starts = [int(v) for v in starts]
        if len(starts) != self.repeats * len(self.window_sizes):
            raise ValueError(f"{len(starts)} starts for {self.repeats} repeats of "
                             f"{len(self.window_sizes)} windows")
        outs, i = [], 0
        for _ in range(self.repeats):
            for ws, pqmf, disc in zip(self.window_sizes, self.pqmfs, self.discriminators):
                x_ = x[..., starts[i]:starts[i] + ws]
                i += 1
                if pqmf is not None:
                    x_ = pqmf.analysis(x_.transpose(1, 2)).transpose(1, 2)
                outs.append(disc(x_))
        return outs
