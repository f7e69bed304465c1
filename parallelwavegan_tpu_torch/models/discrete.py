"""Discrete-symbol (HuBERT-unit) vocoder generators (PyTorch, (B, C, T) layout).

Counterpart of parallelwavegan_tpu/models/discrete.py:

* ``DiscreteSymbolHiFiGANGenerator`` (:208-264): unit ids c (B, 1, T), or
  (B, 2, T) with the speaker id in channel 1, embedded by ``emb`` (and
  the speaker of the first frame, ``c[:, 1, 0]``, by ``spk_emb``, added to
  every frame or concatenated to it), then a HiFi-GAN trunk. The trunk is
  ``HiFiGANGenerator`` itself, so its keys sit at the root as upstream's
  (``input_conv``, ``upsamples.{i}.1``, ``blocks.{j}``, ``output_conv.1``;
  JAX convert/torch_checkpoint.py:366-378), with the discrete trunk's
  transposed convs: padding (K - s) // 2 and no output padding
  (:146-162), where HiFi-GAN's mel trunk takes s // 2 + s % 2 and s % 2
  for K = 2s. ``use_pallas_tail`` runs the fused tail (K1) through the
  trunk's gate, which holds K == 2s on the last two stages as JAX's
  discrete gate does (:111-116): at the shipped scales (10, 8, 2, 2) the
  kernel takes stage 1's MRF at the entry rate and stages 2-3, at 80
  frames per unit and a width of 128. Ids come in any dtype (the
  collater's float32 tokens too) and are cast on their device.
* ``DiscreteSymbolDurationGenerator`` (:267-321): a vocabulary of
  ``num_embs + 1`` (a padding symbol) and a ``DurationPredictor`` on the
  embeddings. ``forward(c, ds, out_length, generator)`` expands the
  embeddings by the given durations to ``out_length`` frames
  (``length_regulator``) and returns (wave, log-domain predicted
  durations), the predictor's dropout active in train mode with masks
  from ``generator``; ``predict_durations``, ``embed_tokens`` and
  ``decode_expanded`` are decode's pieces (``utils/model.py`` expands on
  the host).

Embeddings start N(0, 1), as torch's, from the explicit ``torch.Generator``
passed in; the trunk as ``HiFiGANGenerator``'s.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from parallelwavegan_tpu_torch.layers.duration import DurationPredictor, length_regulator
from parallelwavegan_tpu_torch.models.hifigan import HiFiGANGenerator


def embedding(num: int, dim: int, generator: torch.Generator | None) -> nn.Embedding:
    """An ``nn.Embedding`` of N(0, 1) rows drawn from ``generator``."""
    emb = nn.Embedding(num, dim)
    with torch.no_grad():
        emb.weight.normal_(0.0, 1.0, generator=generator)
    return emb


def embed_symbols(c: torch.Tensor, emb: nn.Embedding, spk_emb: nn.Embedding | None,
                  concat_spk_emb: bool) -> torch.Tensor:
    """Ids c (B, 1|2, T) -> embeddings (B, C, T): the unit ids of channel 0
    through ``emb``, and with ``spk_emb`` the speaker id of channel 1's first
    frame through it, added to every frame or concatenated to it."""
    if c.shape[1] != (1 if spk_emb is None else 2):
        raise ValueError(f"ids of {c.shape[1]} channels: 1 with no speaker "
                         "embedding, 2 (unit, speaker) with one")
    x = emb(c[:, 0].long())  # (B, T, C)
    if spk_emb is not None:
        spk = spk_emb(c[:, 1, 0].long())[:, None, :]  # (B, 1, D)
        x = (torch.cat([x, spk.expand(-1, x.shape[1], -1)], dim=-1) if concat_spk_emb
             else x + spk)
    return x.transpose(1, 2)


class DiscreteSymbolHiFiGANGenerator(HiFiGANGenerator):
    """Ids (B, 1|2, T) -> wave (B, out_channels, T * prod(upsample_scales))."""

    EXTRA_SYMBOLS = 0  # symbols past num_embs (the duration model's padding)

    def __init__(
        self,
        in_channels: int = 512,
        out_channels: int = 1,
        channels: int = 512,
        num_embs: int = 100,
        num_spk_embs: int = 128,
        spk_emb_dim: int = 128,
        concat_spk_emb: bool = False,
        kernel_size: int = 7,
        upsample_scales: Sequence[int] = (8, 8, 2, 2),
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
        use_additional_convs: bool = True,
        bias: bool = True,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: dict | None = None,
        use_weight_norm: bool = True,
        use_pallas_tail: bool = False,
        pallas_tail_tile: int = 1024,
        device: torch.device | str | None = None,
        generator: torch.Generator | None = None,
    ):
        concat = num_spk_embs > 0 and concat_spk_emb
        emb_channels = in_channels + spk_emb_dim if concat else in_channels
        super().__init__(
            in_channels=emb_channels, out_channels=out_channels,
            channels=channels, kernel_size=kernel_size,
            upsample_scales=upsample_scales, upsample_kernel_sizes=upsample_kernel_sizes,
            resblock_kernel_sizes=resblock_kernel_sizes,
            resblock_dilations=resblock_dilations,
            use_additional_convs=use_additional_convs, bias=bias,
            nonlinear_activation=nonlinear_activation,
            nonlinear_activation_params=nonlinear_activation_params,
            use_weight_norm=use_weight_norm, use_pallas_tail=use_pallas_tail,
            pallas_tail_tile=pallas_tail_tile, generator=generator)
        self.emb_channels = emb_channels
        self.emb = embedding(num_embs + self.EXTRA_SYMBOLS, in_channels, generator)
        self.spk_emb = (embedding(num_spk_embs, spk_emb_dim, generator)
                        if num_spk_embs > 0 else None)
        self.concat_spk_emb = concat
        if device is not None:
            self.to(device)

    @staticmethod
    def deconv_padding(kernel_size: int, scale: int) -> tuple:
        """The discrete trunk's (K - s) // 2 and no output padding, any K."""
        return (kernel_size - scale) // 2, 0

    def embed_tokens(self, c: torch.Tensor) -> torch.Tensor:
        """Ids (B, 1|2, T) -> embeddings (B, emb_channels, T)."""
        return embed_symbols(c, self.emb, self.spk_emb, self.concat_spk_emb)

    def decode_expanded(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk on embeddings (B, emb_channels, T)."""
        return super().forward(x)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.decode_expanded(self.embed_tokens(c))


class DiscreteSymbolDurationGenerator(DiscreteSymbolHiFiGANGenerator):
    """(ids (B, 1|2, T), durations (B, T), out_length) -> (wave (B,
    out_channels, out_length * prod(upsample_scales)), log-durations (B, T))."""

    EXTRA_SYMBOLS = 1

    def __init__(self, *args, duration_layers: int = 2, duration_chans: int = 384,
                 duration_kernel_size: int = 3, duration_offset: float = 1.0,
                 duration_dropout_rate: float = 0.5, **kwargs):
        device = kwargs.pop("device", None)
        super().__init__(*args, **kwargs)
        self.duration_predictor = DurationPredictor(
            self.emb_channels, n_layers=duration_layers, n_chans=duration_chans,
            kernel_size=duration_kernel_size, dropout_rate=duration_dropout_rate,
            offset=duration_offset, generator=kwargs.get("generator"))
        if device is not None:
            self.to(device)

    def forward(self, c: torch.Tensor, ds: torch.Tensor, out_length: int,
                generator: torch.Generator | None = None):
        emb = self.embed_tokens(c)
        ds_out = self.duration_predictor(emb, generator=generator)
        return self.decode_expanded(length_regulator(emb, ds, out_length)), ds_out

    def predict_durations(self, c: torch.Tensor) -> torch.Tensor:
        """Integer durations (B, T) of ids (B, 1|2, T), no dropout."""
        return self.duration_predictor.inference(self.embed_tokens(c))
