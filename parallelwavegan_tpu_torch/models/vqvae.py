"""VQ-VAE wave-to-wave codec (PyTorch, (B, C, T) layout).

Counterpart of parallelwavegan_tpu/models/vqvae.py:31-133: the port's
``MelGANDiscriminator`` is the encoder (its last feature map is the
latent z_e, (B, embed_dim, T / prod(downsample_scales))), a
``VQCodebook`` quantizes it with straight-through gradients, and the
port's ``MelGANGenerator(**decoder_conf)`` decodes the quantized latent,
concatenated with the optional local conditioning (a weight-normed 1x1
conv of ``num_local_embeds`` features to ``local_embed_dim``, on the
latent's grid) and global conditioning (an ``nn.Embedding`` of
``num_global_embeds`` ids, broadcast over time). ``decoder_conf`` is
passed on as given, so its ``use_pallas_stacks`` and
``use_pallas_stacks_train`` reach the MelGAN stack kernels (K6, K7) as
they do in JAX. ``use_weight_norm`` is the encoder's norm and the
decoder's, as JAX sets it. Any ``decoder_type`` other than
``MelGANGenerator`` raises, as in JAX.

``forward(x, l, g)`` -> (x_bar, z_e, z_q): the reconstruction and both
latents (B, T', embed_dim), z_q the codebook's rows with their gradient
(the quantization and commitment losses read them). ``encode`` gives
the codebook indices of a wave and ``decode`` the wave of indices, the
split that decode uses. The keys are upstream's: ``encoder.layers.*``,
``codebook.embedding.weight``, ``decoder.melgan.*``, ``local_embed.*``
and ``global_embed.weight`` (JAX convert/torch_checkpoint.py:318-350).
``remove_weight_norm`` and ``prepare_kernels`` reach the decoder, so
decode keeps K6's split weights as the MelGAN decode does.
"""

from __future__ import annotations

import torch
from torch import nn

from parallelwavegan_tpu_torch.layers.convs import Conv1d, remove_weight_norm
from parallelwavegan_tpu_torch.layers.vq import VQCodebook
from parallelwavegan_tpu_torch.models.melgan import MelGANDiscriminator, MelGANGenerator

_ENCODER_DEFAULT = {"out_channels": 256, "downsample_scales": [4, 4, 2, 2],
                    "max_downsample_channels": 1024}
_DECODER_DEFAULT = {"in_channels": 256, "upsample_scales": [4, 4, 2, 2],
                    "channels": 512, "stacks": 3}


class VQVAE(nn.Module):
    """wave (B, in_channels, T) -> (recon (B, out_channels, T), z_e, z_q)."""

    requires_noise_input = False
    requires_aux_input = False

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        num_embeds: int = 512,
        embed_dim: int = 256,
        num_local_embeds: int | None = None,
        local_embed_dim: int | None = None,
        num_global_embeds: int | None = None,
        global_embed_dim: int | None = None,
        encoder_type: str = "MelGANDiscriminator",
        decoder_type: str = "MelGANGenerator",
        encoder_conf: dict | None = None,
        decoder_conf: dict | None = None,
        use_weight_norm: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if encoder_type != "MelGANDiscriminator":
            raise NotImplementedError(f"{encoder_type} is not supported yet.")
        if decoder_type != "MelGANGenerator":
            raise NotImplementedError(f"{decoder_type} is not supported yet.")
        enc_conf = dict(encoder_conf or _ENCODER_DEFAULT, in_channels=in_channels)
        dec_conf = dict(decoder_conf or _DECODER_DEFAULT, out_channels=out_channels,
                        use_weight_norm=use_weight_norm)
        self.encoder = MelGANDiscriminator(**enc_conf, use_weight_norm=use_weight_norm,
                                           generator=generator)
        self.codebook = VQCodebook(num_embeds, embed_dim, generator=generator)
        self.decoder = MelGANGenerator(**dec_conf, generator=generator)
        self.local_embed = None
        if num_local_embeds is not None and local_embed_dim is not None:
            self.local_embed = Conv1d(num_local_embeds, local_embed_dim, 1, padding=0,
                                      use_weight_norm=use_weight_norm,
                                      generator=generator)
        self.global_embed = None
        if num_global_embeds is not None:
            self.global_embed = nn.Embedding(num_global_embeds, global_embed_dim)
            with torch.no_grad():
                self.global_embed.weight.normal_(generator=generator)

    @property
    def downsample_factor(self) -> int:
        """Wave samples per latent frame."""
        f = 1
        for layer in self.encoder.layers[1:-2]:
            f *= layer[0].stride[0]
        return f

    def _encode_latent(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder's last feature map as (B, T', embed_dim)."""
        return self.encoder(x)[-1].transpose(1, 2)

    def _condition(self, z: torch.Tensor, l: torch.Tensor | None,
                   g: torch.Tensor | None) -> torch.Tensor:
        """The latent (B, T', D) with the local features (B, num_local_embeds,
        T') embedded and the global ids (B,) embedded and broadcast, as the
        decoder's input (B, D + ..., T')."""
        z = z.transpose(1, 2)
        if l is not None:
            if self.local_embed is not None:
                l = self.local_embed(l)
            z = torch.cat([z, l.to(z.dtype)], dim=1)
        if g is not None:
            ge = self.global_embed(g.long().reshape(-1)).to(z.dtype)  # (B, D)
            z = torch.cat([z, ge[:, :, None].expand(-1, -1, z.shape[-1])], dim=1)
        return z

    def forward(self, x: torch.Tensor, l: torch.Tensor | None = None,
                g: torch.Tensor | None = None):
        """-> (x_bar, z_e, z_q), both latents (B, T / downsample_factor,
        embed_dim)."""
        z_e = self._encode_latent(x)
        z_q_st, z_q = self.codebook.straight_through(z_e)
        x_bar = self.decoder(self._condition(z_q_st, l, g))
        return x_bar, z_e, z_q

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Wave (B, in_channels, T) -> codebook indices (B, T / downsample_factor)."""
        return self.codebook(self._encode_latent(x))

    def decode(self, indices: torch.Tensor, l: torch.Tensor | None = None,
               g: torch.Tensor | None = None) -> torch.Tensor:
        """Codebook indices (B, T') -> wave (B, out_channels, T' * factor)."""
        z_q = self.codebook.embedding.weight[indices]
        return self.decoder(self._condition(z_q, l, g))

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)
        self.decoder.remove_weight_norm()

    def prepare_kernels(self) -> None:
        self.decoder.prepare_kernels()

    def load_state_dict(self, *args, **kwargs):
        self.decoder._kernel_cache = None
        return super().load_state_dict(*args, **kwargs)
