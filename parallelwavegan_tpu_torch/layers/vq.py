"""Vector-quantization codebook with straight-through gradients (PyTorch).

Counterpart of parallelwavegan_tpu/layers/vq.py:26-79:

* ``nearest_codebook_indices``: the nearest codebook row of each latent,
  as the expression JAX computes, argmin over |e|^2 - 2 z.e (|z|^2 is
  the same for every row), the first index winning a tie (torch's
  ``argmin`` and JAX's both take the first). ``torch.cdist`` computes
  another expression and breaks near ties differently.
* ``VQCodebook``: ``num_embeds`` x ``embed_dim`` rows (upstream's
  ``embedding.weight`` key), initialised U(-1/N, 1/N) from the explicit
  ``torch.Generator`` passed in; ``straight_through`` gives the decoder's
  input z_q = z_e + (lookup - z_e).detach(), the lookup taken from the
  detached codebook (its gradient reaches z_e as the identity and the
  codebook not at all), and z_q_bar, the rows themselves, which carry the
  codebook's gradient for the quantization loss.

Latents are (..., embed_dim); the VQ-VAE gives them as (B, T, D).
"""

from __future__ import annotations

import torch
from torch import nn


def nearest_codebook_indices(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Latents (..., D) and a codebook (N, D) -> int64 indices (...)."""
    flat = z_e.reshape(-1, z_e.shape[-1])
    dist = torch.sum(codebook ** 2, dim=1)[None, :] - 2.0 * (flat @ codebook.t())
    return torch.argmin(dist, dim=-1).reshape(z_e.shape[:-1])


class VQCodebook(nn.Module):
    """A codebook of ``num_embeds`` rows of ``embed_dim``."""

    def __init__(self, num_embeds: int, embed_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.embedding = nn.Embedding(num_embeds, embed_dim)
        bound = 1.0 / num_embeds
        with torch.no_grad():
            self.embedding.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, z_e: torch.Tensor) -> torch.Tensor:
        """Indices (B, T) of latents (B, T, D)."""
        return nearest_codebook_indices(z_e.detach(), self.embedding.weight.detach())

    def straight_through(self, z_e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(z_q, z_q_bar) of latents (B, T, D): z_q for the decoder (the
        gradient passes to z_e, none to the codebook), z_q_bar the same
        values with the codebook's gradient."""
        weight = self.embedding.weight
        idx = nearest_codebook_indices(z_e.detach(), weight.detach())
        lookup = weight.detach()[idx]
        z_q = z_e + (lookup - z_e).detach()
        return z_q, weight[idx]
