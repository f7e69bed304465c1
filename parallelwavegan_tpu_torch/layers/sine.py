"""Sine excitation generator for source-filter vocoders (PyTorch).

Counterpart of parallelwavegan_tpu/layers/sine.py:27-61: F0 (B, 1, T) ->
the harmonics' sines (B, dim, T), dim = harmonic_num + 1, each with a
random initial phase (the fundamental's kept at 0) and its phase the
running sum of (f0 k / samp_rate) mod 1, wrapped into [0, 1) before the
sine as JAX wraps it; voiced where f0 exceeds ``voiced_threshold``; the
noise floor ``noise_std`` where voiced and sine_amp / 3 where not. The
two draws come from the explicit ``torch.Generator`` given, or are
passed in: ``rand_ini`` (B, dim) uniform on [0, 1) and ``normal``
(B, dim, T) standard normal, so that a test can give it JAX's draws.
Nothing takes gradients through it. No path of the package calls it: the
UHiFiGAN excitation of a dump comes from ``ops/f0.py``, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SineGen:
    """F0 (B, 1, T) -> (sine (B, dim, T), uv (B, 1, T), noise (B, dim, T))."""

    samp_rate: int
    harmonic_num: int = 0
    sine_amp: float = 0.1
    noise_std: float = 0.003
    voiced_threshold: float = 0.0

    @property
    def dim(self) -> int:
        return self.harmonic_num + 1

    @torch.no_grad()
    def __call__(self, f0: torch.Tensor, generator: torch.Generator | None = None,
                 rand_ini: torch.Tensor | None = None,
                 normal: torch.Tensor | None = None):
        b, _, t = f0.shape
        harmonics = torch.arange(1, self.dim + 1, dtype=f0.dtype, device=f0.device)
        rad = (f0 * harmonics[None, :, None] / self.samp_rate) % 1.0  # (B, dim, T)
        if rand_ini is None:
            rand_ini = torch.rand((b, self.dim), generator=generator, dtype=f0.dtype,
                                  device=f0.device)
        rand_ini = rand_ini.clone()
        rand_ini[:, 0] = 0.0  # the fundamental keeps zero phase
        rad[:, :, 0] += rand_ini
        phase = torch.cumsum(rad, dim=2) % 1.0
        sines = torch.sin(2.0 * torch.pi * phase)
        uv = (f0 > self.voiced_threshold).to(f0.dtype)
        sine_waves = sines * self.sine_amp
        noise_amp = uv * self.noise_std + (1.0 - uv) * self.sine_amp / 3.0
        if normal is None:
            normal = torch.randn(sine_waves.shape, generator=generator, dtype=f0.dtype,
                                 device=f0.device)
        noise = noise_amp * normal
        return sine_waves * uv + noise, uv, noise
