"""STFT magnitude (counterpart of parallelwavegan_tpu/ops/stft.py:112-153).

``torch.stft`` computes what the JAX package frames and transforms by
hand: a centred, reflect-padded STFT with the periodic Hann window of
``win_length`` zero-padded (centred) to ``fft_size``. It is not a Pallas
kernel in the JAX package, so a library call is its port.
"""

from __future__ import annotations

import torch


def stft_magnitude(x: torch.Tensor, fft_size: int, hop_size: int,
                   win_length: int, *, center: bool = True,
                   eps: float = 1e-7) -> torch.Tensor:
    """Magnitude spectrogram of ``x`` (B, T) -> (B, frames, fft_size//2+1),
    ``sqrt(max(re^2 + im^2, eps))``: the clamp keeps the gradient finite at
    silence, as the JAX package and upstream do."""
    window = torch.hann_window(win_length, periodic=True, dtype=x.dtype,
                               device=x.device)
    spec = torch.stft(x, fft_size, hop_size, win_length, window, center=center,
                      pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(torch.clamp(power, min=eps)).transpose(1, 2)
