"""STFT magnitude (counterpart of parallelwavegan_tpu/ops/stft.py:112-153).

``torch.stft`` computes what the JAX package frames and transforms by
hand: a centred, reflect-padded STFT with the periodic Hann window of
``win_length`` zero-padded (centred) to ``fft_size``. It is not a Pallas
kernel in the JAX package, so a library call is its port.
"""

from __future__ import annotations

import numpy as np
import torch


_WINDOWS: dict = {}


def hann_window(win_length: int, device, dtype) -> torch.Tensor:
    """The periodic Hann window as the JAX package makes it (:31-43): in
    float64, rounded to float32 (torch's float32 ``hann_window`` differs
    from that in the last bit of some taps), then cast to ``dtype``. One
    tensor per (length, device, type)."""
    key = (win_length, str(device), dtype)
    if key not in _WINDOWS:
        n = np.arange(win_length)
        w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
        _WINDOWS[key] = torch.from_numpy(w).to(device=device, dtype=dtype)
    return _WINDOWS[key]


def stft_magnitude(x: torch.Tensor, fft_size: int, hop_size: int,
                   win_length: int, *, center: bool = True,
                   eps: float = 1e-7) -> torch.Tensor:
    """Magnitude spectrogram of ``x`` (B, T) -> (B, frames, fft_size//2+1),
    ``sqrt(max(re^2 + im^2, eps))``: the clamp keeps the gradient finite at
    silence, as the JAX package and upstream do."""
    window = hann_window(win_length, x.device, x.dtype)
    spec = torch.stft(x, fft_size, hop_size, win_length, window, center=center,
                      pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(torch.clamp(power, min=eps)).transpose(1, 2)
