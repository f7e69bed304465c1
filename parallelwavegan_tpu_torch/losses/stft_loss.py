"""Multi-resolution STFT loss (counterpart of
parallelwavegan_tpu/losses/stft_loss.py): spectral convergence over the
whole batch tensor, L1 of log magnitudes, each averaged over the
resolutions. Signals are (B, T), or (B, T, C) flattened to (B*C, T) as
the JAX package flattens sub-bands.
"""

from __future__ import annotations

from typing import Sequence

import torch

from parallelwavegan_tpu_torch.ops.stft import stft_magnitude


def spectral_convergence_loss(x_mag, y_mag):
    """||Y - X||_F / ||Y||_F (Frobenius over the full batch tensor)."""
    return torch.linalg.norm(y_mag - x_mag) / torch.linalg.norm(y_mag)


def log_stft_magnitude_loss(x_mag, y_mag):
    """L1 between log magnitudes."""
    return torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))


class STFTLoss:
    """Single-resolution STFT loss -> (spectral_convergence, log_magnitude)."""

    def __init__(self, fft_size: int = 1024, shift_size: int = 120,
                 win_length: int = 600):
        self.fft_size, self.shift_size, self.win_length = fft_size, shift_size, win_length

    def __call__(self, x, y):
        x_mag = stft_magnitude(x, self.fft_size, self.shift_size, self.win_length)
        y_mag = stft_magnitude(y, self.fft_size, self.shift_size, self.win_length)
        return (spectral_convergence_loss(x_mag, y_mag),
                log_stft_magnitude_loss(x_mag, y_mag))


class MultiResolutionSTFTLoss:
    """Average of STFT losses over several resolutions."""

    def __init__(self, fft_sizes: Sequence[int] = (1024, 2048, 512),
                 hop_sizes: Sequence[int] = (120, 240, 50),
                 win_lengths: Sequence[int] = (600, 1200, 240),
                 window: str = "hann_window"):
        if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
            raise ValueError("fft_sizes, hop_sizes and win_lengths differ in length")
        # ``window`` is accepted and, as in the JAX package, the Hann window
        # is used whatever it names (the criterion drops the key)
        self.losses = [STFTLoss(f, h, w)
                       for f, h, w in zip(fft_sizes, hop_sizes, win_lengths)]

    def __call__(self, x, y):
        if x.dim() == 3:
            x = x.transpose(1, 2).reshape(-1, x.shape[1])
            y = y.transpose(1, 2).reshape(-1, y.shape[1])
        sc_loss = mag_loss = 0.0
        for loss in self.losses:
            sc, mag = loss(x, y)
            sc_loss = sc_loss + sc
            mag_loss = mag_loss + mag
        n = len(self.losses)
        return sc_loss / n, mag_loss / n
