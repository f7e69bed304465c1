"""Mel-spectrogram loss (counterpart of parallelwavegan_tpu/losses/mel_loss.py).

The magnitude of the port's STFT (``ops/stft.py``, its power clamped at
``eps``), times the Slaney filterbank of ``ops/mel.py``, clamped at
``eps`` and logged (natural, base 10 or base 2); the loss is the mean
absolute difference of the two log-mels. ``window`` is accepted and, as in
the JAX package, the Hann window of ``win_length`` (``fft_size`` when
null) is used whatever it names.
"""

from __future__ import annotations

import torch

from parallelwavegan_tpu_torch.ops.mel import mel_filterbank
from parallelwavegan_tpu_torch.ops.stft import stft_magnitude

_LOGS = {None: torch.log, 10.0: torch.log10, 2.0: torch.log2}


class MelSpectrogram:
    """Log-mel spectrogram of a waveform batch: (B, T) or (B, C, T) ->
    (B [* C], frames, num_mels)."""

    def __init__(self, fs: int = 22050, fft_size: int = 1024, hop_size: int = 256,
                 win_length: int | None = None, window: str = "hann",
                 num_mels: int = 80, fmin: float | None = 80,
                 fmax: float | None = 7600, center: bool = True,
                 normalized: bool = False, onesided: bool = True,
                 eps: float = 1e-10, log_base: float | None = 10.0):
        if normalized or not onesided:
            raise ValueError("normalized/onesided overrides are not supported")
        if log_base not in _LOGS:
            raise ValueError(f"log_base {log_base} is not supported.")
        self.fft_size, self.hop_size = fft_size, hop_size
        self.win_length = win_length or fft_size
        self.center, self.eps, self.log = center, eps, _LOGS[log_base]
        self.melmat = torch.from_numpy(mel_filterbank(fs, fft_size, num_mels, fmin, fmax))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x.reshape(-1, x.shape[-1])
        amp = stft_magnitude(x, self.fft_size, self.hop_size, self.win_length,
                             center=self.center, eps=self.eps)
        if self.melmat.device != amp.device:
            self.melmat = self.melmat.to(amp.device)
        return self.log(torch.clamp(amp @ self.melmat.t(), min=self.eps))


class MelSpectrogramLoss:
    """L1 between the log-mels of the generated and the target wave."""

    def __init__(self, **params):
        self.mel = MelSpectrogram(**params)

    def __call__(self, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.abs(self.mel(y_hat) - self.mel(y)))
