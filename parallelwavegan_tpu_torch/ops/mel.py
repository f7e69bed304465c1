"""Mel filterbank (Slaney) and log-mel feature extraction (numpy).

A copy of the numpy code in parallelwavegan_tpu/ops/mel.py:20-130, kept
here because importing any part of the JAX package imports jax; a test
holds the two equal on fixed audio. librosa is not a dependency: the
Slaney-scale filterbank (librosa.filters.mel defaults) is written out
from the Auditory Toolbox formulas so that features match the reference
preprocessing.
"""

from __future__ import annotations

import numpy as np


def _hz_to_mel_slaney(freq):
    """Slaney mel scale (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


def mel_filterbank(
    sampling_rate: int,
    fft_size: int,
    num_mels: int,
    fmin: float | None = None,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (num_mels, fft_size//2+1)."""
    fmin = 0.0 if fmin is None else float(fmin)
    fmax = sampling_rate / 2.0 if fmax is None else float(fmax)

    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, fft_size // 2 + 1)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), num_mels + 2
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalization.
    enorm = 2.0 / (hz_pts[2 : num_mels + 2] - hz_pts[:num_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)


def _stft_magnitude_np(
    audio: np.ndarray, fft_size: int, hop_size: int, win_length: int | None
) -> np.ndarray:
    """Numpy magnitude STFT matching librosa.stft defaults (center, reflect)."""
    win_length = fft_size if win_length is None else win_length
    n = np.arange(win_length)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    if win_length < fft_size:
        lpad = (fft_size - win_length) // 2
        window = np.pad(window, (lpad, fft_size - win_length - lpad))

    pad = fft_size // 2
    x = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - fft_size) // hop_size
    idx = np.arange(fft_size)[None, :] + hop_size * np.arange(n_frames)[:, None]
    frames = x[idx] * window[None, :]
    return np.abs(np.fft.rfft(frames, n=fft_size, axis=-1))


def logmelfilterbank(
    audio: np.ndarray,
    sampling_rate: int,
    fft_size: int = 1024,
    hop_size: int = 256,
    win_length: int | None = None,
    window: str = "hann",
    num_mels: int = 80,
    fmin: float | None = None,
    fmax: float | None = None,
    eps: float = 1e-10,
    log_base: float | None = 10.0,
) -> np.ndarray:
    """Log-mel filterbank feature (#frames, num_mels).

    Same signature and numerics as the reference extractor
    (preprocess.py:26-89): |STFT| -> slaney mel -> log10(max(eps, .)).
    """
    if window != "hann":
        raise ValueError(f"window {window!r} is not supported (hann only).")
    spc = _stft_magnitude_np(audio, fft_size, hop_size, win_length)
    basis = mel_filterbank(sampling_rate, fft_size, num_mels, fmin, fmax, np.float64)
    mel = np.maximum(eps, spc @ basis.T)
    if log_base is None:
        return np.log(mel).astype(np.float32)
    elif log_base == 10.0:
        return np.log10(mel).astype(np.float32)
    elif log_base == 2.0:
        return np.log2(mel).astype(np.float32)
    raise ValueError(f"log_base {log_base} is not supported.")
