"""Pseudo-QMF filterbank (PQMF) for multi-band decode.

Counterpart of parallelwavegan_tpu/ops/pqmf.py. The filter design
(``design_prototype_filter``, ``pqmf_filters``) is a numpy copy held equal
to the JAX package's by a test. ``PQMF`` keeps the JAX layout (B, T, C)
at its functions: analysis is one strided convolution (1 -> subbands
channels), synthesis the reference's zero-stuffing transposed convolution
(x subbands gain) followed by the synthesis filter, as upstream composes
it (layers/pqmf.py:136-149). Both run through cuDNN on a GPU; PQMF is not
a TPU kernel of the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def design_prototype_filter(
    taps: int = 62, cutoff_ratio: float = 0.142, beta: float = 9.0
) -> np.ndarray:
    """Kaiser-window lowpass prototype, impulse response of length taps + 1:
    an ideal sinc lowpass at ``pi * cutoff_ratio`` windowed by a Kaiser
    window."""
    assert taps % 2 == 0, "The number of taps must be even."
    assert 0.0 < cutoff_ratio < 1.0, "Cutoff ratio must be in (0, 1)."
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio  # sinc limit at n = 0
    return h_i * np.kaiser(taps + 1, beta)


@functools.lru_cache(maxsize=None)
def pqmf_filters(
    subbands: int = 4,
    taps: int = 62,
    cutoff_ratio: float = 0.142,
    beta: float = 9.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Cosine-modulated analysis/synthesis banks, each (subbands, taps + 1)."""
    h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
    k = np.arange(subbands)[:, None]
    n = np.arange(taps + 1)[None, :] - taps / 2
    phase = (2 * k + 1) * (np.pi / (2 * subbands)) * n
    shift = ((-1.0) ** k) * np.pi / 4
    h_analysis = 2 * h_proto[None, :] * np.cos(phase + shift)
    h_synthesis = 2 * h_proto[None, :] * np.cos(phase - shift)
    return h_analysis.astype(np.float32), h_synthesis.astype(np.float32)


class PQMF:
    """Near-perfect-reconstruction pseudo-QMF bank over (B, T, C) tensors.

    ``analysis``: (B, T, 1) -> (B, T // subbands, subbands)
    ``synthesis``: (B, T // subbands, subbands) -> (B, T, 1)

    The default (taps 62, cutoff 0.142, beta 9.0) is the reference's tuning
    for 4 subbands. The filters are kept as float32 tensors and moved to
    the input's device on first use there; a bf16 input (mixed precision)
    is filtered by them cast to bf16, as the JAX package casts them to the
    input's type.
    """

    def __init__(self, subbands: int = 4, taps: int = 62,
                 cutoff_ratio: float = 0.142, beta: float = 9.0):
        self.subbands = subbands
        self.taps = taps
        self.cutoff_ratio = cutoff_ratio
        self.beta = beta
        h_analysis, h_synthesis = pqmf_filters(subbands, taps, cutoff_ratio, beta)
        s = subbands
        eye = np.zeros((s, s, s), np.float32)
        eye[np.arange(s), np.arange(s), 0] = 1.0
        self._filters = {"cpu": (
            torch.from_numpy(h_analysis[:, None, :].copy()),   # (S, 1, K)
            torch.from_numpy(h_synthesis[None, :, :].copy()),  # (1, S, K)
            torch.from_numpy(eye * s),                         # (S, S, S)
        )}

    def _on(self, device: torch.device):
        key = str(device)
        if key not in self._filters:
            self._filters[key] = tuple(f.to(device) for f in self._filters["cpu"])
        return self._filters[key]

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """Split (B, T, 1) into subband signals (B, T // subbands, subbands)."""
        h, _, _ = self._on(x.device)
        y = F.conv1d(x.transpose(1, 2), h.to(x.dtype), stride=self.subbands,
                     padding=self.taps // 2)
        return y.transpose(1, 2)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """Reconstruct (B, T * subbands, 1) from subband signals (B, T, S):
        zero-stuffing transposed conv (x subbands gain), then the
        synthesis filter."""
        _, g, updown = self._on(x.device)
        y = F.conv_transpose1d(x.transpose(1, 2), updown.to(x.dtype), stride=self.subbands)
        y = F.conv1d(y, g.to(x.dtype), padding=self.taps // 2)
        return y.transpose(1, 2)
