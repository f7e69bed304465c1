"""F0 extraction + sine excitation generation (numpy, preprocess-side).

A copy of parallelwavegan_tpu/ops/f0.py:17-201, kept here because
importing any part of the JAX package imports jax; a test holds the two
equal on fixed audio.

Behavioral reference: the UHiFiGAN preprocessing path
(upstream parallel_wavegan/bin/preprocess.py:92-133 — torchyin F0
-> SineGen excitation) and the continuous-F0 local features (:136-185,
pyreaper). Neither torchyin nor pyreaper is a dependency of this build;
F0 comes from a YIN-style difference-function tracker implemented here
(same contract: per-hop F0 in Hz, 0 for unvoiced) and the excitation from
the numpy twin of layers/sine.py.
"""

from __future__ import annotations

import numpy as np


def yin_f0(
    audio: np.ndarray,
    fs: int,
    hop_size: int,
    fmin: float = 70.0,
    fmax: float = 340.0,
    frame_length: int | None = None,
    threshold: float = 0.15,
) -> np.ndarray:
    """YIN fundamental-frequency track, one value per hop (0 = unvoiced)."""
    tau_min = max(2, int(fs / fmax))
    tau_max = int(fs / fmin)
    if frame_length is None:
        frame_length = 2 * tau_max
    audio = np.asarray(audio, dtype=np.float64)
    n_frames = max(0, 1 + (len(audio) - frame_length) // hop_size)
    f0 = np.zeros(max(n_frames, 0), dtype=np.float32)
    if n_frames <= 0:
        return f0

    idx = np.arange(frame_length)[None, :] + hop_size * np.arange(n_frames)[:, None]
    frames = audio[idx]  # (n_frames, frame_length)

    w = frame_length // 2
    # difference function via FFT autocorrelation: d(tau) =
    # sum_{j<w} (x_j - x_{j+tau})^2 = r(0)_head + r(0)_lag - 2*corr(tau)
    n_fft = 1
    while n_fft < frame_length * 2:
        n_fft *= 2
    spec = np.fft.rfft(frames, n_fft, axis=1)
    acf = np.fft.irfft(spec * np.conj(spec), n_fft, axis=1)[:, : w + 1]
    cum = np.concatenate(
        [np.zeros((n_frames, 1)), np.cumsum(frames**2, axis=1)], axis=1
    )
    e_head = cum[:, w] - cum[:, 0]  # sum x_j^2, j in [0, w)
    taus = np.arange(w + 1)
    e_lag = cum[:, taus + w] - cum[:, taus]  # sum x_{j+tau}^2
    d = e_head[:, None] + e_lag - 2.0 * acf  # (n_frames, w+1)

    # cumulative mean normalized difference
    with np.errstate(divide="ignore", invalid="ignore"):
        csum = np.cumsum(d[:, 1:], axis=1)
        cmnd = d[:, 1:] * np.arange(1, w + 1)[None, :] / np.maximum(csum, 1e-12)
    cmnd = np.concatenate([np.ones((n_frames, 1)), cmnd], axis=1)

    hi = min(tau_max, w)
    for i in range(n_frames):
        seg = cmnd[i, tau_min:hi]
        below = np.flatnonzero(seg < threshold)
        if len(below) > 0:
            tau = below[0] + tau_min
            # walk to the local minimum of this dip
            while tau + 1 < hi and cmnd[i, tau + 1] < cmnd[i, tau]:
                tau += 1
        else:
            tau = int(np.argmin(seg)) + tau_min
            if seg.min() > 0.7:  # no periodicity -> unvoiced
                continue
        # parabolic interpolation around tau
        if 1 <= tau < w:
            a, b, c = cmnd[i, tau - 1], cmnd[i, tau], cmnd[i, tau + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            tau_f = tau + np.clip(shift, -1, 1)
        else:
            tau_f = float(tau)
        f0[i] = fs / tau_f
    return f0


def postprocess_f0(f0: np.ndarray) -> np.ndarray:
    """Harvest-style track cleanup: drop 1-frame voiced islands, bridge
    1-frame unvoiced gaps, and median-of-3 smooth the voiced contour.

    pyworld's Harvest (the reference evaluate_f0 extractor,
    upstream parallel_wavegan/bin/evaluate_f0.py:102-108) applies
    heavy temporal voicing smoothing; raw YIN leaves isolated octave /
    voicing errors that inflate absolute log-F0-RMSE numbers. This brings
    the track statistics closer without changing the tracker itself.
    """
    f0 = np.asarray(f0, np.float32).copy()
    n = len(f0)
    if n < 3:
        return f0
    v = f0 > 0
    # 1-frame voiced islands -> unvoiced
    island = v[1:-1] & ~v[:-2] & ~v[2:]
    f0[1:-1][island] = 0.0
    # 1-frame unvoiced gaps -> geometric-mean bridge
    v = f0 > 0
    gap = ~v[1:-1] & v[:-2] & v[2:]
    f0[1:-1][gap] = np.sqrt(f0[:-2][gap] * f0[2:][gap])
    # median-of-3 on voiced runs (suppresses single-frame octave jumps)
    v = f0 > 0
    med = f0.copy()
    inner = v[1:-1] & v[:-2] & v[2:]
    stacked = np.stack([f0[:-2], f0[1:-1], f0[2:]])
    med[1:-1][inner] = np.median(stacked, axis=0)[inner]
    return med


def logf0_and_vuv(
    audio: np.ndarray,
    fs: int,
    hop_size: int,
    f0min: float = 40.0,
    f0max: float = 500.0,
) -> np.ndarray | None:
    """Continuous log-F0 + V/UV local-conditioning features, (#frames, 2).

    Behavioral reference: logf0_and_vuv_pyreaper
    (upstream parallel_wavegan/bin/preprocess.py:136-185): extract
    F0, hold the first/last voiced values across the edges, linearly
    interpolate unvoiced gaps, take log, and pair with a binary V/UV
    channel. Returns None when every frame is unvoiced (the caller skips
    the utterance, as the reference does). The tracker here is the numpy
    Harvest implementation (ops/harvest.py) instead of pyreaper — same
    contract, same defaults (f0min 40, f0max 500).
    """
    from parallelwavegan_tpu_torch.ops.harvest import harvest_f0

    f0 = harvest_f0(audio, fs, hop_size, f0_floor=f0min, f0_ceil=f0max)
    vuv = (f0 > 0).astype(np.float32)
    if vuv.sum() == 0:
        return None
    voiced_idx = np.flatnonzero(f0 > 0)
    # np.interp holds the boundary values outside the voiced span and
    # linearly bridges interior unvoiced gaps — exactly the reference's
    # pad-then-interp1d sequence
    filled = np.interp(np.arange(len(f0)), voiced_idx, f0[voiced_idx])
    lf0 = np.log(filled).astype(np.float32)
    return np.stack([lf0, vuv], axis=-1)


def sine_excitation_np(
    f0: np.ndarray,
    fs: int,
    hop_size: int,
    sine_amp: float = 0.1,
    noise_std: float = 0.003,
    voiced_threshold: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Per-sample sine excitation from per-hop F0 (numpy SineGen twin)."""
    f0_up = np.repeat(np.asarray(f0, dtype=np.float64), hop_size)
    rad = (f0_up / fs) % 1.0
    phase = np.cumsum(rad) % 1.0
    sines = np.sin(2.0 * np.pi * phase)
    uv = (f0_up > voiced_threshold).astype(np.float64)
    rng = np.random.RandomState(seed)
    noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
    noise = noise_amp * rng.randn(len(f0_up))
    return (sines * sine_amp * uv + noise).astype(np.float32)


def extract_f0_and_excitation(
    audio: np.ndarray,
    fs: int,
    hop_size: int,
    fmin: float = 70.0,
    fmax: float = 340.0,
    sine_amp: float = 0.1,
    noise_std: float = 0.003,
    log_f0: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """F0 track (padded to ceil(T/hop)) + per-sample sine excitation.

    ``log_f0=True`` follows the reference UHiFiGAN pipeline exactly
    (upstream parallel_wavegan/bin/preprocess.py:92-133): voiced
    frames are replaced by log(F0) BEFORE sine synthesis, so both the
    stored f0 track and the excitation operate in the log domain —
    required for converted-checkpoint input compatibility.
    """
    f0 = yin_f0(audio, fs, hop_size, fmin=fmin, fmax=fmax)
    n_frames = -(-len(audio) // hop_size)
    if len(f0) < n_frames:
        f0 = np.pad(f0, (0, n_frames - len(f0)), mode="edge")
    f0 = f0[:n_frames]
    if log_f0:
        voiced = f0 > 0
        f0 = np.where(voiced, np.log(np.maximum(f0, 1e-10)), 0.0)
    excitation = sine_excitation_np(
        f0, fs, hop_size, sine_amp=sine_amp, noise_std=noise_std
    )
    return f0.astype(np.float32), excitation[: n_frames * hop_size]
