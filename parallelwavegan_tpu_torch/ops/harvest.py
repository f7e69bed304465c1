"""Harvest F0 estimator (pure numpy/scipy).

A copy of parallelwavegan_tpu/ops/harvest.py, kept here because
importing any part of the JAX package imports jax; ``ops/f0.py``
``logf0_and_vuv`` (``preprocess --extract-f0``) tracks F0 with it.

Behavioral reference: upstream parallel_wavegan/bin/evaluate_f0.py:102-108
calls ``pyworld.harvest(x, fs, f0_floor, f0_ceil, frame_period=n_shift/fs*1000)``.
pyworld is not a dependency of this build, so the same algorithm — M. Morise,
"Harvest: A high-performance fundamental frequency estimator from speech
signals", INTERSPEECH 2017 — is implemented here from the paper:

  1. band-pass the signal with Nuttall-windowed filters centered on a dense
     log-spaced grid of boundary frequencies (40 channels/octave);
  2. in each band, measure four event-interval tracks (positive/negative
     zero crossings, peaks, dips); where the four agree with the channel
     center, the channel emits an F0 candidate;
  3. merge adjacent agreeing channels into per-frame candidates and refine
     each by instantaneous frequency of its harmonics (Flanagan's relation
     on an STFT around the frame), scoring by harmonic IF consistency;
  4. pick the best-scored candidate per frame and fix the contour
     (voicing cuts on discontinuities, minimum voiced-run length,
     candidate-guided segment extension, light smoothing).

Unlike pyworld this computes candidates directly on the requested hop grid
(the reference passes frame_period = hop/fs, so the grids coincide); output
is one F0 value per hop, 0 = unvoiced. Not bit-identical to pyworld, but the
same estimator family — absolute log-F0 metrics are comparable in a way a
YIN tracker's are not.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly


import functools


@functools.lru_cache(maxsize=512)
def _nuttall_cached(n: int) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n, endpoint=True)
    w = (
        0.355768
        - 0.487396 * np.cos(2 * np.pi * t)
        + 0.144232 * np.cos(4 * np.pi * t)
        - 0.012604 * np.cos(6 * np.pi * t)
    )
    w.setflags(write=False)
    return w


def _nuttall(n: int) -> np.ndarray:
    """Nuttall window (continuous first derivative variant); cached —
    the refiner requests the same handful of lengths thousands of times."""
    return _nuttall_cached(n)


def _crossing_intervals(y: np.ndarray, fs: float, going_up: bool):
    """Event times (s) and instantaneous F0s from sign crossings of y.

    A crossing is located by linear interpolation between the two samples
    that bracket it; each consecutive pair of crossings yields one interval
    whose reciprocal is an F0 estimate placed at the interval midpoint.
    """
    if going_up:
        mask = (y[:-1] < 0.0) & (y[1:] >= 0.0)
    else:
        mask = (y[:-1] > 0.0) & (y[1:] <= 0.0)
    idx = np.flatnonzero(mask)
    if len(idx) < 2:
        return None
    frac = y[idx] / (y[idx] - y[idx + 1])
    t = (idx + frac) / fs
    locs = 0.5 * (t[:-1] + t[1:])
    f0s = 1.0 / np.diff(t)
    return locs, f0s


def _channel_candidate(
    filtered: np.ndarray,
    fs_d: float,
    frame_times: np.ndarray,
    boundary_f0: float,
    f0_floor: float,
    f0_ceil: float,
) -> np.ndarray | None:
    """Per-frame candidate F0 for one band, or None if the band is silent.

    The four interval tracks (zero crossings of the signal and of its
    first difference, both polarities) are interpolated onto the frame
    grid; a frame keeps the mean of the four only when it sits inside
    [0.9, 1.1] x boundary_f0 — i.e. the band is dominated by a single
    periodic component at its center frequency.
    """
    dy = np.diff(filtered)
    tracks = [
        _crossing_intervals(filtered, fs_d, going_up=False),
        _crossing_intervals(filtered, fs_d, going_up=True),
        _crossing_intervals(dy, fs_d, going_up=False),
        _crossing_intervals(dy, fs_d, going_up=True),
    ]
    if any(t is None for t in tracks):
        return None
    interp = np.stack(
        [np.interp(frame_times, locs, f0s, left=0.0, right=0.0)
         for locs, f0s in tracks]
    )
    cand = interp.mean(axis=0)
    ok = (
        (interp.min(axis=0) > boundary_f0 * 0.9)
        & (interp.max(axis=0) < boundary_f0 * 1.1)
        & (cand > f0_floor)
        & (cand < f0_ceil)
    )
    if not ok.any():
        return None
    return np.where(ok, cand, 0.0)


def _refine_candidate(
    x: np.ndarray,
    fs: float,
    center: float,
    f0_initial: float,
    f0_floor: float,
    f0_ceil: float,
) -> tuple[float, float]:
    """IF-based refinement of one candidate; returns (refined_f0, score).

    A Nuttall-windowed segment of 3 periods around `center` (s) is
    analyzed; the instantaneous frequency at each harmonic bin follows
    Flanagan's relation IF = w_k + Im{S'(k) conj(S(k))} / |S(k)|^2 with
    S' the spectrum under the window's derivative. The refined F0 is the
    amplitude-weighted mean of IF/harmonic over the first <=6 harmonics;
    the score is the inverse mean relative deviation of those estimates
    (high = the harmonics agree that this is the fundamental).
    """
    half_len = int(1.5 * fs / f0_initial) + 1
    c = int(round(center * fs))
    lo, hi = c - half_len, c + half_len + 1
    if lo < 0 or hi > len(x):
        pad_l, pad_r = max(0, -lo), max(0, hi - len(x))
        seg = np.pad(x[max(0, lo):min(len(x), hi)], (pad_l, pad_r))
    else:
        seg = x[lo:hi]
    n = len(seg)
    w = _nuttall(n)
    # derivative of the window (central difference, zero-ended)
    dw = np.zeros(n)
    dw[1:-1] = 0.5 * (w[2:] - w[:-2]) * fs
    nfft = 1
    while nfft < n * 2:
        nfft *= 2
    spec = np.fft.rfft(seg * w, nfft)
    dspec = np.fft.rfft(seg * dw, nfft)
    power = np.abs(spec) ** 2
    bin_w = fs / nfft
    # IF per bin, Hz (Flanagan): f_k + Im{ S'* conj(S) } / (2*pi*|S|^2)
    # sign convention checked empirically on pure tones: with numpy's
    # e^{-j2pi kn/N} forward FFT the reassignment correction enters with a
    # MINUS sign (a tone above the bin center produces negative Im{S' S*})
    with np.errstate(divide="ignore", invalid="ignore"):
        inst = (
            np.arange(len(spec)) * bin_w
            - np.imag(dspec * np.conj(spec)) / np.maximum(power, 1e-30)
            / (2.0 * np.pi)
        )
    n_harm = int(min(6, (fs / 2.0) // f0_initial))
    if n_harm < 1:
        return 0.0, 0.0
    ks = np.arange(1, n_harm + 1)
    bins = np.round(f0_initial * ks / bin_w).astype(int)
    bins = np.clip(bins, 0, len(spec) - 1)
    amps = np.sqrt(power[bins])
    if amps.sum() <= 0:
        return 0.0, 0.0
    # drop leakage-level bins: for a pure tone the upper "harmonic" bins
    # hold only sidelobe energy whose IF is garbage — a 1e-3 relative
    # amplitude there still shifts an amplitude-weighted mean by ~Hz
    keep = amps > 0.05 * amps.max()
    w_h = np.where(keep, amps, 0.0) ** 2
    est = inst[bins] / ks
    refined = float(np.sum(w_h * est) / np.sum(w_h))
    if not (f0_floor <= refined <= f0_ceil) or not np.isfinite(refined):
        return 0.0, 0.0
    dev = np.sum(w_h * np.abs(est - refined)) / (np.sum(w_h) * refined)
    if dev > 0.2:
        # IF estimates disagree -> the refined value is unreliable; keep
        # the interval-based candidate and let the NACF score judge it
        refined = f0_initial
    score = _nacf_score(x, fs, center, refined)
    return refined, score


def _nacf_score(x: np.ndarray, fs: float, center: float, f0: float) -> float:
    """Voicing/octave score: normalized autocorrelation at the period.

    Computed on the broadband signal (not the band-passed channel), so a
    narrowband-noise candidate — whose filtered waveform looks perfectly
    sinusoidal — scores low. If the correlation at twice the period beats
    the one at the period, the candidate is an octave-up error (the true
    fundamental lives at f0/2) and is rejected outright.
    """
    tau = fs / f0
    lag2 = int(round(2.0 * tau))
    win = max(int(round(2.0 * tau)), 16)
    a = int(round(center * fs)) - win // 2
    need = win + lag2 + 2
    if a < 0 or a + need > len(x):
        seg = np.zeros(need)
        lo = max(0, a)
        hi = min(len(x), a + need)
        if hi > lo:
            seg[lo - a:hi - a] = x[lo:hi]
    else:
        seg = x[a:a + need]
    head = seg[:win]
    e_head = float(np.dot(head, head))
    if e_head <= 1e-12:
        return 0.0

    def r(lag: int) -> float:
        tail = seg[lag:lag + win]
        e_tail = float(np.dot(tail, tail))
        if e_tail <= 1e-12:
            return 0.0
        return float(np.dot(head, tail) / np.sqrt(e_head * e_tail))

    lag1 = int(round(tau))
    r1 = max(r(max(lag1 - 1, 1)), r(lag1), r(lag1 + 1))
    r2 = max(r(max(lag2 - 1, 1)), r(lag2), r(lag2 + 1))
    if r2 > r1 + 0.1:
        return 0.0  # true period is ~2x -> octave-up candidate
    # subharmonic test: an F0/m candidate (m=2,3,...) also scores r1 ~ 1
    # because m true periods fit its lag — but then the signal already
    # repeats at tau/m. (m=2 also catches every even-m subharmonic.)
    for m in (2, 3):
        lag_m = int(round(tau / m))
        if lag_m >= 2:
            rm = max(r(lag_m - 1), r(lag_m), r(lag_m + 1))
            if rm > 0.5 and rm > r1 - 0.1:
                return 0.0
    return r1


def _fix_contour(
    f0: np.ndarray,
    scores: np.ndarray,
    candidates: list[list[tuple[float, float]]],
    hop_s: float,
    allowed_per_ms: float = 0.008,
    min_voiced_ms: float = 9.0,
) -> np.ndarray:
    """Contour fixing: discontinuity cuts, short-run removal, extension.

    allowed_per_ms bounds the relative F0 change per millisecond (0.8%/ms,
    Harvest's step-1 constant on its 1 ms grid, scaled to this hop).
    """
    n = len(f0)
    allowed = allowed_per_ms * hop_s * 1000.0
    out = f0.copy()
    # step 1: cut at discontinuities — a frame must agree with a voiced
    # neighbor on at least one side (forward-only scanning would let a
    # wrong FIRST frame of a segment survive and cut the correct second)
    tol = max(allowed, 0.05)
    v = out > 0
    agree_prev = np.zeros(n, dtype=bool)
    agree_next = np.zeros(n, dtype=bool)
    agree_prev[1:] = v[1:] & v[:-1] & (
        np.abs(out[1:] - out[:-1]) <= tol * np.maximum(out[1:], 1e-9)
    )
    agree_next[:-1] = agree_prev[1:]
    lone = v & ~agree_prev & ~agree_next
    out[lone] = 0.0
    # step 2: remove voiced runs shorter than the minimum
    min_run = max(1, int(round(min_voiced_ms / 1000.0 / hop_s)))
    i = 0
    while i < n:
        if out[i] > 0:
            j = i
            while j < n and out[j] > 0:
                j += 1
            if j - i < min_run:
                out[i:j] = 0.0
            i = j
        else:
            i += 1
    # steps 3/4: extend voiced segments outward along agreeing candidates
    ext = max(allowed, 0.09)
    changed = True
    while changed:
        changed = False
        for i in range(n):
            if out[i] > 0:
                continue
            ref = 0.0
            if i > 0 and out[i - 1] > 0:
                ref = out[i - 1]
            elif i + 1 < n and out[i + 1] > 0:
                ref = out[i + 1]
            if ref <= 0 or not candidates[i]:
                continue
            # only extend along candidates that are themselves credibly
            # periodic — low-score candidates let the extension random-walk
            # across whole unvoiced gaps
            good = [c for c in candidates[i] if c[1] >= 0.45]
            if not good:
                continue
            vals = np.array([c[0] for c in good])
            k = int(np.argmin(np.abs(vals - ref)))
            if abs(vals[k] - ref) / ref < ext:
                out[i] = vals[k]
                changed = True
    # light smoothing inside voiced runs (median-3 then binomial-3)
    i = 0
    while i < n:
        if out[i] > 0:
            j = i
            while j < n and out[j] > 0:
                j += 1
            if j - i >= 3:
                seg = out[i:j]
                med = seg.copy()
                med[1:-1] = np.median(
                    np.stack([seg[:-2], seg[1:-1], seg[2:]]), axis=0
                )
                sm = med.copy()
                sm[1:-1] = 0.25 * med[:-2] + 0.5 * med[1:-1] + 0.25 * med[2:]
                out[i:j] = sm
            i = j
        else:
            i += 1
    return out


def harvest_f0(
    audio: np.ndarray,
    fs: int,
    hop_size: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    channels_in_octave: float = 40.0,
    target_fs: int = 8000,
) -> np.ndarray:
    """Harvest F0 track, one value per hop (0 = unvoiced).

    Matches the reference's pyworld call surface (frame_period = hop/fs):
    upstream parallel_wavegan/bin/evaluate_f0.py:102-108.
    """
    audio = np.asarray(audio, dtype=np.float64)
    n_frames = max(1, 1 + (len(audio) - 1) // hop_size)
    # raise the floor so >=3 periods fit the signal (at the TRUE fs: using
    # the decimation target here under-raised the floor and the guard
    # below then rejected short high-fs utterances that fit many periods)
    f0_floor = max(f0_floor, 3.0 * fs / max(len(audio), 1))
    if len(audio) < int(3 * fs / f0_floor) or f0_floor >= f0_ceil:
        return np.zeros(n_frames, dtype=np.float32)

    # decimate to ~target_fs: candidate generation only needs < 1.1*f0_ceil
    ratio = max(1, int(fs // target_fs))
    x_d = resample_poly(audio, 1, ratio) if ratio > 1 else audio
    fs_d = fs / ratio
    frame_times = np.arange(n_frames) * (hop_size / fs)

    # log-spaced boundary frequencies, 40 channels/octave
    adj_floor, adj_ceil = f0_floor * 0.9, f0_ceil * 1.1
    adj_ceil = min(adj_ceil, fs_d / 2 * 0.95)
    n_ch = 1 + int(np.log2(adj_ceil / adj_floor) * channels_in_octave)
    boundary_f0s = adj_floor * 2.0 ** (np.arange(1, n_ch + 1)
                                       / channels_in_octave)

    # one forward FFT of the decimated signal; per-channel band-pass by
    # spectral multiplication with a Nuttall-windowed cosine
    max_half = int(round(fs_d / boundary_f0s[0] * 2.0))
    nfft = 1
    while nfft < len(x_d) + 2 * max_half + 1:
        nfft *= 2
    x_spec = np.fft.rfft(x_d, nfft)

    chan_cands = np.zeros((n_ch, n_frames))
    for ci, bf0 in enumerate(boundary_f0s):
        half = int(round(fs_d / bf0 * 2.0))
        k = np.arange(-half, half + 1)
        bpf = _nuttall(2 * half + 1) * np.cos(2 * np.pi * bf0 * k / fs_d)
        filt_spec = np.fft.rfft(bpf, nfft)
        filtered = np.fft.irfft(x_spec * filt_spec, nfft)[
            half:half + len(x_d)
        ]
        cand = _channel_candidate(
            filtered, fs_d, frame_times, bf0, f0_floor, f0_ceil
        )
        if cand is not None:
            chan_cands[ci] = cand

    # merge adjacent agreeing channels into per-frame candidate lists
    raw_candidates: list[list[float]] = [[] for _ in range(n_frames)]
    nz = chan_cands > 0
    for t in range(n_frames):
        col = nz[:, t]
        if not col.any():
            continue
        edges = np.flatnonzero(np.diff(np.concatenate([[0], col, [0]])))
        for s, e in zip(edges[::2], edges[1::2]):
            raw_candidates[t].append(float(chan_cands[s:e, t].mean()))

    # candidate overlap with +-1 neighbor frames (robustness to onset jitter)
    overlapped: list[list[float]] = []
    for t in range(n_frames):
        vals: list[float] = []
        for tt in (t - 1, t, t + 1):
            if 0 <= tt < n_frames:
                vals.extend(raw_candidates[tt])
        overlapped.append(vals)

    # IF refinement + scoring (on the decimated signal: all harmonics used
    # are below 6*f0_ceil which stays under fs_d/2 for speech ranges)
    refined: list[list[tuple[float, float]]] = []
    best_f0 = np.zeros(n_frames)
    best_score = np.zeros(n_frames)
    for t in range(n_frames):
        entries: list[tuple[float, float]] = []
        seen: list[float] = []
        for c in overlapped[t]:
            if any(abs(c - s) / s < 0.03 for s in seen):
                continue
            seen.append(c)
            rf0, score = _refine_candidate(
                x_d, fs_d, frame_times[t], c, f0_floor, f0_ceil
            )
            if rf0 > 0:
                entries.append((rf0, score))
        entries.sort(key=lambda e: -e[1])
        refined.append(entries)
        # NACF voicing threshold: periodic speech sits near 1.0, broadband
        # noise near 0; 0.5 matches common practice (RAPT/praat use 0.45-0.6)
        if entries and entries[0][1] > 0.5:
            best_f0[t], best_score[t] = entries[0]

    fixed = _fix_contour(best_f0, best_score, refined, hop_size / fs)
    return fixed.astype(np.float32)
