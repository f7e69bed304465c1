"""SPTK-compatible mel-cepstral analysis in pure numpy.

A copy of parallelwavegan_tpu/ops/mcep.py, kept here because importing
any part of the JAX package imports jax; ``ops/metrics.py`` scores
decoded audio with it and a test holds the two equal on seeded signals.

Behavioral reference: upstream parallel_wavegan/bin/evaluate_mcd.py
:48-118 (pysptk.mcep over hamming-windowed frames, fs-dependent order and
all-pass alpha) and evaluate_f0.py:73-118 (pysptk.sp2mc of the WORLD
spectral envelope). pysptk is unavailable in this build, so the same
mathematics is implemented directly:

Mel-cepstral analysis (gamma=0; Fukada et al. 1992, the criterion SPTK's
``mcep`` minimizes) fits ``log|H(w)| = sum_k c_k cos(k * beta(w))`` —
where ``beta(w) = w + 2 atan(a sin w / (1 - a cos w))`` is the phase of
the first-order all-pass ``(z^-1 - a)/(1 - a z^-1)`` — by minimizing the
UELS criterion

    E(c) = mean_w [ I(w) exp(-2 phi(w; c)) + 2 phi(w; c) - log I(w) - 1 ]

over the periodogram ``I``. E is convex in ``c`` (its Hessian
``4 B^T diag(I e^{-2 phi}) B`` is PSD), so a damped Newton iteration from
the weighted-least-squares projection of ``log sqrt(I)`` onto the warped
cosine basis converges to the same minimizer SPTK's iterative solver
finds — values match pysptk up to convergence tolerance, not merely up to
a scale offset like DCT mel-cepstra.

``sp2mc`` (non-iterative) is the frequency-transformed cepstrum: real
cepstrum of the log spectrum followed by Oppenheim's freqt recursion.
"""

from __future__ import annotations

import numpy as np


def warped_freqs(n_freq: int, alpha: float) -> np.ndarray:
    """beta(w_i) for w_i = pi * i / (n_freq - 1), i = 0..n_freq-1."""
    w = np.linspace(0.0, np.pi, n_freq)
    return w + 2.0 * np.arctan2(alpha * np.sin(w), 1.0 - alpha * np.cos(w))


def _basis_and_weights(n_fft: int, order: int, alpha: float):
    """Warped cosine basis B (n_fft//2+1, order+1) and full-circle mean
    weights for the rfft half grid."""
    beta = warped_freqs(n_fft // 2 + 1, alpha)
    k = np.arange(order + 1)
    basis = np.cos(beta[:, None] * k[None, :])
    weights = np.full(n_fft // 2 + 1, 2.0 / n_fft)
    weights[0] = weights[-1] = 1.0 / n_fft
    return basis, weights


def mcep_from_periodogram(
    power: np.ndarray,
    order: int,
    alpha: float,
    n_iter: int = 30,
    tol: float = 1e-10,
) -> np.ndarray:
    """Mel-cepstrum (..., order+1) from periodograms (..., n_fft//2+1).

    ``power`` must already include any eps floor (reference passes
    ``etype=1, eps=1e-6`` so SPTK adds eps to the periodogram).
    """
    power = np.asarray(power, np.float64)
    squeeze = power.ndim == 1
    power = np.atleast_2d(power)
    n_fft = 2 * (power.shape[-1] - 1)
    basis, wts = _basis_and_weights(n_fft, order, alpha)
    log_i = np.log(power)

    # weighted LS init: phi ~= log sqrt(I)
    bw = basis * wts[:, None]
    gram = basis.T @ bw
    c = np.linalg.solve(gram, (0.5 * log_i @ bw).T).T

    def energy(c):
        phi = c @ basis.T
        r = log_i - 2.0 * phi
        return (np.exp(r) - r - 1.0) @ wts

    e_cur = energy(c)
    for _ in range(n_iter):
        phi = c @ basis.T
        expn = power * np.exp(-2.0 * phi)  # I e^{-2 phi}, (F, n_freq)
        grad = 2.0 * ((1.0 - expn) * wts) @ basis  # (F, order+1)
        hess = 4.0 * np.einsum(
            "fn,nk,nl->fkl", expn * wts, basis, basis, optimize=True
        )
        # Levenberg guard for frames whose Hessian is near-singular
        hess += 1e-12 * np.eye(order + 1)
        step = np.linalg.solve(hess, grad[..., None])[..., 0]

        # damped update: backtrack per frame until E does not increase
        scale = np.ones(len(c))
        for _ in range(20):
            e_new = energy(c - scale[:, None] * step)
            worse = e_new > e_cur + 1e-15
            if not worse.any():
                break
            scale[worse] *= 0.5
        c = c - scale[:, None] * step
        e_prev, e_cur = e_cur, energy(c)
        if np.max(np.abs(e_prev - e_cur)) < tol:
            break
    return c[0] if squeeze else c


def mcep(
    frames: np.ndarray,
    order: int,
    alpha: float,
    eps: float = 1e-6,
    n_iter: int = 30,
) -> np.ndarray:
    """pysptk.mcep(frame, order, alpha, eps=eps, etype=1) equivalent.

    frames: windowed signal frames (..., n_fft).
    """
    squeeze = np.ndim(frames) == 1
    frames = np.atleast_2d(np.asarray(frames, np.float64))
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2 + eps
    c = mcep_from_periodogram(power, order, alpha, n_iter=n_iter)
    return c[0] if squeeze else c


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Oppenheim frequency transform of cepstra (..., M1+1) -> (..., order+1).

    Standard recursion (SPTK ``freqt``): process input coefficients from
    highest to lowest,
      d_0' = c_i + a d_0 ; d_1' = (1-a^2) d_0 + a d_1 ;
      d_m' = d_{m-1} + a (d_m - d_{m-1}')   (d' = new sweep, d = previous).
    """
    c = np.asarray(c, np.float64)
    squeeze = c.ndim == 1
    c = np.atleast_2d(c)
    f, m1 = c.shape[0], c.shape[1] - 1
    d = np.zeros((f, order + 1))
    for i in range(m1, -1, -1):
        prev = d
        d = np.empty_like(prev)
        d[:, 0] = c[:, i] + alpha * prev[:, 0]
        if order >= 1:
            d[:, 1] = (1.0 - alpha**2) * prev[:, 0] + alpha * prev[:, 1]
        for m in range(2, order + 1):
            d[:, m] = prev[:, m - 1] + alpha * (prev[:, m] - d[:, m - 1])
    return d[0] if squeeze else d


def sp2mc(sp: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """pysptk.sp2mc equivalent: spectral envelope (..., n_fft//2+1,
    magnitude**2 domain as WORLD produces) -> mel-cepstrum (..., order+1)."""
    sp = np.atleast_2d(np.asarray(sp, np.float64))
    n_fft = 2 * (sp.shape[-1] - 1)
    log_sp = 0.5 * np.log(sp)
    # real cepstrum from the symmetric half spectrum
    full = np.concatenate([log_sp, log_sp[:, -2:0:-1]], axis=-1)
    ceps = np.fft.irfft(full, n=n_fft, axis=-1)[:, : n_fft // 2 + 1]
    ceps[:, 1:-1] *= 2.0  # fold the symmetric part
    return freqt(ceps, order, alpha)


def best_mcep_params(fs: int) -> tuple[int, float]:
    """fs -> (mcep_dim, alpha); reference evaluate_mcd.py:106-118."""
    table = {
        16000: (23, 0.42),
        22050: (34, 0.45),
        24000: (34, 0.46),
        44100: (39, 0.53),
        48000: (39, 0.55),
    }
    if fs in table:
        return table[fs]
    # reference raises for unknown fs; extend gracefully for the 8 kHz
    # yesno CI fixture with a bark-scale-matched alpha
    if fs <= 8000:
        return (19, 0.31)
    return (34, 0.45)


def sptk_extract(
    x: np.ndarray,
    fs: int,
    n_fft: int = 512,
    n_shift: int = 256,
    mcep_dim: int | None = None,
    mcep_alpha: float | None = None,
) -> np.ndarray:
    """Reference evaluate_mcd.py:48-99: hamming-windowed non-centered
    frames -> pysptk.mcep per frame. Returns (n_frame, mcep_dim+1)."""
    if mcep_dim is None or mcep_alpha is None:
        mcep_dim, mcep_alpha = best_mcep_params(fs)
    x = np.asarray(x, np.float64)
    n_frame = (len(x) - n_fft) // n_shift + 1
    if n_frame <= 0:
        raise ValueError(f"signal too short for n_fft={n_fft}")
    idx = n_shift * np.arange(n_frame)[:, None] + np.arange(n_fft)[None, :]
    frames = x[idx] * np.hamming(n_fft)
    return mcep(frames, mcep_dim, mcep_alpha)
