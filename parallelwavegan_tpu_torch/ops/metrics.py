"""Objective-evaluation primitives: mel-cepstra, DTW, F0 metrics.

A copy of parallelwavegan_tpu/ops/metrics.py, kept here because
importing any part of the JAX package imports jax; its lazy imports
point at the port's own ``ops/mcep.py``, ``ops/harvest.py`` and
``ops/f0.py``, and a test holds the two equal on seeded signals.

Behavioral reference: upstream parallel_wavegan/bin/evaluate_mcd.py
(:48-118 pysptk mcep + fastdtw alignment + MCD) and evaluate_f0.py
(pyworld F0 -> log-F0 RMSE / semitone accuracy / VUV error).

Dependency note: pysptk/pyworld/fastdtw are not available in this build.
MCD uses the exact SPTK mel-cepstral analysis re-implemented in
ops/mcep.py (same UELS minimizer as pysptk.mcep, hamming-windowed frames,
c0 included, the reference's 10/ln10*sqrt(2*sum d^2) formula), DTW is an
exact O(T1*T2) dynamic program (the reference's fastdtw is an
approximation of the same alignment), F0 is the YIN tracker from
ops/f0.py standing in for pyworld's harvest/dio.
"""

from __future__ import annotations

import numpy as np

def dtw_path(x: np.ndarray, y: np.ndarray):
    """Exact DTW alignment between feature sequences (T1, D) and (T2, D).

    Euclidean local cost, steps {(1,1),(1,0),(0,1)}; the DP is vectorized
    over anti-diagonals (every cell of diagonal k depends only on
    diagonals k-1 and k-2). Returns (path_x, path_y) index arrays.
    """
    t1, t2 = len(x), len(y)
    # pairwise distances (T1, T2)
    sq = (
        np.sum(x**2, axis=1)[:, None]
        + np.sum(y**2, axis=1)[None, :]
        - 2.0 * (x @ y.T)
    )
    dist = np.sqrt(np.maximum(sq, 0.0))

    cost = np.full((t1 + 1, t2 + 1), np.inf)
    cost[0, 0] = 0.0
    for k in range(2, t1 + t2 + 1):
        i_lo = max(1, k - t2)
        i_hi = min(t1, k - 1)
        if i_lo > i_hi:
            continue
        ii = np.arange(i_lo, i_hi + 1)
        jj = k - ii
        prev = np.minimum(
            np.minimum(cost[ii - 1, jj - 1], cost[ii - 1, jj]),
            cost[ii, jj - 1],
        )
        cost[ii, jj] = dist[ii - 1, jj - 1] + prev

    i, j = t1, t2
    px, py = [], []
    while i > 0 and j > 0:
        px.append(i - 1)
        py.append(j - 1)
        m = int(np.argmin([cost[i - 1, j - 1], cost[i - 1, j], cost[i, j - 1]]))
        if m == 0:
            i, j = i - 1, j - 1
        elif m == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(px[::-1]), np.asarray(py[::-1])


def mel_cepstral_distortion(
    gen_audio: np.ndarray, gt_audio: np.ndarray, fs: int,
    n_fft: int = 1024, n_shift: int = 256,
    mcep_dim: int | None = None, mcep_alpha: float | None = None,
) -> float:
    """DTW-aligned MCD in dB between generated and ground-truth audio.

    Matches the reference pipeline (evaluate_mcd.py:130-172): SPTK
    mel-cepstra over hamming frames (c0 INCLUDED), DTW alignment,
    mean of 10/ln10 * sqrt(2 * sum(diff^2)).
    """
    from parallelwavegan_tpu_torch.ops.mcep import sptk_extract

    # reference reads wavs as int16; scale float audio likewise so the
    # eps=1e-6 periodogram floor is as negligible as it is there
    def _as_int16_scale(x):
        x = np.asarray(x, np.float64)
        return x * 32768.0 if np.abs(x).max() <= 4.0 else x

    gen_audio = _as_int16_scale(gen_audio)
    gt_audio = _as_int16_scale(gt_audio)
    mc_gen = sptk_extract(gen_audio, fs, n_fft, n_shift, mcep_dim, mcep_alpha)
    mc_gt = sptk_extract(gt_audio, fs, n_fft, n_shift, mcep_dim, mcep_alpha)
    px, py = dtw_path(mc_gen, mc_gt)
    diff = mc_gen[px] - mc_gt[py]
    return float(
        np.mean(10.0 / np.log(10.0) * np.sqrt(2.0 * np.sum(diff**2, axis=1)))
    )


def f0_metrics(
    gen_audio: np.ndarray, gt_audio: np.ndarray, fs: int,
    hop: int = 256, f0min: float = 40.0, f0max: float = 800.0,
    tracker: str = "harvest",
) -> dict:
    """log-F0 RMSE, semitone accuracy, and V/UV error rate.

    Frames are DTW-aligned on mel-cepstra (the reference aligns the same
    way before comparing pyworld F0 tracks). Defaults follow the
    reference CLI surface (evaluate_f0.py:262-272: f0min 40, f0max 800).
    The default tracker is the numpy Harvest implementation (ops/harvest.py)
    — the same estimator family the reference uses via pyworld
    (evaluate_f0.py:102-108) — so absolute log-F0/VUV numbers are
    comparable; ``tracker="yin"`` keeps the round-1 YIN path.
    """
    from parallelwavegan_tpu_torch.ops.mcep import sptk_extract

    if tracker == "harvest":
        from parallelwavegan_tpu_torch.ops.harvest import harvest_f0

        f0_gen = harvest_f0(gen_audio, fs, hop, f0_floor=f0min, f0_ceil=f0max)
        f0_gt = harvest_f0(gt_audio, fs, hop, f0_floor=f0min, f0_ceil=f0max)
    elif tracker == "yin":
        from parallelwavegan_tpu_torch.ops.f0 import postprocess_f0, yin_f0

        f0_gen = postprocess_f0(
            yin_f0(gen_audio, fs, hop, fmin=f0min, fmax=f0max))
        f0_gt = postprocess_f0(
            yin_f0(gt_audio, fs, hop, fmin=f0min, fmax=f0max))
    else:
        raise ValueError(f"unknown F0 tracker: {tracker}")
    mc_gen = sptk_extract(np.asarray(gen_audio, np.float64), fs, n_shift=hop)
    mc_gt = sptk_extract(np.asarray(gt_audio, np.float64), fs, n_shift=hop)
    n_gen = min(len(f0_gen), len(mc_gen))
    n_gt = min(len(f0_gt), len(mc_gt))
    px, py = dtw_path(mc_gen[:n_gen], mc_gt[:n_gt])
    g = f0_gen[px]
    r = f0_gt[py]

    voiced = (g > 0) & (r > 0)
    vuv_err = float(np.mean((g > 0) != (r > 0)))
    if voiced.sum() == 0:
        return {"log_f0_rmse": float("nan"), "semitone_acc": 0.0,
                "vuv_error_rate": vuv_err}
    lg, lr = np.log(g[voiced]), np.log(r[voiced])
    log_f0_rmse = float(np.sqrt(np.mean((lg - lr) ** 2)))
    semitone_diff = 12.0 * np.abs(lg - lr) / np.log(2.0)
    semitone_acc = float(np.mean(semitone_diff < 0.5))
    return {
        "log_f0_rmse": log_f0_rmse,
        "semitone_acc": semitone_acc,
        "vuv_error_rate": vuv_err,
    }
