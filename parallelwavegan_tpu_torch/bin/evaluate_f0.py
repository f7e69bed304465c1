"""Objective evaluation CLI: F0 metrics, log-F0 RMSE, semitone accuracy
and V/UV error (counterpart of parallelwavegan_tpu/bin/evaluate_f0.py, the
recipe's stage 4).

Pairs generated and ground-truth waves as ``evaluate_mcd`` does, scores
each pair with ``ops/metrics.f0_metrics`` (Harvest F0 by default, YIN
with ``--tracker yin``, frames DTW-aligned on mel-cepstra) in a pool of
``--n_jobs`` processes, logs each metric's mean and standard deviation
over the utterances where it is finite and, with ``--outdir``, writes
``utt2f0`` and ``avg_f0``; numpy only, no device.

    python -m parallelwavegan_tpu_torch.bin.evaluate_f0 \
        --wavdir GEN --gt-wavdir GT [--outdir OUT] [--tracker harvest]
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os

import numpy as np

from parallelwavegan_tpu_torch.bin.evaluate_mcd import pair_with_ground_truth
from parallelwavegan_tpu_torch.ops.metrics import f0_metrics
from parallelwavegan_tpu_torch.utils.io import read_wav_entry

KEYS = ("log_f0_rmse", "semitone_acc", "vuv_error_rate")


def _evaluate_one(args_tuple):
    utt_id, gen_entry, gt_entry, f0min, f0max, tracker = args_tuple
    fs_gen, gen = read_wav_entry(gen_entry)
    fs_gt, gt = read_wav_entry(gt_entry)
    assert fs_gen == fs_gt, f"{utt_id}: fs mismatch"
    return utt_id, f0_metrics(gen, gt, fs_gen, f0min=f0min, f0max=f0max, tracker=tracker)


def main(argv=None) -> dict:
    """Returns {"utt2f0": {utt: metrics}, "summary": {metric: (mean, std)}}."""
    parser = argparse.ArgumentParser(description="Evaluate F0 metrics.")
    parser.add_argument("--wavdir", type=str, required=True,
                        help="directory of generated wavs, or a wav.scp "
                             "(optional sibling segments file)")
    parser.add_argument("--gt-wavdir", type=str, required=True,
                        help="directory of ground-truth wavs, or a wav.scp "
                             "(optional sibling segments file)")
    parser.add_argument("--outdir", type=str, default=None)
    parser.add_argument("--f0min", type=float, default=40.0)
    parser.add_argument("--f0max", type=float, default=800.0)
    parser.add_argument("--tracker", type=str, default="harvest",
                        choices=["harvest", "yin"],
                        help="F0 estimator (harvest matches the "
                             "reference's pyworld extractor family)")
    parser.add_argument("--n_jobs", type=int, default=8)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    pairs = [p + (args.f0min, args.f0max, args.tracker)
             for p in pair_with_ground_truth(args.wavdir, args.gt_wavdir)]
    with mp.Pool(args.n_jobs) as pool:
        results = pool.map(_evaluate_one, pairs)
    results.sort(key=lambda r: r[0])

    summary = {}
    for k in KEYS:
        vals = np.array([r[1][k] for r in results], dtype=np.float64)
        vals = vals[np.isfinite(vals)]
        summary[k] = (float(vals.mean()) if len(vals) else float("nan"),
                      float(vals.std()) if len(vals) else float("nan"))
        logging.info("%s: %.4f +- %.4f", k, *summary[k])

    if args.outdir is not None:
        os.makedirs(args.outdir, exist_ok=True)
        with open(os.path.join(args.outdir, "utt2f0"), "w") as f:
            for utt_id, m in results:
                f.write(f"{utt_id} " + " ".join(f"{m[k]:.4f}" for k in KEYS) + "\n")
        with open(os.path.join(args.outdir, "avg_f0"), "w") as f:
            for k in KEYS:
                f.write(f"{k} {summary[k][0]:.4f} +- {summary[k][1]:.4f}\n")
        logging.info("Saved results to %s.", args.outdir)
    return {"utt2f0": dict(results), "summary": summary}


if __name__ == "__main__":
    main()
