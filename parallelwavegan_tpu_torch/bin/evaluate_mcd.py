"""Objective evaluation CLI: mel-cepstral distortion (counterpart of
parallelwavegan_tpu/bin/evaluate_mcd.py, the recipe's stage 4).

Pairs each generated ``*_gen.wav`` of ``--wavdir`` (a directory or a
wav.scp with an optional sibling ``segments`` file) with its ground truth
in ``--gt-wavdir`` (the same id, or the first id that starts with it),
scores each pair with ``ops/metrics.mel_cepstral_distortion`` (SPTK
mel-cepstra over hamming frames, c0 included, DTW-aligned) in a pool of
``--n_jobs`` processes, logs the mean and standard deviation and, with
``--outdir``, writes ``utt2mcd`` and ``avg_mcd``; numpy only, no device.

    python -m parallelwavegan_tpu_torch.bin.evaluate_mcd \
        --wavdir GEN --gt-wavdir GT [--outdir OUT] [--n_jobs 8]
"""

from __future__ import annotations

import argparse
import fnmatch
import logging
import multiprocessing as mp
import os

import numpy as np

from parallelwavegan_tpu_torch.ops.metrics import mel_cepstral_distortion
from parallelwavegan_tpu_torch.utils.io import read_wav_entry, wav_index


def _evaluate_one(pair):
    utt_id, gen_entry, gt_entry, opts = pair
    fs_gen, gen = read_wav_entry(gen_entry)
    fs_gt, gt = read_wav_entry(gt_entry)
    assert fs_gen == fs_gt, f"{utt_id}: fs mismatch"
    return utt_id, mel_cepstral_distortion(gen, gt, fs_gen, **opts)


def pair_with_ground_truth(gen_dir: str, gt_dir: str) -> list:
    """[(utt_id, generated entry, ground-truth entry)], sorted by id: each
    ``{utt}_gen`` of ``gen_dir`` (or each wav, where none is so named)
    against ``utt`` of ``gt_dir`` or else its first id matching
    ``{utt}*``; an utterance without ground truth is skipped with a
    warning."""
    gen_index = wav_index(gen_dir, "*_gen.wav") or wav_index(gen_dir)
    gt_index = wav_index(gt_dir)
    pairs = []
    for utt, gen_entry in sorted(gen_index.items()):
        utt = utt.removesuffix("_gen")
        match = gt_index.get(utt) or next(
            (v for k, v in gt_index.items() if fnmatch.fnmatch(k, f"{utt}*")), None)
        if match is None:
            logging.warning("no ground truth for %s; skipped.", utt)
            continue
        pairs.append((utt, gen_entry, match))
    logging.info("number of utterances = %d", len(pairs))
    return pairs


def main(argv=None) -> dict:
    """Returns {"utt2mcd": {utt: MCD in dB}, "mean": ..., "std": ...}."""
    parser = argparse.ArgumentParser(description="Evaluate MCD (gen vs GT).")
    parser.add_argument("--wavdir", type=str, required=True,
                        help="directory with generated *_gen.wav files, or a "
                             "wav.scp (optional sibling segments file)")
    parser.add_argument("--gt-wavdir", type=str, required=True,
                        help="directory with ground-truth wavs, or a wav.scp "
                             "(optional sibling segments file)")
    parser.add_argument("--outdir", type=str, default=None)
    parser.add_argument("--n_fft", type=int, default=1024)
    parser.add_argument("--n_shift", type=int, default=256)
    parser.add_argument("--mcep_dim", type=int, default=None,
                        help="mel-cepstrum order (default: fs-dependent)")
    parser.add_argument("--mcep_alpha", type=float, default=None,
                        help="all-pass alpha (default: fs-dependent)")
    parser.add_argument("--n_jobs", type=int, default=8)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    opts = {"n_fft": args.n_fft, "n_shift": args.n_shift,
            "mcep_dim": args.mcep_dim, "mcep_alpha": args.mcep_alpha}
    pairs = [p + (opts,) for p in pair_with_ground_truth(args.wavdir, args.gt_wavdir)]
    with mp.Pool(args.n_jobs) as pool:
        results = pool.map(_evaluate_one, pairs)

    results.sort(key=lambda r: r[0])
    mcds = np.array([r[1] for r in results])
    mean_mcd, std_mcd = float(np.mean(mcds)), float(np.std(mcds))
    logging.info("Average: %.4f +- %.4f", mean_mcd, std_mcd)

    if args.outdir is not None:
        os.makedirs(args.outdir, exist_ok=True)
        with open(os.path.join(args.outdir, "utt2mcd"), "w") as f:
            for utt_id, mcd in results:
                f.write(f"{utt_id} {mcd:.4f}\n")
        with open(os.path.join(args.outdir, "avg_mcd"), "w") as f:
            f.write(f"{mean_mcd:.4f} +- {std_mcd:.4f}\n")
        logging.info("Saved results to %s.", args.outdir)
    return {"utt2mcd": dict(results), "mean": mean_mcd, "std": std_mcd}


if __name__ == "__main__":
    main()
