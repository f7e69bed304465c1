"""Feature-statistics CLI of the port (counterpart of
parallelwavegan_tpu/bin/compute_statistics.py:25-134).

The mean and population standard deviation of every feature dimension
over a dump directory (``--rootdir``) or a ``--feats-scp``, of the mel
features or, with ``--target-feats local``, the local ones; with
``--utt2spk`` per speaker too. Written as ``stats.h5`` (``mean``,
``scale``, ``{spk}/mean``, ``{spk}/scale``; needs h5py) or
``stats.npy`` and ``stats-{spk}.npy`` ((2, dims): mean, scale):

    python -m parallelwavegan_tpu_torch.bin.compute_statistics --config CONF \
        (--rootdir DUMP | --feats-scp feats.scp) --dumpdir OUT
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from parallelwavegan_tpu_torch.data.datasets import MelDataset, MelSCPDataset
from parallelwavegan_tpu_torch.utils.config import load_config
from parallelwavegan_tpu_torch.utils.io import read_hdf5, write_hdf5


class StreamingScaler:
    """Streaming per-dimension mean and standard deviation (sklearn's
    ``StandardScaler.partial_fit``): float64 sums of x and x²."""

    def __init__(self):
        self.n = 0
        self.sum = None
        self.sumsq = None

    def partial_fit(self, x: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        if self.sum is None:
            self.sum = x.sum(axis=0)
            self.sumsq = (x ** 2).sum(axis=0)
        else:
            self.sum += x.sum(axis=0)
            self.sumsq += (x ** 2).sum(axis=0)
        self.n += len(x)

    @property
    def mean_(self):
        return self.sum / self.n

    @property
    def scale_(self):
        var = self.sumsq / self.n - self.mean_ ** 2
        return np.sqrt(np.maximum(var, 0.0))


def read_utt2spk(path: str | None) -> dict | None:
    """{utt: speaker} of a kaldi ``utt2spk`` file, or None without one."""
    if path is None:
        return None
    utt2spk = {}
    with open(path) as f:
        for line in f:
            utt, spk = line.split()
            utt2spk[utt] = spk
    return utt2spk


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Compute feature statistics.")
    parser.add_argument("--feats-scp", "--scp", default=None, type=str)
    parser.add_argument("--rootdir", type=str, default=None)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--dumpdir", default=None, type=str, required=True)
    parser.add_argument("--target-feats", type=str, default="feats",
                        choices=["feats", "local"])
    parser.add_argument("--utt2spk", default=None, type=str)
    parser.add_argument("--spk2idx", default=None, type=str)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s")
    config = load_config(args.config)
    if (args.feats_scp is not None) == (args.rootdir is not None):
        raise ValueError("Please specify either --rootdir or --feats-scp.")

    fmt = config.get("format", "hdf5")
    if args.feats_scp is None:
        if fmt == "hdf5":
            query = "*.h5"

            def load_fn(x):
                return read_hdf5(x, args.target_feats)
        elif fmt == "npy":
            query, load_fn = f"*-{args.target_feats}.npy", np.load
        else:
            raise ValueError("support only hdf5 or npy format.")
        dataset = MelDataset(args.rootdir, mel_query=query, mel_load_fn=load_fn,
                             return_utt_id=True)
    else:
        dataset = MelSCPDataset(args.feats_scp, return_utt_id=True)
    utt2spk = read_utt2spk(args.utt2spk)

    os.makedirs(args.dumpdir, exist_ok=True)
    scaler = StreamingScaler()
    spk_scalers: dict[str, StreamingScaler] = {}
    for i in range(len(dataset)):
        utt_id, mel = dataset[i]
        scaler.partial_fit(mel)
        if utt2spk is not None:
            spk_scalers.setdefault(utt2spk[utt_id], StreamingScaler()).partial_fit(mel)

    def stats(s):
        return s.mean_.astype(np.float32), s.scale_.astype(np.float32)

    if fmt == "hdf5":
        out = os.path.join(args.dumpdir, "stats.h5")
        for prefix, s in [("", scaler)] + [(f"{k}/", v) for k, v in spk_scalers.items()]:
            mean, scale = stats(s)
            write_hdf5(out, f"{prefix}mean", mean)
            write_hdf5(out, f"{prefix}scale", scale)
    else:
        for name, s in [("stats", scaler)] + [(f"stats-{k}", v)
                                              for k, v in spk_scalers.items()]:
            np.save(os.path.join(args.dumpdir, f"{name}.npy"), np.stack(stats(s)),
                    allow_pickle=False)
    logging.info("Successfully saved statistics to %s.", args.dumpdir)


if __name__ == "__main__":
    main()
