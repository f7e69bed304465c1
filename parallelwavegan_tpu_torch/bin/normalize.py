"""Feature-normalization CLI of the port (counterpart of
parallelwavegan_tpu/bin/normalize.py:29-205).

Each utterance's features, from a dump directory (``--rootdir``) or a
``--wav-scp`` and ``--feats-scp`` pair (with ``--segments``), less the
mean of ``--stats`` over its scale (per speaker with ``--utt2spk``),
written with the waveform (unless ``--skip-wav-copy``) to ``--dumpdir``.
``--target-feats local`` normalizes the local features and leaves their
binary channels (V/UV flags) as they are; f0 and excitation (UHiFiGAN)
and the global speaker index are copied through:

    python -m parallelwavegan_tpu_torch.bin.normalize --config CONF \
        (--rootdir RAW | --wav-scp wav.scp --feats-scp feats.scp) \
        --stats stats.{h5,npy} --dumpdir NORM
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from parallelwavegan_tpu_torch.bin.compute_statistics import read_utt2spk
from parallelwavegan_tpu_torch.bin.preprocess import write_dump
from parallelwavegan_tpu_torch.data.datasets import (
    AudioMelDataset,
    AudioMelF0ExcitationDataset,
    AudioMelSCPDataset,
)
from parallelwavegan_tpu_torch.utils.config import load_config
from parallelwavegan_tpu_torch.utils.io import read_hdf5


def _dataset(args, fmt: str, use_f0_and_excitation: bool, use_global: bool):
    """The utterances to normalize, with their f0 and excitation or global
    index where the config has them."""
    tf = args.target_feats
    if args.rootdir is None:
        if use_f0_and_excitation or use_global:
            raise NotImplementedError("SCP format is not supported for f0/excitation "
                                      "or global conditioning.")
        return AudioMelSCPDataset(args.wav_scp, args.feats_scp, segments=args.segments,
                                  return_utt_id=True)
    if fmt == "hdf5":
        kw = dict(audio_query="*.h5", mel_query="*.h5",
                  audio_load_fn=lambda x: read_hdf5(x, "wave"),
                  mel_load_fn=lambda x: read_hdf5(x, tf))
    elif fmt == "npy":
        kw = dict(audio_query="*-wave.npy", mel_query=f"*-{tf}.npy",
                  audio_load_fn=np.load, mel_load_fn=np.load)
    else:
        raise ValueError("support only hdf5 or npy format.")
    if use_f0_and_excitation:
        if fmt == "npy":
            kw.update(f0_query="*-f0.npy", f0_load_fn=np.load,
                      excitation_query="*-excitation.npy", excitation_load_fn=np.load)
        return AudioMelF0ExcitationDataset(args.rootdir, return_utt_id=True, **kw)
    if use_global:
        if fmt == "hdf5":
            kw.update(global_query="*.h5", global_load_fn=lambda x: read_hdf5(x, "global"))
        else:
            kw.update(global_query="*-global.npy", global_load_fn=np.load)
    return AudioMelDataset(args.rootdir, return_utt_id=True, **kw)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Normalize dumped features.")
    parser.add_argument("--wav-scp", "--scp", default=None, type=str)
    parser.add_argument("--feats-scp", default=None, type=str)
    parser.add_argument("--segments", default=None, type=str)
    parser.add_argument("--rootdir", default=None, type=str)
    parser.add_argument("--dumpdir", type=str, required=True)
    parser.add_argument("--stats", type=str, required=True)
    parser.add_argument("--skip-wav-copy", default=False, action="store_true")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--target-feats", type=str, default="feats",
                        choices=["feats", "local"])
    parser.add_argument("--utt2spk", default=None, type=str)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s")
    config = load_config(args.config)
    if (args.feats_scp is not None) == (args.rootdir is not None):
        raise ValueError("Please specify either --rootdir or --feats-scp.")
    fmt = config.get("format", "hdf5")
    tf = args.target_feats
    use_f0_and_excitation = config.get("generator_type") == "UHiFiGANGenerator"
    use_global = config.get("use_global_condition", False)
    dataset = _dataset(args, fmt, use_f0_and_excitation, use_global)
    utt2spk = read_utt2spk(args.utt2spk)

    def load_stats(spk=None):
        if args.stats.endswith(".h5"):
            prefix = f"{spk}/" if spk else ""
            mean = read_hdf5(args.stats, prefix + "mean").reshape(-1)
            scale = read_hdf5(args.stats, prefix + "scale").reshape(-1)
        else:
            path = args.stats.replace("stats", f"stats-{spk}") if spk else args.stats
            arr = np.load(path)
            mean, scale = arr[0].reshape(-1), arr[1].reshape(-1)
        return mean, scale

    mean, scale = load_stats()
    spk_stats: dict = {}
    os.makedirs(args.dumpdir, exist_ok=True)
    for i in range(len(dataset)):
        f0 = excitation = g = None
        if use_f0_and_excitation:
            utt_id, audio, mel, f0, excitation = dataset[i]
        elif use_global:
            utt_id, audio, mel, g = dataset[i]
        else:
            utt_id, audio, mel = dataset[i]
        m, s = mean, scale
        if utt2spk is not None:
            spk = utt2spk[utt_id]
            if spk not in spk_stats:
                spk_stats[spk] = load_stats(spk)
            m, s = spk_stats[spk]
        mel_norm = (mel - m) / s
        if tf == "local":  # binary channels (V/UV flags) stay as they are
            is_binary = np.logical_or(mel == 1, mel == 0).sum(axis=0) == len(mel)
            mel_norm[:, is_binary] = mel[:, is_binary]
        arrays = {tf: mel_norm.astype(np.float32)}
        if f0 is not None:
            arrays["f0"] = f0.astype(np.float32)
            arrays["excitation"] = excitation.astype(np.float32)
        if g is not None:
            arrays["global"] = np.asarray(g).reshape(-1)
        if not args.skip_wav_copy:
            arrays["wave"] = np.asarray(audio, dtype=np.float32)
        write_dump(args.dumpdir, fmt, utt_id, arrays)


if __name__ == "__main__":
    main()
