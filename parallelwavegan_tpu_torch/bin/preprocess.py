"""Feature-extraction CLI of the port (counterpart of
parallelwavegan_tpu/bin/preprocess.py:29-281).

Reads WAVs from ``--rootdir`` or a kaldi-style ``--wav-scp`` (with
``--segments``), checks them (mono, within [-1, 1], the config's sampling
rate unless ``--allow-different-sampling-rate`` resamples them), trims
silence where the config asks, computes log-mel features with
``ops/mel.py`` (at ``sampling_rate_for_feats`` where the config sets
one), edge-pads and cuts the audio to the frame grid, adds f0 and
excitation for UHiFiGAN configs and continuous log-F0 local features for
``--extract-f0``, applies ``global_gain_scale`` (an utterance that then
clips is skipped) and writes one ``{utt}.h5`` (needs h5py) or
``{utt}-{wave,feats,...}.npy`` set per utterance to ``--dumpdir``:

    python -m parallelwavegan_tpu_torch.bin.preprocess --config CONF \
        (--rootdir WAVDIR | --wav-scp wav.scp [--segments segments]) \
        --dumpdir DUMP

Every array is computed in numpy as the JAX package computes it.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from parallelwavegan_tpu_torch.data.datasets import AudioSCPDataset
from parallelwavegan_tpu_torch.ops.mel import logmelfilterbank
from parallelwavegan_tpu_torch.utils.config import load_config
from parallelwavegan_tpu_torch.utils.io import find_files, read_wav, write_hdf5


def trim_silence_np(audio: np.ndarray, top_db: float = 60.0, frame_length: int = 2048,
                    hop_length: int = 512) -> np.ndarray:
    """Leading and trailing silence removed, as ``librosa.effects.trim``."""
    if len(audio) < frame_length:
        return audio
    n_frames = 1 + (len(audio) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    rms = np.sqrt(np.mean(audio[idx] ** 2, axis=1))
    ref = np.max(rms)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(ref, 1e-10))
    keep = np.flatnonzero(db > -top_db)
    if len(keep) == 0:
        return audio[:0]
    start = keep[0] * hop_length
    end = min(len(audio), (keep[-1] + 1) * hop_length + frame_length)
    return audio[start:end]


def resample_poly_np(audio: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(fs_in, fs_out)
    return resample_poly(audio, fs_out // g, fs_in // g).astype(np.float32)


def _iter_utterances(args):
    if args.rootdir is not None:
        for path in sorted(find_files(args.rootdir, "*.wav")):
            utt_id = os.path.splitext(os.path.basename(path))[0]
            fs, audio = read_wav(path)
            yield utt_id, fs, audio
    else:
        dataset = AudioSCPDataset(args.wav_scp, segments=args.segments,
                                  return_utt_id=True, return_sampling_rate=True)
        for i in range(len(dataset)):
            utt_id, (audio, fs) = dataset[i]
            yield utt_id, fs, audio


def _read_speakers(args):
    """{utt: speaker index} from ``--utt2spk`` and ``--spk2idx``, or None."""
    if args.utt2spk is None:
        return None
    if args.spk2idx is None:
        raise ValueError("--utt2spk requires --spk2idx")
    spk2idx = {}
    with open(args.spk2idx) as f:
        for line in f:
            spk, idx = line.split()
            spk2idx[spk] = int(idx)
    utt2spkid = {}
    with open(args.utt2spk) as f:
        for line in f:
            utt, spk = line.split()
            utt2spkid[utt] = spk2idx[spk]
    return utt2spkid


def write_dump(dumpdir: str, fmt: str, utt_id: str, arrays: dict) -> None:
    """Each named array as a dataset of ``{utt}.h5`` or as ``{utt}-{name}.npy``."""
    for name, value in arrays.items():
        if fmt == "hdf5":
            write_hdf5(os.path.join(dumpdir, f"{utt_id}.h5"), name, value)
        elif fmt == "npy":
            np.save(os.path.join(dumpdir, f"{utt_id}-{name}.npy"), value,
                    allow_pickle=False)
        else:
            raise ValueError(f"format {fmt} is not supported.")


def main(argv=None) -> None:
    """Run the preprocessing."""
    parser = argparse.ArgumentParser(description="Preprocess audio / extract features.")
    parser.add_argument("--wav-scp", "--scp", default=None, type=str)
    parser.add_argument("--segments", default=None, type=str)
    parser.add_argument("--rootdir", default=None, type=str)
    parser.add_argument("--dumpdir", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--utt2spk", default=None, type=str)
    parser.add_argument("--spk2idx", default=None, type=str)
    parser.add_argument("--skip-mel-ext", default=False, action="store_true")
    parser.add_argument("--extract-f0", default=False, action="store_true")
    parser.add_argument("--allow-different-sampling-rate", default=False,
                        action="store_true")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose > 1 else
        (logging.INFO if args.verbose > 0 else logging.WARN),
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s")
    config = load_config(args.config)
    if (args.wav_scp is not None) == (args.rootdir is not None):
        raise ValueError("Please specify either --rootdir or --wav-scp.")
    utt2spkid = _read_speakers(args)

    os.makedirs(args.dumpdir, exist_ok=True)
    fmt = config.get("format", "hdf5")
    hop_size = config["hop_size"]
    for utt_id, fs, audio in _iter_utterances(args):
        if audio.ndim != 1:
            raise ValueError(f"{utt_id}: not mono")
        if np.abs(audio).max() > 1.0:
            raise ValueError(f"{utt_id}: out of [-1, 1] range")
        if fs != config["sampling_rate"] and not args.allow_different_sampling_rate:
            raise ValueError(f"{utt_id}: fs {fs} != config {config['sampling_rate']}")
        if fs != config["sampling_rate"]:
            audio = resample_poly_np(audio, fs, config["sampling_rate"])
            fs = config["sampling_rate"]

        if config.get("trim_silence", False):
            audio = trim_silence_np(audio, top_db=config["trim_threshold_in_db"],
                                    frame_length=config["trim_frame_size"],
                                    hop_length=config["trim_hop_size"])

        feat_fs = config.get("sampling_rate_for_feats")
        if feat_fs in (None, fs):
            x, feat_fs, feat_hop = audio, fs, hop_size
        else:  # features at another rate, on the same frame grid
            if hop_size * feat_fs % fs != 0:
                raise ValueError("hop_size must be adjustable to sampling_rate_for_feats")
            x = resample_poly_np(audio, fs, feat_fs)
            feat_hop = hop_size * feat_fs // fs
        mel = logmelfilterbank(
            x, sampling_rate=feat_fs, hop_size=feat_hop, fft_size=config["fft_size"],
            win_length=config["win_length"], window=config["window"],
            num_mels=config["num_mels"], fmin=config["fmin"], fmax=config["fmax"],
            log_base=config.get("log_base", 10.0))

        # the audio edge-padded, then cut to the frame grid
        audio = np.pad(audio, (0, config["fft_size"]), mode="reflect")
        audio = audio[: len(mel) * hop_size]
        assert len(mel) * hop_size == len(audio)

        f0 = excitation = local = None
        if args.extract_f0:  # continuous log-F0 and V/UV on the hop grid
            from parallelwavegan_tpu_torch.ops.f0 import logf0_and_vuv

            local = logf0_and_vuv(audio, fs, hop_size)
            if local is None:
                logging.warning(f"{utt_id}: all frames unvoiced; skipped.")
                continue
            assert len(local) * hop_size == len(audio), (
                f"{utt_id}: local grid {len(local)} != {len(audio) // hop_size} frames")
        if config.get("generator_type") == "UHiFiGANGenerator":
            from parallelwavegan_tpu_torch.ops.f0 import extract_f0_and_excitation

            f0, excitation = extract_f0_and_excitation(
                audio, fs, hop_size, fmin=config.get("f0min", 70.0),
                fmax=config.get("f0max", 340.0), sine_amp=config.get("sine_amp", 0.1),
                noise_std=config.get("noise_std", 0.003))
            f0 = f0[: len(mel)]
            # one row per frame, so the collater slices it with frame indices
            excitation = excitation[: len(mel) * hop_size].reshape(len(mel), hop_size)

        gain = config.get("global_gain_scale", 1.0)
        if gain != 1.0:
            audio *= gain
        if np.abs(audio).max() >= 1.0:
            logging.warning(f"{utt_id} causes clipping. it is better to re-consider "
                            "global gain scale.")
            continue

        arrays = {"wave": audio.astype(np.float32)}
        if not args.skip_mel_ext:
            arrays["feats"] = mel.astype(np.float32)
        if f0 is not None:
            arrays["f0"] = f0.astype(np.float32)
            arrays["excitation"] = excitation.astype(np.float32)
        if local is not None:
            arrays["local"] = local.astype(np.float32)
        if utt2spkid is not None:
            arrays["global"] = np.asarray(utt2spkid[utt_id])
        write_dump(args.dumpdir, fmt, utt_id, arrays)


if __name__ == "__main__":
    main()
