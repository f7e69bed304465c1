"""Decoding CLI of the port (counterpart of parallelwavegan_tpu/bin/decode.py:34-223).

Reads mel features from a dump directory (``--dumpdir``) or a kaldi-style
``--feats-scp`` (binary ark entries ``path.ark:offset``, hdf5 or npy),
decodes each utterance of any ported generator with
``load_model(...).inference`` on ``--device`` (with ``--batch-size`` N > 1,
the utterances sorted by length and N at a time through
``inference_batch``) and writes 16-bit WAVs (Multi-band MelGAN after PQMF
synthesis; StyleMelGAN with noise drawn as Parallel WaveGAN's is).
``--use-pallas-tail`` routes the HiFi-GAN decode tail,
``--use-pallas-stack`` the Parallel WaveGAN dilation cycles and
``--use-pallas-stacks`` the (Multi-band) MelGAN residual stacks through
their hand-written CUDA kernels (the JAX flag names, kept so configs and
scripts are shared); a config that sets ``use_pallas_stack_train``, as
the shipped ``parallel_wavegan.v1.yaml`` does, routes the PWG cycles
there too (``pallas_stack_bf16`` in the config, without
``use_pallas_stack_train``, runs them in K3's bf16-resident mode, as
JAX's ``compute_dtype=bfloat16``), and HiFi-GAN's MRF kernel is reached through
``use_pallas_mrf`` in the config, and StyleMelGAN's TADE kernels (K8a,
K8b) through ``use_pallas_tade``, as in the JAX package, which has no
flag for either. RTF is measured per utterance (per batch with
``--batch-size``) with the device synchronised before each clock read.
Streaming, sharded, VQ-VAE and f0/excitation decode are not ported yet
and are refused by name (ROADMAP.md). float32 convolutions run without
TF32, as the JAX package computes in full float32.

    python -m parallelwavegan_tpu_torch.bin.decode \
        (--dumpdir DUMP | --feats-scp feats.scp) [--batch-size N] \
        --outdir OUT --checkpoint CKPT.pkl [--config CONFIG] \
        [--normalize-before] [--use-pallas-tail] [--use-pallas-stack] \
        [--use-pallas-stacks] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from parallelwavegan_tpu_torch.data.datasets import MelDataset, MelSCPDataset
from parallelwavegan_tpu_torch.utils.config import load_config
from parallelwavegan_tpu_torch.utils.io import read_hdf5, write_wav
from parallelwavegan_tpu_torch.utils.model import load_model


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to parallelwavegan_tpu_torch yet; see ROADMAP.md")


def main(argv=None) -> dict:
    """Run the decode; returns {"rtf": mean RTF, "rtfs": per utterance, or
    per batch with ``--batch-size`` > 1}."""
    parser = argparse.ArgumentParser(description="Decode with a trained vocoder.")
    parser.add_argument("--feats-scp", "--scp", default=None, type=str)
    parser.add_argument("--dumpdir", default=None, type=str)
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument("--normalize-before", default=False, action="store_true")
    parser.add_argument(
        "--use-pallas-tail", default=False, action="store_true",
        help="run the HiFi-GAN decode tail through the hand-written CUDA "
             "kernel (its plain PyTorch version on the CPU)",
    )
    parser.add_argument(
        "--use-pallas-stack", default=False, action="store_true",
        help="run the Parallel WaveGAN dilation cycles through the "
             "hand-written CUDA kernel (its plain PyTorch version on the CPU)",
    )
    parser.add_argument(
        "--use-pallas-stacks", default=False, action="store_true",
        help="run the MelGAN / Multi-band MelGAN residual stacks through the "
             "hand-written CUDA kernel (its plain PyTorch version on the CPU)",
    )
    parser.add_argument("--batch-size", type=int, default=1,
                        help="decode N utterances per forward, sorted by length")
    refused = {"streaming": "streaming decode", "sharded": "sharded decode",
               "use_f0_and_excitation": "f0/excitation decode",
               "segments": "VQ-VAE wav.scp decode"}
    for dest, what in refused.items():
        parser.add_argument(f"--{dest.replace('_', '-')}", default=None,
                            **({} if dest == "segments" else {"action": "store_true"}),
                            help=f"{what}: not ported yet")
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    for dest, what in refused.items():
        if getattr(args, dest) is not None:
            raise _not_ported(f"{what} (--{dest.replace('_', '-')})")
    if (args.feats_scp is not None) == (args.dumpdir is not None):
        raise ValueError("Please specify either --dumpdir or --feats-scp.")

    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was given but no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.info("TF32 off for matmuls and cuDNN convolutions (float32 decode).")

    if args.config is not None:
        config = load_config(args.config)
    else:
        config = load_config(os.path.join(os.path.dirname(args.checkpoint),
                                          "config.yml"))

    generator_type = config.get("generator_type", "ParallelWaveGANGenerator")
    if generator_type == "VQVAE":
        raise _not_ported("VQ-VAE decode")
    if generator_type == "UHiFiGANGenerator":
        raise _not_ported("f0/excitation decode (UHiFiGANGenerator)")
    fmt = config.get("format", "hdf5")
    if args.feats_scp is not None:
        dataset = MelSCPDataset(args.feats_scp, return_utt_id=True)
    elif fmt == "hdf5":
        dataset = MelDataset(args.dumpdir, mel_query="*.h5", return_utt_id=True,
                             mel_load_fn=lambda x: read_hdf5(x, "feats"))
    elif fmt == "npy":
        dataset = MelDataset(args.dumpdir, mel_query="*-feats.npy",
                             mel_load_fn=np.load, return_utt_id=True)
    else:
        raise ValueError("Support only hdf5 or npy format.")
    logging.info("The number of features to be decoded = %d.", len(dataset))

    for flag, key, gtype in (
            (args.use_pallas_tail, "use_pallas_tail", "HiFiGANGenerator"),
            (args.use_pallas_stack, "use_pallas_stack", "ParallelWaveGANGenerator"),
            (args.use_pallas_stacks, "use_pallas_stacks", "MelGANGenerator")):
        if flag and generator_type == gtype:
            config = dict(config)
            config["generator_params"] = dict(config["generator_params"],
                                              **{key: True})
    model = load_model(args.checkpoint, config, device=device)
    logging.info("Loaded model parameters from %s.", args.checkpoint)

    os.makedirs(args.outdir, exist_ok=True)
    fs = config["sampling_rate"]
    if args.batch_size > 1:
        return _decode_batched(args, model, dataset, fs, device)
    rtfs = []
    for i in range(len(dataset)):
        utt_id, c = dataset[i]
        _synchronize(device)
        start = time.perf_counter()
        y = model.inference(c, normalize_before=args.normalize_before)[:, 0]
        _synchronize(device)
        rtf = (time.perf_counter() - start) / (len(y) / fs)
        if not np.all(np.isfinite(y)):
            raise FloatingPointError(f"non-finite samples decoded for {utt_id}")
        rtfs.append(rtf)
        logging.info("%s: %d samples, RTF = %.06f", utt_id, len(y), rtf)
        write_wav(os.path.join(args.outdir, f"{utt_id}_gen.wav"), fs, y)

    mean_rtf = float(np.mean(rtfs))
    logging.info("Finished generation of %d utterances (RTF = %.06f).",
                 len(dataset), mean_rtf)
    return {"rtf": mean_rtf, "rtfs": rtfs}


def _decode_batched(args, model, dataset, fs: int, device: torch.device) -> dict:
    """The utterances sorted by length (stable), ``--batch-size`` of them per
    ``inference_batch`` call; RTF per batch (its time over its audio)."""
    items = [dataset[i] for i in range(len(dataset))]
    items.sort(key=lambda kv: kv[1].shape[0])
    total_time = total_audio = 0.0
    rtfs = []
    for s in range(0, len(items), args.batch_size):
        group = items[s: s + args.batch_size]
        _synchronize(device)
        start = time.perf_counter()
        ys = model.inference_batch([c for _, c in group],
                                   normalize_before=args.normalize_before)
        _synchronize(device)
        elapsed = time.perf_counter() - start
        audio = sum(len(y) for y in ys) / fs
        total_time += elapsed
        total_audio += audio
        rtfs.append(elapsed / audio)
        logging.info("batch of %d (%s): RTF = %.06f", len(group),
                     ", ".join(u for u, _ in group), rtfs[-1])
        for (utt_id, _), y in zip(group, ys):
            if not np.all(np.isfinite(y)):
                raise FloatingPointError(f"non-finite samples decoded for {utt_id}")
            write_wav(os.path.join(args.outdir, f"{utt_id}_gen.wav"), fs, y[:, 0])
    rtf = total_time / max(total_audio, 1e-9)
    logging.info("Finished batched generation of %d utterances (RTF = %.06f).",
                 len(items), rtf)
    return {"rtf": rtf, "rtfs": rtfs}


if __name__ == "__main__":
    main()
