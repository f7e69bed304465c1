"""Decoding CLI of the port (counterpart of parallelwavegan_tpu/bin/decode.py:34-223).

Reads mel features from a dump directory (``--dumpdir``) or a kaldi-style
``--feats-scp`` (binary ark entries ``path.ark:offset``, hdf5 or npy),
decodes each utterance of any ported generator with
``load_model(...).inference`` on ``--device`` (with ``--batch-size`` N > 1,
the utterances sorted by length and N at a time through
``inference_batch``) and writes 16-bit WAVs (Multi-band MelGAN after PQMF
synthesis; StyleMelGAN with noise drawn as Parallel WaveGAN's is).
The discrete-symbol (HuBERT-unit) generators decode dumps whose
features are unit ids (T, 1), or (T, 2) with the speaker id in channel 1
where the config has speakers (``InferenceModel.inference``'s discrete
branch; ``--normalize-before`` does not apply to ids, as in JAX).
``--use-pallas-tail`` routes the HiFi-GAN decode tail (of
``HiFiGANGenerator``, ``DiscreteSymbolHiFiGANGenerator`` and
``DiscreteSymbolDurationGenerator``, JAX :161-167),
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
flag for either. ``--use-f0-and-excitation``, on by default for the
U-Net HiFi-GAN (JAX :44-50, :116-200), reads each utterance's f0 and
excitation beside its mel from ``--dumpdir`` (an scp carries none) and
decodes one utterance at a time whatever ``--batch-size`` says (:186).
A VQ-VAE checkpoint decodes wave to wave (``_decode_vqvae``, JAX
:253-381): each utterance of ``--dumpdir`` (with its local and global
conditioning) or of the wav.scp given as ``--feats-scp`` (with
``--segments``) is edge-padded to a multiple of prod(encoder
downsample_scales) x in_channels x 16 samples, encoded to codebook
indices (through PQMF analysis where the encoder reads sub-bands) and
decoded, its wave trimmed to the input's length; the indices of each
utterance, ceil(T / (downsample x in_channels)) of them, go to the
symbol file ``text`` in the output directory. Its decoder reaches K6
through ``decoder_conf.use_pallas_stacks`` in the config.
``--streaming`` decodes each utterance in windows of ``--chunk-frames``
with ``--context-frames`` of context (``InferenceModel.inference_streaming``);
``--sharded`` splits each utterance's time axis over every visible card
(``inference_sharded`` over ``parallel/mesh.py make_mesh()``; with
``--device cpu``, or one card, the mesh has one device and the decode
falls back to the one-shot path), or with ``--batch-size`` > 1 each
batch's rows. The dispatch is JAX's (:178-212): ``--batch-size`` > 1
first, then ``--streaming``, then ``--sharded``, then one-shot. RTF is
measured per utterance (per batch with ``--batch-size``) with the device
synchronised before each clock read. float32 convolutions run without
TF32, as the JAX package computes in full float32.

    python -m parallelwavegan_tpu_torch.bin.decode \
        (--dumpdir DUMP | --feats-scp feats.scp [--segments S]) \
        [--batch-size N] --outdir OUT --checkpoint CKPT.pkl [--config CONFIG] \
        [--normalize-before] [--use-pallas-tail] [--use-pallas-stack] \
        [--use-pallas-stacks] [--use-f0-and-excitation] [--streaming]
        [--sharded] [--chunk-frames 256] [--context-frames 64] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from parallelwavegan_tpu_torch.data.datasets import (
    AudioDataset,
    AudioSCPDataset,
    MelDataset,
    MelF0ExcitationDataset,
    MelSCPDataset,
)
from parallelwavegan_tpu_torch.ops.pqmf import PQMF
from parallelwavegan_tpu_torch.parallel.mesh import make_mesh
from parallelwavegan_tpu_torch.utils.config import load_config, validate_local_condition
from parallelwavegan_tpu_torch.utils.io import read_hdf5, write_wav
from parallelwavegan_tpu_torch.utils.model import load_model


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    parser.add_argument("--segments", default=None, type=str,
                        help="kaldi-style segments file (VQ-VAE wav.scp decode)")
    parser.add_argument("--use-f0-and-excitation", default=None, action="store_true",
                        help="read f0 and excitation beside the mel (on by default "
                             "for UHiFiGANGenerator)")
    parser.add_argument("--streaming", default=False, action="store_true",
                        help="chunked decode: fixed window shapes and O(chunk) "
                             "device memory for unbounded lengths (HiFiGAN/MelGAN/"
                             "PWG families)")
    parser.add_argument("--sharded", default=False, action="store_true",
                        help="split each utterance's time axis over every visible "
                             "card (equal to one-shot decode); with --batch-size "
                             ">1 the batch's rows instead")
    parser.add_argument("--chunk-frames", type=int, default=256)
    parser.add_argument("--context-frames", type=int, default=64)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
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
        validate_local_condition(config)
        return _decode_vqvae(args, config, device)
    if args.use_f0_and_excitation is None:
        args.use_f0_and_excitation = generator_type == "UHiFiGANGenerator"
    fmt = config.get("format", "hdf5")
    if fmt not in ("hdf5", "npy"):
        raise ValueError("Support only hdf5 or npy format.")
    mel_kw = (dict(mel_query="*.h5", mel_load_fn=lambda x: read_hdf5(x, "feats"))
              if fmt == "hdf5" else dict(mel_query="*-feats.npy", mel_load_fn=np.load))
    if args.feats_scp is not None:
        if args.use_f0_and_excitation:
            raise NotImplementedError(
                "scp decode does not carry f0/excitation features (UHiFiGAN "
                "needs --dumpdir)")
        dataset = MelSCPDataset(args.feats_scp, return_utt_id=True)
    elif args.use_f0_and_excitation:
        extra = {} if fmt == "hdf5" else dict(
            f0_query="*-f0.npy", f0_load_fn=np.load,
            excitation_query="*-excitation.npy", excitation_load_fn=np.load)
        dataset = MelF0ExcitationDataset(args.dumpdir, return_utt_id=True, **mel_kw,
                                         **extra)
    else:
        dataset = MelDataset(args.dumpdir, return_utt_id=True, **mel_kw)
    logging.info("The number of features to be decoded = %d.", len(dataset))

    for flag, key, gtypes in (
            (args.use_pallas_tail, "use_pallas_tail",
             ("HiFiGANGenerator", "DiscreteSymbolHiFiGANGenerator",
              "DiscreteSymbolDurationGenerator")),
            (args.use_pallas_stack, "use_pallas_stack", ("ParallelWaveGANGenerator",)),
            (args.use_pallas_stacks, "use_pallas_stacks", ("MelGANGenerator",))):
        if flag and generator_type in gtypes:
            config = dict(config)
            config["generator_params"] = dict(config["generator_params"],
                                              **{key: True})
    model = load_model(args.checkpoint, config, device=device)
    logging.info("Loaded model parameters from %s.", args.checkpoint)

    os.makedirs(args.outdir, exist_ok=True)
    fs = config["sampling_rate"]
    mesh = None
    if args.sharded:
        # every visible card; on the CPU the one device asked for
        mesh = make_mesh() if device.type == "cuda" else make_mesh([device])
        logging.info("Sharded decode over %d devices.", len(mesh))
    if args.batch_size > 1 and not args.use_f0_and_excitation:
        return _decode_batched(args, model, dataset, fs, device, mesh)
    rtfs = []
    for i in range(len(dataset)):
        item = dataset[i]
        utt_id, c = item[0], item[1]
        _synchronize(device)
        start = time.perf_counter()
        if args.use_f0_and_excitation:
            y = model.inference(c, normalize_before=args.normalize_before,
                                excitation=item[3])
        elif args.streaming:
            y = model.inference_streaming(
                c, chunk_frames=args.chunk_frames, context_frames=args.context_frames,
                normalize_before=args.normalize_before)
        elif mesh is not None:
            y = model.inference_sharded(c, mesh, context_frames=args.context_frames,
                                        normalize_before=args.normalize_before)
        else:
            y = model.inference(c, normalize_before=args.normalize_before)
        y = y[:, 0]
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


def _decode_batched(args, model, dataset, fs: int, device: torch.device,
                    mesh=None) -> dict:
    """The utterances sorted by length (stable), ``--batch-size`` of them per
    ``inference_batch`` call, its rows split over ``mesh`` where given; RTF
    per batch (its time over its audio)."""
    items = [dataset[i] for i in range(len(dataset))]
    items.sort(key=lambda kv: kv[1].shape[0])
    total_time = total_audio = 0.0
    rtfs = []
    for s in range(0, len(items), args.batch_size):
        group = items[s: s + args.batch_size]
        _synchronize(device)
        start = time.perf_counter()
        ys = model.inference_batch([c for _, c in group],
                                   normalize_before=args.normalize_before, mesh=mesh)
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


def _decode_vqvae(args, config: dict, device: torch.device) -> dict:
    """VQ-VAE wave-to-wave decode (JAX ``_decode_vqvae``): per utterance
    encode -> decode, ``{utt}_gen.wav`` and a line of ``text``."""
    fmt = config.get("format", "hdf5")
    use_local = config.get("use_local_condition", False)
    use_global = config.get("use_global_condition", False)
    if args.dumpdir is not None:
        def reader(name):
            return (lambda x: read_hdf5(x, name)) if fmt == "hdf5" else np.load

        def query(name):
            return "*.h5" if fmt == "hdf5" else f"*-{name}.npy"

        cond = {}
        for flag, name in ((use_local, "local"), (use_global, "global")):
            if flag:
                cond.update({f"{name}_query": query(name), f"{name}_load_fn": reader(name)})
        dataset = AudioDataset(args.dumpdir, audio_query=query("wave"),
                               audio_load_fn=reader("wave"), return_utt_id=True, **cond)
    else:
        if use_local or use_global:
            raise ValueError("scp decode does not carry local/global conditioning")
        dataset = AudioSCPDataset(args.feats_scp, segments=args.segments,
                                  return_utt_id=True)
    logging.info("The number of utterances to be decoded = %d.", len(dataset))
    model = load_model(args.checkpoint, config, device=device).generator
    subbands = config["generator_params"].get("in_channels", 1)
    pqmf = PQMF(subbands) if subbands > 1 else None
    downs = model.downsample_factor
    bucket = downs * subbands * 16
    os.makedirs(args.outdir, exist_ok=True)
    fs = config["sampling_rate"]
    rtfs = []
    with open(os.path.join(args.outdir, "text"), "w") as sym_f:
        for i in range(len(dataset)):
            utt_id, audio, *rest = dataset[i]
            l = rest.pop(0) if use_local else None
            g = rest.pop(0) if use_global else None
            audio = np.asarray(audio, np.float32)
            t = len(audio)
            pad_t = -(-t // bucket) * bucket
            x = torch.from_numpy(np.pad(audio, (0, pad_t - t), mode="edge")[None, None])
            if l is not None:  # on the hop grid, padded to the latent's frames
                n_l = pad_t // config["hop_size"]
                l = np.asarray(l, np.float32)
                l = np.pad(l, ((0, max(0, n_l - len(l))), (0, 0)), mode="edge")[:n_l]
                l = torch.from_numpy(np.ascontiguousarray(l.T[None])).to(device)
            if g is not None:
                g = torch.from_numpy(np.asarray(g).reshape(1).astype(np.int64)).to(device)
            _synchronize(device)
            start = time.perf_counter()
            with torch.inference_mode():
                x = x.to(device)
                if pqmf is not None:
                    x = pqmf.analysis(x.transpose(1, 2)).transpose(1, 2)
                indices = model.encode(x)
                y = model.decode(indices, l, g)
                if pqmf is not None:
                    y = pqmf.synthesis(y.transpose(1, 2)).transpose(1, 2)
                y = y[0, 0, :t].cpu().numpy()
                indices = indices[0].cpu().numpy()
            _synchronize(device)
            rtfs.append((time.perf_counter() - start) / (len(y) / fs))
            if not np.all(np.isfinite(y)):
                raise FloatingPointError(f"non-finite samples decoded for {utt_id}")
            logging.info("%s: %d samples, RTF = %.06f", utt_id, len(y), rtfs[-1])
            write_wav(os.path.join(args.outdir, f"{utt_id}_gen.wav"), fs, y)
            n_sym = -(-t // (downs * subbands))
            sym_f.write(f"{utt_id} " + " ".join(str(int(s)) for s in indices[:n_sym]) + "\n")
    mean_rtf = float(np.mean(rtfs))
    logging.info("Finished generation of %d utterances (RTF = %.06f).", len(dataset),
                 mean_rtf)
    return {"rtf": mean_rtf, "rtfs": rtfs}


if __name__ == "__main__":
    main()
