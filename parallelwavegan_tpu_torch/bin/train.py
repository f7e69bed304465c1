"""Training CLI of the port (counterpart of parallelwavegan_tpu/bin/train.py:43-375).

Trains a generator and discriminator from dump directories, or from a
``wav.scp`` and a ``feats.scp`` (ark, hdf5 or npy) with an optional kaldi
``segments`` file per split, on ``--device`` (the GPU unless ``--device
cpu`` is given; without a card it raises), writing ``config.yml`` and
``checkpoint-{steps}steps.pkl`` files in upstream's layout to ``--outdir``:

    python -m parallelwavegan_tpu_torch.bin.train --train-dumpdir DUMP \
        --dev-dumpdir DEV --outdir OUT --config CONF.json [--resume CKPT] \
        [--pretrain CKPT] [--device cuda]
    python -m parallelwavegan_tpu_torch.bin.train --train-wav-scp wav.scp \
        --train-feats-scp feats.scp [--train-segments segments] \
        --dev-wav-scp ... --dev-feats-scp ... --outdir OUT --config CONF.json

The config is ``.json``, or YAML where PyYAML imports; ``format: npy``
reads ``*-wave.npy`` / ``*-feats.npy`` pairs and ``hdf5`` needs h5py.
Ported so far: the Parallel WaveGAN generator (causal or not, with any of
its upsample nets) and the MelGAN generator (causal or not; Multi-band
MelGAN with ``out_channels`` sub-bands, synthesised by PQMF in the
criterion) with ``ParallelWaveGANDiscriminator``,
``ResidualParallelWaveGANDiscriminator`` or
``MelGANMultiScaleDiscriminator``, the StyleMelGAN generator with
``StyleMelGANDiscriminator`` (its noise and windows drawn per step from
the config's ``seed``), the HiFi-GAN generator with the HiFi-GAN
discriminators (spectral norm included), the STFT, sub-band STFT, mel,
feature-matching and adversarial losses, RAdam, Adam, or Adam with
``amsgrad: true`` (optax's AMSGrad). HiFi-GAN's ``use_pallas_tail`` and
``use_pallas_mrf`` run kernels without a backward: a training config that
sets either is refused before any step (they are for decode).
With ``use_pallas_stack_train`` PWG's gated layers train through the K3
and K4 kernels on the card (in float32: ``pallas_stack_bf16``, K3's
decode-only bf16 mode, has no effect beside it, as in JAX; with
``use_pallas_stack`` alone a forward that needs gradients raises, as the
JAX kernel has no VJP), with ``use_pallas_stacks_train`` MelGAN's
residual stacks of at most 128 channels through K6 and K7, with
``use_pallas_tade_train`` StyleMelGAN's TADE blocks of at least
``pallas_tade_train_min_t`` samples through K8a/K8b and K9a/K9b.
``--resume`` restores the models, the optimizers (AMSGrad's ``nu_max``
too), the step count and the data stream's position; ``--pretrain`` the
model weights only.
``mixed_precision: true`` runs the forwards and backwards in bf16 with
float32 master weights, optimizer state, losses and spectral (u, v), as
the JAX package does (``train/precision.py``; MelGAN's stacks with
``use_pallas_stacks_train`` through K6/K7's bf16 modes, StyleMelGAN's
TADE blocks with ``use_pallas_tade_train`` through K8/K9's, on the card,
and through their bf16 plain versions on the CPU). Not ported yet, and
refused with ``NotImplementedError`` (ROADMAP.md): ``distributed``, the
duration loss, optimizers other than RAdam and Adam, and the other
families; the local, global and F0 datasets are built as in JAX, and the
collater refuses their conditioning inputs. float32 convolutions and
matmuls run without TF32, as the JAX package computes in full float32.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

import parallelwavegan_tpu_torch
from parallelwavegan_tpu_torch.data.collater import Collater
from parallelwavegan_tpu_torch.data.datasets import (
    AudioDataset,
    AudioMelDataset,
    AudioMelF0ExcitationDataset,
    AudioMelSCPDataset,
)
from parallelwavegan_tpu_torch.data.loader import DataLoader
from parallelwavegan_tpu_torch.models import get_model_class
from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config
from parallelwavegan_tpu_torch.train.criterion import build_criterion
from parallelwavegan_tpu_torch.train.trainer import Trainer
from parallelwavegan_tpu_torch.utils.config import load_config, write_config
from parallelwavegan_tpu_torch.utils.io import read_hdf5


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to parallelwavegan_tpu_torch yet; see ROADMAP.md")


def feature_flags(config: dict) -> dict:
    """Input-feature flags from generator_type (train.py:1109-1117)."""
    generator_type = config.get("generator_type", "ParallelWaveGANGenerator")
    return {
        "use_noise_input": (
            "ParallelWaveGAN" in generator_type and "VQVAE" not in generator_type),
        "use_aux_input": "VQVAE" not in generator_type,
        "use_duration": "Duration" in generator_type,
        "use_f0_and_excitation": generator_type == "UHiFiGANGenerator",
        "use_local_condition": config.get("use_local_condition", False),
        "use_global_condition": config.get("use_global_condition", False),
    }


def build_dataset(config: dict, args, split: str):
    """The dataset of one split: a dump directory (``--{split}-dumpdir``),
    with the local, global or F0 streams that the generator's flags ask
    for, or a ``--{split}-wav-scp`` and ``--{split}-feats-scp`` pair with
    ``--{split}-segments`` (JAX ``bin/train.py:58-155``)."""
    flags = feature_flags(config)
    rootdir = getattr(args, f"{split}_dumpdir", None)
    wav_scp = getattr(args, f"{split}_wav_scp", None)
    hop_size = config.get("hop_size")  # absent for wave-to-wave VQ configs
    win = config["generator_params"].get("aux_context_window", 0)
    mel_threshold = None
    if hop_size and config.get("remove_short_samples", False):
        mel_threshold = config["batch_max_steps"] // hop_size + 2 * win
    cache = config.get("allow_cache", False)
    if rootdir is None:
        if wav_scp is None:
            raise ValueError(f"--{split}-dumpdir or --{split}-wav-scp is required")
        return AudioMelSCPDataset(
            wav_scp, getattr(args, f"{split}_feats_scp"),
            segments=getattr(args, f"{split}_segments", None),
            mel_length_threshold=mel_threshold, allow_cache=cache)
    if config.get("format", "hdf5") == "hdf5":
        def reader(name):
            return lambda x: read_hdf5(x, name)

        query = {name: "*.h5" for name in ("wave", "feats", "local", "global")}
    else:
        def reader(name):
            return np.load

        query = {name: f"*-{name}.npy" for name in ("wave", "feats", "local", "global")}
    audio = dict(audio_query=query["wave"], audio_load_fn=reader("wave"))
    local = dict(local_query=query["local"], local_load_fn=reader("local"))
    glob = {}
    if flags["use_global_condition"]:
        glob = dict(global_query=query["global"], global_load_fn=reader("global"))
    if flags["use_f0_and_excitation"]:
        return AudioMelF0ExcitationDataset(
            rootdir, **audio, mel_query=query["feats"], mel_load_fn=reader("feats"),
            mel_length_threshold=mel_threshold, allow_cache=cache)
    if not flags["use_aux_input"]:
        if flags["use_local_condition"]:
            # the local features ride in the mel's place (upstream train.py:1219)
            return AudioMelDataset(rootdir, **audio, mel_query=local["local_query"],
                                   mel_load_fn=local["local_load_fn"], **glob,
                                   allow_cache=cache)
        return AudioDataset(rootdir, **audio, **glob, allow_cache=cache)
    return AudioMelDataset(
        rootdir, **audio, mel_query=query["feats"], mel_load_fn=reader("feats"),
        mel_length_threshold=mel_threshold, allow_cache=cache)


def main(argv=None) -> dict:
    """Run the training; returns {"steps": n, "history": [(steps, {metric:
    mean}), ...]} of the log and eval intervals."""
    parser = argparse.ArgumentParser(description="Train a vocoder (PyTorch/CUDA).")
    for split in ("train", "dev"):
        parser.add_argument(f"--{split}-wav-scp", default=None, type=str)
        parser.add_argument(f"--{split}-feats-scp", default=None, type=str)
        parser.add_argument(f"--{split}-segments", default=None, type=str)
        parser.add_argument(f"--{split}-dumpdir", default=None, type=str)
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--pretrain", default="", type=str)
    parser.add_argument("--resume", default="", type=str)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose > 1 else
        (logging.INFO if args.verbose > 0 else logging.WARN),
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
        stream=sys.stdout)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was given but no CUDA device is "
                           "available: pass --device cpu to train on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    config = load_config(args.config)
    config.update(vars(args))
    config["version"] = parallelwavegan_tpu_torch.__version__
    if config.get("distributed", False):
        raise _not_ported("distributed training")
    gen_type = config["generator_type"]
    if gen_type not in ("ParallelWaveGANGenerator", "MelGANGenerator",
                        "StyleMelGANGenerator", "HiFiGANGenerator"):
        raise _not_ported(f"training {gen_type}")
    for flag in ("use_pallas_tail", "use_pallas_mrf"):
        if config["generator_params"].get(flag, False):
            raise ValueError(f"generator_params.{flag} runs a kernel without a "
                             "backward: it is decode only; drop it to train")
    flags = feature_flags(config)

    os.makedirs(args.outdir, exist_ok=True)
    write_config(os.path.join(args.outdir, "config.yml"), config)
    for key, value in config.items():
        logging.info("%s = %s", key, value)

    seed = config.get("seed", 0)
    train_dataset = build_dataset(config, args, "train")
    logging.info("The number of training files = %d.", len(train_dataset))
    dev_dataset = None
    if args.dev_dumpdir is not None or args.dev_feats_scp is not None:
        dev_dataset = build_dataset(config, args, "dev")
        logging.info("The number of development files = %d.", len(dev_dataset))
    collater = Collater(
        batch_max_steps=config["batch_max_steps"], hop_size=config["hop_size"],
        aux_context_window=config["generator_params"].get("aux_context_window", 0),
        use_noise_input=flags["use_noise_input"],
        use_aux_input=flags["use_aux_input"], use_duration=flags["use_duration"],
        use_f0_and_excitation=flags["use_f0_and_excitation"],
        use_local_condition=flags["use_local_condition"],
        use_global_condition=flags["use_global_condition"],
        rng=np.random.default_rng(seed))
    workers = config.get("num_workers", 1)
    train_loader = DataLoader(train_dataset, collater, batch_size=config["batch_size"],
                              shuffle=True, seed=seed, num_workers=workers)
    dev_loader = None
    if dev_dataset is not None:
        dev_loader = DataLoader(dev_dataset, collater, batch_size=config["batch_size"],
                                shuffle=False, num_workers=workers)

    init = torch.Generator().manual_seed(seed)
    generator = get_model_class(gen_type)(
        **config["generator_params"], generator=init).to(device)
    discriminator = get_model_class(config["discriminator_type"])(
        **config["discriminator_params"], generator=init).to(device)
    for name, model in (("Generator", generator), ("Discriminator", discriminator)):
        logging.info("%s parameters: %.2fM", name,
                     sum(p.numel() for p in model.parameters()) / 1e6)
    criterion = build_criterion(config)
    opt_g = build_optimizer_from_config(config, "generator", generator.parameters())
    opt_d = build_optimizer_from_config(config, "discriminator",
                                        discriminator.parameters())
    trainer = Trainer(config, generator, discriminator, criterion, opt_g, opt_d,
                      train_loader, dev_loader, outdir=args.outdir, device=device)
    if args.pretrain:
        trainer.load_checkpoint(args.pretrain, load_only_params=True)
        logging.info("Successfully loaded parameters from %s.", args.pretrain)
    if args.resume:
        trainer.load_checkpoint(args.resume)
        train_loader.start_seq = trainer.steps
        logging.info("Successfully resumed from %s.", args.resume)
    try:
        trainer.run()
    except KeyboardInterrupt:
        logging.info("Interrupted @ %d steps (checkpoint written).", trainer.steps)
    return {"steps": trainer.steps, "history": trainer.history}


if __name__ == "__main__":
    main()
