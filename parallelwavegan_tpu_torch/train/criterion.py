"""Criterion bundle built from a config (counterpart of
parallelwavegan_tpu/train/criterion.py).

The backward-compatible defaults of the JAX package (:64-68) apply: the
STFT loss is on and the sub-band STFT, mel, feature-matching and duration
losses are off when their keys are absent. The mel loss takes
``mel_loss_params`` or, without them, the config's feature keys
(:81-96). A generator with more than one output channel (Multi-band
MelGAN) gets ``pqmf``, a PQMF bank of that many sub-bands with the
config's ``pqmf_params`` (:106-114; ``build_pqmf``, whose filter
``bin/train.py`` writes into the run's ``config.yml`` so that decode
synthesises with it), and ``use_subband_stft_loss`` (which needs such a
generator, :76-80) a second multi-resolution STFT loss from
``subband_stft_loss_params``; ``train/step.py`` synthesises the full band
and analyses the target with ``pqmf``. ``use_duration_loss`` is
accepted and, as in JAX (:68, :140), decides nothing: the duration loss
is the train step's, for ``DiscreteSymbolDurationGenerator`` whatever the
flag says, as in JAX's step.py. A VQ-VAE has no ``pqmf`` (its output is
the full band) and, where it reads more than one channel, its encoder's
input is the PQMF analysis of the wave by ``encoder_pqmf``, of
``in_channels`` sub-bands (:115-120); ``lambda_commit`` (default 0.25)
weighs its commitment loss (:139).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from parallelwavegan_tpu_torch.losses import (
    DiscriminatorAdversarialLoss,
    FeatureMatchLoss,
    GeneratorAdversarialLoss,
    MelSpectrogramLoss,
    MultiResolutionSTFTLoss,
)
from parallelwavegan_tpu_torch.ops.pqmf import PQMF


@dataclass(frozen=True)
class Criterion:
    """The loss callables and lambda weights of one config."""

    gen_adv: GeneratorAdversarialLoss
    dis_adv: DiscriminatorAdversarialLoss
    stft: MultiResolutionSTFTLoss | None
    mel: MelSpectrogramLoss | None
    feat_match: FeatureMatchLoss | None
    lambda_aux: float
    lambda_adv: float
    lambda_feat_match: float
    sub_stft: MultiResolutionSTFTLoss | None = None
    pqmf: PQMF | None = None
    lambda_commit: float = 0.25
    encoder_pqmf: PQMF | None = None


def build_pqmf(config: dict) -> PQMF | None:
    """The PQMF bank of a generator of more than one output channel, from
    the config's ``pqmf_params`` (defaults where absent); None otherwise,
    and for a VQ-VAE."""
    subbands = config["generator_params"].get("out_channels", 1)
    if subbands <= 1 or config.get("generator_type") == "VQVAE":
        return None
    return PQMF(subbands=subbands, **config.get("pqmf_params", {}))


def build_criterion(config: dict) -> Criterion:
    """The criterion of ``config``; sets the JAX package's defaults of the
    ``use_*_loss`` keys in ``config``."""
    config.setdefault("use_stft_loss", True)
    config.setdefault("use_subband_stft_loss", False)
    config.setdefault("use_mel_loss", False)
    config.setdefault("use_feat_match_loss", False)
    config.setdefault("use_duration_loss", False)
    subbands = config["generator_params"].get("out_channels", 1)
    stft = sub_stft = None
    if config["use_stft_loss"]:
        params = dict(config.get("stft_loss_params", {}))
        params.pop("window", None)
        stft = MultiResolutionSTFTLoss(**params)
    if config["use_subband_stft_loss"]:
        if subbands <= 1:
            raise ValueError("use_subband_stft_loss needs a generator with more than "
                             f"one output channel, got out_channels {subbands}")
        params = dict(config.get("subband_stft_loss_params", {}))
        params.pop("window", None)
        sub_stft = MultiResolutionSTFTLoss(**params)
    pqmf = build_pqmf(config)
    mel = None
    if config["use_mel_loss"]:
        mel = MelSpectrogramLoss(**(config.get("mel_loss_params") or {
            "fs": config["sampling_rate"], "fft_size": config["fft_size"],
            "hop_size": config["hop_size"], "win_length": config["win_length"],
            "window": config["window"], "num_mels": config["num_mels"],
            "fmin": config["fmin"], "fmax": config["fmax"]}))
    feat_match = None
    if config["use_feat_match_loss"]:
        feat_match = FeatureMatchLoss(**config.get("feat_match_loss_params", {}))
    encoder_pqmf = None
    in_channels = config["generator_params"].get("in_channels", 1)
    if config.get("generator_type") == "VQVAE" and in_channels > 1:
        encoder_pqmf = PQMF(subbands=in_channels, **config.get("pqmf_params", {}))
    if stft is None and sub_stft is None and mel is None and (
            config.get("generator_type") != "VQVAE"):
        logging.warning("no auxiliary (stft/mel) loss is enabled")
    return Criterion(
        gen_adv=GeneratorAdversarialLoss(
            **config.get("generator_adv_loss_params", {})),
        dis_adv=DiscriminatorAdversarialLoss(
            **config.get("discriminator_adv_loss_params", {})),
        stft=stft,
        mel=mel,
        feat_match=feat_match,
        lambda_aux=config.get("lambda_aux", 1.0),
        lambda_adv=config.get("lambda_adv", 1.0),
        lambda_feat_match=config.get("lambda_feat_match", 1.0),
        sub_stft=sub_stft,
        pqmf=pqmf,
        lambda_commit=config.get("lambda_commit", 0.25),
        encoder_pqmf=encoder_pqmf,
    )
