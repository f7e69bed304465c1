"""Criterion bundle built from a config (counterpart of
parallelwavegan_tpu/train/criterion.py).

The backward-compatible defaults of the JAX package (:64-68) apply: the
STFT loss is on and the sub-band STFT, mel, feature-matching and duration
losses are off when their keys are absent. Those four, and PQMF in the
criterion (a generator with more than one output channel), are not ported
yet and raise ``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from parallelwavegan_tpu_torch.losses import (
    DiscriminatorAdversarialLoss,
    GeneratorAdversarialLoss,
    MultiResolutionSTFTLoss,
)


@dataclass(frozen=True)
class Criterion:
    """The loss callables and lambda weights of one config."""

    gen_adv: GeneratorAdversarialLoss
    dis_adv: DiscriminatorAdversarialLoss
    stft: MultiResolutionSTFTLoss | None
    lambda_aux: float
    lambda_adv: float


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to parallelwavegan_tpu_torch yet; see ROADMAP.md")


def build_criterion(config: dict) -> Criterion:
    """The criterion of ``config``; sets the JAX package's defaults of the
    ``use_*_loss`` keys in ``config``."""
    config.setdefault("use_stft_loss", True)
    config.setdefault("use_subband_stft_loss", False)
    config.setdefault("use_mel_loss", False)
    config.setdefault("use_feat_match_loss", False)
    config.setdefault("use_duration_loss", False)
    for key, what in (("use_subband_stft_loss", "the sub-band STFT loss"),
                      ("use_mel_loss", "the mel loss"),
                      ("use_feat_match_loss", "the feature-matching loss"),
                      ("use_duration_loss", "the duration loss")):
        if config[key]:
            raise _not_ported(what)
    if config["generator_params"].get("out_channels", 1) > 1:
        raise _not_ported("PQMF in the criterion (multi-band generators)")
    stft = None
    if config["use_stft_loss"]:
        params = dict(config.get("stft_loss_params", {}))
        params.pop("window", None)
        stft = MultiResolutionSTFTLoss(**params)
    else:
        logging.warning("no auxiliary (stft/mel) loss is enabled")
    return Criterion(
        gen_adv=GeneratorAdversarialLoss(
            **config.get("generator_adv_loss_params", {})),
        dis_adv=DiscriminatorAdversarialLoss(
            **config.get("discriminator_adv_loss_params", {})),
        stft=stft,
        lambda_aux=config.get("lambda_aux", 1.0),
        lambda_adv=config.get("lambda_adv", 1.0),
    )
