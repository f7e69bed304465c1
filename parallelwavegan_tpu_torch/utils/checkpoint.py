"""Checkpoints in upstream's ``.pkl`` layout.

``torch.save({"model": {"generator": state_dict, ...}, "steps": n, ...})``,
the layout upstream's trainer writes and that
parallelwavegan_tpu/convert/torch_checkpoint.py:33 reads, so a checkpoint
written here decodes through the JAX package's ``load_model`` as well.
A training checkpoint (counterpart of parallelwavegan_tpu/utils/
checkpoint.py, ROADMAP M10) also holds ``model.discriminator``,
``optimizer.{generator,discriminator}`` (each parameter's moments, and
AMSGrad's ``nu_max``), ``scheduler.{generator,
discriminator}`` (the update count each schedule is at) and ``epochs``.
The state dicts hold the buffers too, so a spectral norm's power-iteration
vectors (``weight_u``, ``weight_v``) are saved and restored with the
weights, bit for bit.
"""

from __future__ import annotations

import os

import torch


def _cpu(state_dict: dict) -> dict:
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def _write(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, generator_state_dict: dict, steps: int = 0) -> None:
    """A generator-only checkpoint (what decode reads)."""
    _write(path, {"model": {"generator": _cpu(generator_state_dict)},
                  "steps": int(steps)})


def load_generator_state_dict(path: str) -> dict:
    """The generator's state dict from an upstream ``.pkl`` checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["model"]["generator"]


def save_training_checkpoint(path: str, generator, discriminator, opt_g, opt_d,
                             steps: int, epochs: int = 0) -> None:
    """The whole training state, written to a temporary file and renamed."""
    _write(path, {
        "model": {"generator": _cpu(generator.state_dict()),
                  "discriminator": _cpu(discriminator.state_dict())},
        "optimizer": {"generator": opt_g.state_dict(),
                      "discriminator": opt_d.state_dict()},
        "scheduler": {"generator": {"last_epoch": opt_g.step_count},
                      "discriminator": {"last_epoch": opt_d.step_count}},
        "steps": int(steps),
        "epochs": int(epochs),
    })


def load_training_checkpoint(path: str, generator, discriminator, opt_g, opt_d,
                             load_only_params: bool = False) -> tuple[int, int]:
    """Restore a training checkpoint into the modules and optimizers ->
    (steps, epochs). ``load_only_params`` (``--pretrain``) restores the
    model weights only and keeps fresh optimizers and step 0."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    generator.load_state_dict(ckpt["model"]["generator"])
    discriminator.load_state_dict(ckpt["model"]["discriminator"])
    if load_only_params:
        return 0, 0
    opt_g.load_state_dict(ckpt["optimizer"]["generator"])
    opt_d.load_state_dict(ckpt["optimizer"]["discriminator"])
    return int(ckpt["steps"]), int(ckpt.get("epochs", 0))
