"""Generator checkpoints in upstream's ``.pkl`` layout.

``torch.save({"model": {"generator": state_dict}, "steps": n})``, the
layout upstream's trainer writes and that
parallelwavegan_tpu/convert/torch_checkpoint.py:33 reads, so a checkpoint
written here decodes through the JAX package's ``load_model`` as well.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, generator_state_dict: dict, steps: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {k: v.detach().cpu() for k, v in generator_state_dict.items()}
    torch.save({"model": {"generator": state}, "steps": int(steps)}, path)


def load_generator_state_dict(path: str) -> dict:
    """The generator's state dict from an upstream ``.pkl`` checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["model"]["generator"]
