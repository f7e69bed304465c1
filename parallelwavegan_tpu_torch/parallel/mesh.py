"""The port's device mesh for decode over several devices.

Counterpart of parallelwavegan_tpu/parallel/mesh.py:10-13 (``make_mesh``).
A JAX mesh is a named array of devices that one sharded program spans;
the port's is a plain list of ``torch.device`` that
``InferenceModel.inference_sharded`` and ``inference_batch(mesh=...)``
split their windows or rows over, entry by entry, as JAX splits the
leading axis over its ``data`` axis. An entry may repeat: ``["cpu"] * 8``
is eight shares on the CPU, as the JAX tests' eight forced host devices
are (tests/conftest.py:17-20), and ``[cuda:0] * 4`` runs the several
windows on one card. The shares of one device run as one batched
forward. ``batch_sharding``, ``shard_batch`` and ``shard_state`` belong
to distributed training and are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch


def canonical_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: a bare ``cuda`` is
    the current card, so that ``cuda`` and ``cuda:0`` compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices=None) -> list:
    """A 1-D mesh: every visible CUDA device, or the ``devices`` given
    (names or ``torch.device``s, repeats allowed). It never falls back to
    the CPU on its own: with no card and no ``devices`` it raises."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass the devices, "
                "e.g. make_mesh(['cpu'] * 8), to split over the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    mesh = [canonical_device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: the device list is empty")
    return mesh
