"""Random fixed-length crop collater (counterpart of
parallelwavegan_tpu/data/collater.py:21-144, the mel-to-wave branch).

A random frame start per utterance; the audio slice [start*hop,
start*hop + batch_max_steps]; the mel slice with ``aux_context_window``
frames each side; noise z ~ N(0, 1) for generators that take it. Output
is numpy in the JAX package's layout: y (B, T, 1), c (B, T'+2w, C), z
(B, T, 1). Randomness comes from an explicit ``numpy.random.Generator``,
so the same seed gives the JAX package's batches exactly. The duration,
f0/excitation and VQ branches are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np


class Collater:
    """Fixed-shape batches from variable-length (audio, mel) items."""

    def __init__(self, batch_max_steps=20480, hop_size=256,
                 aux_context_window=2, use_noise_input=False,
                 use_f0_and_excitation=False, use_aux_input=True,
                 use_duration=False, use_global_condition=False,
                 use_local_condition=False, pad_value=0,
                 rng: np.random.Generator | None = None):
        for flag, what in ((use_f0_and_excitation, "f0/excitation input"),
                           (not use_aux_input, "the VQ (wave-to-wave) collater"),
                           (use_duration, "duration input"),
                           (use_global_condition, "global conditioning"),
                           (use_local_condition, "local conditioning")):
            if flag:
                raise NotImplementedError(
                    f"{what} is not ported to parallelwavegan_tpu_torch yet; "
                    "see ROADMAP.md")
        if batch_max_steps % hop_size != 0:
            batch_max_steps += -(batch_max_steps % hop_size)
        self.hop_size = hop_size
        self.batch_max_frames = batch_max_steps // hop_size
        self.batch_max_steps = batch_max_steps
        self.aux_context_window = aux_context_window
        self.use_noise_input = use_noise_input
        self.pad_value = pad_value
        self.rng = rng or np.random.default_rng()
        self.start_offset = aux_context_window
        self.end_offset = -(self.batch_max_frames + aux_context_window)
        self.mel_threshold = self.batch_max_frames + 2 * aux_context_window

    def __call__(self, batch, rng=None) -> dict:
        """Items -> {'y', 'c'[, 'z']} of float32 numpy arrays; ``rng``
        overrides the instance generator for this call (the loader passes a
        per-batch child generator)."""
        rng = rng if rng is not None else self.rng
        batch = [self._adjust_length(*b) for b in batch
                 if len(b[1]) > self.mel_threshold]
        if not batch:
            raise ValueError(
                "every utterance in the batch is shorter than "
                f"mel_threshold={self.mel_threshold} frames")
        xs = [b[0] for b in batch]
        cs = [b[1] for b in batch]
        start_frames = np.array([
            rng.integers(self.start_offset, len(c) + self.end_offset) for c in cs])
        x_starts = start_frames * self.hop_size
        c_starts = start_frames - self.aux_context_window
        c_ends = start_frames + self.batch_max_frames + self.aux_context_window
        y_batch = np.stack([x[s:s + self.batch_max_steps]
                            for x, s in zip(xs, x_starts)]).astype(np.float32)[..., None]
        c_batch = np.stack([c[s:e] for c, s, e in zip(cs, c_starts, c_ends)])
        out = {"c": c_batch.astype(np.float32), "y": y_batch}
        if self.use_noise_input:
            out["z"] = rng.standard_normal(y_batch.shape).astype(np.float32)
        return out

    def _adjust_length(self, x, c):
        """Edge-pad audio so len(x) == len(c) * hop (train.py:877-897)."""
        if len(x) < len(c) * self.hop_size:
            x = np.pad(x, (0, len(c) * self.hop_size - len(x)), mode="edge")
        if len(x) != len(c) * self.hop_size:
            raise ValueError(f"audio of {len(x)} samples for {len(c)} frames "
                             f"of hop {self.hop_size}")
        return x, c
