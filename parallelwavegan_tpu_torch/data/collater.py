"""Random fixed-length crop collater (counterpart of
parallelwavegan_tpu/data/collater.py:21-227: the mel-to-wave branch with
its duration and f0/excitation branches, and the VQ-VAE branch).

A random frame start per utterance; the audio slice [start*hop,
start*hop + batch_max_steps]; the mel slice with ``aux_context_window``
frames each side; noise z ~ N(0, 1) for generators that take it. Output
is numpy in the JAX package's layout: y (B, T, 1), c (B, T'+2w, C), z
(B, T, 1). Discrete-symbol features (unit ids, and the speaker id in
channel 1) come out as float32 c like a mel, which the generators cast
to ids. With ``use_duration`` each crop's runs of equal rows collapse
into (codes, durations) (:111-127, ``_unique_consecutive`` :219-227):
c (B, L, C) int32 padded with ``pad_value`` and ds (B, L) int32 padded
with zeros, L the most runs in the batch. Randomness comes from an
explicit ``numpy.random.Generator``, so the same seed gives the JAX
package's batches exactly.

With ``use_f0_and_excitation`` (U-Net HiFi-GAN, :133-141) items are
(audio, mel, f0, excitation), the f0 (T', ) and the excitation (T', hop)
per frame, both cropped as the mel is: the batch adds 'f0' (B, T', 1)
and 'excitation' (B, T' hop, 1). ``use_aux_input`` false is the VQ-VAE
wave-to-wave branch (:147-213): without local conditioning a random
audio crop per item longer than ``batch_max_steps`` ('y'), with its
global id ('global' (B,) int32, items (audio, id)) under
``use_global_condition``; with ``use_local_condition`` items are
(audio, local features[, id]), the local features cropped on the hop
grid ('local' (B, T', C), no context window) and the audio on the
samples under them. ``hop_size`` may be None there (a wave-to-wave
config without features).
"""

from __future__ import annotations

import numpy as np


class Collater:
    """Fixed-shape batches from variable-length (audio, mel, ...) items."""

    def __init__(self, batch_max_steps=20480, hop_size=256,
                 aux_context_window=2, use_noise_input=False,
                 use_f0_and_excitation=False, use_aux_input=True,
                 use_duration=False, use_global_condition=False,
                 use_local_condition=False, pad_value=0,
                 rng: np.random.Generator | None = None):
        if hop_size is not None:
            if batch_max_steps % hop_size != 0:
                batch_max_steps += -(batch_max_steps % hop_size)
            self.hop_size = hop_size
            self.batch_max_frames = batch_max_steps // hop_size
        self.batch_max_steps = batch_max_steps
        self.aux_context_window = aux_context_window
        self.use_noise_input = use_noise_input
        self.use_f0_and_excitation = use_f0_and_excitation
        self.use_aux_input = use_aux_input
        self.use_duration = use_duration
        self.use_global_condition = use_global_condition
        self.use_local_condition = use_local_condition
        self.pad_value = pad_value
        self.rng = rng or np.random.default_rng()
        if use_aux_input or use_local_condition:
            self.start_offset = aux_context_window
            self.end_offset = -(self.batch_max_frames + aux_context_window)
            self.mel_threshold = self.batch_max_frames + 2 * aux_context_window
        else:
            self.start_offset = 0
            self.end_offset = -batch_max_steps
            self.audio_threshold = batch_max_steps

    def __call__(self, batch, rng=None) -> dict:
        """Items -> {'y', 'c'[, 'z'][, 'f0', 'excitation']} of float32 numpy
        arrays (with ``use_duration`` {'y', 'c', 'ds'}, c and ds int32; the
        VQ branch {'y'[, 'local'][, 'global']}); ``rng`` overrides the
        instance generator for this call (the loader passes a per-batch
        child generator)."""
        rng = rng if rng is not None else self.rng
        if self.use_aux_input:
            return self._collate_mel2wav(batch, rng)
        return self._collate_vq(batch, rng)

    def _collate_mel2wav(self, batch, rng) -> dict:
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
        if self.use_duration:
            runs = [_unique_consecutive(c) for c in c_batch]
            longest = max(len(d) for _, d in runs)
            c_pad = np.full((len(runs), longest) + runs[0][0].shape[1:], self.pad_value,
                            dtype=np.int32)
            d_pad = np.zeros((len(runs), longest), dtype=np.int32)
            for i, (code, d) in enumerate(runs):
                c_pad[i, :len(code)] = code
                d_pad[i, :len(d)] = d
            return {"c": c_pad, "y": y_batch, "ds": d_pad}
        out = {"c": c_batch.astype(np.float32), "y": y_batch}
        if self.use_noise_input:
            out["z"] = rng.standard_normal(y_batch.shape).astype(np.float32)
        if self.use_f0_and_excitation:
            f_batch = np.stack([b[2][s:e] for b, s, e in zip(batch, c_starts, c_ends)])
            e_batch = np.stack([b[3][s:e] for b, s, e in zip(batch, c_starts, c_ends)])
            if f_batch.ndim == 2:
                f_batch = f_batch[..., None]
            out["f0"] = f_batch.astype(np.float32)
            out["excitation"] = e_batch.reshape(len(batch), -1, 1).astype(np.float32)
        return out

    def _collate_vq(self, batch, rng) -> dict:
        """The wave-to-wave crops (JAX :147-213)."""
        if self.use_local_condition:
            # strict >: an item of exactly the threshold leaves no start
            items = [self._adjust_length(b[0], b[1]) + tuple(b[2:]) for b in batch
                     if len(b[1]) > self.mel_threshold]
            if not items:
                raise ValueError("no utterance in the batch is longer than "
                                 f"mel_threshold={self.mel_threshold} frames")
            l_starts = np.array([rng.integers(self.start_offset, len(b[1]) + self.end_offset)
                                 for b in items])
            y_starts = l_starts * self.hop_size
            out = {"y": np.stack([b[0][s:s + self.batch_max_steps]
                                  for b, s in zip(items, y_starts)]
                                 ).astype(np.float32)[..., None],
                   "local": np.stack([b[1][s:s + self.batch_max_frames]
                                      for b, s in zip(items, l_starts)]).astype(np.float32)}
            if self.use_global_condition:
                out["global"] = _global_ids(b[2] for b in items)
            return out
        if self.use_global_condition:
            items = [b for b in batch if len(b[0]) > self.audio_threshold]
        else:
            items = [(b,) for b in batch if len(b) > self.audio_threshold]
        if not items:
            raise ValueError("no utterance in the batch is longer than "
                             f"audio_threshold={self.audio_threshold} samples")
        y_starts = np.array([rng.integers(self.start_offset, len(b[0]) + self.end_offset)
                             for b in items])
        out = {"y": np.stack([b[0][s:s + self.batch_max_steps]
                              for b, s in zip(items, y_starts)]).astype(np.float32)[..., None]}
        if self.use_global_condition:
            out["global"] = _global_ids(b[1] for b in items)
        return out

    def _adjust_length(self, x, c, *extras):
        """Edge-pad audio so len(x) == len(c) * hop (train.py:877-897)."""
        if len(x) < len(c) * self.hop_size:
            x = np.pad(x, (0, len(c) * self.hop_size - len(x)), mode="edge")
        if len(x) != len(c) * self.hop_size:
            raise ValueError(f"audio of {len(x)} samples for {len(c)} frames "
                             f"of hop {self.hop_size}")
        return (x, c) + extras


def _global_ids(ids) -> np.ndarray:
    """One int32 id per item, from ids stored as scalars or arrays of one."""
    return np.array([np.reshape(g, (1,))[0] for g in ids], dtype=np.int32)


def _unique_consecutive(c: np.ndarray):
    """Runs of equal rows of c (T, ...) -> (codes (runs, ...) int32, counts
    (runs,) int32), as ``torch.unique_consecutive(..., dim=0)``."""
    c = np.asarray(c)
    if c.ndim == 1:
        c = c[:, None]
    change = np.any(c[1:] != c[:-1], axis=tuple(range(1, c.ndim)))
    starts = np.flatnonzero(np.concatenate([[True], change]))
    counts = np.diff(np.concatenate([starts, [len(c)]]))
    return c[starts].astype(np.int32), counts.astype(np.int32)
