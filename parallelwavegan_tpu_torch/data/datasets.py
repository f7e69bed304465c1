"""Datasets over dumped features (counterpart of
parallelwavegan_tpu/data/datasets.py).

``MelDataset`` (:276-330) gives (utterance id, mel) for decode, the id
being the file name without its extension. ``AudioMelDataset`` (:72-145)
gives (audio, mel) pairs for training, from ``*.h5`` files (h5py is
imported only when one is read) or ``*-wave.npy`` / ``*-feats.npy``
pairs, with the mel length filter and the in-memory cache that
``bin/train.py`` sets. Its audio length filter, utterance ids and local
and global conditioning are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import logging
import os

from parallelwavegan_tpu_torch.utils.io import find_files, read_hdf5


def _default_mel_load(path):
    return read_hdf5(path, "feats")


def _default_audio_load(path):
    return read_hdf5(path, "wave")


class MelDataset:
    """Mel features of a dump directory (``*.h5`` or ``*-feats.npy``)."""

    def __init__(self, root_dir, mel_query="*.h5", mel_load_fn=_default_mel_load):
        mel_files = sorted(find_files(root_dir, mel_query))
        if not mel_files:
            raise FileNotFoundError(f"No mel files found in {root_dir}.")
        self.mel_files = mel_files
        self.mel_load_fn = mel_load_fn
        self.utt_ids = [os.path.splitext(os.path.basename(f))[0] for f in mel_files]

    def __len__(self):
        return len(self.mel_files)

    def __getitem__(self, idx):
        return self.utt_ids[idx], self.mel_load_fn(self.mel_files[idx])


class AudioMelDataset:
    """(audio, mel) pairs of a dump directory, optionally cached in memory."""

    def __init__(self, root_dir, audio_query="*.h5",
                 audio_load_fn=_default_audio_load, mel_query="*.h5",
                 mel_load_fn=_default_mel_load, mel_length_threshold=None,
                 allow_cache=False):
        audio_files = sorted(find_files(root_dir, audio_query))
        mel_files = sorted(find_files(root_dir, mel_query))
        if len(audio_files) != len(mel_files):
            raise ValueError(f"audio/mel file counts differ ({len(audio_files)} "
                             f"vs {len(mel_files)}).")
        if mel_length_threshold is not None:
            keep = [i for i, f in enumerate(mel_files)
                    if mel_load_fn(f).shape[0] > mel_length_threshold]
            if len(keep) != len(mel_files):
                logging.warning("Some files are filtered by mel length threshold "
                                "(%d -> %d).", len(mel_files), len(keep))
            audio_files = [audio_files[i] for i in keep]
            mel_files = [mel_files[i] for i in keep]
        if not audio_files:
            raise FileNotFoundError(f"No audio files found in {root_dir}.")
        self.audio_files = audio_files
        self.mel_files = mel_files
        self.audio_load_fn = audio_load_fn
        self.mel_load_fn = mel_load_fn
        self.allow_cache = allow_cache
        self.caches = [None] * len(audio_files) if allow_cache else []

    def __len__(self):
        return len(self.audio_files)

    def __getitem__(self, idx):
        if self.allow_cache and self.caches[idx] is not None:
            return self.caches[idx]
        item = (self.audio_load_fn(self.audio_files[idx]),
                self.mel_load_fn(self.mel_files[idx]))
        if self.allow_cache:
            self.caches[idx] = item
        return item
