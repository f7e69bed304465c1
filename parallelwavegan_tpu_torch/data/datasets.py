"""Mel dataset for decode (counterpart of parallelwavegan_tpu/data/datasets.py:276-330).

Items are (utterance id, mel) with the mel as a numpy array; the id is the
file name without its extension, as in the JAX package.
"""

from __future__ import annotations

import os

from parallelwavegan_tpu_torch.utils.io import find_files, read_hdf5


def _default_mel_load(path):
    return read_hdf5(path, "feats")


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
