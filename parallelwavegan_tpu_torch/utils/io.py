"""File IO for decode (counterpart of parallelwavegan_tpu/utils/io.py).

h5py is imported only when an ``.h5`` file is read; WAV files are written
with scipy, as in the JAX package.
"""

from __future__ import annotations

import fnmatch
import os

import numpy as np
from scipy.io import wavfile


def find_files(root_dir: str, query: str = "*.wav"):
    """Recursively find files matching ``query`` under ``root_dir``."""
    files = []
    for root, _, filenames in os.walk(root_dir, followlinks=True):
        for filename in fnmatch.filter(filenames, query):
            files.append(os.path.join(root, filename))
    return files


def read_hdf5(hdf5_name: str, hdf5_path: str):
    """Read one dataset from an hdf5 file."""
    import h5py

    if not os.path.exists(hdf5_name):
        raise FileNotFoundError(f"There is no such a hdf5 file ({hdf5_name}).")
    with h5py.File(hdf5_name, "r") as f:
        if hdf5_path not in f:
            raise KeyError(f"There is no such a data in hdf5 file. ({hdf5_path})")
        return f[hdf5_path][()]


def write_wav(path: str, fs: int, data: np.ndarray):
    """Write a float waveform as 16-bit PCM (upstream decode convention)."""
    data = np.clip(np.asarray(data, dtype=np.float64), -1.0, 1.0)
    wavfile.write(path, fs, (data * 32767.0).astype(np.int16))
