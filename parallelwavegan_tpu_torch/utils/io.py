"""File IO (counterpart of parallelwavegan_tpu/utils/io.py:20-205).

HDF5 datasets, kaldi-style scp loaders over hdf5 and npy files, WAV IO
and the directory-or-``wav.scp`` index of the evaluation tools. h5py is
imported only when an ``.h5`` file is read or written; WAV files are read
and written with scipy, as in the JAX package.
"""

from __future__ import annotations

import fnmatch
import logging
import os

import numpy as np
from scipy.io import wavfile


def find_files(root_dir: str, query: str = "*.wav", include_root_dir: bool = True):
    """Recursively find files matching ``query`` under ``root_dir``."""
    files = []
    for root, _, filenames in os.walk(root_dir, followlinks=True):
        for filename in fnmatch.filter(filenames, query):
            files.append(os.path.join(root, filename))
    if not include_root_dir:
        files = [f.replace(root_dir + "/", "") for f in files]
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


def write_hdf5(hdf5_name: str, hdf5_path: str, write_data, is_overwrite: bool = True):
    """Write one dataset to an hdf5 file (creating parents as needed)."""
    import h5py

    write_data = np.array(write_data)
    folder_name, _ = os.path.split(hdf5_name)
    if folder_name and not os.path.exists(folder_name):
        os.makedirs(folder_name, exist_ok=True)
    mode = "r+" if os.path.exists(hdf5_name) else "w"
    with h5py.File(hdf5_name, mode) as f:
        if hdf5_path in f:
            if not is_overwrite:
                raise RuntimeError(
                    f"Dataset {hdf5_path} already exists in {hdf5_name}; "
                    "set is_overwrite=True to replace it.")
            logging.debug("recreating dataset %s in %s", hdf5_path, hdf5_name)
            del f[hdf5_path]
        f.create_dataset(hdf5_path, data=write_data)
        f.flush()


class ScpLoader:
    """Dict-like view of a kaldi-style scp (``key value`` lines); a subclass
    reads one entry's value in ``__getitem__``."""

    def __init__(self, feats_scp: str):
        self.data = {}
        with open(feats_scp) as f:
            for line in f:
                if not line.strip():
                    continue
                key, value = line.strip().split(maxsplit=1)
                self.data[key] = value

    def get_path(self, key):
        return self.data[key]

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        return iter(self.data)

    def keys(self):
        return self.data.keys()

    def values(self):
        for key in self.keys():
            yield self[key]


class HDF5ScpLoader(ScpLoader):
    """Loader for a kaldi-style scp pointing at hdf5 files: ``key path.h5``,
    ``key path.h5:feats`` and the ``key path.h5:feats_1,feats_2`` concat
    form (1-D datasets joined as columns)."""

    def __init__(self, feats_scp: str, default_hdf5_path: str = "feats"):
        super().__init__(feats_scp)
        self.default_hdf5_path = default_hdf5_path

    def __getitem__(self, key):
        p = self.data[key]
        if ":" not in p:
            return read_hdf5(p, self.default_hdf5_path)
        fname, dsets = p.split(":")
        names = dsets.split(",")
        if len(names) == 1:
            return read_hdf5(fname, names[0])
        feats = [read_hdf5(fname, n) for n in names]
        return np.concatenate(
            [f if f.ndim != 1 else f.reshape(-1, 1) for f in feats], 1)


class NpyScpLoader(ScpLoader):
    """Loader for a kaldi-style scp pointing at npy files."""

    def __getitem__(self, key):
        return np.load(self.data[key])


def read_wav(path: str) -> tuple[int, np.ndarray]:
    """Read a WAV file -> (fs, float32 samples in [-1, 1))."""
    fs, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return fs, data


def write_wav(path: str, fs: int, data: np.ndarray):
    """Write a float waveform as 16-bit PCM (upstream decode convention)."""
    data = np.clip(np.asarray(data, dtype=np.float64), -1.0, 1.0)
    wavfile.write(path, fs, (data * 32767.0).astype(np.int16))


def wav_index(path_or_dir: str, pattern: str = "*.wav") -> dict:
    """{utt_id: (path, start_sec, end_sec)} from a directory or a kaldi-style
    ``wav.scp`` (with a sibling ``segments`` file where one exists); start
    and end are None for a whole file. Piped entries are refused."""
    if os.path.isdir(path_or_dir):
        return {os.path.splitext(os.path.basename(f))[0]: (f, None, None)
                for f in find_files(path_or_dir, pattern)}
    recs = {}
    with open(path_or_dir) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            if len(parts) > 2:
                raise ValueError(f"pipe-style wav.scp entries are not supported: {line!r}")
            recs[parts[0]] = parts[1]
    seg_path = os.path.join(os.path.dirname(path_or_dir), "segments")
    if not os.path.exists(seg_path):
        return {utt: (p, None, None) for utt, p in recs.items()}
    index = {}
    with open(seg_path) as f:
        for line in f:
            utt, rec, start, end = line.split()
            if rec not in recs:
                logging.warning("segments entry %s references unknown recording %s",
                                utt, rec)
                continue
            index[utt] = (recs[rec], float(start), float(end))
    return index


def read_wav_entry(entry: tuple) -> tuple:
    """Read a ``wav_index`` entry -> (fs, float32 samples)."""
    path, start, end = entry
    fs, data = read_wav(path)
    if start is not None:
        data = data[int(start * fs): int(end * fs)]
    return fs, data
