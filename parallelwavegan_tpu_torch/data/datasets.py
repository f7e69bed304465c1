"""Datasets over dumped features and kaldi-style scp files (counterpart of
parallelwavegan_tpu/data/datasets.py:31-554).

Dump directories: ``AudioMelDataset`` (audio, mel and the optional local
and global conditioning), ``AudioMelF0ExcitationDataset``,
``AudioDataset``, ``MelDataset`` and ``MelF0ExcitationDataset``, each
with the JAX package's queries, load functions, length filters, utterance
ids (the file name without its extension) and in-memory cache. Items are
plain numpy arrays for the collater. h5py is imported only when an
``.h5`` file is read.

scp files: ``AudioMelSCPDataset``, ``AudioSCPDataset`` and
``MelSCPDataset`` over a ``wav.scp`` (with a kaldi ``segments`` file;
piped entries are refused) and a ``feats.scp`` whose values are binary
ark entries (``path.ark:offset``, read by ``utils/kaldi_ark.py``), hdf5
files (``path.h5`` or ``path.h5:a,b``) or npy files.
"""

from __future__ import annotations

import logging
import os

from parallelwavegan_tpu_torch.utils.io import (
    HDF5ScpLoader,
    NpyScpLoader,
    find_files,
    read_hdf5,
    read_wav,
)


def _default_audio_load(x):
    return read_hdf5(x, "wave")


def _default_mel_load(x):
    return read_hdf5(x, "feats")


def _default_f0_load(x):
    return read_hdf5(x, "f0")


def _default_excitation_load(x):
    return read_hdf5(x, "excitation")


def _filter_by_length(lengths, threshold, *file_lists):
    """Each list kept at the indices whose length exceeds ``threshold``."""
    idxs = [i for i, n in enumerate(lengths) if n > threshold]
    if len(idxs) != len(lengths):
        logging.warning("Some files are filtered by length threshold (%d -> %d).",
                        len(lengths), len(idxs))
    return [[fl[i] for i in idxs] if fl is not None else None for fl in file_lists]


class _CachedDataset:
    """``__len__`` and ``__getitem__`` with an optional in-memory cache."""

    def __init__(self, n: int, allow_cache: bool):
        self.allow_cache = allow_cache
        self.caches: list = [None] * n if allow_cache else []
        self._n = n

    def __len__(self):
        return self._n

    def _cached(self, idx, build):
        if self.allow_cache and self.caches[idx] is not None:
            return self.caches[idx]
        item = build()
        if self.allow_cache:
            self.caches[idx] = item
        return item


class _DumpDataset(_CachedDataset):
    """Items read from parallel sorted file lists of one dump directory.

    ``streams`` is [(name, query, load_fn)], a stream with a query of None
    left out; the first stream is the one that must have files and names
    the utterances. ``thresholds`` is [(stream name, threshold)], applied
    in order. An item is the tuple of the streams' arrays, the utterance id
    in front with ``return_utt_id``; with ``bare_single`` a lone array is
    given bare (``AudioDataset``, ``MelDataset``)."""

    def __init__(self, root_dir, streams, thresholds, return_utt_id, allow_cache,
                 bare_single=False, same_count=()):
        streams = [(n, q, fn) for n, q, fn in streams if q is not None]
        files = {n: sorted(find_files(root_dir, q)) for n, q, _ in streams}
        first = streams[0][0]
        for name in same_count:
            if len(files[name]) != len(files[first]):
                raise ValueError(f"{first}/{name} file counts differ "
                                 f"({len(files[first])} vs {len(files[name])}).")
        loaders = {n: fn for n, _, fn in streams}
        names = [n for n, _, _ in streams]
        for name, threshold in thresholds:
            if threshold is None:
                continue
            lengths = [loaders[name](f).shape[0] for f in files[name]]
            kept = _filter_by_length(lengths, threshold, *(files[n] for n in names))
            files = dict(zip(names, kept))
        if not files[first]:
            raise FileNotFoundError(f"No {first} files found in {root_dir}.")
        self.files = files
        self.load_fns = loaders
        self.utt_ids = [os.path.splitext(os.path.basename(f))[0] for f in files[first]]
        self.return_utt_id = return_utt_id
        self.bare_single = bare_single
        super().__init__(len(files[first]), allow_cache)

    def __getitem__(self, idx):
        def build():
            items = tuple(fn(self.files[n][idx]) for n, fn in self.load_fns.items())
            if self.return_utt_id:
                return (self.utt_ids[idx],) + items
            if self.bare_single and len(items) == 1:
                return items[0]
            return items

        return self._cached(idx, build)


class AudioMelDataset(_DumpDataset):
    """Audio and mel (and optional local and global conditioning) items."""

    def __init__(self, root_dir, audio_query="*.h5", audio_load_fn=_default_audio_load,
                 mel_query="*.h5", mel_load_fn=_default_mel_load, local_query=None,
                 local_load_fn=None, global_query=None, global_load_fn=None,
                 audio_length_threshold=None, mel_length_threshold=None,
                 return_utt_id=False, allow_cache=False):
        super().__init__(
            root_dir, [("audio", audio_query, audio_load_fn),
                       ("mel", mel_query, mel_load_fn),
                       ("local", local_query, local_load_fn),
                       ("global", global_query, global_load_fn)],
            [("audio", audio_length_threshold), ("mel", mel_length_threshold)],
            return_utt_id, allow_cache, same_count=("mel",))


class AudioMelF0ExcitationDataset(_DumpDataset):
    """Audio, mel, f0 and excitation items (the UHiFiGAN path)."""

    def __init__(self, root_dir, audio_query="*.h5", audio_load_fn=_default_audio_load,
                 mel_query="*.h5", mel_load_fn=_default_mel_load, f0_query="*.h5",
                 f0_load_fn=_default_f0_load, excitation_query="*.h5",
                 excitation_load_fn=_default_excitation_load,
                 audio_length_threshold=None, mel_length_threshold=None,
                 return_utt_id=False, allow_cache=False):
        super().__init__(
            root_dir, [("audio", audio_query, audio_load_fn),
                       ("mel", mel_query, mel_load_fn),
                       ("f0", f0_query, f0_load_fn),
                       ("excitation", excitation_query, excitation_load_fn)],
            [("audio", audio_length_threshold), ("mel", mel_length_threshold)],
            return_utt_id, allow_cache, same_count=("mel",))


class AudioDataset(_DumpDataset):
    """Audio (and optional local and global conditioning) items: the VQ-VAE
    wave-to-wave path."""

    def __init__(self, root_dir, audio_query="*.h5", audio_load_fn=_default_audio_load,
                 local_query=None, local_load_fn=None, global_query=None,
                 global_load_fn=None, audio_length_threshold=None,
                 return_utt_id=False, allow_cache=False):
        super().__init__(
            root_dir, [("audio", audio_query, audio_load_fn),
                       ("local", local_query, local_load_fn),
                       ("global", global_query, global_load_fn)],
            [("audio", audio_length_threshold)], return_utt_id, allow_cache,
            bare_single=True)


class MelDataset(_DumpDataset):
    """Mel (and optional local and global conditioning) items: decode."""

    def __init__(self, root_dir, mel_query="*.h5", mel_load_fn=_default_mel_load,
                 local_query=None, local_load_fn=None, global_query=None,
                 global_load_fn=None, mel_length_threshold=None,
                 return_utt_id=False, allow_cache=False):
        super().__init__(
            root_dir, [("mel", mel_query, mel_load_fn),
                       ("local", local_query, local_load_fn),
                       ("global", global_query, global_load_fn)],
            [("mel", mel_length_threshold)], return_utt_id, allow_cache,
            bare_single=True)


class MelF0ExcitationDataset(_DumpDataset):
    """Mel, f0 and excitation items (UHiFiGAN decode)."""

    def __init__(self, root_dir, mel_query="*.h5", mel_load_fn=_default_mel_load,
                 f0_query="*.h5", f0_load_fn=_default_f0_load,
                 excitation_query="*.h5", excitation_load_fn=_default_excitation_load,
                 mel_length_threshold=None, return_utt_id=False, allow_cache=False):
        super().__init__(
            root_dir, [("mel", mel_query, mel_load_fn),
                       ("f0", f0_query, f0_load_fn),
                       ("excitation", excitation_query, excitation_load_fn)],
            [("mel", mel_length_threshold)], return_utt_id, allow_cache)


# kaldi-style scp datasets


def _get_feats_scp_loader(feats_scp):
    """The loader for a feats.scp, chosen by its first value: a binary ark
    (``path.ark:offset``), hdf5 (``path.h5`` or ``path.h5:names``) or npy."""
    with open(feats_scp) as f:
        value = f.readlines()[0].replace("\n", "").split()[1]
    if ":" in value:
        value_ = value.split(":")[0]
        if value_.endswith(".ark"):
            from parallelwavegan_tpu_torch.utils.kaldi_ark import ArkScpLoader

            return ArkScpLoader(feats_scp)
        if value_.endswith(".h5"):
            return HDF5ScpLoader(feats_scp)
        raise ValueError(f"Not supported feats.scp type ({value}).")
    if value.endswith(".h5"):
        return HDF5ScpLoader(feats_scp)
    if value.endswith(".npy"):
        return NpyScpLoader(feats_scp)
    raise ValueError(f"Not supported feats.scp type ({value}).")


class _WavScpLoader:
    """wav.scp (with an optional kaldi ``segments`` file) -> (fs, float
    waveform); a segment's end below 0 means the end of its recording."""

    def __init__(self, wav_scp, segments=None):
        self.data = {}
        with open(wav_scp) as f:
            for line in f:
                if not line.strip():
                    continue
                key, value = line.strip().split(maxsplit=1)
                if value.endswith("|") or value.startswith("|"):
                    raise ValueError("piped wav.scp entries are not supported")
                self.data[key] = value
        self.segments = None
        if segments is not None:
            self.segments = {}
            with open(segments) as f:
                for line in f:
                    if not line.strip():
                        continue
                    utt, rec, start, end = line.strip().split()
                    self.segments[utt] = (rec, float(start), float(end))

    def keys(self):
        return (self.segments or self.data).keys()

    def __len__(self):
        return len(self.segments or self.data)

    def __getitem__(self, key):
        if self.segments is not None:
            rec, start, end = self.segments[key]
            fs, wav = read_wav(self.data[rec])
            s = int(start * fs)
            e = len(wav) if end < 0 else int(end * fs)
            return fs, wav[s:e]
        return read_wav(self.data[key])


class AudioMelSCPDataset(_CachedDataset):
    """(audio, mel) items of a wav.scp and a feats.scp, over the keys that
    both hold, in the wav.scp's (or the segments') order."""

    def __init__(self, wav_scp, feats_scp, segments=None, audio_length_threshold=None,
                 mel_length_threshold=None, return_utt_id=False,
                 return_sampling_rate=False, allow_cache=False):
        self.audio_loader = _WavScpLoader(wav_scp, segments)
        self.mel_loader = _get_feats_scp_loader(feats_scp)
        utt_ids = [k for k in self.audio_loader.keys() if k in self.mel_loader.keys()]
        if audio_length_threshold is not None:
            lengths = [self.audio_loader[k][1].shape[0] for k in utt_ids]
            (utt_ids,) = _filter_by_length(lengths, audio_length_threshold, utt_ids)
        if mel_length_threshold is not None:
            lengths = [self.mel_loader[k].shape[0] for k in utt_ids]
            (utt_ids,) = _filter_by_length(lengths, mel_length_threshold, utt_ids)
        if not utt_ids:
            raise FileNotFoundError(f"No utterances found in {wav_scp}.")
        self.utt_ids = utt_ids
        self.return_utt_id = return_utt_id
        self.return_sampling_rate = return_sampling_rate
        super().__init__(len(utt_ids), allow_cache)

    def __getitem__(self, idx):
        def build():
            utt_id = self.utt_ids[idx]
            fs, audio = self.audio_loader[utt_id]
            mel = self.mel_loader[utt_id]
            if self.return_sampling_rate:
                audio = (audio, fs)
            if self.return_utt_id:
                return utt_id, audio, mel
            return audio, mel

        return self._cached(idx, build)


class AudioSCPDataset(_CachedDataset):
    """Audio items of a wav.scp (with an optional segments file)."""

    def __init__(self, wav_scp, segments=None, audio_length_threshold=None,
                 return_utt_id=False, return_sampling_rate=False, allow_cache=False):
        self.audio_loader = _WavScpLoader(wav_scp, segments)
        utt_ids = list(self.audio_loader.keys())
        if audio_length_threshold is not None:
            lengths = [self.audio_loader[k][1].shape[0] for k in utt_ids]
            (utt_ids,) = _filter_by_length(lengths, audio_length_threshold, utt_ids)
        if not utt_ids:
            raise FileNotFoundError(f"No utterances found in {wav_scp}.")
        self.utt_ids = utt_ids
        self.return_utt_id = return_utt_id
        self.return_sampling_rate = return_sampling_rate
        super().__init__(len(utt_ids), allow_cache)

    def __getitem__(self, idx):
        def build():
            utt_id = self.utt_ids[idx]
            fs, audio = self.audio_loader[utt_id]
            if self.return_sampling_rate:
                audio = (audio, fs)
            if self.return_utt_id:
                return utt_id, audio
            return audio

        return self._cached(idx, build)


class MelSCPDataset(_CachedDataset):
    """Mel items of a feats.scp (decode)."""

    def __init__(self, feats_scp, mel_length_threshold=None, return_utt_id=False,
                 allow_cache=False):
        self.mel_loader = _get_feats_scp_loader(feats_scp)
        utt_ids = list(self.mel_loader.keys())
        if mel_length_threshold is not None:
            lengths = [self.mel_loader[k].shape[0] for k in utt_ids]
            (utt_ids,) = _filter_by_length(lengths, mel_length_threshold, utt_ids)
        if not utt_ids:
            raise FileNotFoundError(f"No utterances found in {feats_scp}.")
        self.utt_ids = utt_ids
        self.return_utt_id = return_utt_id
        super().__init__(len(utt_ids), allow_cache)

    def __getitem__(self, idx):
        def build():
            utt_id = self.utt_ids[idx]
            mel = self.mel_loader[utt_id]
            if self.return_utt_id:
                return utt_id, mel
            return mel

        return self._cached(idx, build)
