"""The port's data surfaces against the JAX package's: Kaldi binary arks
(``utils/kaldi_ark.py``, the compressed CM, CM2 and CM3 forms too), every
feats.scp form through ``_get_feats_scp_loader``, the scp and dump
datasets item for item, and the IO helpers; and the import boundary for
the modules the card's machine lacks (PyYAML, h5py, tqdm)."""

import argparse
import ast
import io
import os
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401
h5py = pytest.importorskip("h5py")

from parallelwavegan_tpu.data import datasets as jds  # noqa: E402
from parallelwavegan_tpu.utils import io as jio  # noqa: E402
from parallelwavegan_tpu.utils import kaldi_ark as jark  # noqa: E402
from parallelwavegan_tpu_torch.data import datasets as pds  # noqa: E402
from parallelwavegan_tpu_torch.utils import io as pio  # noqa: E402
from parallelwavegan_tpu_torch.utils import kaldi_ark as park  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal(a, b):
    """Items of two datasets equal: same structure, arrays bit for bit."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, str) or isinstance(a, int):
        assert a == b
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer,reader", [(jark, park), (park, jark)])
def test_ark_written_by_one_package_reads_the_same_in_the_other(tmp_path, writer, reader):
    rs = np.random.RandomState(0)
    data = {"utt_a": rs.randn(17, 80).astype(np.float32),
            "utt_b": rs.randn(5, 3).astype(np.float32),
            "vec_c": rs.randn(23).astype(np.float32)}
    ark, scp = str(tmp_path / "feats.ark"), str(tmp_path / "feats.scp")
    writer.write_ark(ark, data, scp)
    loaded = reader.read_ark(ark)
    assert list(loaded) == list(data)
    loader = reader.ArkScpLoader(scp)
    assert list(loader.keys()) == list(data) and len(loader) == 3
    for k, v in data.items():
        _equal(loaded[k], v)
        _equal(loader[k], v)
        _equal(reader.read_ark_entry(loader.get_path(k)), v)
    other = (park if reader is jark else jark).ArkScpLoader(scp)
    for a, b in zip(loader.values(), other.values()):
        _equal(a, b)
    # a bare ark of one entry (no offset)
    writer.write_ark(str(tmp_path / "one.ark"), {"k": data["utt_b"]})
    _equal(reader.read_ark_entry(str(tmp_path / "one.ark")), data["utt_b"])


def _header(min_value, rng, rows, cols):
    return struct.pack("<ffii", min_value, rng, rows, cols)


def _compressed_blobs():
    rs = np.random.RandomState(1)
    rows, cols = 6, 5
    pch = np.sort(rs.randint(0, 65536, (cols, 4)), axis=1).astype("<u2")
    return {
        "CM": b"\x00BCM " + _header(-3.0, 7.5, rows, cols) + pch.tobytes()
              + rs.randint(0, 256, rows * cols).astype(np.uint8).tobytes(),
        "CM2": b"\x00BCM2 " + _header(-2.0, 4.0, rows, cols)
               + rs.randint(0, 65536, rows * cols).astype("<u2").tobytes(),
        "CM3": b"\x00BCM3 " + _header(-1.0, 3.0, rows, cols)
               + rs.randint(0, 256, rows * cols).astype(np.uint8).tobytes(),
        "DM": b"\x00BDM \x04" + struct.pack("<i", 2) + b"\x04" + struct.pack("<i", 3)
              + rs.randn(6).astype("<f8").tobytes(),
        "DV": b"\x00BDV \x04" + struct.pack("<i", 4) + rs.randn(4).astype("<f8").tobytes(),
    }


@pytest.mark.parametrize("token", ["CM", "CM2", "CM3", "DM", "DV"])
def test_compressed_and_double_objects_decode_as_in_jax(tmp_path, token):
    blob = _compressed_blobs()[token]
    got = park.read_kaldi_object(io.BytesIO(blob))
    _equal(got, jark.read_kaldi_object(io.BytesIO(blob)))
    assert got.ndim == (1 if token == "DV" else 2)
    # the same object as an ark entry at an offset, through the scp loader
    (tmp_path / "c.ark").write_bytes(b"utt " + blob)
    (tmp_path / "c.scp").write_text(f"utt {tmp_path / 'c.ark'}:4\n")
    _equal(park.ArkScpLoader(str(tmp_path / "c.scp"))["utt"], got)
    with pytest.raises(ValueError, match="text arks"):
        park.read_kaldi_object(io.BytesIO(b"  FM"))


def _feats_scp(tmp_path, form):
    """A feats.scp of three utterances in ``form``, and their mels."""
    rs = np.random.RandomState(2)
    mels = {f"u{i}": rs.randn(20 + 3 * i, 6).astype(np.float32) for i in range(3)}
    scp = str(tmp_path / f"{form}.scp")
    lines = []
    for k, m in mels.items():
        if form == "ark":
            continue
        if form == "npy":
            np.save(tmp_path / f"{k}.npy", m)
            lines.append(f"{k} {tmp_path / f'{k}.npy'}")
        else:
            with h5py.File(tmp_path / f"{k}.h5", "w") as f:
                f["feats"], f["a"], f["b"] = m, m[:, :4], m[:, 4]
            value = {"h5": "", "h5_name": ":feats", "h5_concat": ":a,b"}[form]
            lines.append(f"{k} {tmp_path / f'{k}.h5'}{value}")
    if form == "ark":
        jark.write_ark(str(tmp_path / "f.ark"), mels, scp)
    else:
        with open(scp, "w") as f:
            f.write("\n".join(lines) + "\n")
    if form == "h5_concat":
        mels = {k: np.concatenate([m[:, :4], m[:, 4:5]], 1) for k, m in mels.items()}
    return scp, mels


@pytest.mark.parametrize("form", ["ark", "h5", "h5_name", "h5_concat", "npy"])
def test_every_feats_scp_form_loads_as_in_jax(tmp_path, form):
    scp, mels = _feats_scp(tmp_path, form)
    got, want = pds._get_feats_scp_loader(scp), jds._get_feats_scp_loader(scp)
    assert type(got).__name__ == type(want).__name__
    assert list(got.keys()) == list(want.keys()) == list(mels)
    for k in mels:
        _equal(got[k], want[k])
        _equal(got[k], mels[k])
    for cls in (pds.MelSCPDataset, jds.MelSCPDataset):
        assert len(cls(scp, mel_length_threshold=22)) == 2
    p, j = (m.MelSCPDataset(scp, return_utt_id=True, allow_cache=True) for m in (pds, jds))
    for i in range(len(j)):
        _equal(p[i], j[i])
    assert p[1] is p[1]  # cached
    _equal(pds.MelSCPDataset(scp)[0], jds.MelSCPDataset(scp)[0])


def test_unsupported_feats_scp_raises(tmp_path):
    (tmp_path / "f.scp").write_text("u0 x.txt\n")
    with pytest.raises(ValueError, match="Not supported"):
        pds._get_feats_scp_loader(str(tmp_path / "f.scp"))


def _wavs(tmp_path, fs=8000):
    """Two recordings, three utterances (u2 and u3 cut from one by segments),
    16-bit WAVs written by the port's ``write_wav``."""
    rs = np.random.RandomState(3)
    wav_scp, seg = tmp_path / "wav.scp", tmp_path / "segments"
    for rec, n in (("r0", 4000), ("r1", 9000)):
        pio.write_wav(str(tmp_path / f"{rec}.wav"), fs, 0.3 * rs.randn(n).clip(-3, 3) / 3)
    wav_scp.write_text(f"r0 {tmp_path / 'r0.wav'}\nr1 {tmp_path / 'r1.wav'}\n")
    seg.write_text("u1 r0 0.0 -1\nu2 r1 0.1 0.6\nu3 r1 0.6 1.125\n")
    return str(wav_scp), str(seg)


def test_piped_wav_scp_entries_are_refused(tmp_path):
    (tmp_path / "wav.scp").write_text("u0 sox a.wav -t wav - |\n")
    for m in (pds, jds):
        with pytest.raises(ValueError, match="piped"):
            m.AudioSCPDataset(str(tmp_path / "wav.scp"))
    with pytest.raises(ValueError, match="pipe-style"):
        pio.wav_index(str(tmp_path / "wav.scp"))


@pytest.mark.parametrize("form", ["ark", "npy"])
def test_audio_mel_scp_dataset_items_equal_jax(tmp_path, form):
    wav_scp, seg = _wavs(tmp_path)
    rs = np.random.RandomState(4)
    mels = {u: rs.randn(n, 6).astype(np.float32) for u, n in (("u1", 15), ("u2", 10),
                                                             ("u3", 17), ("u9", 5))}
    scp = str(tmp_path / "feats.scp")
    if form == "ark":
        park.write_ark(str(tmp_path / "f.ark"), mels, scp)
    else:
        for k, m in mels.items():
            np.save(tmp_path / f"{k}.npy", m)
        with open(scp, "w") as f:
            f.writelines(f"{k} {tmp_path / f'{k}.npy'}\n" for k in mels)
    for kw in (dict(return_utt_id=True, return_sampling_rate=True),
               dict(audio_length_threshold=4000, mel_length_threshold=12),
               dict(return_utt_id=True, allow_cache=True)):
        p = pds.AudioMelSCPDataset(wav_scp, scp, segments=seg, **kw)
        j = jds.AudioMelSCPDataset(wav_scp, scp, segments=seg, **kw)
        assert p.utt_ids == j.utt_ids
        for i in range(len(j)):
            _equal(p[i], j[i])
    assert p.utt_ids == ["u1", "u2", "u3"]  # u9 has no audio
    _, audio, _ = p[2]
    assert audio.shape == (int(1.125 * 8000) - int(0.6 * 8000),)
    for kw in (dict(return_utt_id=True, return_sampling_rate=True), {}):
        p, j = pds.AudioSCPDataset(wav_scp, seg, **kw), jds.AudioSCPDataset(wav_scp, seg, **kw)
        for i in range(len(j)):
            _equal(p[i], j[i])
    p, j = pds.AudioSCPDataset(wav_scp), jds.AudioSCPDataset(wav_scp)
    assert p.utt_ids == j.utt_ids == ["r0", "r1"]
    _equal(p[1], j[1])


def _dump(tmp_path):
    """An npy dump of four utterances with every stream preprocess writes."""
    rs = np.random.RandomState(5)
    for i, frames in enumerate((6, 9, 12, 4)):
        for name, arr in (("wave", rs.randn(frames * 4)), ("feats", rs.randn(frames, 3)),
                          ("local", rs.randn(frames, 2)), ("f0", rs.randn(frames)),
                          ("excitation", rs.randn(frames, 4))):
            np.save(tmp_path / f"u{i}-{name}.npy", arr.astype(np.float32))
        np.save(tmp_path / f"u{i}-global.npy", np.asarray(i % 2))
    return str(tmp_path)


def _kw(**streams):
    out = {}
    for key, name in streams.items():
        out[f"{key}_query"], out[f"{key}_load_fn"] = f"*-{name}.npy", np.load
    return out


@pytest.mark.parametrize("cls,kw", [
    ("AudioMelDataset", dict(_kw(audio="wave", mel="feats"))),
    ("AudioMelDataset", dict(_kw(audio="wave", mel="feats", local="local", **{
        "global": "global"}), return_utt_id=True, audio_length_threshold=20)),
    ("AudioMelDataset", dict(_kw(audio="wave", mel="feats"), mel_length_threshold=7,
                             allow_cache=True, return_utt_id=True)),
    ("AudioMelF0ExcitationDataset", dict(
        _kw(audio="wave", mel="feats", f0="f0", excitation="excitation"),
        mel_length_threshold=5, return_utt_id=True)),
    ("AudioDataset", dict(_kw(audio="wave"))),
    ("AudioDataset", dict(_kw(audio="wave"), return_utt_id=True, audio_length_threshold=30)),
    ("AudioDataset", dict(_kw(audio="wave", **{"global": "global"}))),
    ("MelDataset", dict(_kw(mel="feats"))),
    ("MelDataset", dict(_kw(mel="feats", local="local"), return_utt_id=True,
                        mel_length_threshold=6)),
    ("MelF0ExcitationDataset", dict(_kw(mel="feats", f0="f0", excitation="excitation"),
                                    return_utt_id=True)),
])
def test_dump_dataset_items_equal_jax(tmp_path, cls, kw):
    root = _dump(tmp_path)
    p, j = getattr(pds, cls)(root, **kw), getattr(jds, cls)(root, **kw)
    assert len(p) == len(j) and p.utt_ids == j.utt_ids
    for i in range(len(j)):
        _equal(p[i], j[i])
        if kw.get("allow_cache"):
            assert p[i] is p[i]


def test_dump_datasets_refuse_an_empty_directory_and_unpaired_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        pds.MelDataset(str(tmp_path), mel_query="*.npy", mel_load_fn=np.load)
    np.save(tmp_path / "u0-wave.npy", np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="counts differ"):
        pds.AudioMelDataset(str(tmp_path), **_kw(audio="wave", mel="feats"))


def test_io_helpers_equal_jax(tmp_path):
    from scipy.io import wavfile

    from parallelwavegan_tpu.utils import config as jcfg
    from parallelwavegan_tpu_torch.utils import config as pcfg

    rs = np.random.RandomState(6)
    for dtype, data in (("int16", rs.randint(-32768, 32767, 50).astype(np.int16)),
                        ("int32", rs.randint(-2 ** 31, 2 ** 31 - 1, 50).astype(np.int32)),
                        ("uint8", rs.randint(0, 255, 50).astype(np.uint8)),
                        ("float32", rs.randn(50).astype(np.float32))):
        path = str(tmp_path / f"{dtype}.wav")
        wavfile.write(path, 8000, data)
        _equal(pio.read_wav(path), jio.read_wav(path))
    (tmp_path / "sub").mkdir()
    wavfile.write(str(tmp_path / "sub" / "x.wav"), 8000, np.zeros(10, np.int16))
    for inc in (True, False):
        assert sorted(pio.find_files(str(tmp_path), include_root_dir=inc)) == sorted(
            jio.find_files(str(tmp_path), include_root_dir=inc))
    wav_scp, _ = _wavs(tmp_path / "sub")
    for where in (str(tmp_path / "sub"), wav_scp):
        got, want = pio.wav_index(where), jio.wav_index(where)
        assert got == want
        for k in want:
            _equal(pio.read_wav_entry(got[k]), jio.read_wav_entry(want[k]))

    h5 = str(tmp_path / "d" / "x.h5")
    pio.write_hdf5(h5, "a", [1.0, 2.0])
    pio.write_hdf5(h5, "a", [3.0])
    _equal(pio.read_hdf5(h5, "a"), np.array([3.0]))
    with pytest.raises(RuntimeError, match="already exists"):
        pio.write_hdf5(h5, "a", [4.0], is_overwrite=False)
    with pytest.raises(KeyError):
        pio.read_hdf5(h5, "b")

    args = argparse.Namespace(config="c.yaml", outdir="exp", steps=3)
    assert pcfg.merge_args({"steps": 1, "a": 2}, args) == jcfg.merge_args(
        {"steps": 1, "a": 2}, args) == {"steps": 3, "a": 2, "outdir": "exp"}


def _module_level_imports(path):
    """Top-level modules imported by the statements run at import time (not
    inside a function or class body)."""
    tree = ast.parse(open(path).read(), path)
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                todo += getattr(node, field, [])
        elif isinstance(node, ast.ExceptHandler):
            todo += node.body


def test_port_imports_no_yaml_h5py_or_tqdm_at_module_level():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(ROOT, "parallelwavegan_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    pkg = os.path.join(ROOT, "parallelwavegan_tpu_torch")
    assert {os.path.join(pkg, "bin", f"{m}.py") for m in (
        "preprocess", "compute_statistics", "normalize")} <= set(files)
    assert os.path.join(pkg, "utils", "kaldi_ark.py") in files
    for path in files:
        for top in _module_level_imports(path):
            assert top not in ("yaml", "h5py", "tqdm", "jax", "parallelwavegan_tpu"), (
                path, top)
