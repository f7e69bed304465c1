"""Kaldi binary ark reader and writer in numpy, without kaldiio
(counterpart of parallelwavegan_tpu/utils/kaldi_ark.py:31-184).

An entry at ``path.ark:<offset>`` is laid out as:

  b"\\x00B"                      binary marker
  token + b" "                   "FM" f32 / "DM" f64 matrix,
                                 "FV" f32 / "DV" f64 vector,
                                 "CM "/"CM2"/"CM3" compressed matrix
  FM/DM: \\x04 int32 rows, \\x04 int32 cols, row-major data
  FV/DV: \\x04 int32 dim, data
  CM:  GlobalHeader {f32 min, f32 range, i32 rows, i32 cols}, then per
       column {4x uint16 percentiles}, then per column uint8 codes
       (piecewise-linear in the percentile ranges)
  CM2: GlobalHeader then row-major uint16 codes
  CM3: GlobalHeader then row-major uint8 codes

``write_ark`` writes uncompressed float32 "FM" / "FV" entries and, where
asked, the scp with each entry's byte offset, as ESPnet's front ends do.
"""

from __future__ import annotations

import struct

import numpy as np

from parallelwavegan_tpu_torch.utils.io import ScpLoader


def _read_token(f) -> str:
    tok = b""
    while True:
        ch = f.read(1)
        if ch in (b" ", b""):
            break
        tok += ch
    return tok.decode()


def _read_basic_int32(f) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size marker, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def _decompress_cm1(f) -> np.ndarray:
    min_value, rng, rows, cols = struct.unpack("<ffii", f.read(16))
    pch = np.frombuffer(f.read(8 * cols), "<u2").reshape(cols, 4)
    p = min_value + rng * pch.astype(np.float64) / 65535.0  # (cols, 4)
    codes = np.frombuffer(f.read(rows * cols), np.uint8)
    codes = codes.reshape(cols, rows).astype(np.float64)  # column-major
    p0, p25, p75, p100 = (p[:, i: i + 1] for i in range(4))
    lo = p0 + (p25 - p0) * (codes / 64.0)
    mid = p25 + (p75 - p25) * ((codes - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((codes - 192.0) / 63.0)
    out = np.where(codes <= 64, lo, np.where(codes <= 192, mid, hi))
    return out.T.astype(np.float32)


def read_kaldi_object(f) -> np.ndarray:
    """Read one kaldi object from a binary stream positioned at its start."""
    marker = f.read(2)
    if marker != b"\x00B":
        raise ValueError(f"not a kaldi binary object (marker {marker!r}); text "
                         "arks are not supported")
    token = _read_token(f)
    if token in ("FM", "DM"):
        rows = _read_basic_int32(f)
        cols = _read_basic_int32(f)
        dtype = "<f4" if token == "FM" else "<f8"
        nbytes = rows * cols * np.dtype(dtype).itemsize
        return np.frombuffer(f.read(nbytes), dtype).reshape(rows, cols)
    if token in ("FV", "DV"):
        dim = _read_basic_int32(f)
        dtype = "<f4" if token == "FV" else "<f8"
        return np.frombuffer(f.read(dim * np.dtype(dtype).itemsize), dtype)
    if token == "CM":
        return _decompress_cm1(f)
    if token in ("CM2", "CM3"):
        min_value, rng, rows, cols = struct.unpack("<ffii", f.read(16))
        if token == "CM2":
            codes = np.frombuffer(f.read(2 * rows * cols), "<u2")
            scale = rng / 65535.0
        else:
            codes = np.frombuffer(f.read(rows * cols), np.uint8)
            scale = rng / 255.0
        return (min_value + scale * codes.astype(np.float64)).reshape(
            rows, cols).astype(np.float32)
    raise ValueError(f"unsupported kaldi object token {token!r}")


def read_ark_entry(path_with_offset: str) -> np.ndarray:
    """Read one object from ``path.ark:offset`` (or a bare ark of one)."""
    if ":" in path_with_offset:
        path, offset = path_with_offset.rsplit(":", 1)
        offset = int(offset)
    else:
        path, offset = path_with_offset, None
    with open(path, "rb") as f:
        if offset is None:
            _read_token(f)  # a bare ark: skip the "key " prefix
        else:
            f.seek(offset)
        return read_kaldi_object(f)


def read_ark(path: str) -> dict[str, np.ndarray]:
    """Read every ``key object`` pair of a binary ark file."""
    out = {}
    with open(path, "rb") as f:
        while True:
            key = _read_token(f)
            if not key:
                break
            out[key] = read_kaldi_object(f)
    return out


def write_ark(ark_path: str, data: dict[str, np.ndarray],
              scp_path: str | None = None) -> None:
    """Write float32 matrices and vectors as an uncompressed binary ark, and
    the scp with byte offsets where ``scp_path`` is given."""
    scp_lines = []
    with open(ark_path, "wb") as f:
        for key, value in data.items():
            f.write(key.encode() + b" ")
            offset = f.tell()
            value = np.asarray(value)
            f.write(b"\x00B")
            if value.ndim == 2:
                value = value.astype("<f4")
                f.write(b"FM ")
                f.write(b"\x04" + struct.pack("<i", value.shape[0]))
                f.write(b"\x04" + struct.pack("<i", value.shape[1]))
            elif value.ndim == 1:
                value = value.astype("<f4")
                f.write(b"FV ")
                f.write(b"\x04" + struct.pack("<i", value.shape[0]))
            else:
                raise ValueError(f"{key}: only 1-D/2-D arrays supported")
            f.write(value.tobytes())
            scp_lines.append(f"{key} {ark_path}:{offset}\n")
    if scp_path is not None:
        with open(scp_path, "w") as f:
            f.writelines(scp_lines)


class ArkScpLoader(ScpLoader):
    """Dict-like loader of an scp whose values are ``file.ark:offset``
    entries (kaldiio's ``load_scp`` for binary arks)."""

    def __getitem__(self, key):
        return read_ark_entry(self.data[key])
