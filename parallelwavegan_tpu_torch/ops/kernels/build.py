"""Build and bind the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``csrc/`` are compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``_build/`` beside this file (listed in .gitignore), named by a hash
of the source and flags so that an edit rebuilds. Nothing is compiled
when a module is imported: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "hifigan_tail.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # n, then arrays of n: x, out, w1, b1, w2, b2, K, dil; B, T, C, slope,
    # device, stream
    "hifigan_resunits": [_I] + [_P] * 8 + [_I] * 3 + [_F, _I, _P],
    # n, array of n sources, out, numel, device, stream
    "hifigan_mean": [_I, _P, _P, ctypes.c_longlong, _I, _P],
    # x, y, w, b, B, T, Tout, Cin, Cout, K, stride, pad, slope, device, stream
    "hifigan_deconv": [_P] * 4 + [_I] * 8 + [_F, _I, _P],
    # x, y, w, b, B, T, Cin, Cout, K, slope, device, stream
    "hifigan_outconv": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
}


class KernelLibrary:
    """The loaded shared library with typed entry points, and how it was
    built (``build_seconds`` is 0 when a cached build was loaded)."""

    def __init__(self, path: str, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self._lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib.hifigan_error_string.argtypes = [ctypes.c_int]
        self._lib.hifigan_error_string.restype = ctypes.c_char_p

    def call(self, name: str, *args) -> None:
        """Launch one kernel; raise if the launch was refused."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            msg = self._lib.hifigan_error_string(err).decode()
            raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> KernelLibrary:
    """Compile the kernel source unless a build of the same source and
    flags exists, then load it."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"libhifigan_tail_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return KernelLibrary(path, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return KernelLibrary(path, seconds, log)


_LIBRARY: KernelLibrary | None = None


def load() -> KernelLibrary:
    """The process's kernel library, built on first use."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build()
    return _LIBRARY
