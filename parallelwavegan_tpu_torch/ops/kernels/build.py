"""Build and bind the port's CUDA kernels (nvcc -> shared library -> ctypes).

Every ``csrc/*.cu`` is compiled on first use by its own
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler -fPIC``
process, all started together, and the objects are linked by one
``nvcc -shared`` into one shared library in ``_build/`` beside this file
(listed in .gitignore), named by a hash of every source, every header
beside them (``csrc/*.cuh``) and the flags, so that an edit or a new
source rebuilds. Each exported entry point has its
ctypes signature in ``_SIGNATURES``; a test holds that table to the
sources. Nothing is compiled when a module is imported: the CPU tests
import every module.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # n, then arrays of n: x, out, w1, b1, w2, b2, f1, f2, K, dil; B, T, C,
    # slope, device, stream
    "hifigan_resunits": [_I] + [_P] * 10 + [_I] * 3 + [_F, _I, _P],
    # n, array of n sources, out, numel, device, stream
    "hifigan_mean": [_I, _P, _P, ctypes.c_longlong, _I, _P],
    # x, y, w, b, B, T, Tout, Cin, Cout, K, stride, pad, slope, device, stream
    "hifigan_deconv": [_P] * 4 + [_I] * 8 + [_F, _I, _P],
    # x, y, w, b, B, T, Cin, Cout, K, slope, device, stream
    "hifigan_outconv": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
    # x, c, x_out, skip, wf, bconv, bskip, bres, B, T, C, Ca, K, dil, causal,
    # accumulate, device, stream
    "wavenet_layer": [_P] * 8 + [_I] * 9 + [_P],
    # csrc/wavenet_bf16.cu, K3's bf16-resident mode, every layer of a stack
    # in one call: x, c, xa, xb, skip, tiles, bconv, bskip, bres, dils (L
    # ints), L, B, T, C, Ca, K, device, stream
    "wavenet_stack_bf16": [_P] * 10 + [_I] * 7 + [_P],
    # x, c, dxo, dsk, dx, dc, dz, g, part, wconv, bconv, waux, wskip, wres,
    # dwconv, dbconv, dwaux, dwskip, dbskip, dwres, dbres, part_floats, B, T,
    # C, Ca, K, dil, accumulate_dc, device, stream
    "wavenet_layer_bwd": [_P] * 21 + [ctypes.c_longlong] + [_I] * 8 + [_P],
    # B, T, C, Ca, K -> floats of wavenet_layer_bwd's partial buffer
    "wavenet_bwd_part_floats": [_I] * 5,
    # x, out, wf, bias, B, T, C, K, dil, mode, slope, device, stream
    "melgan_stack": [_P] * 4 + [_I] * 6 + [_F, _I, _P],
    # n, (wd, w1, ws, bd, b1, bs) per stack, K per stack, out, C, device,
    # stream
    "melgan_stack_split": [_I, _P, _P, _P, _I, _I, _P],
    # x, y, w, b, B, T, C, Cout, K, mode, slope, device, stream
    "melgan_outconv": [_P] * 4 + [_I] * 6 + [_F, _I, _P],
    # x, g, dx, dz, h, part, wf, bd, dwd, dbd, dw1, db1, dws, dbs,
    # part_floats, B, T, C, K, dil, mode, slope, device, stream
    "melgan_stack_bwd": [_P] * 14 + [ctypes.c_longlong] + [_I] * 6 + [_F, _I, _P],
    # B, T, C, K, dil -> floats of melgan_stack_bwd's partial buffer
    "melgan_stack_bwd_part_floats": [_I] * 5,
    # x, y, dy, dx, part, w, dw, db, part_floats, B, T, C, Cout, K, mode,
    # slope, device, stream
    "melgan_outconv_bwd": [_P] * 8 + [ctypes.c_longlong] + [_I] * 6 + [_F, _I, _P],
    # B, T, C, Cout, K -> floats of melgan_outconv_bwd's partial buffer
    "melgan_outconv_bwd_part_floats": [_I] * 5,
    # csrc/melgan_stack_bf16.cu, the bf16-resident modes: x, out, wf, bias,
    # B, T, C, K, dil, mode, slope, slope_x, x_bf16, out_bf16, device, stream
    "melgan_stack_bf16": [_P] * 4 + [_I] * 6 + [_F, _F, _I, _I, _I, _P],
    # x, y, w, b, B, T, C, Cout, K, mode, slope, y_bf16, device, stream
    "melgan_outconv_bf16": [_P] * 4 + [_I] * 6 + [_F, _I, _I, _P],
    # n, (wd, w1, ws, bd, b1, bs) per stack, K per stack, tiles, biases, C,
    # w_bf16, b_bf16, device, stream
    "melgan_stack_tiles_bf16": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # csrc/melgan_stack_bwd_bf16.cu: x, g, gsum, gsum_rows, dx, dxsum, dz, h,
    # xl, xb, xs, part, part_floats, wf, bd, dwd, dbd, dw1, db1, dws, dbs, B,
    # T, C, K, dil, mode, slope, slope_x, x_bf16, device, stream
    "melgan_stack_bwd_bf16": [_P] * 3 + [_I] + [_P] * 8 + [ctypes.c_longlong] + [_P] * 8
    + [_I] * 6 + [_F, _F, _I, _I, _P],
    # B, T, C, K, dil -> floats of melgan_stack_bwd_bf16's partial buffer
    "melgan_stack_bwd_bf16_part_floats": [_I] * 5,
    # B, T, C, outconv -> rows of the column sums the bf16 backward writes
    "melgan_bf16_sum_rows": [_I] * 4,
    # x, y, dy, g, gsum, part, w, dw, db, part_floats, B, T, C, Cout, K,
    # mode, slope, device, stream
    "melgan_outconv_bwd_bf16": [_P] * 9 + [ctypes.c_longlong] + [_I] * 6 + [_F, _I, _P],
    # B, T, C, Cout, K -> floats of melgan_outconv_bwd_bf16's partial buffer
    "melgan_outconv_bwd_bf16_part_floats": [_I] * 5,
    # x, c, mean, rstd, x2, a, wf, aux_b, g_b, gc_b, y, s, t, B, T, gate,
    # device, stream
    "tade1": [_P] * 13 + [_I] * 4 + [_P],
    # x, x2, a, mean, rstd, out, a2, wf, aux_b, g_b, gc_b, y, s, t, ua, B, T,
    # scale, dilation, gate, device, stream
    "tade2": [_P] * 15 + [_I] * 6 + [_P],
    # t, dout, s, xr, mean, rstd, dext, wf_gc, wf_g, wf_aux, y, ain, src,
    # dT, dG, dxn, da, dsrc, dw_gc, db_gc, dw_g, db_g, dw_aux, db_aux, part,
    # part_floats, B, L, scale, dilation, gate, device, stream
    "tade_stage_bwd": [_P] * 25 + [ctypes.c_longlong] + [_I] * 6 + [_P],
    # B, L -> floats of tade_stage_bwd's partial buffer
    "tade_stage_bwd_part_floats": [_I] * 2,
    # the bf16-resident modes (csrc/tade_bf16.cu), the float32 entry points'
    # arguments (the activations bf16, the weights in wgmma's tiles)
    "tade1_bf16": [_P] * 13 + [_I] * 4 + [_P],
    "tade2_bf16": [_P] * 15 + [_I] * 6 + [_P],
    # csrc/tade_bf16.cu: x, part, mean, rstd, B, T, device, stream
    "tade_stats_bf16": [_P] * 4 + [_I] * 3 + [_P],
    # B, T -> floats of tade_stats_bf16's partial buffer
    "tade_stats_bf16_part_floats": [_I] * 2,
    # csrc/tade_bwd_bf16.cu: tade_stage_bwd's arguments (dT, dG, da bf16
    # too, the weights in mma_bf16.tade_conv_wgmma's tiles)
    "tade_stage_bwd_bf16": [_P] * 25 + [ctypes.c_longlong] + [_I] * 6 + [_P],
    # B, L -> floats of tade_stage_bwd_bf16's partial buffer
    "tade_stage_bwd_bf16_part_floats": [_I] * 2,
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

    def query(self, name: str, *args) -> int:
        """The value an entry point that launches nothing returns."""
        return getattr(self._lib, name)(*args)

    def call(self, name: str, *args) -> None:
        """Launch one kernel; raise if the launch was refused."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            msg = self._lib.hifigan_error_string(err).decode()
            raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def check_tensor(name: str, t, device, shape, align: int = 0,
                 dtypes=(torch.float32,)) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes``
    (float32 by default) and of ``shape`` on ``device`` (and its data
    ``align``-byte aligned, where asked)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{name} must be {names}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


# The decode kernels (K1/K2 in hifigan_tail.cu, K3/K5 in wavenet.cu, K6 in
# melgan_stack.cu) put the batch on blockIdx.y and take the time length as
# an int; every offset into a tensor is 64-bit (size_t). A length of at
# most 2**30 rows keeps their int row arithmetic (a tile's rounding, 2 T - 2
# - p of the reflect padding) in range.
MAX_GRID_Y = 65535
MAX_ROWS = 2 ** 30


def check_grid(name: str, batch: int, rows: int) -> None:
    """Raise a ValueError naming the limit, before any launch (and on any
    device, so that a CPU test sees it), where a decode kernel's grid or its
    32-bit row index cannot take a call of ``batch`` items of ``rows`` rows
    (its longest time axis)."""
    if not 1 <= batch <= MAX_GRID_Y:
        raise ValueError(f"{name}: a batch of {batch} is outside the kernel's grid "
                         f"(blockIdx.y takes 1 to {MAX_GRID_Y})")
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"{name}: {rows} rows are outside the kernel's 32-bit row "
                         f"index (1 to 2**30 = {MAX_ROWS})")


BF16 = (torch.bfloat16,)
EITHER = (torch.float32, torch.bfloat16)  # weights that a bf16 mode rounds


def launch_target(x) -> tuple:
    """(device index, current stream handle) for launching on x's device."""
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(x.device).cuda_stream


def refuse_training(name: str, tensors) -> None:
    """Raise when a forward through kernel ``name``, which has no backward
    on this path, would need gradients."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is inference-only (no backward on this path, see "
            "ROADMAP.md): run the forward under torch.inference_mode() or "
            "torch.no_grad()")


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources(csrc: str = CSRC) -> list[str]:
    """Every kernel source, in a fixed order."""
    return sorted(glob.glob(os.path.join(csrc, "*.cu")))


def source_digest(paths: list[str]) -> str:
    """Hash of the flags and of the name and content of every source and of
    every header (``*.cuh``) in the sources' directories."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    dirs = sorted({os.path.dirname(path) for path in paths})
    headers = [h for d in dirs for h in sorted(glob.glob(os.path.join(d, "*.cuh")))]
    for path in paths + headers:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read() + b"\0")
    return digest.hexdigest()[:16]


def _run(procs: dict) -> str:
    """Wait for every nvcc process; raise if any failed. Returns the logs."""
    logs, failed = [], []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode})")
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    return log


def build() -> KernelLibrary:
    """Compile every kernel source into one library unless a build of the
    same sources and flags exists, then load it."""
    srcs = sources()
    path = os.path.join(BUILD_DIR, f"libport_kernels_{source_digest(srcs)}.so")
    if os.path.exists(path):
        return KernelLibrary(path, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{path}.{os.getpid()}"
    objs = {src: f"{tag}.{os.path.basename(src)}.o" for src in srcs}
    popen = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    start = time.perf_counter()
    try:
        log = _run({os.path.basename(src): subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src], **popen)
            for src, obj in objs.items()})
        log += _run({"link": subprocess.Popen(
            [nvcc, *LINK_FLAGS, "-o", f"{tag}.tmp", *objs.values()], **popen)})
        os.replace(f"{tag}.tmp", path)
    finally:
        for obj in objs.values():
            if os.path.exists(obj):
                os.remove(obj)
    return KernelLibrary(path, time.perf_counter() - start, log)


_LIBRARY: KernelLibrary | None = None


def load() -> KernelLibrary:
    """The process's kernel library, built on first use."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build()
    return _LIBRARY
