"""Two probes of the MelGAN stacks' bf16 kernels on the card.

    python -m parallelwavegan_tpu_torch.ops.kernels.probe_melgan_bf16 [--clocks]

Without --clocks: which offset field of a no-swizzle wgmma descriptor
steps along K and which along N, in either major, and whether
csrc/melgan_bf16.cuh's ``mma_cols`` cuts every width C = 16 .. 128 into
wgmma products right: one m64nNk16 on the card against the same product in
PyTorch. A probe kernel (below, compiled with ``build.py``'s flags into a
temporary library) stages B, a 16 x N bf16 matrix, in 8 x 8 core matrices
of 128 contiguous bytes (K-major: a core row is one n's 8 k values;
MN-major: one k's 8 n values), the cores ``k_step`` bytes apart along K
and ``n_step`` along N, and runs ``mma_cols<N>`` with the descriptor's
leading byte offset and stride byte offset set to (k_step, n_step) and to
(n_step, k_step). Prints, per major and width, which assignment gives
A . B, and exits non-zero unless exactly the one that
csrc/melgan_bf16.cuh's ``desc_b`` uses does.

With --clocks: where the kernels' time goes. Every source is compiled
with MELBF_CLOCKS defined (thread 0 of each block adds the clock64 cycles
between the kernels' stamps, phase by phase; melgan_bf16.cuh) into a
library of its own, which then stands in for the built one; K6's training
forward and K7 (on the forward's weight layout, K6's re-run included) run
at MelGAN v1's three fused training stages and MB-MelGAN v2's two
(``time_melgan._stages``), and each kernel's cycles are printed per
phase: the share of its blocks' cycles, and the cycles per row tile.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

_SOURCE = r"""
#include "melgan_bf16.cuh"

namespace {
template <int N>
__global__ void probe_kernel(const uint16_t* a, const uint8_t* b, int b_bytes, float* d,
                             int trans, uint32_t lbo, uint32_t sbo, uint32_t n_step) {
  __shared__ __align__(128) uint8_t bs[32768];
  __shared__ __align__(16) uint16_t as[64 * 24];
  for (int i = threadIdx.x; i < b_bytes / 16; i += 128)
    reinterpret_cast<uint4*>(bs)[i] = reinterpret_cast<const uint4*>(b)[i];
  for (int i = threadIdx.x; i < 64 * 2; i += 128)
    *reinterpret_cast<uint4*>(as + (i / 2) * 24 + (i % 2) * 8) =
        *reinterpret_cast<const uint4*>(a + (i / 2) * 16 + (i % 2) * 8);
  wgmma::fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t ar[4];
  wgmma::ldmatrix_x4(ar, as + (16 * warp + (lane & 15)) * 24 + (lane >> 4) * 8);
  float acc[N / 2];
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
  const uint64_t desc = wgmma::desc_inter(wgmma::smem_u32(bs), lbo, sbo);
  wgmma::fence();
  if (trans)
    melbf::mma_cols<N, 1>(acc, ar, desc, n_step, 0);
  else
    melbf::mma_cols<N, 0>(acc, ar, desc, n_step, 0);
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
  const int gid = lane >> 2, tig = lane & 3;
  for (int i = 0; i < N / 8; ++i)
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e)
        d[(16 * warp + gid + 8 * h) * N + 8 * i + 2 * tig + e] = acc[4 * i + 2 * h + e];
}

template <int N>
int run(const uint16_t* a, const uint8_t* b, int b_bytes, float* d, int trans, int lbo, int sbo,
        int n_step) {
  probe_kernel<N><<<1, 128>>>(a, b, b_bytes, d, trans, lbo, sbo, n_step);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int probe(const void* a, const void* b, int b_bytes, float* d, int n, int trans,
                     int lbo, int sbo, int n_step) {
  const uint16_t* ah = static_cast<const uint16_t*>(a);
  const uint8_t* bh = static_cast<const uint8_t*>(b);
  switch (n) {
    case 16: return run<16>(ah, bh, b_bytes, d, trans, lbo, sbo, n_step);
    case 32: return run<32>(ah, bh, b_bytes, d, trans, lbo, sbo, n_step);
    case 48: return run<48>(ah, bh, b_bytes, d, trans, lbo, sbo, n_step);
    case 64: return run<64>(ah, bh, b_bytes, d, trans, lbo, sbo, n_step);
    case 80: return run<80>(ah, bh, b_bytes, d, trans, lbo, sbo, n_step);
    case 96: return run<96>(ah, bh, b_bytes, d, trans, lbo, sbo, n_step);
    case 112: return run<112>(ah, bh, b_bytes, d, trans, lbo, sbo, n_step);
    case 128: return run<128>(ah, bh, b_bytes, d, trans, lbo, sbo, n_step);
    default: return -1;
  }
}
"""


def core_layout(b, k_major: bool, k_step: int, n_step: int):
    """B (16, N) bf16 as bytes: core (kc, nc) at kc k_step + nc n_step
    bytes, its 8 rows 16 bytes apart (K-major: row = n, 8 k values; MN-major:
    row = k, 8 n values)."""
    import torch

    k, n = b.shape
    size = max((k // 8 - 1) * k_step + (n // 8 - 1) * n_step + 128, 16)
    out = torch.zeros(size // 2, dtype=torch.bfloat16)
    for kc in range(k // 8):
        for nc in range(n // 8):
            core = b[8 * kc:8 * kc + 8, 8 * nc:8 * nc + 8]
            if k_major:
                core = core.t()
            start = (kc * k_step + nc * n_step) // 2
            out[start:start + 64] = core.reshape(-1)
    return out


def descriptors() -> int:
    """The descriptor probe (the module docstring)."""
    import torch

    from parallelwavegan_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("probe_melgan_bf16: needs a CUDA device")
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(_SOURCE)
        lib_path = os.path.join(tmp, "probe.so")
        flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([build._nvcc(), *flags, "-shared", "-I", build.CSRC, "-o", lib_path,
                        src], check=True)
        lib = ctypes.CDLL(lib_path)
        lib.probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        lib.probe.restype = ctypes.c_int
        g = torch.Generator().manual_seed(0)
        ok = True
        for major in ("K", "MN"):
            for n in range(16, 129, 16):
                a = torch.randn(64, 16, generator=g).to(torch.bfloat16)
                b = torch.randn(16, n, generator=g).to(torch.bfloat16)
                want = a.float() @ b.float()
                # cores along N 128 bytes apart, along K past all of them
                n_step, k_step = 128, 128 * (n // 8) + 256
                tile = core_layout(b, major == "K", k_step, n_step).cuda()
                got = {}
                for name, (lbo, sbo) in (("lbo=K, sbo=N", (k_step, n_step)),
                                         ("lbo=N, sbo=K", (n_step, k_step))):
                    d = torch.full((64, n), float("nan"), device="cuda")
                    err = lib.probe(a.cuda().data_ptr(), tile.data_ptr(), tile.numel() * 2,
                                    d.data_ptr(), n, int(major == "MN"), lbo, sbo, n_step)
                    torch.cuda.synchronize()
                    if err:
                        raise RuntimeError(f"probe launch failed: {err}")
                    got[name] = bool(torch.allclose(d.cpu(), want, rtol=1e-3, atol=1e-3))
                right = [k for k, v in got.items() if v]
                print(f"{major}-major N={n}: right with {right or 'neither'}")
                ok &= right == ["lbo=K, sbo=N"]
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        print(f"on {card}: " + ("desc_b's assignment holds" if ok else
                                "desc_b's assignment does NOT hold"))
    return 0 if ok else 1


# each kernel's clock slot and the phases it stamps (melgan_bf16.cuh)
PHASES = {
    "K6 stack_bf16_kernel": (0, ("wait for the window", "convert the window", "taps",
                                 "leaky(z) rows", "W1 and Ws products", "store")),
    "K7 dz_bf16_kernel": (1, ("wait for the window", "convert the window", "taps", "h out",
                              "wait for g", "dh product", "dz out, column sums",
                              "prefetch g")),
    "K7 dx_bf16_kernel": (2, ("wait, prefetch the window", "taps and fold", "leaky'(x)",
                              "wait for g", "skip product", "store, column sums",
                              "prefetch g")),
    "K7 wgrad_bf16_kernel": (3, ("prologue", "wait for the step", "stage a step ahead",
                                 "products, retire")),
}


def clocks() -> int:
    """The --clocks probe (the module docstring)."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels import build
    from parallelwavegan_tpu_torch.ops.kernels import time_melgan as tm
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        fused_melgan_stacks,
        kernel_weights_bf16,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import melgan_stacks_backward

    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
    sys.path.insert(0, root)
    import chip_smoke as smoke

    with tempfile.TemporaryDirectory() as tmp:
        objs, procs = [], []
        for src in build.sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [build._nvcc(), *[f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")],
                 "-DMELBF_CLOCKS", "-c", "-o", obj, src]))
        if any(p.wait() for p in procs):
            raise RuntimeError("nvcc failed")
        path = os.path.join(tmp, "clocks.so")
        subprocess.run([build._nvcc(), *build.LINK_FLAGS, "-o", path, *objs], check=True)
        lib = build.KernelLibrary(path, 0.0, "")
        build._LIBRARY = lib
        readers = [getattr(lib._lib, n) for n in ("melgan_stack_bf16_clocks",
                                                  "melgan_stack_bwd_bf16_clocks")]
        for r in readers:
            r.argtypes, r.restype = [ctypes.c_void_p], ctypes.c_int
        buf = np.zeros((4, 1024, 8), dtype=np.uint64)

        def read():
            total = np.zeros_like(buf)
            for r in readers:
                if r(buf.ctypes.data):
                    raise RuntimeError("reading the clocks failed")
                total += buf
            return total

        rs = np.random.RandomState(0)

        def randn(*shape, scale=1.0):
            return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).cuda()

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        for name, (x, stacks, fin, dy) in tm._stages(smoke, randn).items():
            xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
            split = kernel_weights_bf16(stacks)
            tiles = x.shape[0] * -(-x.shape[1] // 128) * len(stacks)  # row tiles of a call
            with torch.no_grad():
                fused_melgan_stacks(xb, stacks, final=fin)  # warm
            melgan_stacks_backward(xb, stacks, fin, 0.2, "reflect", dyb, split)
            torch.cuda.synchronize()
            read()
            with torch.no_grad():
                fused_melgan_stacks(xb, stacks, final=fin)
            torch.cuda.synchronize()
            fwd = read()
            melgan_stacks_backward(xb, stacks, fin, 0.2, "reflect", dyb, split)
            torch.cuda.synchronize()
            bwd = read()
            for label, got in (("forward", fwd), ("backward", bwd)):
                for kernel, (slot, phases) in PHASES.items():
                    if label == "forward" and not kernel.startswith("K6"):
                        continue
                    per = got[slot].sum(0)[:len(phases)].astype(np.float64)
                    if per.sum() == 0:
                        continue
                    print(f"{name} {label} {kernel}: " + ", ".join(
                        f"{ph} {v / per.sum():.1%} ({v / tiles:.0f} cycles a tile)"
                        for ph, v in zip(phases, per)) + f" on {card}")
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clocks", action="store_true", help="where the kernels' time goes")
    args = ap.parse_args(argv)
    return clocks() if args.clocks else descriptors()


if __name__ == "__main__":
    sys.exit(main())
