"""The design alternatives of csrc/tade_bf16.cu (K8a/K8b's bf16-resident
mode) against the kept design, on the card:

    python -m parallelwavegan_tpu_torch.ops.kernels.probe_tade_bf16

Each alternative is the kept source with its tiling constants and its conv
(``conv9``) rewritten by text substitution, compiled by itself with the
flags of ``build.py`` into a library of its own in a temporary directory,
and called through the same entry points (``tade1_bf16``, ``tade2_bf16``)
with the same weight tiles, statistics and biases:

- kept: three warpgroups of 192 rows, one block an SM, m64n128 products
  for g and gc, each tap retired into float32 totals;
- two_wg: the same at two warpgroups of 128 rows;
- two_acc: two warpgroups, each tap issued into one of two accumulators
  while the other tap is retired into the totals;
- group3: two warpgroups, three taps summed by the tensor cores, then
  into the totals;
- one_acc: two warpgroups at two blocks an SM (128 registers), the nine
  taps issued back to back and summed by the tensor cores into one
  accumulator (no totals), a 4-stage ring.

Prints, for each, the kernels' device time per StyleMelGAN v1 G step
(K8a and K8b, forward and Save, blocks 4-8, B=32, median of 20 CUDA
events each, summed over the blocks) and, at the forward cases of
tests/test_torch_port_cuda.py (its inputs, built by that file's own
helper), the largest rms|diff| / rms|plain| of x2, a, out and a2 against
``tade1_reference_bf16`` / ``tade2_reference_bf16`` (the bound of the
card's check is 1e-3) and whether the results equal the kept design's bit
for bit. Needs the card, nvcc and the repository's tests directory.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))

# the alternatives' conv9 bodies; `keep` holds a tap's A registers until
# its products have retired
_KEEP = '''
__device__ __forceinline__ void keep(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[ks][i])::"memory");
}
'''

_HEAD = '''template <int N, int DD>
__device__ __forceinline__ void conv9(const uint16_t* in, const uint16_t* __restrict__ w,
                                      uint8_t* ring, uint64_t* full, uint64_t* empty, int& tap,
                                      float (&tot)[N / 2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint16_t* a0 = in + (16 * warp + (lane & 15)) * kLd + (lane >> 4) * 8;
  uint32_t a[2][4][4];
'''

# one product of tap j into accumulator ACC (the first k16 step overwrites
# it when FIRST holds)
_ISSUE = '''
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma::ldmatrix_x4(a[j & 1][ks], a0 + j * DD * kLd + ks * 16);
    const int st = tap % kStages;
    wgmma::mbar_wait(full + st, (tap / kStages) & 1);
    wgmma::fence();
    const uint64_t desc = wgmma::desc_k_sw128(ring + st * kStageB);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if constexpr (N == 128)
        wgmma::m64n128k16<0>(ACC, a[j & 1][ks], desc + 2 * ks, !(FIRST) || ks > 0);
      else
        wgmma::m64n64k16<0>(ACC, a[j & 1][ks], desc + 2 * ks, !(FIRST) || ks > 0);
    }
    wgmma::commit();
'''

_CONVS = {
    "two_acc": _HEAD + '''  float acc[2][N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) tot[e] = acc[0][e] = acc[1][e] = 0.f;
  wgmma::fence_operand(acc[0]);
  wgmma::fence_operand(acc[1]);
#pragma unroll
  for (int j = 0; j < kK; ++j, ++tap) {''' + _ISSUE.replace("ACC", "acc[j & 1]").replace(
        "FIRST", "true") + '''    if (j == 0) continue;
    wgmma::wait<1>();
    wgmma::fence_operand(acc[(j - 1) & 1]);
    keep(a[(j - 1) & 1]);
    hand_back(w, tap - 1, ring, full, empty);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) tot[e] += acc[(j - 1) & 1][e];
    wgmma::fence_operand(acc[(j - 1) & 1]);
  }
  wgmma::wait<0>();
  wgmma::fence_operand(acc[(kK - 1) & 1]);
  keep(a[(kK - 1) & 1]);
  hand_back(w, tap - 1, ring, full, empty);
#pragma unroll
  for (int e = 0; e < N / 2; ++e) tot[e] += acc[(kK - 1) & 1][e];
}
''',
    "group3": _HEAD + '''  float acc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) tot[e] = acc[e] = 0.f;
  wgmma::fence_operand(acc);
#pragma unroll
  for (int j = 0; j < kK; ++j, ++tap) {''' + _ISSUE.replace("ACC", "acc").replace(
        "FIRST", "j % 3 == 0") + '''    if (j % 3 < 2) {
      wgmma::wait<1>();
      if (j % 3 > 0) {
        keep(a[(j - 1) & 1]);
        hand_back(w, tap - 1, ring, full, empty);
      }
      continue;
    }
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    keep(a[(j - 1) & 1]);
    keep(a[j & 1]);
    hand_back(w, tap - 1, ring, full, empty);
    hand_back(w, tap, ring, full, empty);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) tot[e] += acc[e];
    wgmma::fence_operand(acc);
  }
}
''',
    "one_acc": _HEAD + '''#pragma unroll
  for (int e = 0; e < N / 2; ++e) tot[e] = 0.f;
  wgmma::fence_operand(tot);
#pragma unroll
  for (int j = 0; j < kK; ++j, ++tap) {''' + _ISSUE.replace("ACC", "tot").replace(
        "FIRST", "j == 0") + '''    wgmma::wait<1>();
    if (j > 0) {
      keep(a[(j - 1) & 1]);
      hand_back(w, tap - 1, ring, full, empty);
    }
  }
  wgmma::wait<0>();
  wgmma::fence_operand(tot);
  keep(a[(kK - 1) & 1]);
  hand_back(w, tap - 1, ring, full, empty);
}
''',
}

_TWO_WG = {"constexpr int kThreads = 384;": "constexpr int kThreads = 256;",
           "constexpr int kM = 192;": "constexpr int kM = 128;"}
_VARIANTS = {
    "kept": {},
    "two_wg": _TWO_WG,
    "two_acc": _TWO_WG,
    "group3": _TWO_WG,
    "one_acc": dict(_TWO_WG, **{"constexpr int kStages = 6;": "constexpr int kStages = 4;",
                               "constexpr int kLag = 2;": "constexpr int kLag = 0;",
                               "__launch_bounds__(kThreads, 1)": "__launch_bounds__(kThreads, 2)"}),
}


def variant_source(name: str) -> str:
    """The kept source with alternative ``name``'s substitutions."""
    with open(os.path.join(_HERE, "csrc", "tade_bf16.cu")) as f:
        src = f.read()
    for old, new in _VARIANTS[name].items():
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} is not in csrc/tade_bf16.cu")
        src = src.replace(old, new)
    if name in _CONVS:
        start = src.index("template <int N, int DD>\n__device__ __forceinline__ void conv9(")
        end = src.index("// The channel of accumulator column tile i")
        src = src[:start] + _KEEP + _CONVS[name] + "\n" + src[end:]
    return src


def _libraries(tmp: str) -> dict:
    """{name: ctypes library} of every alternative, compiled at once."""
    from parallelwavegan_tpu_torch.ops.kernels import build

    procs = {}
    for name in _VARIANTS:
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
        with open(cu, "w") as f:
            f.write(variant_source(name))
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for entry in ("tade1_bf16", "tade2_bf16"):
            getattr(lib, entry).argtypes = build._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _launcher(lib, half: int, x, c, x2, a, blk, gate: int, save: bool):
    """A function that launches K8a (half 1) or K8b of ``lib`` once, and
    the outputs it writes."""
    import torch

    from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td

    b, t, _ = x.shape
    sc, d = int(blk["scale"]), int(blk["dilation"])
    rows = t if half == 1 else sc * t
    wf, bias = td._fragments(blk, half, True), td._biases(blk, half)
    mean, rstd = td.stats_cuda(x if half == 1 else x2)
    out = {k: torch.empty(b, rows, 64, dtype=torch.bfloat16, device=x.device)
           for k in ("out", "a", "y", "ua")}
    s, tp = (torch.empty(b, rows, n, device=x.device) for n in (64, 128))
    sv = [out["y"].data_ptr(), s.data_ptr(), tp.data_ptr()] if save else [None] * 3
    o = None if save else out["out"].data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [wf.data_ptr(), *(v.data_ptr() for v in bias), *sv]
    if half == 1:
        args = (x.data_ptr(), c.data_ptr(), mean.data_ptr(), rstd.data_ptr(), o,
                out["a"].data_ptr(), *ptrs, b, t, gate, x.device.index or 0, stream)
        entry = lib.tade1_bf16
    else:
        ua = out["ua"].data_ptr() if save and sc == 2 else None
        args = (x.data_ptr(), x2.data_ptr(), a.data_ptr(), mean.data_ptr(), rstd.data_ptr(), o,
                out["a"].data_ptr(), *ptrs, ua, b, t, sc, d, gate, x.device.index or 0,
                stream)
        entry = lib.tade2_bf16

    def launch():
        if entry(*args) != 0:
            raise RuntimeError("launch refused")

    held = (wf, bias, mean, rstd, s, tp)  # alive while the launches run
    return launch, out, held


def _median_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_tade_bf16: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td

    root = os.path.abspath(os.path.join(_HERE, "..", "..", ".."))
    sys.path.insert(0, os.path.join(root, "tests"))
    import test_torch_port_cuda as card_tests

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = _libraries(tmp)
        worst = dict.fromkeys(libs, 0.0)
        same = dict.fromkeys(libs, True)
        cuda = torch.device("cuda")
        for case in card_tests.TADE_BF16_FORWARD_CASES:
            b, t, scale, dilation, gated, bias, wdtype = case
            blk, x, c, _, _, _ = card_tests._tade_bf16_case(cuda, b, t, scale, dilation, bias,
                                                            wdtype)
            gate = 0 if gated == "softmax" else 1
            with torch.no_grad():
                want1 = [v.contiguous() for v in td.tade1_reference_bf16(x, c, blk, gated)]
                x2, a = want1
                want2 = [v.contiguous() for v in td.tade2_reference_bf16(x, x2, a, blk, gated)]
                got = {}
                for name, lib in libs.items():
                    run1, out1, held1 = _launcher(lib, 1, x, c, x2, a, blk, gate, False)
                    run2, out2, held2 = _launcher(lib, 2, x, c, x2, a, blk, gate, False)
                    run1()
                    run2()
                    torch.cuda.synchronize()
                    got[name] = (out1["out"], out1["a"], out2["out"], out2["a"])
                    for g, w in zip(got[name], want1 + want2):
                        d = g.float() - w.float()
                        worst[name] = max(worst[name], float(
                            d.pow(2).mean().sqrt() / w.float().pow(2).mean().sqrt()))
                    same[name] &= all(torch.equal(p, q) for p, q in zip(got[name], got["kept"]))
        rs = np.random.RandomState(0)

        def randn(*shape, scale=1.0):
            return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to(cuda)

        ms = {name: dict.fromkeys(("K8a", "K8b", "K8a Save", "K8b Save"), 0.0) for name in libs}
        for t, scale in ((1408, 2), (2816, 2), (5632, 2), (11264, 2), (22528, 1)):
            blk = {"scale": scale, "dilation": 2}
            for key in td.WEIGHT_KEYS:
                cout = 64 if key.startswith("aux") else 128
                blk[f"{key}_w"] = randn(9, 64, cout, scale=1 / 24.0).to(torch.bfloat16)
                blk[f"{key}_b"] = randn(cout, scale=0.1)
            x, c = (randn(32, t, 64).to(torch.bfloat16) for _ in range(2))
            with torch.no_grad():
                x2, a = (v.contiguous() for v in td.tade1_reference_bf16(x, c, blk))
                for name, lib in libs.items():
                    for half in (1, 2):
                        for save in (False, True):
                            run, _, held = _launcher(lib, half, x, c, x2, a, blk, 0, save)
                            key = f"K8{'ab'[half - 1]}" + (" Save" if save else "")
                            ms[name][key] += _median_ms(run)
            torch.cuda.empty_cache()
    print(card)
    for name in libs:
        m = ms[name]
        print(f"{name}: K8a + K8b {m['K8a'] + m['K8b']:.3f} ms per G step (K8a {m['K8a']:.3f}, "
              f"K8b {m['K8b']:.3f}; Save {m['K8a Save']:.3f} + {m['K8b Save']:.3f}); worst "
              f"rms|diff| / rms|plain| at the card tests' forward cases {worst[name]:.3e} "
              f"(bound 1e-3); bit-equal to kept: {same[name]} on {card}")


if __name__ == "__main__":
    main()
