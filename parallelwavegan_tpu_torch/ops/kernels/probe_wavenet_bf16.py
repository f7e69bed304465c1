"""Where the time of K3's bf16-resident kernel (csrc/wavenet_bf16.cu) goes,
phase by phase, on the card.

    python -m parallelwavegan_tpu_torch.ops.kernels.probe_wavenet_bf16 --clocks

Every source is compiled with MELBF_CLOCKS defined (thread 0 of each block,
in its first warpgroup, adds the clock64 cycles between the kernel's stamps
into melbf_clocks, phase by phase; csrc/melgan_bf16.cuh) into a library of
its own, which then stands in for the built one. One Parallel WaveGAN v1
cycle (the generator's first 10 layers from ``chip_smoke.SEED``, d = 1 ..
512, B=1, T=131072, random inputs) runs layer by layer, each layer once to
warm and once counted, and each layer's cycles are printed per phase: the
share of the counted cycles, and the cycles per tile of the first
warpgroup (64 rows) or, for the prologue, per block.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

# csrc/wavenet_bf16.cu's stamps: the phase that ends at each
PHASES = ("wait for the stage", "gate products", "gate", "[skip | res] product",
          "epilogue", "prologue")


def clocks() -> int:
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.kernels import build
    from parallelwavegan_tpu_torch.ops.kernels import wavenet as wn

    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
    sys.path.insert(0, root)
    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("probe_wavenet_bf16: needs a CUDA device")
        return 2
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
        reader = lib._lib.wavenet_stack_bf16_clocks
        reader.argtypes, reader.restype = [ctypes.c_void_p], ctypes.c_int
        buf = np.zeros((4, 1024, 8), dtype=np.uint64)

        def read():
            if reader(buf.ctypes.data):
                raise RuntimeError("reading the clocks failed")
            return buf[0].sum(0).astype(np.float64)

        gen = get_model_class("ParallelWaveGANGenerator")(
            **dict(smoke.V1_PWG_GENERATOR, use_pallas_stack_train=False,
                   use_pallas_stack=True, pallas_stack_bf16=True),
            device="cuda", generator=torch.Generator().manual_seed(smoke.SEED))
        gen.remove_weight_norm()
        gen.eval()
        gen.prepare_kernels()  # decode's bf16 tiles
        n = smoke.V1_PWG_GENERATOR["layers"] // smoke.V1_PWG_GENERATOR["stacks"]
        all_w, all_d = gen._kernel_cache["stack"]
        weights, dils = {k: v[:n] for k, v in all_w.items()}, tuple(all_d[:n])
        rs = np.random.RandomState(smoke.SEED)
        b, t = 1, 131072
        x = torch.from_numpy(rs.randn(b, t, 64).astype(np.float32)).cuda()
        c = torch.from_numpy(rs.randn(b, t, 80).astype(np.float32)).cuda()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tiles = b * -(-t // 64)
        with torch.inference_mode():
            for li, d in enumerate(dils):
                wl = {k: v[li:li + 1] for k, v in weights.items()}
                wn.fused_wavenet_stack(x, c, wl, (d,), torch.bfloat16)
                torch.cuda.synchronize()
                read()
                wn.fused_wavenet_stack(x, c, wl, (d,), torch.bfloat16)
                torch.cuda.synchronize()
                per = read()[:len(PHASES)]
                blocks = min(sms, -(-tiles // 2))
                per_unit = [v / (blocks if ph == "prologue" else -(-tiles // 2))
                            for ph, v in zip(PHASES, per)]
                print(f"layer {li} (d={d}): " + ", ".join(
                    f"{ph} {v / per.sum():.1%} ({u:.0f} cycles a "
                    f"{'block' if ph == 'prologue' else 'tile'})"
                    for ph, v, u in zip(PHASES, per, per_unit)) + f" on {card}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clocks", action="store_true", required=True,
                    help="where the kernel's time goes (the only probe)")
    ap.parse_args(argv)
    return clocks()


if __name__ == "__main__":
    sys.exit(main())
