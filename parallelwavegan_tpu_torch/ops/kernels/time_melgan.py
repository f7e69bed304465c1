"""Device times of the MelGAN stack backward K7 on the card, by the public
wrappers alone, so that two trees can be timed in turns:

    python parallelwavegan_tpu_torch/ops/kernels/time_melgan.py [--root DIR]

DIR (default: this file's tree) is put first on sys.path, so its package
and its kernel sources are the ones timed (a parent commit unpacked with
``git archive``). At MelGAN v1's three fused stages of one G step's
backward (B=8; T = 6400, 12800, 25600 at C = 128, 64, 32, the last with
the final conv to 1; 3 stacks at d = 1, 3, 9, reflect; the random weights
of ``chip_smoke.py`` phase 17), as that phase takes them:

- ``melgan_stacks_backward`` (K6's re-run included) and its plain version
  ``melgan_stacks_backward_reference``, median of 10 of each call (CUDA
  events), per stage and summed over the three;
- the device time by kernel of one call per stage (torch.profiler).

Prints the card (``nvidia-smi``) and one JSON line of the times in ms.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys


def _median_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def short_name(key: str) -> str:
    """A profiler kernel name without return type, namespaces and
    parameters: "void (anonymous namespace)::dz_kernel<128>((anonymous
    namespace)::StackArgs)" -> "dz_kernel<128>"; template arguments are
    kept only when they are plain numbers (PyTorch's own kernels get
    "<...>")."""
    name = re.sub(r"^void ", "", key.replace("(anonymous namespace)::", ""))
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    base, _, args = name.partition("<")
    base = base.split("::")[-1]
    if not args:
        return base
    return f"{base}<{args}" if re.fullmatch(r"[\d, ]+>", args) else f"{base}<...>"


def by_kernel(prof) -> dict:
    """{short kernel name: [device ms, launches]} of a torch.profiler run."""
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        if us > 0:
            part = split.setdefault(short_name(ev.key), [0.0, 0])
            part[0] += us / 1e3
            part[1] += ev.count
    return split


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "..")))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import parallelwavegan_tpu_torch
    from chip_smoke import SEED, V1_MELGAN_CONFIG
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        melgan_stacks_backward,
        melgan_stacks_backward_reference,
    )

    if not torch.cuda.is_available():
        raise SystemExit("time_melgan: needs a CUDA device")
    if not parallelwavegan_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"time_melgan: imported {parallelwavegan_tpu_torch.__file__}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    rs = np.random.RandomState(SEED)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).cuda()

    gp = V1_MELGAN_CONFIG["generator_params"]
    b, t = V1_MELGAN_CONFIG["batch_size"], V1_MELGAN_CONFIG["batch_max_steps"]
    dils = [gp["stack_kernel_size"] ** j for j in range(gp["stacks"])]
    out = {"root": root, "stages": {}}
    for i in (1, 2, 3):
        c, ti = 512 >> (i + 1), t >> (3 - i)
        stacks = [{"wd": randn(3, c, c, scale=(3 * c) ** -0.5), "bd": randn(c, scale=0.1),
                   "w1": randn(1, c, c, scale=c ** -0.5), "b1": randn(c, scale=0.1),
                   "ws": randn(1, c, c, scale=c ** -0.5), "bs": randn(c, scale=0.1),
                   "dilation": d} for d in dils]
        fin = (randn(7, c, 1, scale=(7 * c) ** -0.5), randn(1, scale=0.1)) if i == 3 else None
        x = randn(b, ti, c)
        dy = randn(b, ti, 1 if fin else c, scale=1e-3)
        ms = _median_ms(lambda: melgan_stacks_backward(x, stacks, fin, 0.2, "reflect", dy))
        plain = _median_ms(lambda: melgan_stacks_backward_reference(
            x, stacks, fin, 0.2, "reflect", dy))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            melgan_stacks_backward(x, stacks, fin, 0.2, "reflect", dy)
            torch.cuda.synchronize()
        out["stages"][f"stage {i} B={b} T={ti} C={c}" + (" + final" if fin else "")] = {
            "ms": ms, "plain_ms": plain, "by_kernel": by_kernel(prof)}
    out["g_step_ms"] = sum(s["ms"] for s in out["stages"].values())
    out["g_step_plain_ms"] = sum(s["plain_ms"] for s in out["stages"].values())
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
