"""Device times of the MelGAN stack kernels K6 (forward) and K7 (backward)
on the card, by the public wrappers alone, so that two trees can be timed
in turns:

    python parallelwavegan_tpu_torch/ops/kernels/time_melgan.py [--root DIR]

DIR (default: this file's tree) is put first on sys.path, so its package
and its kernel sources are the ones timed (a parent commit unpacked with
``git archive``). Median of 10 of each call (CUDA events):

- K6 per 512-frame Multi-band MelGAN v2 decode (B=1): ``fused_melgan_stacks``
  on stage 1 (T = 16384, C = 96, 4 stacks) and stage 2 with the final conv
  (T = 32768, C = 48 -> 4), the full-width generator's weights from seed 0
  (``chip_smoke.py``'s ``V2_MB_GENERATOR``) as ``prepare_kernels`` keeps
  them (with their split, where the tree keeps one) and as each call
  gathers them (splitting per call), beside the plain version: each stage
  timed apart, and both stages' calls in one window as a decode makes
  them; the device time by kernel of each stage and the device time of
  one decode's K6 (torch.profiler); the host time of a stage-1 call
  (enqueue, without waiting for the card) with the split kept and
  gathering and splitting the weights per call; and the generator's
  forward at 512 frames plus PQMF synthesis, with the kernel and plain;
- K6 over MelGAN v1's three fused stages of one training forward (B=8; T
  = 6400, 12800, 25600 at C = 128, 64, 32, the last with the final conv
  to 1; 3 stacks at d = 1, 3, 9, reflect; the random weights of
  ``chip_smoke.py`` phase 17), splitting per call as the training forward
  does, beside its plain version;
- K7 (``melgan_stacks_backward``, K6's re-run included) at the same
  stages and weights, beside ``melgan_stacks_backward_reference``, per
  stage and summed over the three (one G step's backward), with the
  device time by kernel of one call per stage;
- where the tree has them, K6's and K7's bf16-resident modes (mixed
  precision: a bf16 input, the same weights) at the same stages, beside
  their bf16 plain versions (``melgan_stacks_reference_bf16``,
  ``melgan_stacks_backward_reference_bf16``), per stage and summed; the
  float32 times above are the float32 kernels' on the same shapes.

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
    kept only when they are plain numbers or bools (PyTorch's own kernels
    get "<...>")."""
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
    plain = re.fullmatch(r"(?:\d+|true|false)(?:, (?:\d+|true|false))*>", args)
    return f"{base}<{args}" if plain else f"{base}<...>"


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


def profile_by_kernel(fn, tries: int = 3) -> dict:
    """``by_kernel`` of one call of fn, after a traced warm-up call that is
    discarded (a profiler schedule): traced alone, a call that starts on an
    idle card loses its first few library kernels from the trace. A cycle
    that recorded no device time (seen about once in twenty) is run again,
    up to ``tries`` times; {} if none recorded any."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        split = {}
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: split.update(by_kernel(p))) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        split = {k: v for k, v in split.items() if not k.startswith("ProfilerStep")}
        if split:
            return split
    return {}


def _host_us(fn, reps: int = 50) -> float:
    """Median host time of one call of fn in microseconds, without waiting
    for the card (a synchronise every 10 calls keeps the queue short)."""
    import time

    import torch

    times = []
    for i in range(reps):
        if i % 10 == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _decode(out: dict, smoke, randn) -> None:
    """K6 per MB-MelGAN v2 decode, and the v2 forward + PQMF."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        fused_melgan_stacks,
        melgan_stacks_reference,
    )
    from parallelwavegan_tpu_torch.ops.pqmf import PQMF

    def v2(**flags):
        gen = get_model_class("MelGANGenerator")(
            **smoke.V2_MB_GENERATOR, **flags, device="cuda",
            generator=torch.Generator().manual_seed(smoke.SEED))
        gen.remove_weight_norm()
        gen.eval()
        gen.prepare_kernels()
        return gen

    gen, plain_gen = v2(use_pallas_stacks=True), v2()
    stages = {"stage 1 B=1 T=16384 C=96": (randn(1, 16384, 96, scale=0.5), 1),
              "stage 2 B=1 T=32768 C=48 + final": (randn(1, 32768, 48, scale=0.5), 2)}
    res = {}
    with torch.inference_mode():
        for name, (x, i) in stages.items():
            kept, per_call = gen._kernel_cache[i], gen.stage_weights(i)

            def run(w, fn=fused_melgan_stacks, x=x):
                return fn(x, w["stacks"], final=w["final"], slope=gen.slope,
                          pad_mode=gen.pad_mode)

            res[name] = {
                "ms": _median_ms(lambda: run(kept)),
                "split_per_call_ms": _median_ms(lambda: run(per_call)),
                "plain_ms": _median_ms(lambda: run(per_call, melgan_stacks_reference)),
                "by_kernel": profile_by_kernel(lambda: run(kept))}

        def decode(kept=True, fn=fused_melgan_stacks):  # both calls, as a decode
            for x, i in stages.values():
                w = gen._kernel_cache[i] if kept else gen.stage_weights(i)
                fn(x, w["stacks"], final=w["final"], slope=gen.slope,
                   pad_mode=gen.pad_mode)

        out["k6_decode_one_window_ms"] = _median_ms(decode)
        out["k6_decode_one_window_split_per_call_ms"] = _median_ms(
            lambda: decode(kept=False))
        out["k6_decode_one_window_plain_ms"] = _median_ms(
            lambda: decode(kept=False, fn=melgan_stacks_reference))
        out["k6_decode_device_ms"] = sum(
            ms for ms, _ in profile_by_kernel(decode).values())
        x1, w1 = stages["stage 1 B=1 T=16384 C=96"][0], gen._kernel_cache[1]
        out["k6_stage1_host_us"] = {
            "split kept": _host_us(lambda: fused_melgan_stacks(x1, w1["stacks"])),
            "splitting per call": _host_us(
                lambda: fused_melgan_stacks(x1, gen.stage_weights(1)["stacks"]))}
        pqmf = PQMF(4, taps=62, cutoff_ratio=0.15, beta=9.0)
        mel = torch.randn(1, 80, 512, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(smoke.SEED))
        out["v2_forward_pqmf_ms"] = _median_ms(
            lambda: pqmf.synthesis(gen(mel).transpose(1, 2)))
        out["v2_forward_pqmf_plain_ms"] = _median_ms(
            lambda: pqmf.synthesis(plain_gen(mel).transpose(1, 2)))
    out["k6_decode"] = res
    for key in ("ms", "split_per_call_ms", "plain_ms"):
        out[f"k6_decode_{key}"] = sum(s[key] for s in res.values())


def _training(out: dict, smoke, randn) -> None:
    """K6 over one MelGAN v1 training forward's stages, and K7 per G step."""
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        fused_melgan_stacks,
        melgan_stacks_reference,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        melgan_stacks_backward,
        melgan_stacks_backward_reference,
    )

    try:  # the bf16 modes, where the tree has them
        from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
            melgan_stacks_reference_bf16,
        )
        from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
            melgan_stacks_backward_reference_bf16,
        )
    except ImportError:
        melgan_stacks_reference_bf16 = None
    fwd16, bwd16 = {}, {}

    gp = smoke.V1_MELGAN_CONFIG["generator_params"]
    b, t = smoke.V1_MELGAN_CONFIG["batch_size"], smoke.V1_MELGAN_CONFIG["batch_max_steps"]
    dils = [gp["stack_kernel_size"] ** j for j in range(gp["stacks"])]
    fwd, bwd = {}, {}
    for i in (1, 2, 3):
        c, ti = 512 >> (i + 1), t >> (3 - i)
        stacks = [{"wd": randn(3, c, c, scale=(3 * c) ** -0.5), "bd": randn(c, scale=0.1),
                   "w1": randn(1, c, c, scale=c ** -0.5), "b1": randn(c, scale=0.1),
                   "ws": randn(1, c, c, scale=c ** -0.5), "bs": randn(c, scale=0.1),
                   "dilation": d} for d in dils]
        fin = (randn(7, c, 1, scale=(7 * c) ** -0.5), randn(1, scale=0.1)) if i == 3 else None
        x = randn(b, ti, c)
        dy = randn(b, ti, 1 if fin else c, scale=1e-3)
        name = f"stage {i} B={b} T={ti} C={c}" + (" + final" if fin else "")
        with torch.inference_mode():
            fwd[name] = {
                "ms": _median_ms(lambda: fused_melgan_stacks(x, stacks, final=fin)),
                "plain_ms": _median_ms(lambda: melgan_stacks_reference(x, stacks,
                                                                       final=fin)),
                "by_kernel": profile_by_kernel(lambda: fused_melgan_stacks(x, stacks, final=fin))}
        bwd[name] = {
            "ms": _median_ms(lambda: melgan_stacks_backward(x, stacks, fin, 0.2,
                                                            "reflect", dy)),
            "plain_ms": _median_ms(lambda: melgan_stacks_backward_reference(
                x, stacks, fin, 0.2, "reflect", dy)),
            "by_kernel": profile_by_kernel(lambda: melgan_stacks_backward(x, stacks, fin, 0.2,
                                                                 "reflect", dy))}
        if melgan_stacks_reference_bf16 is None:
            continue
        xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
        with torch.inference_mode():
            fwd16[name] = {
                "ms": _median_ms(lambda: fused_melgan_stacks(xb, stacks, final=fin)),
                "plain_ms": _median_ms(lambda: melgan_stacks_reference_bf16(
                    xb, stacks, final=fin))}
        bwd16[name] = {
            "ms": _median_ms(lambda: melgan_stacks_backward(xb, stacks, fin, 0.2,
                                                            "reflect", dyb)),
            "plain_ms": _median_ms(lambda: melgan_stacks_backward_reference_bf16(
                xb, stacks, fin, 0.2, "reflect", dyb))}
    if fwd16:
        out["bf16"] = {
            "k6_train_forward": fwd16, "stages": bwd16,
            "k6_train_forward_ms": sum(v["ms"] for v in fwd16.values()),
            "k6_train_forward_plain_ms": sum(v["plain_ms"] for v in fwd16.values()),
            "g_step_ms": sum(v["ms"] for v in bwd16.values()),
            "g_step_plain_ms": sum(v["plain_ms"] for v in bwd16.values())}
    out["k6_train_forward"] = fwd
    out["k6_train_forward_ms"] = sum(s["ms"] for s in fwd.values())
    out["k6_train_forward_plain_ms"] = sum(s["plain_ms"] for s in fwd.values())
    out["stages"] = bwd
    out["g_step_ms"] = sum(s["ms"] for s in bwd.values())
    out["g_step_plain_ms"] = sum(s["plain_ms"] for s in bwd.values())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "..")))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as smoke
    import parallelwavegan_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("time_melgan: needs a CUDA device")
    if not parallelwavegan_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"time_melgan: imported {parallelwavegan_tpu_torch.__file__}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    rs = np.random.RandomState(smoke.SEED)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).cuda()

    out = {"root": root}
    _decode(out, smoke, randn)
    _training(out, smoke, randn)
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
