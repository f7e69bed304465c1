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
  does, beside its plain version, and MB-MelGAN v2's two (B=64; T = 2048,
  4096 at C = 96, 48, the last with the final conv to 4; d = 1, 3, 9, 27);
- K7 (``melgan_stacks_backward``, K6's re-run included) at the same
  stages and weights, beside ``melgan_stacks_backward_reference`` at v1's,
  per stage and summed (one G step's backward), with the device time by
  kernel of one call per stage;
- K6's and K7's bf16-resident modes (mixed precision: a bf16 input, the
  same weights) at the same stages, beside their bf16 plain versions
  (``melgan_stacks_reference_bf16``, ``melgan_stacks_backward_reference_bf16``),
  per stage and summed, K7 reading the forward's weight layout as
  training does, their device time by part (``bf16_parts``: K6's
  kernels, K7's kernels, the reduce kernels, the weight layout, glue) and
  their host time a call (enqueue, ``_host_us``; the weight layout's
  apart).

Prints the card (``nvidia-smi``) and one JSON line of the times in ms.
"""

from __future__ import annotations

import argparse
import json
import math
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


# K6's and K7's bf16 parts by the kernels' names in this tree and in a
# tree before it (csrc/melgan_stack.cu's and csrc/melgan_stack_bwd.cu's
# bf16 instantiations); any other kernel is glue
BF16_PARTS = {
    "K6 kernels": ("stack_bf16_kernel", "outconv_bf16_kernel", "stack_tc_kernel",
                   "outconv_kernel"),
    "K7 kernels": ("dz_bf16_kernel", "dx_bf16_kernel", "wgrad_bf16_kernel",
                   "outconv_bwd_bf16_kernel", "dz_kernel", "dx_kernel", "wgrad_kernel",
                   "outconv_bwd_kernel"),
    "reduce": ("wgrad_reduce_bf16_kernel", "colsum_kernel", "slab_sum_kernel",
               "wgrad_reduce_kernel")}


def bf16_parts(fn, layout=None, reps: int = 5) -> dict:
    """{part: device ms} of one call of fn (K6 or K7 in the bf16 mode) under
    torch.profiler: the parts of ``BF16_PARTS`` (in K7 "K6 kernels" is its
    re-run), "weight layout" (``layout``, the weights' bf16 layout that a
    training forward makes, traced alone over ``reps`` calls and divided;
    0 without it) and "glue", the rest of fn's device time (in a tree
    before this one K7 laid out its own weights in every call: glue)."""
    out = dict.fromkeys([*BF16_PARTS, "weight layout", "glue"], 0.0)
    prof = profile_by_kernel(fn)
    for name, (ms, _) in prof.items():
        part = next((part for part, names in BF16_PARTS.items()
                     if name.split("<")[0] in names), "glue")
        out[part] += ms
    if layout is not None:
        traced = profile_by_kernel(lambda: [layout() for _ in range(reps)])
        out["weight layout"] = sum(ms for ms, _ in traced.values()) / reps
        out["glue"] = max(0.0, out["glue"] - out["weight layout"])
    return out


def _stages(smoke, randn) -> dict:
    """{name: (x, stacks, final, dy)} of MelGAN v1's three fused training
    stages (B=8; T = 6400, 12800, 25600 at C = 128, 64, 32, the last with
    the final conv to 1; d = 1, 3, 9) and MB-MelGAN v2's two (B=64; T =
    2048, 4096 at C = 96, 48, the last with the final conv to 4; d = 1, 3,
    9, 27), random weights as in ``chip_smoke.py`` phase 17, float32."""
    out = {}
    for cfg, label in ((smoke.V1_MELGAN_CONFIG, "v1"), (smoke.V2_MB_CONFIG, "v2")):
        gp = cfg["generator_params"]
        b, frames = cfg["batch_size"], cfg["batch_max_steps"] // cfg["hop_size"]
        dils = [gp["stack_kernel_size"] ** j for j in range(gp["stacks"])]
        n = len(gp["upsample_scales"])
        for i in range(1, n) if label == "v1" else range(n - 2, n):
            c = gp["channels"] >> (i + 1)
            t = frames * math.prod(gp["upsample_scales"][:i + 1])
            stacks = [{"wd": randn(3, c, c, scale=(3 * c) ** -0.5), "bd": randn(c, scale=0.1),
                       "w1": randn(1, c, c, scale=c ** -0.5), "b1": randn(c, scale=0.1),
                       "ws": randn(1, c, c, scale=c ** -0.5), "bs": randn(c, scale=0.1),
                       "dilation": d} for d in dils]
            last = i == n - 1
            out_ch = gp["out_channels"]
            fin = ((randn(7, c, out_ch, scale=(7 * c) ** -0.5), randn(out_ch, scale=0.1))
                   if last else None)
            x = randn(b, t, c)
            dy = randn(b, t, out_ch if last else c, scale=1e-3)
            name = f"{label} stage {i} B={b} T={t} C={c}" + (" + final" if last else "")
            out[name] = (x, stacks, fin, dy)
    return out


def _training(out: dict, smoke, randn) -> None:
    """K6 over one MelGAN v1 training forward's stages and K7 per G step, in
    float32 and in the bf16 mode; both modes at MB-MelGAN v2's stages too."""
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        fused_melgan_stacks,
        kernel_weights_bf16,
        melgan_stacks_reference,
        melgan_stacks_reference_bf16,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        melgan_stacks_backward,
        melgan_stacks_backward_reference,
        melgan_stacks_backward_reference_bf16,
    )

    fwd, bwd, fwd16, bwd16 = {}, {}, {}, {}
    for name, (x, stacks, fin, dy) in _stages(smoke, randn).items():
        with torch.inference_mode():
            fwd[name] = {
                "ms": _median_ms(lambda: fused_melgan_stacks(x, stacks, final=fin)),
                "by_kernel": profile_by_kernel(lambda: fused_melgan_stacks(x, stacks, final=fin))}
            if name.startswith("v1"):
                fwd[name]["plain_ms"] = _median_ms(
                    lambda: melgan_stacks_reference(x, stacks, final=fin))
        bwd[name] = {
            "ms": _median_ms(lambda: melgan_stacks_backward(x, stacks, fin, 0.2,
                                                            "reflect", dy)),
            "by_kernel": profile_by_kernel(lambda: melgan_stacks_backward(x, stacks, fin, 0.2,
                                                                 "reflect", dy))}
        if name.startswith("v1"):
            bwd[name]["plain_ms"] = _median_ms(lambda: melgan_stacks_backward_reference(
                x, stacks, fin, 0.2, "reflect", dy))
        # the bf16 mode: the forward lays the weights out (as a training
        # forward does) and K7 reads the forward's layout
        xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
        split = kernel_weights_bf16(stacks)
        with torch.inference_mode():
            fwd16[name] = {
                "ms": _median_ms(lambda: fused_melgan_stacks(xb, stacks, final=fin)),
                "plain_ms": _median_ms(lambda: melgan_stacks_reference_bf16(
                    xb, stacks, final=fin)),
                "parts": bf16_parts(lambda: fused_melgan_stacks(xb, stacks, final=fin),
                                    lambda: kernel_weights_bf16(stacks)),
                "host_us": _host_us(lambda: fused_melgan_stacks(xb, stacks, final=fin)),
                "layout_host_us": _host_us(lambda: kernel_weights_bf16(stacks))}

        def k7_bf16():
            return melgan_stacks_backward(xb, stacks, fin, 0.2, "reflect", dyb, split)

        bwd16[name] = {
            "ms": _median_ms(k7_bf16),
            "plain_ms": _median_ms(lambda: melgan_stacks_backward_reference_bf16(
                xb, stacks, fin, 0.2, "reflect", dyb)),
            "parts": bf16_parts(k7_bf16),
            "host_us": _host_us(k7_bf16, reps=20)}
    for label in ("v1", "v2"):
        for key, res in (("k6_train_forward", fwd), ("k7_g_step", bwd),
                         ("bf16_k6_train_forward", fwd16), ("bf16_k7_g_step", bwd16)):
            rows = {k: v for k, v in res.items() if k.startswith(label)}
            out[f"{label}_{key}"] = rows
            out[f"{label}_{key}_ms"] = sum(v["ms"] for v in rows.values())
            if all("plain_ms" in v for v in rows.values()):
                out[f"{label}_{key}_plain_ms"] = sum(v["plain_ms"] for v in rows.values())
            if key.startswith("bf16"):
                out[f"{label}_{key}_parts"] = {
                    part: sum(v["parts"][part] for v in rows.values())
                    for part in next(iter(rows.values()))["parts"]}


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
