"""Device times of the WaveNet layer kernel K3/K5 on the card, by the public
wrappers alone, so that two trees can be timed in turns:

    python parallelwavegan_tpu_torch/ops/kernels/time_wavenet.py [--root DIR]

DIR (default: this file's tree) is put first on sys.path, so its package
and its kernel sources are the ones timed (a parent commit unpacked with
``git archive``). With the Parallel WaveGAN v1 generator's weights from
seed 0 (the first cycle: 10 layers, d = 1 .. 512) and random inputs:

- K3 per v1 cycle (``fused_wavenet_stack``) at B=1, T=131072 (a 512-frame
  decode) with the weights that ``prepare_kernels`` keeps (their split,
  where the tree keeps one), and with each call splitting its weights;
  and at B=6, T=25600 (a training batch; a training forward splits its
  weights once per call);
- K3's bf16-resident mode per v1 cycle at B=1, T=131072 (``compute_dtype=
  torch.bfloat16`` on the bf16 weights that decode keeps for
  ``pallas_stack_bf16``: ``with_tiles_bf16``, or the older trees'
  ``with_fragments_bf16``) beside its bf16 plain version, where the tree
  has the mode (null otherwise), to hold beside the float32 K3 above; with
  its device time by part (torch.profiler, ``bf16_parts``: each layer's
  kernel, and the casts and copies around them) and its host time a call
  (the enqueue, without waiting for the card: ``time_melgan._host_us``);
  with ``--k3-bf16`` this alone is timed;
- K5, one layer at d=1, B=1, T=131072 (``fused_gated_resblock`` on the
  block weights of ``prepare_kernels`` with ``use_pallas_kernels``);
- ``wavenet_stack_backward`` per v1 cycle at B=6, T=25600 as two 5-layer
  calls (K4, K3's re-run of the layer inputs included; the split that the
  tree's training forward keeps, where it keeps one);

each the median of 10 calls (CUDA events) beside its plain version, and
the device time by kernel of one call of each (torch.profiler). Prints the
card (``nvidia-smi``) and one JSON line of the times in ms.

With ``--k4-margins`` it times nothing and prints instead, for the K4
cases of DIR's ``tests/test_torch_port_cuda.py``
(``test_wavenet_backward_matches_plain_version``), each gradient's worst
|kernel - plain| / (2e-4 + 1e-3 |plain|) (the test fails above 1) and
the max error of K3's re-run layer inputs against the plain stack.
"""

from __future__ import annotations

import argparse
import json
import os
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


# (C, Ca, B, T, bias, dilations) of test_wavenet_backward_matches_plain_version
K4_CASES = [(64, 80, 2, 1000, True, (32, 64, 128, 256, 512)),
            (64, 10, 1, 777, True, (1, 2, 4, 8, 16)), (16, 80, 3, 300, True, (1, 2, 4)),
            (64, 80, 1, 1100, False, (1, 8, 64, 512)), (64, 80, 2, 1023, True, (1, 16, 256)),
            (64, 80, 1, 1025, True, (2, 32, 512))]


def _k4_margins(root: str) -> None:
    import importlib.util

    import torch

    from parallelwavegan_tpu_torch.ops.kernels import wavenet as wn
    from parallelwavegan_tpu_torch.ops.kernels.wavenet_train import (
        wavenet_stack_backward,
        wavenet_stack_backward_reference,
    )

    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "gpu_tests", os.path.join(root, "tests", "test_torch_port_cuda.py"))
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    for ch, ca, b, t, bias, dils in K4_CASES:
        w, x, c, dxo, dsk = tests._k4_case(torch.device("cuda"), ch, ca, b, t, bias,
                                           n_layers=len(dils))
        dx, dc, dw = wavenet_stack_backward(x, c, w, dils, dxo, dsk)
        rdx, rdc, rdw = wavenet_stack_backward_reference(x, c, w, dils, dxo, dsk)
        got = [("dx", dx, rdx), ("dc", dc, rdc)] + [(k, dw[k], rdw[k]) for k in wn.WEIGHT_KEYS]
        margins = {name: round(float(((g - r).abs() / (2e-4 + 1e-3 * r.abs())).max()), 3)
                   for name, g, r in got}
        with torch.inference_mode():
            xs, ref, errs = [x], x, []
            wn._run_layers(x, c, w, dils[:-1], False, wn.fused_wavenet_stack, xs)
            for layer, d in enumerate(dils[:-1]):
                ref, _ = wn.gated_resblock_reference(
                    ref, c, *(w[k][layer] for k in wn.WEIGHT_KEYS), dilation=d, causal=False)
                errs.append(float((xs[layer + 1] - ref).abs().max()))
        print(json.dumps({"root": root, "case": [ch, ca, b, t, bias], "margins": margins,
                          "layer_input_max_err": errs}))


def kernel_trace(fn, tries: int = 3) -> list:
    """[(short kernel name, device µs)] of one call of fn in launch order,
    from torch.profiler's trace, after a traced warm-up call that is
    discarded (as ``time_melgan.profile_by_kernel``); a call whose trace
    holds no kernel is run again, up to ``tries`` times."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from parallelwavegan_tpu_torch.ops.kernels.time_melgan import short_name

    for _ in range(tries):
        events = []

        def keep(prof):
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events.extend(e for e in json.load(f)["traceEvents"]
                                  if e.get("cat") == "kernel")

        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=keep) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        if events:
            break
    return [(short_name(e["name"]), float(e["dur"]))
            for e in sorted(events, key=lambda e: e["ts"])]


def bf16_parts(trace: list) -> dict:
    """A bf16 cycle's device time by part from ``kernel_trace``: each
    layer's kernel in launch order (``wavenet_bf16_kernel``, or the older
    trees' ``wavenet_layer_kernel``), their sum, and the rest (x's and c's
    casts to bf16, the outputs' casts back), in ms."""
    layers = [us for name, us in trace if name.startswith("wavenet_")]
    return {"layer_us": layers, "layers_ms": sum(layers) / 1e3,
            "other_ms": sum(us for name, us in trace if not name.startswith("wavenet_")) / 1e3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "..")))
    ap.add_argument("--k4-margins", action="store_true",
                    help="print K4's GPU-test margins instead of timing")
    ap.add_argument("--k3-bf16", action="store_true",
                    help="time K3's bf16-resident mode alone")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if args.k4_margins:
        _k4_margins(root)
        return
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import parallelwavegan_tpu_torch
    from chip_smoke import SEED, V1_PWG_GENERATOR
    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.kernels import wavenet as wn
    from parallelwavegan_tpu_torch.ops.kernels.time_melgan import _host_us, by_kernel
    from parallelwavegan_tpu_torch.ops.kernels.wavenet_train import (
        wavenet_stack_backward,
        wavenet_stack_backward_reference,
    )

    if not torch.cuda.is_available():
        raise SystemExit("time_wavenet: needs a CUDA device")
    if not parallelwavegan_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"time_wavenet: imported {parallelwavegan_tpu_torch.__file__}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]

    def generator(**flags):
        gen = get_model_class("ParallelWaveGANGenerator")(
            **dict(V1_PWG_GENERATOR, **flags), device="cuda",
            generator=torch.Generator().manual_seed(SEED))
        gen.remove_weight_norm()
        gen.eval()
        gen.prepare_kernels()
        return gen

    n = V1_PWG_GENERATOR["layers"] // V1_PWG_GENERATOR["stacks"]
    all_w, all_d = generator()._kernel_cache["stack"]
    kept = {k: v[:n] for k, v in all_w.items()}  # the first cycle, its split if kept
    plain_w = {k: kept[k] for k in wn.WEIGHT_KEYS}
    dils = tuple(all_d[:n])
    block = generator(use_pallas_kernels=True, use_pallas_stack_train=False)
    bw = block._kernel_cache["blocks"][0]
    bkw = {"fragments": bw["frag"]} if "frag" in bw else {}
    rs = np.random.RandomState(SEED)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).cuda()

    def timed(fn, plain):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {"ms": _median_ms(fn), "plain_ms": _median_ms(plain),
                "by_kernel": by_kernel(prof)}

    out = {"root": root}
    with torch.inference_mode():
        x, c = randn(1, 131072, 64), randn(1, 131072, 80)
        out["k3_bf16_decode"] = None
        if not args.k3_bf16:
            out["k3_decode"] = timed(lambda: wn.fused_wavenet_stack(x, c, kept, dils),
                                     lambda: wn.wavenet_stack_reference(x, c, plain_w, dils))
            out["k3_decode_split_per_call"] = timed(
                lambda: wn.fused_wavenet_stack(x, c, plain_w, dils),
                lambda: wn.wavenet_stack_reference(x, c, plain_w, dils))
        if hasattr(wn, "wavenet_stack_reference_bf16"):
            keep = getattr(wn, "with_tiles_bf16", None) or wn.with_fragments_bf16
            kept_bf16 = keep(plain_w)

            def bf16_cycle():
                return wn.fused_wavenet_stack(x, c, kept_bf16, dils, torch.bfloat16)

            rec = timed(bf16_cycle,
                        lambda: wn.wavenet_stack_reference_bf16(x, c, plain_w, dils))
            rec["bf16_parts"] = bf16_parts(kernel_trace(bf16_cycle))
            rec["host_us"] = _host_us(bf16_cycle)
            out["k3_bf16_decode"] = rec
        if args.k3_bf16:
            print(card)
            print(json.dumps(out))
            return
        args = [bw[k] for k in wn.WEIGHT_KEYS]
        out["k5_layer_d1"] = timed(
            lambda: wn.fused_gated_resblock(x, c, *args, dilation=1, **bkw),
            lambda: wn.gated_resblock_reference(x, c, *args, dilation=1, causal=False))
    del x, c
    x, c = randn(6, 25600, 64), randn(6, 25600, 80)  # not inference tensors
    with torch.inference_mode():
        out["k3_train"] = timed(lambda: wn.fused_wavenet_stack(x, c, plain_w, dils),
                                lambda: wn.wavenet_stack_reference(x, c, plain_w, dils))
    dxo, dsk = randn(6, 25600, 64, scale=1e-3), randn(6, 25600, 64, scale=1e-3)
    halves = []
    for s in (0, n // 2):
        w = {k: v[s:s + n // 2] for k, v in plain_w.items()}
        if hasattr(wn, "with_fragments"):  # what the tree's training forward keeps
            w = wn.with_fragments(w)
        halves.append((w, dils[s:s + n // 2]))

    def backward(fn):
        for w, d in halves:
            fn(x, c, w, d, dxo, dsk)

    out["k4_cycle"] = timed(lambda: backward(wavenet_stack_backward),
                            lambda: backward(wavenet_stack_backward_reference))
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
