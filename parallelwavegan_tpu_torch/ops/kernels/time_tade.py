"""Device times of the forward TADE kernels K8a and K8b on the card, by the
public wrappers alone, so that two trees can be timed in turns:

    python parallelwavegan_tpu_torch/ops/kernels/time_tade.py [--root DIR]

DIR (default: this file's tree) is put first on sys.path, so its package
and its kernel sources are the ones timed (a parent commit unpacked with
``git archive``). Three measurements, as ``chip_smoke.py`` phases 11, 20 and 28
take them:

- decode: K8a and K8b (``tade1_cuda``, ``tade2_cuda``, the instance-norm
  statistics included) at StyleMelGAN v1's blocks 3-8 of a 512-frame
  decode (B=1, T = 5632 .. 180224), weights from ``prepare_kernels``;
  median of 10 of each call (CUDA events), summed over the blocks; and
  the same with each call splitting its weights (the blocks without the
  split that ``prepare_kernels`` keeps, where a tree keeps one);
- re-run: K8's re-runs inside K9 (``tade1_kernel`` and ``tade2_kernel``
  device time under torch.profiler) in one G step's backward of blocks
  4-8 at B=32 (T = 1408 .. 22528); median of 3;
- bf16 (a tree with the bf16-resident modes, else left out): one G step's
  K8a, K8b (``tade1_cuda``, ``tade2_cuda``) and K9a, K9b
  (``tade1_backward_cuda``, ``tade2_backward_cuda``) over blocks 4-8 at
  B=32 on bf16 inputs and weights, beside the float32 kernels on the same
  values and the bf16 plain versions (``tade1_reference_bf16``,
  ``tade2_reference_bf16``, ``tade1_backward_reference``,
  ``tade2_backward_reference`` on bf16); medians of 10 (CUDA events), the
  weights split per call as training splits them; K9a and K9b bf16 by
  part (``k9_parts``: the re-run, the chain, the weight gradients, their
  reduce and the glue between them, device time under torch.profiler),
  whichever tree's kernel names they run; and K8a and K8b bf16, forward
  and the Save re-run inside K9 (``tade1_rerun_cuda``, ``tade2_rerun_cuda``
  on the statistics K9 computes), by part (``k8_parts``: the kernel, the
  statistics, the weights' layout, the glue).

Prints the card (``nvidia-smi``) and one JSON line of the times in ms.
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


# K8's bf16 kernels, by their names in this tree (csrc/tade_bf16.cu) and in
# a tree before it (csrc/tade.cu's bf16 instantiations)
K8_KERNELS = ("tade1_bf16_kernel", "tade2_bf16_kernel", "tade1_kernel", "tade2_kernel")
K8_PARTS = ("kernel", "statistics", "weight layout", "glue")


def k8_parts(fn, pieces: dict, tries: int = 5, reps: int = 5) -> dict:
    """{part: device ms} of one call of fn (K8a or K8b in the bf16 mode, or
    its Save re-run) under torch.profiler (``time_melgan.profile_by_kernel``):
    "kernel" the K8 kernel (``K8_KERNELS``), then each of ``pieces``
    ({part: a function that does only that part of fn's work, on the same
    inputs}: "statistics", the statistics of x; "weight layout",
    ``_fragments``) by its own device time, traced alone over ``reps``
    calls and divided, and "glue" the rest of fn's device time (the biases
    widened). A trace without the kernel, or a piece's without any kernel
    (a call's first kernels are sometimes missing from a trace), is taken
    again, up to ``tries`` times."""
    from parallelwavegan_tpu_torch.ops.kernels.time_melgan import profile_by_kernel

    for _ in range(tries):
        prof = profile_by_kernel(fn)
        kernel = [(ms, n) for name, (ms, n) in prof.items() if name.split("<")[0] in K8_KERNELS]
        if sum(n for _, n in kernel) == 1:
            break
    out = {"kernel": sum(ms for ms, _ in kernel)}
    for part, piece in pieces.items():
        for _ in range(tries):
            traced = profile_by_kernel(lambda: [piece() for _ in range(reps)])
            out[part] = sum(ms for ms, _ in traced.values()) / reps
            if out[part] > 0:
                break
    out["glue"] = max(0.0, sum(ms for ms, _ in prof.values()) - sum(out.values()))
    return {part: out.get(part, 0.0) for part in K8_PARTS}


# K9's parts in one bf16 call, by the kernels' names in this tree
# (csrc/tade_bwd_bf16.cu) and in a tree before it (csrc/tade_bwd.cu's
# bf16 instantiations); a kernel of none of them is glue
K9_PARTS = {"re-run": ("tade1_bf16_kernel", "tade2_bf16_kernel", "tade1_kernel",
                       "tade2_kernel"),
            "chain": ("chain_bf16_kernel", "stage_bwd_kernel"),
            "weight gradients": ("wgrad_bf16_kernel", "stage_wgrad_kernel"),
            "reduce": ("wgrad_bf16_reduce_kernel", "stage_wgrad_reduce_kernel")}


def k9_parts(fn, tries: int = 5) -> dict:
    """{part: device ms} of one call of fn (K9a or K9b in the bf16 mode)
    under torch.profiler (``time_melgan.profile_by_kernel``): the parts of
    ``K9_PARTS``, then "glue", every other kernel (the statistics, the
    casts, the weights' layout, the instance norm's backward, the stretch
    adjoint). A trace that holds fewer than one launch of each part's
    kernel (a call's first kernels are sometimes missing from it) is taken
    again, up to ``tries`` times; the last one is returned."""
    from parallelwavegan_tpu_torch.ops.kernels.time_melgan import profile_by_kernel

    for _ in range(tries):
        out = dict.fromkeys([*K9_PARTS, "glue"], 0.0)
        launches = dict.fromkeys(K9_PARTS, 0)
        for name, (ms, n) in profile_by_kernel(fn).items():
            part = next((part for part, names in K9_PARTS.items()
                         if name.split("<")[0] in names), "glue")
            out[part] += ms
            if part in launches:
                launches[part] += n
        if all(launches[part] == 1 for part in K9_PARTS):
            break
    return out


def k8_pieces(td, half: int, x, blk, rerun: bool) -> dict:
    """``k8_parts``' pieces of K8a (``half`` 1, x its input) or K8b (2, x
    its x2), forward or (``rerun``) the Save re-run inside K9, whose
    statistics K9 computes."""
    pieces = {"weight layout": lambda: td._fragments(blk, half, True)}
    if not rerun:  # the wrapper's statistics, in a tree before stats_cuda torch's
        stats = getattr(td, "stats_cuda", lambda v: td._stats(v.float()))
        pieces["statistics"] = lambda: stats(x)
    return pieces


def _bf16_step(td, tt, step) -> dict:
    """{kernel: {"bf16", "float32", "bf16_plain"}}: one G step's K8a, K8b,
    K9a and K9b over the blocks of ``step`` (x, c, x2, a, blk, dxo, dco),
    K9a and K9b with "bf16_parts" (``k9_parts``) too, K8a and K8b with
    "bf16_parts" (``k8_parts``), and "k8a_rerun", "k8b_rerun": K8's Save
    re-runs inside K9 ("bf16" by CUDA events, "bf16_parts")."""
    import torch

    bf = torch.bfloat16
    out = {k: {"bf16": 0.0, "float32": 0.0, "bf16_plain": 0.0}
           for k in ("k8a", "k8b", "k9a", "k9b")}
    for k in ("k9a", "k9b"):
        out[k]["bf16_parts"] = dict.fromkeys([*K9_PARTS, "glue"], 0.0)
    for k in ("k8a", "k8b", "k8a_rerun", "k8b_rerun"):
        out.setdefault(k, {"bf16": 0.0})["bf16_parts"] = dict.fromkeys(K8_PARTS, 0.0)
    for x, c, _, _, blk, dxo, dco in step:
        b32 = {k: v for k, v in blk.items() if not k.startswith("frag")}
        b16 = {k: v.to(bf) if torch.is_tensor(v) else v for k, v in b32.items()}
        runs = {"float32": (x, c, dxo, dco, b32),
                "bf16": (x.to(bf), c.to(bf), dxo.to(bf), dco.to(bf), b16)}
        for mode, (xx, cc, do, dc, bl) in runs.items():
            with torch.no_grad():
                x2, a = td.tade1_cuda(xx, cc, bl)
            _, dx2, da, _ = tt.tade2_backward_cuda(xx, x2, a, bl, "softmax", do, dc)
            fns = {"k8a": lambda: td.tade1_cuda(xx, cc, bl),
                   "k8b": lambda: td.tade2_cuda(xx, x2, a, bl),
                   "k9a": lambda: tt.tade1_backward_cuda(xx, cc, bl, "softmax", dx2, da),
                   "k9b": lambda: tt.tade2_backward_cuda(xx, x2, a, bl, "softmax", do, dc)}
            if mode == "bf16":
                plain = {"k8a": lambda: td.tade1_reference_bf16(xx, cc, bl),
                         "k8b": lambda: td.tade2_reference_bf16(xx, x2, a, bl),
                         "k9a": lambda: tt.tade1_backward_reference(xx, cc, bl, "softmax",
                                                                    dx2, da),
                         "k9b": lambda: tt.tade2_backward_reference(xx, x2, a, bl,
                                                                    "softmax", do, dc)}
            for k, fn in fns.items():
                with torch.no_grad():
                    out[k][mode] += _median_ms(fn)
                    if mode == "bf16":
                        out[k]["bf16_plain"] += _median_ms(plain[k])
                if mode == "bf16" and k in ("k9a", "k9b"):
                    for part, ms in k9_parts(fn).items():
                        out[k]["bf16_parts"][part] += ms
            if mode == "bf16":
                with torch.no_grad():
                    m1, r1 = td._stats(xx.float())
                    m2, r2 = td._stats(x2.float())
                    k8 = {"k8a": (fns["k8a"], 1, xx, False),
                          "k8b": (fns["k8b"], 2, x2, False),
                          "k8a_rerun": (lambda: tt.tade1_rerun_cuda(xx, cc, bl, "softmax", m1,
                                                                    r1), 1, xx, True),
                          "k8b_rerun": (lambda: tt.tade2_rerun_cuda(xx, x2, a, bl, "softmax",
                                                                    m2, r2), 2, x2, True)}
                    for k, (fn, half, v, rerun) in k8.items():
                        if rerun:
                            out[k]["bf16"] += _median_ms(fn)
                        for part, ms in k8_parts(fn, k8_pieces(td, half, v, bl, rerun)).items():
                            out[k]["bf16_parts"][part] += ms
            del x2, a, dx2, da
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "..")))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import parallelwavegan_tpu_torch
    from chip_smoke import STYLE_FRAMES, V1_STYLE_CONFIG, V1_STYLE_GENERATOR
    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as tt

    if not torch.cuda.is_available():
        raise SystemExit("time_tade: needs a CUDA device")
    if not parallelwavegan_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"time_tade: imported {parallelwavegan_tpu_torch.__file__}")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    gen = get_model_class("StyleMelGANGenerator")(
        **dict(V1_STYLE_GENERATOR, use_pallas_tade=True), device="cuda",
        generator=torch.Generator().manual_seed(0))
    gen.remove_weight_norm()
    gen.eval()
    gen.prepare_kernels()
    blocks = gen._kernel_cache
    rs = np.random.RandomState(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).cuda()

    out = {"root": root}
    x0, c0 = randn(1, STYLE_FRAMES * 8, 64), randn(1, STYLE_FRAMES * 8, 64)
    for name, bl in (("decode_ms", blocks[3:]),
                     ("decode_split_per_call_ms",
                      [{k: v for k, v in blk.items() if not k.startswith("frag")}
                       for blk in blocks[3:]])):
        k8a = k8b = 0.0
        x, c = x0, c0
        with torch.inference_mode():
            for blk in bl:
                x2, a = td.tade1_cuda(x, c, blk)
                k8a += _median_ms(lambda: td.tade1_cuda(x, c, blk))
                k8b += _median_ms(lambda: td.tade2_cuda(x, x2, a, blk))
                x, c = td.tade2_cuda(x, x2, a, blk)
        out[name] = {"k8a": k8a, "k8b": k8b, "sum": k8a + k8b}

    b = V1_STYLE_CONFIG["batch_size"]
    t = V1_STYLE_CONFIG["batch_max_steps"] // V1_STYLE_CONFIG["hop_size"]
    step = []
    for i, blk in enumerate(blocks):
        if i >= 4:
            sc = int(blk["scale"])
            x, c = randn(b, t, 64), randn(b, t, 64)
            with torch.no_grad():
                x2, a = td.tade1_cuda(x, c, blk)
            step.append((x, c, x2, a, blk, randn(b, sc * t, 64, scale=1e-3),
                         randn(b, sc * t, 64, scale=1e-3)))
        t *= int(blk["scale"])

    from torch.profiler import ProfilerActivity, profile

    def backward():
        for x, c, x2, a, blk, dxo, dco in step:
            tt.tade_block_backward(x, c, x2, a, blk, "softmax", dxo, dco)

    backward()
    runs = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            backward()
            torch.cuda.synchronize()
        ms = {"k8a": 0.0, "k8b": 0.0}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0) or 0
            for name, key in (("tade1_kernel", "k8a"), ("tade2_kernel", "k8b")):
                if name in ev.key:
                    ms[key] += us / 1e3
        runs.append(ms)
    mid = sorted(runs, key=lambda r: r["k8a"] + r["k8b"])[1]
    out["rerun_ms"] = {**mid, "sum": mid["k8a"] + mid["k8b"]}
    if hasattr(td, "tade1_reference_bf16"):
        out["bf16_step_ms"] = _bf16_step(td, tt, step)
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
