"""Device times of the HiFi-GAN residual-unit kernel, through the decode
tail K1 and the MRF stage K2, on the card, by the public wrappers alone, so
that two trees can be timed in turns:

    python parallelwavegan_tpu_torch/ops/kernels/time_hifigan.py [--root DIR]

DIR (default: this file's tree) is put first on sys.path, so its package
and its kernel sources are the ones timed (a parent commit unpacked with
``git archive``). With the HiFi-GAN v1 generator's weights from seed 0
(``chip_smoke.py``'s V1_GENERATOR) and random inputs of scale 0.5:

- K1 per call (``fused_hifigan_tail``) at B=1, T0=32768, C0=128 (the tail
  of a 512-frame decode) with the bundle that ``prepare_kernels`` keeps
  (with its split, where the tree keeps one), and with each call splitting
  its weights;
- K2b per decode, the MRFs of stages 2 and 3 (``fused_hifigan_mrf`` at
  (1, 65536, 64) and (1, 131072, 32)), split kept and per call, and K2a,
  stage 1's MRF at (1, 32768, 128);
- the HiFi-GAN v1 forward at 512 frames with ``use_pallas_tail`` and
  without;

each the median of 10 calls (CUDA events) beside its plain version, with
max|kernel - plain| and its ratio to max|plain|, and the device time by
kernel of one K1 call and one K2b decode (torch.profiler, after a warm-up
call). Prints the card (``nvidia-smi``) and one JSON line of the times in
ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


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
    from chip_smoke import SEED, V1_GENERATOR
    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_mrf import (
        fused_hifigan_mrf,
        hifigan_mrf_reference,
    )
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
        fused_hifigan_tail,
        hifigan_tail_reference,
    )
    from parallelwavegan_tpu_torch.ops.kernels.time_melgan import _median_ms, by_kernel

    if not torch.cuda.is_available():
        raise SystemExit("time_hifigan: needs a CUDA device")
    if not parallelwavegan_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"time_hifigan: imported {parallelwavegan_tpu_torch.__file__}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]

    def generator(**flags):
        gen = get_model_class("HiFiGANGenerator")(
            **V1_GENERATOR, **flags, device="cuda",
            generator=torch.Generator().manual_seed(SEED))
        gen.remove_weight_norm()
        gen.eval()
        gen.prepare_kernels()
        return gen

    tail = generator(use_pallas_tail=True)
    mrfs = generator(use_pallas_mrf=True, pallas_mrf_max_channels=128)
    plain = generator()
    rs = np.random.RandomState(SEED)

    def randn(*shape):
        return torch.from_numpy((rs.randn(*shape) * 0.5).astype(np.float32)).cuda()

    def timed(fn, ref, **extra):
        got, want = fn(), ref()
        peak = float(want.abs().max())
        err = float((got - want).abs().max())
        return dict({"ms": _median_ms(fn), "plain_ms": _median_ms(ref),
                     "max_abs_err": err, "err_of_max_plain": err / peak}, **extra)

    def profiled(fn):
        fn()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return by_kernel(prof)

    out = {"root": root}
    with torch.inference_mode():
        kept, per_call = tail._tail_cache, tail.tail_weights()
        x = randn(1, 32768, 128)

        def k1(w):
            return lambda: fused_hifigan_tail(x, w["stages"], w["final_w"], w["final_b"],
                                              slope=tail.slope, pre_blocks=w["pre_blocks"])

        ref = k1(per_call)
        plain_k1 = lambda: hifigan_tail_reference(  # noqa: E731
            x, per_call["stages"], per_call["final_w"], per_call["final_b"],
            slope=tail.slope, pre_blocks=per_call["pre_blocks"])
        out["k1"] = timed(k1(kept), plain_k1, by_kernel=profiled(k1(kept)))
        out["k1_split_per_call"] = timed(ref, plain_k1)
        del x

        xs = {i: randn(1, 32768 << (i - 1), 512 >> (i + 1)) for i in (1, 2, 3)}

        def k2(stages, cached):
            def run(fn):  # every stage's output, flattened into one
                return torch.cat([fn(xs[i], mrfs._mrf_cache[i] if cached else
                                     mrfs.mrf_weights(i), slope=mrfs.slope).flatten()
                                  for i in stages])
            return (lambda: run(fused_hifigan_mrf)), (lambda: run(hifigan_mrf_reference))

        fn, ref = k2((2, 3), True)
        out["k2b"] = timed(fn, ref, by_kernel=profiled(fn))
        out["k2b_split_per_call"] = timed(*k2((2, 3), False))
        out["k2a"] = timed(*k2((1,), True))
        del xs

        mel = torch.from_numpy(rs.randn(1, 80, 512).astype(np.float32)).cuda()
        out["forward_512_frames_tail"] = timed(lambda: tail(mel), lambda: plain(mel))
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
