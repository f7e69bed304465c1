"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Preconditions and build: a CUDA device must be present; the fused
   HiFi-GAN tail kernel is compiled from this checkout's sources.
2. Kernel against its plain PyTorch version at the HiFi-GAN v1 tail shapes
   (B=1, T0=32768, C0=128: the tail of a 512-frame decode) and on one
   ragged case (B=2, T0=1000), max |diff| <= 2e-4, with CUDA-event times.
3. The main path through the decode entry point: a random-init, full-width
   HiFi-GAN v1 checkpoint, stats and a 3-utterance npy dump directory are
   written to a scratch directory in the checkout;
   ``parallelwavegan_tpu_torch.bin.decode.main`` decodes it with
   ``--use-pallas-tail`` (the kernel must launch once per utterance) and
   again with the tail off; the two must agree to 2e-4.

The last three lines are the kernel record (JSON), the card's name and
power limit from nvidia-smi, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke_work")
TOL = 2e-4
SEED = 0

# egs/ljspeech/voc1/conf/hifigan.v1.yaml (a test holds these equal to it)
V1_FEATURES = dict(sampling_rate=22050, fft_size=1024, hop_size=256,
                   win_length=None, window="hann", num_mels=80, fmin=80,
                   fmax=7600)
V1_GENERATOR = dict(
    in_channels=80, out_channels=1, channels=512, kernel_size=7,
    upsample_scales=[8, 8, 2, 2], upsample_kernel_sizes=[16, 16, 4, 4],
    resblock_kernel_sizes=[3, 7, 11],
    resblock_dilations=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    use_additional_convs=True, bias=True, nonlinear_activation="LeakyReLU",
    nonlinear_activation_params={"negative_slope": 0.1}, use_weight_norm=True,
)
UTT_FRAMES = (512, 300, 77)


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel(card: str) -> dict:
    """Kernel vs plain version at the v1 tail shapes and one ragged case."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
        fused_hifigan_tail,
        hifigan_tail_reference,
    )

    gen = get_model_class("HiFiGANGenerator")(
        **V1_GENERATOR, use_pallas_tail=True, device="cuda",
        generator=torch.Generator().manual_seed(SEED),
    )
    gen.remove_weight_norm()
    gen.eval()
    w = gen.tail_weights()
    args = (w["stages"], w["final_w"], w["final_b"])
    kw = dict(slope=gen.slope, pre_blocks=w["pre_blocks"])
    rs = np.random.RandomState(SEED)
    record = {}
    for name, (b, t0) in (("v1", (1, 32768)), ("ragged", (2, 1000))):
        x = torch.from_numpy(
            (rs.randn(b, t0, 128) * 0.5).astype(np.float32)).to("cuda")
        with torch.inference_mode():
            got = fused_hifigan_tail(x, *args, **kw)
            torch.cuda.synchronize()
            ref = hifigan_tail_reference(x, *args, **kw)
            torch.cuda.synchronize()
        if got.shape != (b, t0 * 4, 1) or ref.shape != got.shape:
            _fail(f"{name}: shapes {tuple(got.shape)} vs {tuple(ref.shape)}")
        if not torch.isfinite(got).all():
            _fail(f"{name}: non-finite kernel output")
        err = float((got - ref).abs().max())
        print(f"kernel vs plain [{name}] B={b} T0={t0} C0=128: "
              f"max|diff| = {err:.3e} (tol {TOL})")
        if not err <= TOL:
            _fail(f"{name}: kernel disagrees with its plain version")
        record[f"{name}_err"] = err
        if name == "v1":
            with torch.inference_mode():
                record["ms"] = _median_ms(lambda: fused_hifigan_tail(x, *args, **kw))
                record["plain_ms"] = _median_ms(
                    lambda: hifigan_tail_reference(x, *args, **kw))
            print(f"time [v1, median of 10, CUDA events]: kernel "
                  f"{record['ms']:.3f} ms, plain {record['plain_ms']:.3f} ms "
                  f"on {card}")
    return record


def _write_inputs(config_tail: dict) -> dict:
    """Checkpoint, stats, configs and an npy dump directory under WORK."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.mel import logmelfilterbank
    from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint

    shutil.rmtree(WORK, ignore_errors=True)
    exp, dump = os.path.join(WORK, "exp"), os.path.join(WORK, "dump")
    os.makedirs(exp)
    os.makedirs(dump)
    gen = get_model_class("HiFiGANGenerator")(
        **V1_GENERATOR, generator=torch.Generator().manual_seed(SEED))
    ckpt = os.path.join(exp, "checkpoint-0steps.pkl")
    save_checkpoint(ckpt, gen.state_dict(), steps=0)

    rs = np.random.RandomState(SEED)
    hop, fs = V1_FEATURES["hop_size"], V1_FEATURES["sampling_rate"]
    mels = []
    for i, frames in enumerate(UTT_FRAMES):
        n = frames * hop
        t = np.arange(n) / fs
        f0 = 110.0 + 40.0 * i
        audio = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rs.randn(n)
        feats = {k: v for k, v in V1_FEATURES.items() if k != "sampling_rate"}
        mel = logmelfilterbank(audio, fs, **feats)[:frames]
        np.save(os.path.join(dump, f"utt{i}-feats.npy"), mel.astype(np.float32))
        mels.append(mel)
    allm = np.concatenate(mels)
    np.save(os.path.join(exp, "stats.npy"),
            np.stack([allm.mean(0), allm.std(0)]).astype(np.float32))

    paths = {"ckpt": ckpt, "dump": dump}
    for name, tail in (("tail", True), ("plain", False)):
        cfg = dict(config_tail)
        cfg["generator_params"] = dict(cfg["generator_params"],
                                       use_pallas_tail=tail)
        paths[name] = os.path.join(exp, f"config_{name}.json")
        with open(paths[name], "w") as f:
            json.dump(cfg, f)
    return paths


def _read_wavs(outdir: str) -> dict:
    import numpy as np
    from scipy.io import wavfile

    out = {}
    for name in sorted(os.listdir(outdir)):
        _, data = wavfile.read(os.path.join(outdir, name))
        out[name] = data.astype(np.float32) / 32767.0
    return out


def phase_decode(card: str) -> dict:
    """The main path: decode entry point with the tail kernel, then without."""
    import numpy as np

    from parallelwavegan_tpu_torch.bin import decode
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
        fused_hifigan_tail,
    )

    config = dict(V1_FEATURES, format="npy", generator_type="HiFiGANGenerator",
                  generator_params=dict(V1_GENERATOR))
    p = _write_inputs(config)
    common = ["--dumpdir", p["dump"], "--checkpoint", p["ckpt"],
              "--normalize-before", "--device", "cuda"]
    out_tail = os.path.join(WORK, "wav_tail")
    out_plain = os.path.join(WORK, "wav_plain")

    fused_hifigan_tail.launches = 0
    res_tail = decode.main(common + ["--outdir", out_tail, "--config", p["tail"],
                                     "--use-pallas-tail"])
    launches = fused_hifigan_tail.launches
    print(f"main path: tail kernel launches = {launches} for "
          f"{len(UTT_FRAMES)} utterances")
    if launches != len(UTT_FRAMES):
        _fail("the decode did not go through the tail kernel once per utterance")

    res_plain = decode.main(common + ["--outdir", out_plain, "--config", p["plain"]])
    if fused_hifigan_tail.launches != launches:
        _fail("the plain decode launched the tail kernel")

    wav_tail, wav_plain = _read_wavs(out_tail), _read_wavs(out_plain)
    expected = {f"utt{i}-feats_gen.wav": f * V1_FEATURES["hop_size"]
                for i, f in enumerate(UTT_FRAMES)}
    if set(wav_tail) != set(expected) or set(wav_plain) != set(expected):
        _fail(f"wav files {sorted(wav_tail)} / {sorted(wav_plain)}")
    err = 0.0
    for name, n in expected.items():
        a, b = wav_tail[name], wav_plain[name]
        if a.shape != (n,) or b.shape != (n,):
            _fail(f"{name}: lengths {a.shape} / {b.shape}, expected {n}")
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            _fail(f"{name}: non-finite samples")
        if float(np.abs(a).max()) == 0.0:
            _fail(f"{name}: silent output")
        err = max(err, float(np.abs(a - b).max()))
    print(f"decode with tail kernel vs without: max|diff| = {err:.3e} "
          f"(tol {TOL}, 16-bit WAVs)")
    if not err <= TOL:
        _fail("decode with the tail kernel disagrees with the plain decode")
    print(f"decode RTF (mean of {len(UTT_FRAMES)} utterances, first one "
          f"includes warm-up) on {card}: tail kernel {res_tail['rtf']:.6f} "
          f"{['%.6f' % r for r in res_tail['rtfs']]}, plain "
          f"{res_plain['rtf']:.6f} {['%.6f' % r for r in res_plain['rtfs']]}")
    shutil.rmtree(WORK)
    return {"launches": launches, "err": err}


def main() -> None:
    pkg = os.path.join(ROOT, "parallelwavegan_tpu_torch")
    if not os.path.isdir(pkg):
        _fail(f"{pkg} not found: run this script from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    import parallelwavegan_tpu_torch
    from parallelwavegan_tpu_torch.ops.kernels import build

    if not os.path.abspath(parallelwavegan_tpu_torch.__file__).startswith(pkg):
        _fail(f"imported {parallelwavegan_tpu_torch.__file__}, not {pkg}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; card: {card}")

    start = time.perf_counter()
    lib = build.load()
    print(f"kernel build: {time.perf_counter() - start:.1f} s wall, nvcc "
          f"{lib.build_seconds:.1f} s -> {os.path.relpath(lib.path, ROOT)} "
          f"on {card}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    kern = phase_kernel(card)
    torch.cuda.synchronize()
    dec = phase_decode(card)
    torch.cuda.synchronize()

    record = {"kernels": [{
        "name": "fused_hifigan_tail",
        "route": "cuda",
        "source": "parallelwavegan_tpu_torch/ops/kernels/csrc/hifigan_tail.cu",
        "replaces": "parallelwavegan_tpu/ops/pallas_kernels/hifigan_tail.py:256",
        "launches": dec["launches"],
        "max_abs_err": max(kern["v1_err"], kern["ragged_err"]),
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
