"""The port's decode slice end to end on the CPU, held against the JAX package.

The port writes an upstream ``.pkl``; the JAX package's ``load_model`` and
the port's ``bin/decode.main`` decode the same npy dump directory, both
through the decode tail (the Pallas kernel in interpret mode on the JAX
side, the kernel's plain version on the port side). The port's 16-bit WAVs
agree with the JAX waveform to atol 1e-4 (three 16-bit steps: quantisation
plus float32 sums taken in another order).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

from scipy.io import wavfile  # noqa: E402

from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.bin import decode  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.mel import logmelfilterbank  # noqa: E402
from parallelwavegan_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_generator_state_dict,
    save_checkpoint,
)
from parallelwavegan_tpu_torch.utils.config import load_config  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import load_model  # noqa: E402

HOP = 64
CONFIG = {
    "sampling_rate": 16000, "fft_size": 256, "hop_size": HOP,
    "num_mels": 20, "format": "npy", "generator_type": "HiFiGANGenerator",
    "generator_params": {
        "in_channels": 20, "out_channels": 1, "channels": 32, "kernel_size": 7,
        "upsample_scales": [4, 4, 2, 2],
        # the reference's typo, remapped by load_model on both sides
        "upsample_kernal_sizes": [8, 8, 4, 4],
        "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilations": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
        "use_pallas_tail": True,
    },
}
FRAMES = (20, 29)  # one 32-frame bucket: one JAX compile


def _write_slice(root):
    exp, dump = root / "exp", root / "dump"
    exp.mkdir()
    dump.mkdir()
    gp = {k.replace("kernal", "kernel"): v
          for k, v in CONFIG["generator_params"].items()}
    gen = get_model_class("HiFiGANGenerator")(
        **gp, generator=torch.Generator().manual_seed(0))
    ckpt = str(exp / "checkpoint-5steps.pkl")
    save_checkpoint(ckpt, gen.state_dict(), steps=5)
    rs = np.random.RandomState(0)
    mels = {}
    for i, frames in enumerate(FRAMES):
        audio = 0.3 * np.sin(np.arange(frames * HOP) * (0.05 + 0.02 * i))
        audio = audio + 0.05 * rs.randn(frames * HOP)
        mel = logmelfilterbank(audio, CONFIG["sampling_rate"],
                               fft_size=CONFIG["fft_size"], hop_size=HOP,
                               num_mels=CONFIG["num_mels"])[:frames]
        np.save(dump / f"utt{i}-feats.npy", mel)
        mels[f"utt{i}-feats"] = mel
    allm = np.concatenate(list(mels.values()))
    np.save(exp / "stats.npy", np.stack([allm.mean(0), allm.std(0)]))
    cfg = str(exp / "config.json")
    with open(cfg, "w") as f:
        json.dump(CONFIG, f)
    return ckpt, cfg, str(dump), mels


def test_decode_slice_matches_jax(tmp_path):
    ckpt, cfg, dump, mels = _write_slice(tmp_path)
    out = tmp_path / "wav"
    res = decode.main(["--dumpdir", dump, "--outdir", str(out),
                       "--checkpoint", ckpt, "--config", cfg,
                       "--normalize-before", "--use-pallas-tail",
                       "--device", "cpu", "--verbose", "0"])
    assert len(res["rtfs"]) == len(FRAMES)

    jax_model = jax_load_model(ckpt, load_config(cfg))
    assert jax_model.mean is not None  # stats.npy found beside the checkpoint
    for utt, mel in mels.items():
        fs, data = wavfile.read(out / f"{utt}_gen.wav")
        assert fs == CONFIG["sampling_rate"] and data.dtype == np.int16
        got = data.astype(np.float32) / 32767.0
        want = np.clip(jax_model.inference(mel, normalize_before=True)[:, 0],
                       -1, 1)
        assert got.shape == want.shape == (mel.shape[0] * HOP,)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_load_model_and_checkpoint_layout(tmp_path):
    ckpt, cfg, dump, mels = _write_slice(tmp_path)
    raw = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert raw["steps"] == 5 and set(raw) == {"model", "steps"}
    sd = load_generator_state_dict(ckpt)
    assert "upsamples.0.1.weight_g" in sd

    model = load_model(ckpt, load_config(cfg), device="cpu")
    gen = model.generator
    assert not gen.training and gen.tail_from == 2
    assert not hasattr(gen.input_conv, "weight_g")  # weight norm folded
    assert gen._tail_cache is not None              # bundle prepared once
    mel = mels["utt0-feats"]
    y = model.inference(mel, normalize_before=True)
    assert y.shape == (mel.shape[0] * HOP, 1)  # bucket padding trimmed
    assert np.isfinite(y).all()
    with pytest.raises(ValueError, match="stats"):
        model.mean = None
        model.inference(mel, normalize_before=True)


def test_decode_reads_config_beside_checkpoint(tmp_path):
    yaml = pytest.importorskip("yaml")
    ckpt, cfg, dump, _ = _write_slice(tmp_path)
    with open(os.path.join(os.path.dirname(ckpt), "config.yml"), "w") as f:
        yaml.safe_dump(dict(CONFIG, generator_params=dict(
            CONFIG["generator_params"], use_pallas_tail=False)), f)
    out = tmp_path / "wav"
    decode.main(["--dumpdir", dump, "--outdir", str(out), "--checkpoint", ckpt,
                 "--device", "cpu", "--verbose", "0"])
    assert sorted(os.listdir(out)) == ["utt0-feats_gen.wav", "utt1-feats_gen.wav"]


def test_decode_device_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.main(["--dumpdir", str(tmp_path), "--outdir", str(tmp_path),
                     "--checkpoint", str(tmp_path / "none.pkl"),
                     "--device", "cuda"])
