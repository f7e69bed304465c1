"""The recipe's front end in the port against the JAX package's CLIs, in the
stage order of ``egs/yesno/voc1/run.sh``: ``preprocess`` (a wav.scp with a
segments file, trimmed silence, a different sampling rate, f0 and
excitation, local and global features, the hdf5 and npy layouts) writes the
same arrays bit for bit; ``compute_statistics`` the same mean and scale
(per speaker too) within 1e-6 relative; ``normalize`` the same dumps bit
for bit. Then a 2-step CPU training of ``hifigan.v1.debug.yaml`` through
``--train-wav-scp/--train-feats-scp/--train-segments`` whose batches are
cut from JAX's ``AudioMelSCPDataset`` items, and the checkpoint decoded
from a Kaldi ark with ``--feats-scp --batch-size 2`` by both packages'
``bin/decode.main`` within 2e-4. The JAX CLIs read ``sys.argv``."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401
yaml = pytest.importorskip("yaml")
h5py = pytest.importorskip("h5py")

from parallelwavegan_tpu.bin import compute_statistics as j_stats  # noqa: E402
from parallelwavegan_tpu.bin import decode as j_decode  # noqa: E402
from parallelwavegan_tpu.bin import normalize as j_norm  # noqa: E402
from parallelwavegan_tpu.bin import preprocess as j_pre  # noqa: E402
from parallelwavegan_tpu.data.datasets import AudioMelSCPDataset  # noqa: E402
from parallelwavegan_tpu_torch.bin import compute_statistics as p_stats  # noqa: E402
from parallelwavegan_tpu_torch.bin import decode as p_decode  # noqa: E402
from parallelwavegan_tpu_torch.bin import normalize as p_norm  # noqa: E402
from parallelwavegan_tpu_torch.bin import preprocess as p_pre  # noqa: E402
from parallelwavegan_tpu_torch.bin import train as p_train  # noqa: E402
from parallelwavegan_tpu_torch.data import collater as p_collater  # noqa: E402
from parallelwavegan_tpu_torch.utils.io import write_wav  # noqa: E402
from parallelwavegan_tpu_torch.utils.kaldi_ark import write_ark  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBUG_YAML = os.path.join(ROOT, "egs", "yesno", "voc1", "conf", "hifigan.v1.debug.yaml")
FS = 8000


def _utterance(rs, seconds, fs=FS, quiet=0.0):
    """Harmonics of a random f0 under AM plus noise, with ``quiet`` seconds of
    near-silence at both ends (for the trim)."""
    t = np.arange(int(seconds * fs)) / fs
    f0 = rs.uniform(90, 220)
    x = sum(np.sin(2 * np.pi * k * f0 * t + rs.uniform(0, 6)) / k for k in (1, 2, 3))
    x = 0.25 * x * (1 + 0.5 * np.sin(2 * np.pi * rs.uniform(1, 4) * t))
    x += 0.01 * rs.randn(len(t))
    pad = 1e-4 * rs.randn(int(quiet * fs))
    return np.concatenate([pad, x, pad]).clip(-0.95, 0.95)


def _corpus(root):
    """Recordings written as 16-bit WAVs by the port's ``write_wav``: r0 holds
    u0-u2 (cut by the segments file), a3-a5 are whole files, s6 is at 16 kHz.
    Returns the scp and speaker files."""
    rs = np.random.RandomState(0)
    os.makedirs(root / "wav")
    long = np.concatenate([_utterance(rs, s) for s in (0.9, 1.1, 0.8)])
    write_wav(str(root / "wav" / "r0.wav"), FS, long)
    for i, (sec, quiet) in enumerate(((1.0, 0.3), (1.3, 0.0), (0.7, 0.4)), 3):
        write_wav(str(root / "wav" / f"a{i}.wav"), FS, _utterance(rs, sec, quiet=quiet))
    os.makedirs(root / "wav16")
    write_wav(str(root / "wav16" / "s6.wav"), 2 * FS, 0.5 * _utterance(rs, 0.8, fs=2 * FS))
    recs = ["r0", "a3", "a4", "a5"]
    (root / "wav.scp").write_text("".join(f"{r} {root / 'wav' / r}.wav\n" for r in recs))
    (root / "wav16.scp").write_text(
        "".join(f"{r} {root / 'wav' / r}.wav\n" for r in recs[1:])
        + f"s6 {root / 'wav16' / 's6.wav'}\n")
    (root / "segments").write_text(
        "u0 r0 0.0 0.9\nu1 r0 0.9 2.0\nu2 r0 2.0 -1\n"
        "a3 a3 0.0 -1\na4 a4 0.0 -1\na5 a5 0.0 -1\n")
    utts = ["u0", "u1", "u2", "a3", "a4", "a5", "s6"]
    (root / "utt2spk").write_text("".join(f"{u} spk{i % 2}\n" for i, u in enumerate(utts)))
    (root / "spk2idx").write_text("spk0 0\nspk1 1\n")
    return {k: str(root / k) for k in ("wav.scp", "wav16.scp", "segments", "utt2spk",
                                       "spk2idx")} | {"wavdir": str(root / "wav")}


def _config(root, name, **overrides):
    with open(DEBUG_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg.update(overrides)
    path = str(root / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _both(monkeypatch, jax_main, port_main, argv_of):
    """Run a CLI of each package, ``argv_of(side)`` its arguments."""
    monkeypatch.setattr(sys, "argv", ["cli"] + argv_of("jax"))
    jax_main()
    port_main(argv_of("port"))


def _arrays(path):
    """{name: array} of a dump directory (every npy file, every h5 dataset)."""
    out = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name.endswith(".npy"):
            out[name] = np.load(full)
        elif name.endswith(".h5"):
            with h5py.File(full, "r") as f:
                f.visititems(lambda k, v, n=name: out.__setitem__(
                    f"{n}/{k}", v[()]) if isinstance(v, h5py.Dataset) else None)
    return out


def _same_dumps(a, b, rel=None):
    got, want = _arrays(a), _arrays(b)
    assert sorted(got) == sorted(want) and got
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if rel is None:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=rel, atol=0, err_msg=k)
    return want


# name: (config overrides, preprocess input args, stats args, normalize args)
CASES = {
    "hdf5_segments_trim_global": (
        dict(), ["--wav-scp", "wav.scp", "--segments", "segments", "--utt2spk", "utt2spk",
                 "--spk2idx", "spk2idx"],
        ["--utt2spk", "utt2spk"], ["--utt2spk", "utt2spk"]),
    "npy_resampled_gain": (
        dict(format="npy", trim_silence=False, sampling_rate_for_feats=4000, fmax=2000,
             global_gain_scale=1.6),
        ["--wav-scp", "wav16.scp", "--allow-different-sampling-rate"],
        ["--feats-scp"], ["--skip-wav-copy"]),
    "hdf5_uhifigan_f0": (
        dict(generator_type="UHiFiGANGenerator"), ["--rootdir", "wavdir"], [], []),
    "npy_local_global": (
        dict(format="npy", use_local_condition=True, use_global_condition=True),
        ["--wav-scp", "wav.scp", "--segments", "segments", "--extract-f0",
         "--utt2spk", "utt2spk", "--spk2idx", "spk2idx"],
        ["--target-feats", "local"], ["--target-feats", "local"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_preprocess_statistics_and_normalize_equal_jax(tmp_path, monkeypatch, case):
    overrides, pre_args, stats_args, norm_args = CASES[case]
    files = _corpus(tmp_path)
    conf = _config(tmp_path, case, **overrides)
    npy = overrides.get("format") == "npy"

    def resolve(args):
        return [files.get(a, a) for a in args]

    def out(side, stage):
        return str(tmp_path / side / stage)

    _both(monkeypatch, j_pre.main, p_pre.main,
          lambda s: ["--config", conf, "--dumpdir", out(s, "raw"), "--verbose", "0"]
          + resolve(pre_args))
    raw = _same_dumps(out("port", "raw"), out("jax", "raw"))
    utts = sorted({k.split("-")[0].split(".")[0] for k in raw})
    feats_name = "local" if "local" in stats_args else "feats"
    if case == "hdf5_segments_trim_global":
        # u0-u2 cut from r0; a3 and a5 lost their quiet ends to the trim
        assert utts == ["a3", "a4", "a5", "u0", "u1", "u2"]
        assert raw["a3.h5/wave"].shape[0] < 1.3 * FS
        assert int(raw["a4.h5/global"]) == 0 and int(raw["u1.h5/global"]) == 1
    elif case == "npy_resampled_gain":
        assert "s6" in utts  # resampled from 16 kHz
        assert len(utts) < 4  # some clipped under the gain and were skipped
    elif case == "hdf5_uhifigan_f0":
        assert {"a3.h5/f0", "a3.h5/excitation"} <= set(raw)
    else:
        assert raw["u0-local.npy"].shape[1] == 2 and "u0-global.npy" in raw

    stats_in = ["--rootdir", out("{s}", "raw")]
    if "--feats-scp" in stats_args:
        scp = tmp_path / "raw_feats.scp"
        scp.write_text("".join(f"{u} {out('port', 'raw')}/{u}-feats.npy\n" for u in utts))
        stats_in = ["--feats-scp", str(scp)]
    _both(monkeypatch, j_stats.main, p_stats.main,
          lambda s: ["--config", conf, "--dumpdir", out(s, "stats"), "--verbose", "0"]
          + [a.format(s=s) for a in stats_in]
          + resolve([a for a in stats_args if a != "--feats-scp"]))
    _same_dumps(out("port", "stats"), out("jax", "stats"), rel=1e-6)
    stats = f"stats.{'npy' if npy else 'h5'}"

    _both(monkeypatch, j_norm.main, p_norm.main,
          lambda s: ["--config", conf, "--rootdir", out(s, "raw"), "--dumpdir",
                     out(s, "norm"), "--stats", os.path.join(out(s, "stats"), stats),
                     "--verbose", "0"] + resolve(norm_args))
    norm = _same_dumps(out("port", "norm"), out("jax", "norm"))
    if case == "npy_local_global":  # the V/UV channel stays binary
        # (npy dumps name an utterance after its wave file, as in JAX)
        local = norm["u0-wave-local.npy"]
        assert set(np.unique(local[:, 1])) <= {0.0, 1.0} and local[:, 1].any()
        assert abs(local[:, 0].mean()) < 3 and "u0-wave-global.npy" in norm
    elif case == "hdf5_uhifigan_f0":
        np.testing.assert_array_equal(norm["a3.h5/f0"], raw["a3.h5/f0"])
    elif case == "npy_resampled_gain":
        assert not any(k.endswith("-wave.npy") for k in norm)
    if case == "hdf5_segments_trim_global":  # normalize from a wav.scp and feats.scp
        scp = tmp_path / "raw_feats.scp"
        scp.write_text("".join(f"{u} {out('port', 'raw')}/{u}.h5:{feats_name}\n"
                               for u in utts))
        _both(monkeypatch, j_norm.main, p_norm.main,
              lambda s: ["--config", conf, "--wav-scp", files["wav.scp"], "--segments",
                         files["segments"], "--feats-scp", str(scp), "--dumpdir",
                         out(s, "norm_scp"), "--stats",
                         os.path.join(out("port", "stats"), stats), "--verbose", "0"])
        _same_dumps(out("port", "norm_scp"), out("jax", "norm_scp"))


@pytest.mark.parametrize("fn", ["yin_f0", "postprocess_f0", "logf0_and_vuv",
                                "sine_excitation_np", "extract_f0_and_excitation"])
def test_f0_functions_equal_jax(fn):
    """The port's copy of ops/f0.py (and the Harvest tracker behind
    logf0_and_vuv) against the JAX package's, bit for bit."""
    from parallelwavegan_tpu.ops import f0 as jf0
    from parallelwavegan_tpu_torch.ops import f0 as pf0

    rs = np.random.RandomState(9)
    audio = _utterance(rs, 0.4).astype(np.float32)
    f0 = np.abs(rs.randn(40)).astype(np.float32) * 100 * (rs.rand(40) > 0.3)
    args = {"yin_f0": (audio, FS, 64), "postprocess_f0": (f0,),
            "logf0_and_vuv": (audio[:2400], FS, 256), "sine_excitation_np": (f0, FS, 64),
            "extract_f0_and_excitation": (audio, FS, 64)}[fn]
    got, want = getattr(pf0, fn)(*args), getattr(jf0, fn)(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape and np.any(w)
        np.testing.assert_array_equal(g, w)


def test_preprocess_refuses_what_jax_asserts(tmp_path, monkeypatch):
    """A recording at another rate without --allow-different-sampling-rate,
    and a config whose hop does not fit sampling_rate_for_feats: JAX's
    asserts, the port's ValueErrors."""
    files = _corpus(tmp_path)
    for overrides, what in (({}, "fs 16000"), (
            dict(sampling_rate_for_feats=4100), "sampling_rate_for_feats")):
        conf = _config(tmp_path, "bad", **overrides)
        argv = ["--config", conf, "--wav-scp", files["wav16.scp"], "--dumpdir",
                str(tmp_path / "out"), "--verbose", "0"]
        if overrides:
            argv.append("--allow-different-sampling-rate")
        monkeypatch.setattr(sys, "argv", ["cli"] + argv)
        with pytest.raises(AssertionError):
            j_pre.main()
        with pytest.raises(ValueError, match=what):
            p_pre.main(argv)


def test_train_through_scp_and_batched_decode_from_an_ark_equal_jax(tmp_path, monkeypatch):
    files = _corpus(tmp_path)
    conf = _config(tmp_path, "train", format="hdf5", trim_silence=False,
                   generator_optimizer_type="Adam", discriminator_optimizer_type="Adam",
                   generator_scheduler_type="MultiStepLR",
                   generator_scheduler_params={"milestones": [1000], "gamma": 0.5},
                   discriminator_scheduler_type="MultiStepLR",
                   discriminator_scheduler_params={"milestones": [1000], "gamma": 0.5},
                   generator_train_start_steps=0, train_max_steps=2,
                   save_interval_steps=2, eval_interval_steps=2, log_interval_steps=1,
                   num_save_intermediate_results=0)
    raw, norm = str(tmp_path / "raw"), str(tmp_path / "norm")
    p_pre.main(["--config", conf, "--wav-scp", files["wav.scp"], "--segments",
                files["segments"], "--dumpdir", raw, "--verbose", "0"])
    p_stats.main(["--config", conf, "--rootdir", raw, "--dumpdir", str(tmp_path),
                  "--verbose", "0"])
    p_norm.main(["--config", conf, "--rootdir", raw, "--dumpdir", norm, "--stats",
                 str(tmp_path / "stats.h5"), "--verbose", "0"])
    utts = ["u0", "u1", "u2", "a3", "a4", "a5"]
    feats_scp = tmp_path / "feats.scp"
    feats_scp.write_text("".join(f"{u} {norm}/{u}.h5\n" for u in utts))

    seen = []
    call = p_collater.Collater.__call__

    def spy(self, batch, rng=None):
        seen.extend(batch)
        return call(self, batch, rng)

    monkeypatch.setattr(p_collater.Collater, "__call__", spy)
    exp = str(tmp_path / "exp")
    res = p_train.main(["--train-wav-scp", files["wav.scp"], "--train-feats-scp",
                        str(feats_scp), "--train-segments", files["segments"],
                        "--dev-wav-scp", files["wav.scp"], "--dev-feats-scp",
                        str(feats_scp), "--dev-segments", files["segments"],
                        "--outdir", exp, "--config", conf, "--device", "cpu",
                        "--verbose", "0"])
    assert res["steps"] == 2
    losses = [m for _, m in res["history"] if "train/generator_loss" in m]
    assert losses and all(np.isfinite(v) for m in losses for v in m.values())
    jax_items = AudioMelSCPDataset(files["wav.scp"], str(feats_scp),
                                   segments=files["segments"])
    assert len(jax_items) == len(utts) and len(seen) >= 4
    for audio, mel in seen:  # every item the collater cut a batch from is JAX's
        assert any(a.shape == audio.shape and np.array_equal(a, audio)
                   and np.array_equal(m, mel) for a, m in
                   (jax_items[i] for i in range(len(jax_items))))

    # ESPnet's hand-off: the eval mels in a Kaldi ark, decoded in batches of 2
    from parallelwavegan_tpu_torch.utils.io import read_hdf5

    eval_ark, eval_scp = str(tmp_path / "eval.ark"), str(tmp_path / "eval.scp")
    write_ark(eval_ark, {u: read_hdf5(f"{norm}/{u}.h5", "feats") for u in utts[:4]},
              eval_scp)
    ckpt = os.path.join(exp, "checkpoint-2steps.pkl")
    wavs = {}

    def capture(side):
        def write(path, fs, y):
            wavs.setdefault(side, {})[os.path.basename(path)] = np.asarray(y)
        return write

    monkeypatch.setattr(p_decode, "write_wav", capture("port"))
    monkeypatch.setattr(j_decode, "write_wav", capture("jax"))
    common = ["--feats-scp", eval_scp, "--checkpoint", ckpt, "--batch-size", "2",
              "--verbose", "0"]
    _both(monkeypatch, j_decode.main, lambda argv: p_decode.main(argv + ["--device", "cpu"]),
          lambda s: common + ["--outdir", str(tmp_path / f"wav_{s}")]
          + (["--no-compilation-cache"] if s == "jax" else []))
    assert sorted(wavs["port"]) == sorted(wavs["jax"]) == sorted(
        f"{u}_gen.wav" for u in utts[:4])
    for k, want in wavs["jax"].items():
        assert wavs["port"][k].shape == want.shape and want.shape[0] % 256 == 0
        np.testing.assert_allclose(wavs["port"][k], want, atol=2e-4, err_msg=k)
