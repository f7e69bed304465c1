"""The port's evaluation CLIs, ``bin/evaluate_mcd.py`` and
``bin/evaluate_f0.py`` (the recipe's stage 4), against the JAX package's
on the same WAVs: two generated utterances of 1 s at 16 kHz (``*_gen.wav``)
beside their ground truth, one generated utterance without ground truth
(skipped by both), scored in a pool of two processes. The files each CLI
writes (``utt2mcd``/``avg_mcd``, ``utt2f0``/``avg_f0``) are held equal
byte for byte, and the returned scores to the JAX metric functions' on
the WAVs as read (tolerance 0)."""

import sys

import numpy as np
import pytest

from torch_port_threads import one_torch_thread  # noqa: F401

from parallelwavegan_tpu.bin import evaluate_f0 as jax_evaluate_f0  # noqa: E402
from parallelwavegan_tpu.bin import evaluate_mcd as jax_evaluate_mcd  # noqa: E402
from parallelwavegan_tpu.ops import metrics as jax_metrics  # noqa: E402
from parallelwavegan_tpu_torch.bin import evaluate_f0, evaluate_mcd  # noqa: E402
from parallelwavegan_tpu_torch.utils.io import read_wav, write_wav  # noqa: E402

FS = 16000


def _wavs(tmp_path):
    """gen/ (u1_gen, u2_gen, u3_gen) and gt/ (u1, u2-take1): u2 matches by
    prefix, u3 has no ground truth."""
    t = np.arange(FS) / FS
    rs = np.random.RandomState(0)
    gen, gt = tmp_path / "gen", tmp_path / "gt"
    gen.mkdir()
    gt.mkdir()

    def tone(f0):
        phase = 2 * np.pi * (f0 + 20 * t) * t
        return (0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase)
                + 0.01 * rs.randn(FS)).astype(np.float32)

    for name, f0 in (("u1", 110.0), ("u2", 150.0), ("u3", 200.0)):
        write_wav(str(gen / f"{name}_gen.wav"), FS, tone(f0 * 1.03))
    write_wav(str(gt / "u1.wav"), FS, tone(110.0))
    write_wav(str(gt / "u2-take1.wav"), FS, tone(150.0))
    return gen, gt


def _jax_cli(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


def test_evaluate_mcd_matches_jax(tmp_path, monkeypatch):
    gen, gt = _wavs(tmp_path)
    common = ["--wavdir", str(gen), "--gt-wavdir", str(gt), "--n_jobs", "2",
              "--verbose", "0"]
    res = evaluate_mcd.main(common + ["--outdir", str(tmp_path / "port")])
    _jax_cli(monkeypatch, jax_evaluate_mcd, common + ["--outdir", str(tmp_path / "jax")])
    for name in ("utt2mcd", "avg_mcd"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert sorted(res["utt2mcd"]) == ["u1", "u2"]
    pairs = {"u1": "u1.wav", "u2": "u2-take1.wav"}
    for utt, ref in pairs.items():
        _, a = read_wav(str(gen / f"{utt}_gen.wav"))
        _, b = read_wav(str(gt / ref))
        assert res["utt2mcd"][utt] == jax_metrics.mel_cepstral_distortion(a, b, FS) > 0.01
    assert res["mean"] == np.mean(list(res["utt2mcd"].values()))


def test_evaluate_f0_matches_jax(tmp_path, monkeypatch):
    gen, gt = _wavs(tmp_path)
    common = ["--wavdir", str(gen), "--gt-wavdir", str(gt), "--n_jobs", "2",
              "--tracker", "yin", "--verbose", "0"]
    res = evaluate_f0.main(common + ["--outdir", str(tmp_path / "port")])
    _jax_cli(monkeypatch, jax_evaluate_f0, common + ["--outdir", str(tmp_path / "jax")])
    for name in ("utt2f0", "avg_f0"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    _, a = read_wav(str(gen / "u1_gen.wav"))
    _, b = read_wav(str(gt / "u1.wav"))
    assert res["utt2f0"]["u1"] == jax_metrics.f0_metrics(a, b, FS, tracker="yin")
    assert sorted(res["utt2f0"]) == ["u1", "u2"] and set(res["summary"]) == set(
        evaluate_f0.KEYS)


def test_evaluate_clis_take_a_wav_scp(tmp_path):
    """A wav.scp with a sibling segments file on the generated side: the
    segment ids pair with the ground truth by prefix."""
    gen, gt = _wavs(tmp_path)
    scp_dir = tmp_path / "scp"
    scp_dir.mkdir()
    (scp_dir / "wav.scp").write_text(f"rec {gen / 'u1_gen.wav'}\n")
    (scp_dir / "segments").write_text("u1_gen rec 0.0 0.5\n")
    res = evaluate_mcd.main(["--wavdir", str(scp_dir / "wav.scp"), "--gt-wavdir", str(gt),
                             "--n_jobs", "1", "--verbose", "0"])
    _, a = read_wav(str(gen / "u1_gen.wav"))
    _, b = read_wav(str(gt / "u1.wav"))
    assert res["utt2mcd"] == {"u1": jax_metrics.mel_cepstral_distortion(a[: FS // 2], b, FS)}
    with pytest.raises(SystemExit):
        evaluate_f0.main(["--wavdir", str(gen), "--gt-wavdir", str(gt), "--tracker", "dio"])
