"""The port's copies of the evaluation numpy code, ``ops/mcep.py`` and
``ops/metrics.py``, against the JAX package's on seeded signals of 1 s at
16 kHz: both run the same numpy operations in the same order, so every
result is held bit for bit (tolerance 0)."""

import numpy as np
import pytest

from torch_port_threads import one_torch_thread  # noqa: F401

from parallelwavegan_tpu.ops import mcep as jax_mcep  # noqa: E402
from parallelwavegan_tpu.ops import metrics as jax_metrics  # noqa: E402
from parallelwavegan_tpu_torch.ops import mcep, metrics  # noqa: E402

FS = 16000


def _voice(seed: int, f0: float) -> np.ndarray:
    """1 s of a gliding harmonic tone with a little noise, as decode's WAVs
    are read (float in [-1, 1])."""
    t = np.arange(FS) / FS
    rs = np.random.RandomState(seed)
    phase = 2 * np.pi * (f0 + 20 * t) * t
    y = sum(0.2 / k * np.sin(k * phase) for k in (1, 2, 3)) + 0.01 * rs.randn(FS)
    return y.astype(np.float32)


def test_mcep_matches_jax():
    x = _voice(0, 120.0).astype(np.float64)
    np.testing.assert_array_equal(mcep.sptk_extract(x, FS), jax_mcep.sptk_extract(x, FS))
    np.testing.assert_array_equal(mcep.sptk_extract(x, FS, n_fft=1024, n_shift=128),
                                  jax_mcep.sptk_extract(x, FS, n_fft=1024, n_shift=128))
    for fs in (8000, 16000, 22050, 24000, 44100, 48000, 12345):
        assert mcep.best_mcep_params(fs) == jax_mcep.best_mcep_params(fs)
    frames = x[:2048].reshape(4, 512) * np.hamming(512)
    np.testing.assert_array_equal(mcep.mcep(frames, 24, 0.42), jax_mcep.mcep(frames, 24, 0.42))
    sp = np.abs(np.fft.rfft(frames, axis=-1)) ** 2 + 1e-6
    np.testing.assert_array_equal(mcep.sp2mc(sp, 24, 0.42), jax_mcep.sp2mc(sp, 24, 0.42))
    c = np.random.RandomState(1).randn(3, 25)
    np.testing.assert_array_equal(mcep.freqt(c, 30, 0.42), jax_mcep.freqt(c, 30, 0.42))
    np.testing.assert_array_equal(mcep.warped_freqs(257, 0.42),
                                  jax_mcep.warped_freqs(257, 0.42))


def test_dtw_and_mcd_match_jax():
    a, b = _voice(0, 120.0), _voice(1, 130.0)
    x, y = mcep.sptk_extract(a, FS), mcep.sptk_extract(b[: FS - 1000], FS)
    for got, want in zip(metrics.dtw_path(x, y), jax_metrics.dtw_path(x, y)):
        np.testing.assert_array_equal(got, want)
    got = metrics.mel_cepstral_distortion(a, b, FS)
    assert got == jax_metrics.mel_cepstral_distortion(a, b, FS) and got > 0.1
    assert metrics.mel_cepstral_distortion(a, a, FS) == 0.0


@pytest.mark.parametrize("tracker", ["harvest", "yin"])
def test_f0_metrics_match_jax(tracker):
    a, b = _voice(0, 120.0), _voice(1, 126.0)
    got = metrics.f0_metrics(a, b, FS, tracker=tracker)
    assert got == jax_metrics.f0_metrics(a, b, FS, tracker=tracker)
    assert got["vuv_error_rate"] < 0.5 and np.isfinite(got["log_f0_rmse"])
    with pytest.raises(ValueError, match="unknown F0 tracker"):
        metrics.f0_metrics(a, b, FS, tracker="dio")
