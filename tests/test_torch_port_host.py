"""Host-side pieces of the PyTorch port: the numpy copies held equal to the
JAX package's, the smoke script's v1 parameters held equal to the shipped
config, IO helpers, and the import boundary (no jax/flax in the port)."""

import ast
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parallelwavegan_tpu.ops import mel as jax_mel  # noqa: E402
from parallelwavegan_tpu_torch.data.datasets import MelDataset  # noqa: E402
from parallelwavegan_tpu_torch.ops import mel as port_mel  # noqa: E402
from parallelwavegan_tpu_torch.utils.config import load_config  # noqa: E402
from parallelwavegan_tpu_torch.utils.io import find_files, write_wav  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V1_YAML = os.path.join(ROOT, "egs", "ljspeech", "voc1", "conf", "hifigan.v1.yaml")


@pytest.mark.parametrize("kw", [
    dict(sampling_rate=22050, fft_size=1024, hop_size=256, num_mels=80,
         fmin=80, fmax=7600),
    dict(sampling_rate=16000, fft_size=512, hop_size=128, win_length=400,
         num_mels=40, log_base=None),
])
def test_logmelfilterbank_equals_jax_package(kw):
    audio = np.random.RandomState(0).randn(9000) * 0.1
    sr = kw.pop("sampling_rate")
    np.testing.assert_array_equal(port_mel.logmelfilterbank(audio, sr, **kw),
                                  jax_mel.logmelfilterbank(audio, sr, **kw))
    np.testing.assert_array_equal(
        port_mel.mel_filterbank(sr, 1024, 80, 80, 7600),
        jax_mel.mel_filterbank(sr, 1024, 80, 80, 7600))


def test_chip_smoke_v1_parameters_equal_shipped_config():
    yaml = pytest.importorskip("yaml")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    with open(V1_YAML) as f:
        cfg = yaml.safe_load(f)
    assert smoke.V1_GENERATOR == cfg["generator_params"]
    for k, v in smoke.V1_FEATURES.items():
        assert cfg[k] == v, k
    assert cfg["generator_type"] == "HiFiGANGenerator"


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(ROOT, "parallelwavegan_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "parallelwavegan_tpu"), (path, mod)


def test_load_config_json_and_yaml(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"a": 1, "b": [1, 2]}))
    assert load_config(str(p)) == {"a": 1, "b": [1, 2]}
    pytest.importorskip("yaml")
    assert load_config(V1_YAML)["generator_params"]["channels"] == 512


def test_mel_dataset_and_wav_io(tmp_path):
    from scipy.io import wavfile

    (tmp_path / "sub").mkdir()
    for name in ("b-feats.npy", "sub/a-feats.npy"):
        np.save(tmp_path / name, np.full((3, 2), len(name), np.float32))
    (tmp_path / "x.txt").write_text("")
    ds = MelDataset(str(tmp_path), mel_query="*-feats.npy", mel_load_fn=np.load)
    assert len(ds) == 2 and ds.utt_ids == ["b-feats", "a-feats"]
    utt, mel = ds[1]
    assert utt == "a-feats" and mel.shape == (3, 2)
    assert sorted(find_files(str(tmp_path), "*.npy")) == [
        str(tmp_path / "b-feats.npy"), str(tmp_path / "sub" / "a-feats.npy")]
    with pytest.raises(FileNotFoundError):
        MelDataset(str(tmp_path), mel_query="*.h5")

    write_wav(str(tmp_path / "y.wav"), 8000, np.array([0.0, 0.5, -2.0, 1.0]))
    fs, data = wavfile.read(tmp_path / "y.wav")
    assert fs == 8000 and data.dtype == np.int16
    assert data.tolist() == [0, 16383, -32767, 32767]
