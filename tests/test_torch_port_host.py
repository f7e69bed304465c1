"""Host-side pieces of the PyTorch port: the numpy copies held equal to the
JAX package's, the smoke script's v1 parameters held equal to the shipped
config, IO helpers, and the import boundary (no jax/flax in the port)."""

import ast
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

from parallelwavegan_tpu.ops import mel as jax_mel  # noqa: E402
from parallelwavegan_tpu_torch.data.datasets import MelDataset  # noqa: E402
from parallelwavegan_tpu_torch.ops import mel as port_mel  # noqa: E402
from parallelwavegan_tpu_torch.utils.config import load_config  # noqa: E402
from parallelwavegan_tpu_torch.utils.io import find_files, write_wav  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V1_YAML = os.path.join(ROOT, "egs", "ljspeech", "voc1", "conf", "hifigan.v1.yaml")
PWG_V1_YAML = os.path.join(ROOT, "egs", "ljspeech", "voc1", "conf",
                           "parallel_wavegan.v1.yaml")
MB_V2_YAML = os.path.join(ROOT, "egs", "ljspeech", "voc1", "conf",
                          "multi_band_melgan.v2.yaml")
CSRC = os.path.join(ROOT, "parallelwavegan_tpu_torch", "ops", "kernels", "csrc")


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


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    return smoke


def test_chip_smoke_v1_parameters_equal_shipped_config():
    yaml = pytest.importorskip("yaml")
    smoke = _chip_smoke()
    with open(V1_YAML) as f:
        cfg = yaml.safe_load(f)
    assert smoke.V1_GENERATOR == cfg["generator_params"]
    for k, v in smoke.V1_FEATURES.items():
        assert cfg[k] == v, k
    assert cfg["generator_type"] == "HiFiGANGenerator"


def test_chip_smoke_pwg_v1_parameters_equal_shipped_config():
    yaml = pytest.importorskip("yaml")
    smoke = _chip_smoke()
    with open(PWG_V1_YAML) as f:
        cfg = yaml.safe_load(f)
    assert smoke.V1_PWG_GENERATOR == cfg["generator_params"]
    assert cfg["generator_params"]["use_pallas_stack_train"] is True
    for k, v in smoke.V1_FEATURES.items():
        assert cfg[k] == v, k
    assert cfg.get("generator_type", "ParallelWaveGANGenerator") == (
        "ParallelWaveGANGenerator")


def test_chip_smoke_mb_melgan_v2_parameters_equal_shipped_config():
    yaml = pytest.importorskip("yaml")
    smoke = _chip_smoke()
    with open(MB_V2_YAML) as f:
        cfg = yaml.safe_load(f)
    assert smoke.V2_MB_GENERATOR == cfg["generator_params"]
    assert cfg["generator_type"] == "MelGANGenerator"
    for k, v in smoke.V1_FEATURES.items():
        assert cfg[k] == v, k


def _exported(source):
    """(name, parameter count) of each function in the extern "C" block."""
    import re

    text = open(source).read()
    block = text[text.index('extern "C" {'):]
    for m in re.finditer(r"^(?:int|const char\*) (\w+)\(([^)]*)\)", block,
                         re.MULTILINE):
        yield m.group(1), len([a for a in m.group(2).split(",") if a.strip()])


def test_every_kernel_entry_point_has_a_ctypes_signature():
    from parallelwavegan_tpu_torch.ops.kernels import build

    assert build.sources() == sorted(
        os.path.join(CSRC, n) for n in os.listdir(CSRC) if n.endswith(".cu"))
    exported = {}
    for src in build.sources():
        exported.update(_exported(src))
    assert {"hifigan_resunits", "hifigan_mean", "wavenet_layer",
            "melgan_stack", "melgan_outconv", "tade1", "tade2"} <= set(exported)
    assert set(exported) == set(build._SIGNATURES) | {"hifigan_error_string"}
    for name, argtypes in build._SIGNATURES.items():
        assert len(argtypes) == exported[name], name


def test_library_hash_covers_every_source(tmp_path):
    import shutil

    from parallelwavegan_tpu_torch.ops.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    srcs = build.sources(str(csrc))
    assert [os.path.basename(p) for p in srcs] == [
        os.path.basename(p) for p in build.sources()]
    base = build.source_digest(srcs)
    assert base == build.source_digest(build.sources())
    headers = sorted(str(p) for p in csrc.glob("*.cuh"))
    assert headers  # the split-TF32 blocks and TADE pieces the kernels share
    for path in srcs + headers:  # an edit of any one source or header changes it
        text = open(path).read()
        with open(path, "w") as f:
            f.write(text + "\n// edit\n")
        assert build.source_digest(srcs) != base, path
        with open(path, "w") as f:
            f.write(text)
    (csrc / "extra.cu").write_text("// a new kernel source\n")
    assert build.source_digest(build.sources(str(csrc))) != base


def _fake_nvcc(tmp_path, monkeypatch):
    """Put an nvcc stand-in first on PATH: it appends its arguments to the
    returned log, fails on a source named bad.cu, else writes its -o file."""
    bin_dir, log = tmp_path / "bin", tmp_path / "nvcc.log"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        f'echo "$*" >> "{log}"\n'
        'case "$*" in *bad.cu*) echo "bad.cu: error"; exit 2;; esac\n'
        'echo built > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    return log


def test_build_runs_one_nvcc_per_source_then_one_link(tmp_path, monkeypatch):
    from parallelwavegan_tpu_torch.ops.kernels import build

    log = _fake_nvcc(tmp_path, monkeypatch)
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(build, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(build, "KernelLibrary", lambda path, seconds, log: path)
    srcs = build.sources()
    path = build.build()
    assert os.path.basename(path) == f"libport_kernels_{build.source_digest(srcs)}.so"
    calls = log.read_text().splitlines()
    assert len(calls) == len(srcs) + 1
    assert sorted(c.split()[-1] for c in calls[:-1]) == srcs  # one compile each
    assert all(" -c " in c for c in calls[:-1])
    assert " -shared " in calls[-1] and " -c " not in calls[-1]  # then the link
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert os.listdir(build_dir) == [os.path.basename(path)]  # objects removed
    assert build.build() == path  # cached: no second nvcc
    assert len(log.read_text().splitlines()) == len(calls)


def test_build_raises_when_a_source_fails_to_compile(tmp_path, monkeypatch):
    from parallelwavegan_tpu_torch.ops.kernels import build

    _fake_nvcc(tmp_path, monkeypatch)
    bad = tmp_path / "bad.cu"
    bad.write_text("// does not compile\n")
    srcs = build.sources() + [str(bad)]
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "sources", lambda: srcs)
    with pytest.raises(RuntimeError, match=r"nvcc failed: bad\.cu \(2\)"):
        build.build()
    assert os.listdir(tmp_path / "_build") == []  # no library, no objects


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
    pkg = os.path.join(ROOT, "parallelwavegan_tpu_torch")
    assert {os.path.join(pkg, "losses", f) for f in ("mel_loss.py", "feat_match_loss.py")
            } <= set(files)
    assert {os.path.join(pkg, "train", "precision.py"),
            os.path.join(pkg, "ops", "kernels", "mma_bf16.py")} <= set(files)
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
    ds = MelDataset(str(tmp_path), mel_query="*-feats.npy", mel_load_fn=np.load,
                    return_utt_id=True)
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
