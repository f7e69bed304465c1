"""Decode split over a mesh, the port against the JAX package
(``tests/test_sharded_decode.py``'s shapes): ``inference_sharded`` over
``make_mesh(["cpu"] * 8)`` against JAX's over its eight forced host devices
and against the port's bucketed ``inference``, for HiFi-GAN (through K1's
plain version), MelGAN (K6's) and Parallel WaveGAN (K3's, the same numpy
noise on both sides), chunk < context and the short fallback;
``inference_batch(mesh=...)`` with 3 rows over 2 and over 8 devices; and
``bin/decode.py --streaming`` and ``--sharded --batch-size 2`` on a tiny
dump. atol 2e-4, rtol 1e-3."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.bin import decode  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import load_model  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3
CASES = {
    "hifigan": ("HiFiGANGenerator", dict(
        in_channels=8, out_channels=1, channels=16, upsample_scales=[4, 2, 2],
        upsample_kernel_sizes=[8, 4, 4], resblock_kernel_sizes=[3, 5],
        resblock_dilations=[[1, 3], [1, 3]]), {"use_pallas_tail": True}),
    "melgan": ("MelGANGenerator", dict(
        in_channels=8, out_channels=1, channels=16, upsample_scales=[4, 4], stacks=2),
        {"use_pallas_stacks": True}),
    "pwg": ("ParallelWaveGANGenerator", dict(
        in_channels=1, out_channels=1, layers=6, stacks=2, residual_channels=16,
        gate_channels=32, skip_channels=16, aux_channels=8, aux_context_window=2,
        upsample_net="ConvInUpsampleNetwork", upsample_params={"upsample_scales": [4, 4]}),
        {"use_pallas_stack": True}),
}


def _checkpoint(tmp_path, case):
    gen_type, gp, flag = CASES[case]
    gen = get_model_class(gen_type)(**gp, generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "checkpoint-1steps.pkl")
    save_checkpoint(ckpt, gen.state_dict(), steps=1)
    config = {"sampling_rate": 16000, "hop_size": 16, "format": "npy", "version": "0.5.4",
              "generator_type": gen_type, "generator_params": gp}
    return ckpt, config, dict(config, generator_params=dict(gp, **flag))


def _models(tmp_path, case):
    ckpt, config, port_config = _checkpoint(tmp_path, case)
    return load_model(ckpt, port_config, device="cpu"), jax_load_model(ckpt, config)


def _shared_noise(monkeypatch, port, shape):
    """The same numpy noise for the port's ``_noise`` and JAX's draw."""
    z = np.random.RandomState(11).randn(*shape).astype(np.float32)
    monkeypatch.setattr(port, "_noise", lambda s, rng: torch.from_numpy(z.copy()))
    real = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, s, *a, **k: (
        jnp.asarray(z) if tuple(s) == tuple(shape) else real(key, s, *a, **k)))


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def test_make_mesh():
    mesh = make_mesh(["cpu"] * 3)
    assert mesh == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="empty"):
        make_mesh([])
    if not torch.cuda.is_available():  # never the CPU on its own
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.parametrize("case,t,ctx", [
    ("hifigan", 1024, 32), ("hifigan", 1003, 32),  # ragged last chunk
    ("melgan", 777, 32), ("pwg", 512, 32),
    ("hifigan", 200, 64),  # chunk < context: windows clamped to the true edges
    ("melgan", 40, 32),  # too short: one-shot
])
def test_sharded_matches_jax_and_one_shot(tmp_path, monkeypatch, case, t, ctx):
    port, jax_model = _models(tmp_path, case)
    mesh = make_mesh(["cpu"] * 8)
    jmesh = jax_make_mesh()
    assert np.prod(list(jmesh.shape.values())) == 8
    c = np.random.RandomState(0).randn(t, 8).astype(np.float32)
    up = port.upsample_factor
    if case == "pwg":
        _shared_noise(monkeypatch, port, (_ceil_to(t, 32) * up,))
    batches = []
    forward = port.forward_padded_batch
    monkeypatch.setattr(port, "forward_padded_batch",
                        lambda cw, z=None: batches.append(tuple(cw.shape)) or forward(cw, z))
    got = port.inference_sharded(c, mesh, context_frames=ctx)
    # the eight windows of the one device run as one batched forward
    pad_t = _ceil_to(t, 32)
    chunk = _ceil_to(-(-pad_t // 8), 32)
    sharded = pad_t >= 2 * chunk + 2 * ctx
    assert batches == ([(8, chunk + 2 * ctx, 8)] if sharded else [(1, pad_t, 8)])
    want = np.asarray(jax_model.inference_sharded(c, jmesh, context_frames=ctx))
    assert got.shape == want.shape == (t * up, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, port.inference(c), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ["hifigan", "pwg"])
@pytest.mark.parametrize("n_dev", [2, 8])
def test_inference_batch_over_a_mesh_matches_jax(tmp_path, monkeypatch, case, n_dev):
    """3 rows padded to a multiple of the devices with the last row, split
    in contiguous blocks; only the real rows come back."""
    port, jax_model = _models(tmp_path, case)
    rs = np.random.RandomState(1)
    mels = [rs.randn(t, 8).astype(np.float32) for t in (33, 40, 64)]
    rows = -(-3 // n_dev) * n_dev
    up = port.upsample_factor
    if case == "pwg":
        _shared_noise(monkeypatch, port, (rows, 64 * up))
    seen = []
    forward = port.forward_padded_batch
    monkeypatch.setattr(port, "forward_padded_batch",
                        lambda cw, z=None: seen.append(cw.clone()) or forward(cw, z))
    got = port.inference_batch(mels, mesh=make_mesh(["cpu"] * n_dev))
    assert [tuple(s.shape) for s in seen] == [(rows, 64, 8)]
    for r in range(3, rows):  # the last row repeated
        torch.testing.assert_close(seen[0][r], seen[0][2], rtol=0, atol=0)
    want = jax_model.inference_batch(mels, mesh=jax_make_mesh(jax.devices()[:n_dev]))
    assert len(got) == len(want) == 3
    for m, y, w in zip(mels, got, want):
        assert y.shape == np.asarray(w).shape == (m.shape[0] * up, 1)
        np.testing.assert_allclose(y, np.asarray(w), atol=ATOL, rtol=RTOL)


def test_sharded_rows_of_distinct_devices_run_apart(tmp_path, monkeypatch):
    """A mesh of two distinct devices runs each device's rows through its
    own replica of the generator, made once and kept."""
    ckpt, config, _ = _checkpoint(tmp_path, "melgan")
    port = load_model(ckpt, config, device="cpu")
    other = torch.device("meta")
    replica = port._on(other)
    assert replica is port._on(other) and replica.generator is not port.generator
    groups = []

    def fake(model):
        def run(cw, z=None):
            groups.append((cw.device.type, model.device.type, cw.shape[0]))
            return torch.zeros(cw.shape[0], cw.shape[1] * 16, 1)
        return run

    monkeypatch.setattr(port, "forward_padded_batch", fake(port))
    monkeypatch.setattr(replica, "forward_padded_batch", fake(replica))
    c = np.random.RandomState(3).randn(600, 8).astype(np.float32)
    port.inference_sharded(c, [torch.device("cpu"), other, torch.device("cpu"), other],
                           context_frames=16)
    assert groups == [("cpu", "cpu", 2), ("meta", "meta", 2)]


def _dump(tmp_path, lengths):
    dump = tmp_path / "dump"
    dump.mkdir()
    rs = np.random.RandomState(4)
    mels = {}
    for i, t in enumerate(lengths):
        mels[f"u{i}-feats"] = rs.randn(t, 8).astype(np.float32)
        np.save(dump / f"u{i}-feats.npy", mels[f"u{i}-feats"])
    return str(dump), mels


def _decode(argv, monkeypatch):
    """``decode.main(argv)`` and each waveform it wrote, before the 16-bit
    rounding."""
    wavs = {}
    real = decode.write_wav

    def write(path, fs, y):
        wavs[path.rsplit("/", 1)[1]] = y.copy()
        real(path, fs, y)

    monkeypatch.setattr(decode, "write_wav", write)
    decode.main(argv + ["--verbose", "0"])
    return wavs


def test_decode_cli_streaming_and_sharded(tmp_path, monkeypatch):
    ckpt, _, port_config = _checkpoint(tmp_path, "hifigan")
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(port_config))
    dump, mels = _dump(tmp_path, (229, 40, 100))
    common = ["--dumpdir", dump, "--checkpoint", ckpt, "--config", str(cfg),
              "--device", "cpu"]
    model = load_model(ckpt, port_config, device="cpu")
    streamed = _decode(common + ["--outdir", str(tmp_path / "s"), "--streaming",
                                 "--chunk-frames", "64", "--context-frames", "32"],
                       monkeypatch)
    assert sorted(streamed) == [f"u{i}-feats_gen.wav" for i in range(3)]
    for utt, mel in mels.items():
        np.testing.assert_allclose(
            streamed[f"{utt}_gen.wav"],
            model.inference_streaming(mel, chunk_frames=64, context_frames=32)[:, 0],
            atol=1e-6)
    # --sharded with --batch-size 2: each batch's rows over two devices
    meshes = []
    monkeypatch.setattr(decode, "make_mesh", lambda devices=None: meshes.append(devices) or
                        make_mesh(["cpu"] * 2))
    calls = []
    real_batch = type(model).inference_batch

    def batch(self, cs, normalize_before=False, rng=None, mesh=None):
        calls.append((len(cs), mesh))
        return real_batch(self, cs, normalize_before, rng, mesh)

    monkeypatch.setattr(type(model), "inference_batch", batch)
    sharded = _decode(common + ["--outdir", str(tmp_path / "b"), "--sharded",
                                "--batch-size", "2"], monkeypatch)
    assert meshes == [[torch.device("cpu")]]  # --device cpu: the one device
    assert calls == [(2, [torch.device("cpu")] * 2), (1, [torch.device("cpu")] * 2)]
    by_len = sorted(mels, key=lambda u: mels[u].shape[0])  # batches sorted by length
    want = model.inference_batch([mels[u] for u in by_len[:2]])
    for u, w in zip(by_len[:2], want):
        np.testing.assert_allclose(sharded[f"{u}_gen.wav"], w[:, 0], atol=1e-6)
    np.testing.assert_allclose(sharded[f"{by_len[2]}_gen.wav"],
                               model.inference(mels[by_len[2]])[:, 0], atol=1e-6)
