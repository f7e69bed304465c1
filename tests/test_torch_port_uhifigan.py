"""The port's U-Net HiFi-GAN held against the JAX package on the CPU: the
forward, causal and not, at the opencpop config's odd scales (down 5, 5,
4, 3; up 3, 4, 5, 5) with narrow channels, the f0/excitation collater bit
for bit, the train step against JAX's ``build_train_step`` on
``uhifigan.v1.debug.yaml`` (AdamW, ExponentialLR) with its dropout at 0,
the dropout's seeded masks, the decode against JAX's
``_inference_uhifigan``, ``bin/train.main`` -> ``bin/decode.main`` on an
f0/excitation dump, ``SineGen`` against JAX's with the same draws, and
chip_smoke's embedded U-Net HiFi-GAN config against its YAML file.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.convert.torch_checkpoint import convert_state_dict  # noqa: E402
from parallelwavegan_tpu.data.collater import Collater as JaxCollater  # noqa: E402
from parallelwavegan_tpu.layers.sine import SineGen as JaxSineGen  # noqa: E402
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.optimizers import (  # noqa: E402
    build_optimizer_from_config as jax_optimizer_from_config,
)
from parallelwavegan_tpu.train.criterion import build_criterion as jax_criterion  # noqa: E402
from parallelwavegan_tpu.train.state import init_train_state  # noqa: E402
from parallelwavegan_tpu.train.step import build_train_step  # noqa: E402
from parallelwavegan_tpu.utils.model import InferenceModel as JaxInferenceModel  # noqa: E402
from parallelwavegan_tpu_torch.bin import decode, train  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import jax_params_to_state_dict  # noqa: E402
from parallelwavegan_tpu_torch.data.collater import Collater  # noqa: E402
from parallelwavegan_tpu_torch.layers.sine import SineGen  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.f0 import extract_f0_and_excitation  # noqa: E402
from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config  # noqa: E402
from parallelwavegan_tpu_torch.train.criterion import build_criterion  # noqa: E402
from parallelwavegan_tpu_torch.train.step import (  # noqa: E402
    NOISE_G,
    TrainStep,
    batch_to_device,
    generator_forward,
)
from parallelwavegan_tpu_torch.utils.model import InferenceModel  # noqa: E402

yaml = pytest.importorskip("yaml")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4  # tests/test_torch_parity.py:41
UHIFI, MSMPD = "UHiFiGANGenerator", "HiFiGANMultiScaleMultiPeriodDiscriminator"
DEBUG_YAML = "egs/yesno/voc1/conf/uhifigan.v1.debug.yaml"
# opencpop's uhifigan.v1.yaml generator at 4 channels (64 at the bottleneck)
OPENCPOP = dict(in_channels=6, out_channels=1, channels=4, kernel_size=7,
                downsample_scales=[5, 5, 4, 3], downsample_kernel_sizes=[10, 10, 8, 6],
                upsample_scales=[3, 4, 5, 5], upsample_kernel_sizes=[6, 8, 10, 10],
                resblock_kernel_sizes=[3, 7, 11],
                resblock_dilations=[[1, 3, 5], [1, 3, 5], [1, 3, 5]], dropout=0.0)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _load_yaml(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return yaml.safe_load(f)


def _port_from_jax(gp, variables):
    model = get_model_class(UHIFI)(**gp)
    model.load_state_dict(jax_params_to_state_dict(UHIFI, gp, variables))
    return model


def _ncw(a):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)))


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax_at_the_opencpop_scales(causal):
    """The odd scales' padding (scale // 2 + scale % 2) and output padding
    (scale % 2) keep every length: 7 frames x 300 in and out, within 2e-4."""
    gp = dict(OPENCPOP, use_causal_conv=causal)
    rs = np.random.RandomState(0)
    e = (0.1 * rs.randn(2, 7 * 300, 1)).astype(np.float32)
    c = rs.randn(2, 7, 6).astype(np.float32)
    jm = jax_model_class(UHIFI)(**gp)
    variables = jm.init(jax.random.key(0), jnp.asarray(e), jnp.asarray(c))
    want = np.asarray(jm.apply(variables, jnp.asarray(e), jnp.asarray(c)))
    model = _port_from_jax(gp, variables).eval()
    with torch.no_grad():
        got = model(_ncw(e), _ncw(c)).numpy().transpose(0, 2, 1)
    assert got.shape == want.shape == (2, 7 * 300, 1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.abs(want).max() > 10 * TOL


def _f0_items(rs, n, frames, hop, mels=5):
    items = []
    for i in range(n):
        t = frames + 3 * i
        items.append(((0.3 * rs.randn(t * hop)).astype(np.float32),
                      rs.randn(t, mels).astype(np.float32),
                      np.abs(rs.randn(t)).astype(np.float32),
                      (0.1 * rs.randn(t, hop)).astype(np.float32)))
    return items


def test_f0_excitation_collater_matches_jax_bit_for_bit():
    """(audio, mel, f0, excitation (T', hop)) items: 'f0' (B, T', 1) and
    'excitation' (B, T' hop, 1) cropped with the mel, over two batches."""
    items = _f0_items(np.random.RandomState(1), 3, 30, 16)
    kw = dict(batch_max_steps=256, hop_size=16, aux_context_window=0,
              use_f0_and_excitation=True)
    port, jaxc = (C(**kw, rng=np.random.default_rng(2)) for C in (Collater, JaxCollater))
    for _ in range(2):
        got, want = port(items), jaxc(items)
        assert sorted(got) == sorted(want) == ["c", "excitation", "f0", "y"]
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["excitation"].shape == (3, 256, 1) and got["f0"].shape == (3, 16, 1)


def test_train_step_matches_jax_build_train_step():
    """``uhifigan.v1.debug.yaml`` as it ships but its dropout 0 (the two
    packages draw different masks) and crops of 1024 samples (4 frames)
    for its 4096: 4 G+D steps with AdamW and ExponentialLR; every loss,
    every parameter of both models and the scale discriminator's spectral
    (u, v) to 1e-5. Both run in float64, as the duration HiFi-GAN's A/B
    does: in float32 the G parameters part by 9.4e-4 after 4 steps (the
    mel loss's log at an untrained generator's small magnitudes leaves the
    gradients apart, and AdamW's first update, about lr sign(g), moves the
    elements under that noise 2 lr apart). XLA's float64 convolutions on
    the CPU take 33 s a step at 4096 samples, hence the shorter crop."""
    config = _load_yaml(DEBUG_YAML)
    config["generator_params"]["dropout"] = 0.0
    config["batch_max_steps"] = 1024
    gp, dp = config["generator_params"], config["discriminator_params"]
    hop = config["hop_size"]
    collater = Collater(batch_max_steps=config["batch_max_steps"], hop_size=hop,
                        aux_context_window=0, use_f0_and_excitation=True,
                        rng=np.random.default_rng(3))
    items = _f0_items(np.random.RandomState(4), 2, 20, hop, gp["in_channels"])
    batches = [{k: v.astype(np.float64) for k, v in collater(items).items()}
               for _ in range(4)]
    init = torch.Generator().manual_seed(0)
    gen = get_model_class(UHIFI)(**gp, generator=init).double()
    dis = get_model_class(MSMPD)(**dp, generator=init).double()
    jcfg = json.loads(json.dumps(config))

    def to_jax(model_type, params, module):
        return convert_state_dict(model_type, params, {
            k: v.detach().numpy().copy() for k, v in module.state_dict().items()})

    params_g = to_jax(UHIFI, gp, gen)[0]
    params_d, vars_d = to_jax(MSMPD, dp, dis)
    opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
    opt_d = build_optimizer_from_config(config, "discriminator", dis.parameters())
    crit = build_criterion(config)
    crit.mel.mel.melmat = crit.mel.mel.melmat.double()
    step = TrainStep(config, gen, dis, crit, opt_g, opt_d)
    phases = [(True, True)] * 4
    with jax.enable_x64(True):
        tx_g, tx_d = (jax_optimizer_from_config(jcfg, w) for w in ("generator",
                                                                   "discriminator"))
        state = init_train_state(params_g, params_d, tx_g, tx_d, vars_d=vars_d)
        jg, jd = jax_model_class(UHIFI)(**gp), jax_model_class(MSMPD)(**dp)
        steps = {p: build_train_step(jcfg, jg, jd, jax_criterion(jcfg), tx_g, tx_d,
                                     train_g=p[0], train_d=p[1], donate=False)
                 for p in set(phases)}
        for i, (batch, phase) in enumerate(zip(batches, phases)):
            state, want = steps[phase](state, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jax.random.key(i))
            got = step(batch_to_device(batch, "cpu"), *phase, step=i)
            assert sorted(got) == sorted(want), i
            for k in want:
                rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
                assert rel <= 1e-5, (i, k, float(got[k]), float(want[k]))
        state = jax.tree_util.tree_map(np.asarray, state)
    assert {"mel_loss", "feature_matching_loss", "real_loss"} <= set(got)
    assert got["mel_loss"].dtype == torch.float64
    for name, have, model in (
            ("G", jax_params_to_state_dict(UHIFI, gp, state.params_g), gen),
            ("D", jax_params_to_state_dict(MSMPD, dp, state.params_d,
                                           spectral=state.vars_d["spectral"]), dis)):
        sd = model.state_dict()
        assert sorted(have) == sorted(sd), name
        for k, v in have.items():
            err = float((sd[k] - v.double()).abs().max())
            assert err <= 1e-5, (name, k, err)


def test_dropout_masks_are_seeded_by_step_and_off_outside_training():
    """The G phase's masks repeat for the same (seed, step) and differ
    between steps; the D phase's re-run (``train=False``) and eval mode
    run without dropout, and agree with each other."""
    gp = dict(OPENCPOP, dropout=0.5)
    gen = get_model_class(UHIFI)(**gp, generator=torch.Generator().manual_seed(5))
    rs = np.random.RandomState(6)
    batch = {"excitation": torch.from_numpy((0.1 * rs.randn(1, 1, 4 * 300)).astype(np.float32)),
             "c": torch.from_numpy(rs.randn(1, 6, 4).astype(np.float32))}
    config = {"generator_type": UHIFI}
    with torch.no_grad():
        a, b, c = (generator_forward(config, gen, batch, (0, s, NOISE_G)) for s in (3, 3, 4))
        off = generator_forward(config, gen, batch, (0, 3, NOISE_G), train=False)
        gen.eval()
        ev = generator_forward(config, gen, batch, (0, 3, NOISE_G))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, off)
    assert torch.equal(off, ev)


def _jax_inference_model(gp, model):
    variables = convert_state_dict(UHIFI, gp, {
        k: v.detach().numpy().copy() for k, v in model.state_dict().items()})
    return JaxInferenceModel(jax_model_class(UHIFI)(**gp), variables[0],
                             {"generator_type": UHIFI, "generator_params": gp},
                             vars_g=variables[1])


def test_inference_matches_jax_inference_uhifigan():
    """``InferenceModel.inference(c, excitation=...)``: the mel edge-padded to
    the 32-frame bucket, the excitation cut (longer than the padded length)
    or zero-padded (shorter), the output trimmed, within 2e-4 of JAX's."""
    gp = OPENCPOP
    model = get_model_class(UHIFI)(**gp, generator=torch.Generator().manual_seed(7))
    want_model = _jax_inference_model(gp, model)
    model.remove_weight_norm()
    port = InferenceModel(model.eval(), "cpu")
    rs = np.random.RandomState(8)
    for frames, exc_len in ((40, 64 * 300 + 50), (19, 10 * 300)):
        c = rs.randn(frames, 6).astype(np.float32)
        e = (0.1 * rs.randn(exc_len)).astype(np.float32)
        got = port.inference(c, excitation=e)
        want = np.asarray(want_model.inference(c, excitation=e))
        assert got.shape == want.shape == (frames * 300, 1)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _write_f0_dump(root, n, frames, config, seed):
    """npy dumps: a sine of a random f0 plus noise, its mel, and the f0 and
    excitation the port's ``ops/f0.py`` makes of it (one excitation row a
    frame), as the port's preprocess writes them."""
    from parallelwavegan_tpu_torch.ops.mel import logmelfilterbank

    rs = np.random.RandomState(seed)
    hop, fs = config["hop_size"], config["sampling_rate"]
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        t = (frames + 5 * i) * hop
        audio = (0.3 * np.sin(2 * np.pi * rs.uniform(100, 200) * np.arange(t) / fs)
                 + 0.02 * rs.randn(t)).astype(np.float32)
        mel = logmelfilterbank(audio, fs, fft_size=config["fft_size"], hop_size=hop,
                               num_mels=config["num_mels"], fmin=config["fmin"],
                               fmax=config["fmax"])[: t // hop]
        f0, exc = extract_f0_and_excitation(audio, fs, hop)
        for name, arr in (("wave", audio), ("feats", mel), ("f0", f0[: t // hop]),
                          ("excitation", exc.reshape(t // hop, hop))):
            np.save(os.path.join(root, f"u{i}-{name}.npy"), arr.astype(np.float32))


def test_train_main_then_decode_on_an_f0_dump(tmp_path):
    """``bin/train.main`` on ``uhifigan.v1.debug.yaml`` as it ships but for
    its loop (2 steps, G and D from the start, an eval and a checkpoint at
    step 2) on an npy dump of waves, mels, f0 and excitations, then
    ``bin/decode.main`` of the checkpoint with f0/excitation on by default:
    every WAV of its mel's length."""
    config = dict(_load_yaml(DEBUG_YAML), format="npy", train_max_steps=2,
                  generator_train_start_steps=0, discriminator_train_start_steps=0,
                  save_interval_steps=2, eval_interval_steps=2, log_interval_steps=1,
                  num_workers=1)
    for split, seed in (("train", 0), ("dev", 1)):
        _write_f0_dump(str(tmp_path / split), 2, 20, config, seed)
    with open(tmp_path / "c.json", "w") as f:
        json.dump(config, f)
    out = train.main(["--train-dumpdir", str(tmp_path / "train"), "--dev-dumpdir",
                      str(tmp_path / "dev"), "--outdir", str(tmp_path / "exp"), "--config",
                      str(tmp_path / "c.json"), "--device", "cpu", "--verbose", "0"])
    assert out["steps"] == 2
    logged = {}
    for s, m in out["history"]:
        logged.setdefault(s, {}).update(m)
    assert {"train/mel_loss", "train/real_loss", "eval/generator_loss"} <= set(logged[2])
    assert all(np.isfinite(v) for m in logged.values() for v in m.values())
    res = decode.main(["--dumpdir", str(tmp_path / "dev"), "--outdir",
                       str(tmp_path / "wav"), "--batch-size", "2", "--checkpoint",
                       str(tmp_path / "exp" / "checkpoint-2steps.pkl"), "--device", "cpu",
                       "--verbose", "0"])
    assert len(res["rtfs"]) == 2  # one utterance at a time with the excitation
    from scipy.io import wavfile

    for i in range(2):
        _, wav = wavfile.read(tmp_path / "wav" / f"u{i}-feats_gen.wav")
        assert wav.shape == ((20 + 5 * i) * config["hop_size"],) and np.abs(wav).max() > 0


def test_sine_gen_matches_jax_with_the_same_draws():
    """JAX's SineGen and the port's on f0 with voiced and unvoiced frames, 3
    harmonics, the port given JAX's two draws (its key split as JAX splits
    it): sines, uv and noise."""
    rs = np.random.RandomState(9)
    f0 = np.repeat(rs.uniform(80, 300, (2, 12)) * (rs.rand(2, 12) > 0.3), 40, axis=1)
    f0 = f0[..., None].astype(np.float32)  # (B, T, 1)
    key = jax.random.key(10)
    jgen = JaxSineGen(samp_rate=16000, harmonic_num=2)
    want = [np.asarray(a) for a in jgen(jnp.asarray(f0), key)]
    k_ini, k_noise = jax.random.split(key)
    rand_ini = np.asarray(jax.random.uniform(k_ini, (2, 3)))
    normal = np.asarray(jax.random.normal(k_noise, (2, 480, 3), jnp.float32))
    got = SineGen(samp_rate=16000, harmonic_num=2)(
        _ncw(f0), rand_ini=torch.from_numpy(rand_ini), normal=_ncw(normal))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy().transpose(0, 2, 1), b, atol=1e-5, rtol=0)
    assert np.abs(want[0]).max() > 0.1 and 0 < want[1].mean() < 1
    # drawn from a generator: seeded, the same draws again
    a = SineGen(16000)(_ncw(f0), generator=torch.Generator().manual_seed(1))[0]
    b = SineGen(16000)(_ncw(f0), generator=torch.Generator().manual_seed(1))[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("name,rel", [
    ("UHIFIGAN_OPENCPOP_CONFIG", "egs/opencpop/voc1/conf/uhifigan.v1.yaml"),
    ("UHIFIGAN_YESNO_DEBUG_CONFIG", DEBUG_YAML),
])
def test_chip_smoke_uhifigan_config_equals_shipped_config(name, rel):
    """The U-Net HiFi-GAN configs of chip_smoke.py's phase 36 are the YAMLs
    verbatim."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    assert json.loads(json.dumps(getattr(smoke, name))) == _load_yaml(rel)
