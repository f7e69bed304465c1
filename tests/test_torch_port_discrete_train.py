"""Training of the discrete-symbol (HuBERT-unit) vocoders in the port held
against the JAX package on the CPU: the train step against JAX's
``build_train_step`` for the duration HiFi-GAN
(``hifigan_hubert_duration.v1.debug.yaml``) and a cut-down discrete
StyleMelGAN through ``use_pallas_tade_train``, ``bin/train.main`` ->
``bin/decode.main`` on a token dump for each of the three generators, and
chip_smoke's embedded hubert configs against their YAML files.

The train steps start from the port's weights (and spectral norm's (u,
v)) carried into JAX by its converter, take the same batches, and agree
to 1e-5 on every loss (relative) and every parameter after 4 steps, as the
other families' A/Bs do. The two packages draw different dropout masks,
so the duration predictor's rate is 0 in that A/B (a test of
``test_torch_port_discrete.py`` holds the port's dropout apart), and
StyleMelGAN's noise and window starts are pinned on both sides.
"""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.convert.torch_checkpoint import (  # noqa: E402
    convert_state_dict,
)
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.optimizers import build_optimizer as jax_build_optimizer  # noqa: E402
from parallelwavegan_tpu.train.criterion import build_criterion as jax_criterion  # noqa: E402
from parallelwavegan_tpu.train.state import init_train_state  # noqa: E402
from parallelwavegan_tpu.train.step import build_train_step  # noqa: E402
from parallelwavegan_tpu_torch.bin import decode, train  # noqa: E402
from parallelwavegan_tpu_torch.data.collater import Collater  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9  # noqa: E402
from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config  # noqa: E402
from parallelwavegan_tpu_torch.train.criterion import build_criterion  # noqa: E402
from parallelwavegan_tpu_torch.train.step import TrainStep, batch_to_device  # noqa: E402

yaml = pytest.importorskip("yaml")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIFI, DUR, STYLE = ("DiscreteSymbolHiFiGANGenerator", "DiscreteSymbolDurationGenerator",
                    "DiscreteSymbolStyleMelGANGenerator")
MSMPD, STYLE_D = "HiFiGANMultiScaleMultiPeriodDiscriminator", "StyleMelGANDiscriminator"
DEBUG_YAML = "egs/cvss_c/hubert_voc1/conf/hifigan_hubert_duration.v1.debug.yaml"
# style_melgan_hubert.v1.yaml cut down: width 64 (the TADE kernels'), ids
# of 3 speakers added at aux width 20, noise x8, blocks x5, x2, x1 (hubert's
# first, middle and last scales), hop 10; the train gate's min_t 40 sends
# blocks 1-2 (T = 40, 80) through K8/K9's plain versions
STYLE_G = dict(in_channels=16, aux_channels=20, channels=64, out_channels=1,
               num_embs=9, num_spk_embs=3, spk_emb_dim=20, kernel_size=9, dilation=2,
               noise_upsample_scales=[4, 2], upsample_scales=[5, 2, 1])
STYLE_FLAGS = dict(use_pallas_tade_train=True, pallas_tade_train_min_t=40)
STYLE_SMALL_D = dict(repeats=2, window_sizes=[16, 32],
                     pqmf_params=[[1, None, None, None], [2, 62, 0.267, 9.0]],
                     discriminator_params=dict(channels=8, max_downsample_channels=32,
                                               downsample_scales=[2, 2]))


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _load_yaml(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return yaml.safe_load(f)


def _debug_config(**generator_params) -> dict:
    cfg = _load_yaml(DEBUG_YAML)
    cfg["generator_params"].update(generator_params)
    return cfg


def _with_eps(cfg: dict) -> dict:
    """Adam's eps 1e-6, as the other families' A/Bs: both packages'
    gradients agree to about 1e-5 of each leaf's max (float32), and Adam
    turns a difference e in an element near 0 into a step difference of up
    to lr e / eps (with the shipped 1e-8, 1.7e-5 after 4 steps)."""
    for who in ("generator", "discriminator"):
        cfg[f"{who}_optimizer_params"]["eps"] = 1e-6
    return cfg


def _style_config() -> dict:
    cfg = _load_yaml("egs/vctk/hubert_voc1/conf/style_melgan_hubert.v1.yaml")
    cfg.update(hop_size=10, sampling_rate=8000, format="npy", batch_size=2,
               batch_max_steps=80, generator_params=dict(STYLE_G, **STYLE_FLAGS),
               discriminator_params=STYLE_SMALL_D, discriminator_train_start_steps=1,
               stft_loss_params={"fft_sizes": [16, 32, 8], "hop_sizes": [4, 8, 2],
                                 "win_lengths": [12, 24, 6], "window": "hann_window"})
    cfg["generator_scheduler_params"]["milestones"] = [2, 3]
    return _with_eps(cfg)


def _to_jax(model_type, params, module):
    """The module's weights as JAX trees (its converter runs ``init`` under
    eval_shape in float32; float64 weights stay float64)."""
    sd = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
    return convert_state_dict(model_type, params, sd)


def _jax_optimizers(cfg):
    return [jax_build_optimizer(cfg[f"{w}_optimizer_type"], cfg[f"{w}_optimizer_params"],
                                cfg[f"{w}_scheduler_type"], cfg[f"{w}_scheduler_params"],
                                cfg[f"{w}_grad_norm"])
            for w in ("generator", "discriminator")]


def _assert_trees_close(pairs):
    for name, tree, got in pairs:
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        assert len(leaves) == len(jax.tree_util.tree_leaves(got)), name
        for (path, a), b in zip(leaves, jax.tree_util.tree_leaves(got)):
            err = float(np.abs(np.asarray(a) - b).max())
            assert err <= 1e-5, (name, jax.tree_util.keystr(path), err)


def _run_steps(config, gen, dis, jg, jd, batches, phases, x64=False):
    """The port's and JAX's steps on the same batches from the same weights
    (with ``x64`` both in float64: the port's modules and mel basis, JAX
    under ``enable_x64``); returns JAX's final state after holding every
    loss to 1e-5 relative."""
    jcfg = json.loads(json.dumps(config))
    gp, dp = config["generator_params"], config["discriminator_params"]
    params_d, vars_d = _to_jax(config["discriminator_type"], dp, dis)
    params_g = _to_jax(config["generator_type"], gp, gen)[0]
    opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
    opt_d = build_optimizer_from_config(config, "discriminator", dis.parameters())
    crit = build_criterion(config)
    if x64:
        crit.mel.mel.melmat = crit.mel.mel.melmat.double()
    step = TrainStep(config, gen, dis, crit, opt_g, opt_d)
    with jax.enable_x64(x64):
        tx_g, tx_d = _jax_optimizers(jcfg)
        state = init_train_state(params_g, params_d, tx_g, tx_d, vars_d=vars_d)
        steps = {p: build_train_step(jcfg, jg, jd, jax_criterion(jcfg), tx_g, tx_d,
                                     train_g=p[0], train_d=p[1], donate=False)
                 for p in set(phases)}
        for i, (batch, phase) in enumerate(zip(batches, phases)):
            jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "z"}
            state, want = steps[phase](state, jbatch, jax.random.key(i))
            got = step(batch_to_device(batch, "cpu"), *phase, step=i)
            assert sorted(got) == sorted(want), i
            for k in want:
                rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
                assert rel <= 1e-5, (i, k, float(got[k]), float(want[k]))
        return jax.tree_util.tree_map(np.asarray, state), got


def _token_items(rs, n, frames, hop, vocab, speakers=0):
    """(audio, ids) items: runs of 1-4 equal units, a speaker per item."""
    items = []
    for _ in range(n):
        units = np.repeat(rs.randint(0, vocab, frames), rs.randint(1, 5, frames))[:frames]
        feats = units[:, None].astype(np.float32)
        if speakers:
            feats = np.concatenate([feats, np.full_like(feats, rs.randint(speakers))], 1)
        items.append(((0.3 * rs.randn(frames * hop)).astype(np.float32), feats))
    return items


def test_duration_train_step_matches_jax_build_train_step():
    """hifigan_hubert_duration.v1.debug.yaml as it ships but its dropout
    rate 0 (the two packages draw different masks): 4 steps (2 G-only, 2
    G+D) on collated runs and durations; every loss (the
    duration loss among them, times lambda_aux 45 with the mel loss), every
    parameter of both models (the duration predictor's too) and the
    spectral (u, v) to 1e-5.

    Both run in float64. In float32 the G phase's gradients part by up to
    6.4e-4 of a leaf's largest (the mel loss's log of the untrained
    generator's small magnitudes; in float64 by 2.7e-11), and Adam's first
    update, about lr sign(g), takes the elements under that noise 2 lr
    apart: 3.2e-4 on ``upsamples_0`` after one step, with eps 1e-8 or 1e-6."""
    config = _debug_config(duration_dropout_rate=0.0)
    gp, dp = config["generator_params"], config["discriminator_params"]
    hop = config["hop_size"]
    collater = Collater(batch_max_steps=config["batch_max_steps"], hop_size=hop,
                        aux_context_window=0, use_duration=True,
                        rng=np.random.default_rng(0))
    items = _token_items(np.random.RandomState(0), 2, 24, hop, gp["num_embs"])
    batches = [collater(items) for _ in range(4)]
    assert batches[0]["c"].dtype == np.int32 and (batches[0]["ds"].sum(1) == 10).all()
    for b in batches:
        b["y"] = b["y"].astype(np.float64)
    gen = get_model_class(DUR)(**gp, generator=torch.Generator().manual_seed(0)).double()
    dis = get_model_class(MSMPD)(**dp, generator=torch.Generator().manual_seed(1)).double()
    jg, jd = jax_model_class(DUR)(**gp), jax_model_class(MSMPD)(**dp)
    phases = [(True, False)] * 2 + [(True, True)] * 2
    state, got = _run_steps(config, gen, dis, jg, jd, batches, phases, x64=True)
    assert {"duration_loss", "mel_loss", "feature_matching_loss", "real_loss"} <= set(got)
    assert got["duration_loss"].dtype == torch.float64
    params_d, vars_d = _to_jax(MSMPD, dp, dis)
    _assert_trees_close([("G", state.params_g, _to_jax(DUR, gp, gen)[0]),
                         ("D", state.params_d, params_d),
                         ("D (u, v)", state.vars_d, vars_d)])


class _PinnedZ:
    """The JAX generator's ``apply`` with z fixed: JAX's step draws the
    discrete StyleMelGAN's noise inside ``apply``, the port takes the
    batch's ``z``."""

    def __init__(self, module, z):
        self.module, self.z = module, jnp.asarray(z)

    def apply(self, variables, c, rngs=None):
        return self.module.apply(variables, c, self.z, rngs=rngs)


def test_style_train_step_matches_jax_build_train_step(monkeypatch):
    """The cut-down hubert StyleMelGAN with ``use_pallas_tade_train`` (blocks
    1-2 through K8/K9's plain versions) against JAX's XLA path: 4 G+D steps
    on float32 ids, the same z and window starts."""
    config = _style_config()
    rs = np.random.RandomState(8)
    z = rs.randn(2, 1, STYLE_G["in_channels"]).astype(np.float32)
    collater = Collater(batch_max_steps=80, hop_size=10, aux_context_window=0,
                        rng=np.random.default_rng(1))
    items = _token_items(rs, 2, 20, 10, STYLE_G["num_embs"], STYLE_G["num_spk_embs"])
    batches = []
    for _ in range(4):
        b = dict(collater(items), z=z)
        for key in ("adv", "real", "fake"):
            b[f"rwd_starts_{key}"] = np.array(
                [rs.randint(0, 80 - ws) for ws in STYLE_SMALL_D["window_sizes"] * 2],
                np.int32)
        batches.append(b)
    assert batches[0]["c"].shape == (2, 8, 2) and batches[0]["c"].dtype == np.float32
    gen = get_model_class(STYLE)(**config["generator_params"],
                                 generator=torch.Generator().manual_seed(0))
    dis = get_model_class(STYLE_D)(**STYLE_SMALL_D, generator=torch.Generator().manual_seed(1))
    jg = _PinnedZ(jax_model_class(STYLE)(**STYLE_G), z)
    jd = jax_model_class(STYLE_D)(**STYLE_SMALL_D)
    seen, real = [], k9.tade_block_train.apply

    def spy(x, *args):
        seen.append(x.shape[1])
        return real(x, *args)

    monkeypatch.setattr(k9.tade_block_train, "apply", spy)
    phases = [(True, True)] * 4
    state, got = _run_steps(config, gen, dis, jg, jd, batches, phases)
    assert "real_loss" in got and "spectral_convergence_loss" in got
    assert seen == [40, 80] * 8  # 4 G forwards and 4 D-phase re-runs
    _assert_trees_close([("G", state.params_g, _to_jax(STYLE, STYLE_G, gen)[0]),
                         ("D", state.params_d, _to_jax(STYLE_D, STYLE_SMALL_D, dis)[0])])


def _write_token_dump(root, n, frames, hop, vocab, speakers, seed):
    """npy dumps of n utterances, utterance i of frames + 3 (n - i) frames."""
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        ((audio, feats),) = _token_items(rs, 1, frames + 3 * (n - i), hop, vocab, speakers)
        np.save(os.path.join(root, f"u{i}-wave.npy"), audio)
        np.save(os.path.join(root, f"u{i}-feats.npy"), feats)


DRIVES = {
    HIFI: lambda: dict(_debug_config(), generator_type=HIFI, use_duration_loss=False,
                       generator_params={k: v for k, v in dict(
                           _debug_config()["generator_params"], num_spk_embs=4,
                           spk_emb_dim=32).items() if not k.startswith("duration_")}),
    DUR: _debug_config,
    STYLE: _style_config,
}


@pytest.mark.parametrize("gen_type", [HIFI, DUR, STYLE])
def test_train_main_then_decode_on_a_token_dump(tmp_path, gen_type):
    """``bin/train.main`` 2 steps (G only, then G+D; an eval and a checkpoint
    at step 2) on npy token dumps, then ``bin/decode.main`` of the last
    checkpoint on the dev dump (``--use-pallas-tail``: K1's plain version
    where the trunk's gate takes it); the duration model's WAVs are as long
    as its predicted frames. The duration model trains 4 steps, and a
    resume from step 2 logs steps 3-4 as the uninterrupted run did: its
    dropout masks are drawn by (seed, step)."""
    steps = 4 if gen_type == DUR else 2
    config = dict(DRIVES[gen_type](), format="npy", train_max_steps=steps,
                  save_interval_steps=2, eval_interval_steps=2, log_interval_steps=1,
                  generator_train_start_steps=0, discriminator_train_start_steps=0,
                  num_workers=1)
    gp, hop = config["generator_params"], config["hop_size"]
    frames = config["batch_max_steps"] // hop + 2
    speakers = gp.get("num_spk_embs", 0)
    for split, seed in (("train", 0), ("dev", 1)):
        _write_token_dump(str(tmp_path / split), 2, frames, hop, gp["num_embs"], speakers,
                          seed)
    with open(tmp_path / "c.json", "w") as f:
        json.dump(config, f)

    def run(outdir, *extra):
        out = train.main(["--train-dumpdir", str(tmp_path / "train"), "--dev-dumpdir",
                          str(tmp_path / "dev"), "--outdir", str(tmp_path / outdir),
                          "--config", str(tmp_path / "c.json"), "--verbose", "0",
                          "--device", "cpu", *extra])
        logged = {}
        for s, means in out["history"]:
            logged.setdefault(s, {}).update(
                {k: v for k, v in means.items() if k.startswith(("train/", "eval/"))})
        return out["steps"], logged

    done, logged = run("exp")
    assert done == steps
    assert all(np.isfinite(v) for m in logged.values() for v in m.values())
    assert ("eval/duration_loss" in logged[2]) == (gen_type == DUR)
    assert "train/real_loss" in logged[2]
    if gen_type == DUR:
        assert "train/duration_loss" in logged[3]
        _, again = run("exp2", "--resume", str(tmp_path / "exp" / "checkpoint-2steps.pkl"))
        for s in (3, 4):  # the eval's crops follow the dev loader's own stream
            assert ({k: v for k, v in again[s].items() if k.startswith("train/")}
                    == {k: v for k, v in logged[s].items() if k.startswith("train/")}), s
    from scipy.io import wavfile

    decode.main(["--dumpdir", str(tmp_path / "dev"), "--outdir", str(tmp_path / "wav"),
                 "--checkpoint", str(tmp_path / "exp" / f"checkpoint-{steps}steps.pkl"),
                 "--use-pallas-tail", "--device", "cpu", "--verbose", "0"])
    for i in range(2):
        _, wav = wavfile.read(tmp_path / "wav" / f"u{i}-feats_gen.wav")
        n = frames + 3 * (2 - i)
        if gen_type == DUR:
            assert len(wav) % math.prod(gp["upsample_scales"]) == 0
        else:
            assert len(wav) == n * hop
        assert np.abs(wav).max() > 0


@pytest.mark.parametrize("name,rel", [
    ("HUBERT_HIFIGAN_CONFIG", "egs/vctk/hubert_voc1/conf/hifigan_hubert.v1.yaml"),
    ("HUBERT_DURATION_CONFIG", "egs/cvss_c/hubert_voc1/conf/hifigan_hubert_duration.v1.yaml"),
    ("HUBERT_STYLE_CONFIG", "egs/vctk/hubert_voc1/conf/style_melgan_hubert.v1.yaml"),
])
def test_chip_smoke_hubert_configs_equal_shipped_configs(name, rel):
    """The configs of chip_smoke.py's phase 35 are the YAMLs verbatim."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    assert json.loads(json.dumps(getattr(smoke, name))) == _load_yaml(rel)
