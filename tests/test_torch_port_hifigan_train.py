"""HiFi-GAN v1 training in the port held against the JAX package on the
CPU: spectral norm in the 1-D and 2-D convs, the five HiFi-GAN
discriminators, the mel and feature-matching losses, the converter's round
trip, the train step against JAX ``build_train_step``, ``bin/train.main``
with resume and JAX's ``load_model`` of its checkpoint, the refusal of the
decode-only kernel flags, and chip_smoke's HiFi-GAN v1 config.

Inputs are made with numpy from seeds and fed to both packages; weights
and spectral norm's (u, v) are carried across by the converters, since the
two packages start the power iteration from different draws. JAX matmuls
run at ``highest`` precision. Tolerances: 1e-5 for spectral norm and the
train step (losses relative, parameters and (u, v) absolute, as the PWG,
MelGAN and StyleMelGAN A/Bs), 2e-4 for the discriminators' features
(tests/test_torch_parity.py's TOL), rtol 1e-5 for the losses.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.convert.torch_checkpoint import (  # noqa: E402
    convert_state_dict,
)
from parallelwavegan_tpu.layers.convs import Conv1d as JaxConv1d  # noqa: E402
from parallelwavegan_tpu.layers.convs import Conv2dP as JaxConv2d  # noqa: E402
from parallelwavegan_tpu.losses import FeatureMatchLoss as JaxFeatureMatchLoss  # noqa: E402
from parallelwavegan_tpu.losses import MelSpectrogramLoss as JaxMelLoss  # noqa: E402
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.optimizers import build_optimizer as jax_build_optimizer  # noqa: E402
from parallelwavegan_tpu.train.criterion import build_criterion as jax_criterion  # noqa: E402
from parallelwavegan_tpu.train.state import init_train_state  # noqa: E402
from parallelwavegan_tpu.train.step import build_train_step  # noqa: E402
from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.bin import train  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.layers.convs import Conv1d, Conv2d  # noqa: E402
from parallelwavegan_tpu_torch.losses import (  # noqa: E402
    FeatureMatchLoss,
    MelSpectrogramLoss,
)
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config  # noqa: E402
from parallelwavegan_tpu_torch.train.criterion import build_criterion  # noqa: E402
from parallelwavegan_tpu_torch.train.step import TrainStep, batch_to_device  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN, MSMPD = "HiFiGANGenerator", "HiFiGANMultiScaleMultiPeriodDiscriminator"
# 2 scales and periods [2, 3] at channels 4-16; T = 16 x frames is never a
# multiple of 3, so the period-3 discriminator reflect-pads
SCALE = dict(channels=8, max_downsample_channels=16, max_groups=4,
             downsample_scales=[2, 2, 1], kernel_sizes=[5, 7, 3, 3])
PERIOD = dict(channels=4, max_downsample_channels=16, downsample_scales=[3, 3, 1],
              kernel_sizes=[5, 3])
SMALL_D = dict(scales=2, scale_discriminator_params=SCALE, follow_official_norm=True,
               periods=[2, 3], period_discriminator_params=PERIOD)
DISCRIMINATORS = [
    ("HiFiGANPeriodDiscriminator", dict(PERIOD, period=3)),
    ("HiFiGANMultiPeriodDiscriminator", dict(periods=[2, 3],
                                             discriminator_params=PERIOD)),
    ("HiFiGANScaleDiscriminator", dict(SCALE, use_weight_norm=False,
                                       use_spectral_norm=True)),
    ("HiFiGANMultiScaleDiscriminator", dict(scales=2, discriminator_params=SCALE,
                                            follow_official_norm=True)),
    (MSMPD, SMALL_D),
]
SMALL_G = dict(in_channels=8, out_channels=1, channels=16, kernel_size=7,
               upsample_scales=[4, 4], upsample_kernel_sizes=[8, 8],
               resblock_kernel_sizes=[3, 5], resblock_dilations=[[1, 3], [1, 3]])
CONFIG = {
    "sampling_rate": 8000, "hop_size": 16, "format": "npy",
    "generator_type": GEN, "generator_params": SMALL_G,
    "discriminator_type": MSMPD, "discriminator_params": SMALL_D,
    # hifigan.v1.yaml's losses and weights at this model's rate
    "use_stft_loss": False, "use_mel_loss": True,
    "mel_loss_params": {"fs": 8000, "fft_size": 64, "hop_size": 16, "win_length": None,
                        "window": "hann", "num_mels": 8, "fmin": 0, "fmax": 4000,
                        "log_base": None},
    "generator_adv_loss_params": {"average_by_discriminators": False},
    "discriminator_adv_loss_params": {"average_by_discriminators": False},
    "use_feat_match_loss": True,
    "feat_match_loss_params": {"average_by_discriminators": False,
                               "average_by_layers": False,
                               "include_final_outputs": False},
    "lambda_aux": 45.0, "lambda_adv": 1.0, "lambda_feat_match": 2.0,
    "batch_size": 2, "batch_max_steps": 160, "num_workers": 1,
    "generator_optimizer_type": "Adam",
    # v1's rates and betas, and eps 1e-6 as the other A/Bs: both packages'
    # gradients agree to about 1e-5 of each leaf's max (float32), and Adam
    # turns a difference e in an element near 0 into a step difference of
    # up to lr e / eps
    "generator_optimizer_params": {"lr": 2e-4, "betas": [0.5, 0.9], "eps": 1e-6,
                                   "weight_decay": 0.0},
    "generator_scheduler_type": "MultiStepLR",
    "generator_scheduler_params": {"gamma": 0.5, "milestones": [2, 3]},
    "generator_grad_norm": -1,
    "discriminator_optimizer_type": "Adam",
    "discriminator_optimizer_params": {"lr": 2e-4, "betas": [0.5, 0.9], "eps": 1e-6,
                                       "weight_decay": 0.0},
    "discriminator_scheduler_type": "MultiStepLR",
    "discriminator_scheduler_params": {"gamma": 0.5, "milestones": [3]},
    "discriminator_grad_norm": -1,
    # v1's start steps: G only, D only, G+D, G+D
    "generator_train_start_steps": 1, "discriminator_train_start_steps": 0,
    "train_max_steps": 4, "save_interval_steps": 2, "eval_interval_steps": 4,
    "log_interval_steps": 1,
}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _nchw(f: np.ndarray) -> np.ndarray:
    """A JAX feature map (B, T, C) or (B, H, W, C) in the port's layout."""
    return np.moveaxis(f, -1, 1) if f.ndim >= 3 else f


# ---------------------------------------------------------------------------
# spectral norm
# ---------------------------------------------------------------------------


def _sn_layer(kind):
    """(JAX module, port module, input (port layout)); torch layouts of
    the kernel are (Cout, Cin, K) and (Cout, Cin, Kh, Kw)."""
    rs = np.random.RandomState(5)
    if kind == "conv1d":
        jm = JaxConv1d(features=6, kernel_size=5, stride=2, padding=2, norm="spectral")
        pm = Conv1d(4, 6, 5, stride=2, padding=2, use_weight_norm=False,
                    use_spectral_norm=True, generator=torch.Generator().manual_seed(0))
        x = rs.randn(2, 4, 23).astype(np.float32)
    else:
        jm = JaxConv2d(features=6, kernel_size=(5, 1), strides=(3, 1),
                       padding=((2, 2), (0, 0)), norm="spectral")
        pm = Conv2d(4, 6, (5, 1), stride=(3, 1), padding=(2, 0), use_weight_norm=False,
                    use_spectral_norm=True, generator=torch.Generator().manual_seed(0))
        x = rs.randn(2, 4, 11, 3).astype(np.float32)
    return jm, pm, x


def _kernel_to_torch(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1) if k.ndim == 4 else (2, 1, 0))


@pytest.mark.parametrize("kind", ["conv1d", "conv2d"])
def test_spectral_norm_matches_jax(kind):
    """Outputs and W-gradients in train and eval mode, and (u, v) after each
    of 3 train forwards, within 1e-5 of JAX's from the same (W, u, v); the
    port's init runs one power iteration (|u| = 1, u = W v / |W v|)."""
    jm, pm, x = _sn_layer(kind)
    w = pm.weight_orig.detach()
    u, v = pm.weight_u, pm.weight_v
    w_mat = w.reshape(w.shape[0], -1)
    torch.testing.assert_close(u, w_mat @ v / torch.linalg.vector_norm(w_mat @ v))
    assert set(pm.state_dict()) == {"bias", "weight_orig", "weight_u", "weight_v"}
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    vj = jm.init(jax.random.key(0), xj)
    params = jax.tree_util.tree_map(np.asarray, vj["params"])
    pm.load_state_dict({"weight_orig": torch.from_numpy(_kernel_to_torch(params["kernel"])),
                        "bias": torch.from_numpy(params["bias"]),
                        "weight_u": torch.from_numpy(np.asarray(vj["spectral"]["u"])),
                        "weight_v": torch.from_numpy(np.asarray(vj["spectral"]["v"]))})
    rs = np.random.RandomState(6)
    spectral = vj["spectral"]
    for i, mode in enumerate(["train"] * 3 + ["eval"]):
        pm.train(mode == "train")

        def loss(p, spectral=spectral):
            out, new = jm.apply({"params": p, "spectral": spectral}, xj,
                                mutable=["spectral"] if mode == "train" else [])
            return out, new

        out, new = loss(params)
        cot = rs.randn(*np.shape(out)).astype(np.float32)
        grad = jax.grad(lambda p: jnp.sum(loss(p)[0] * cot))(params)
        pm.zero_grad()
        got = pm(torch.from_numpy(x))
        (got * torch.from_numpy(np.moveaxis(cot, -1, 1))).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), _nchw(np.asarray(out)),
                                   atol=1e-5, err_msg=f"{mode} {i}")
        np.testing.assert_allclose(pm.weight_orig.grad.numpy(),
                                   _kernel_to_torch(np.asarray(grad["kernel"])),
                                   atol=1e-5, err_msg=f"{mode} {i}")
        if mode == "train":
            spectral = new["spectral"]
        for vec in ("u", "v"):
            np.testing.assert_allclose(getattr(pm, f"weight_{vec}").numpy(),
                                       np.asarray(spectral[vec]), atol=1e-5)
    assert not np.allclose(np.asarray(spectral["u"]), np.asarray(vj["spectral"]["u"]),
                           atol=1e-5)  # the iterations moved u


def test_spectral_norm_iterates_under_no_grad_and_not_in_eval():
    _, pm, x = _sn_layer("conv1d")
    u0 = pm.weight_u.clone()
    with torch.no_grad():
        pm.eval()
        pm(torch.from_numpy(x))
        torch.testing.assert_close(pm.weight_u, u0, rtol=0, atol=0)
        pm.train()
        pm(torch.from_numpy(x))
    assert not torch.equal(pm.weight_u, u0)
    with pytest.raises(ValueError, match="Either"):
        Conv1d(2, 2, 3, use_weight_norm=True, use_spectral_norm=True)


# ---------------------------------------------------------------------------
# the discriminators and the converter
# ---------------------------------------------------------------------------


def _flat(outs):
    return [o for group in outs for o in group] if isinstance(outs[0], list) else outs


@pytest.mark.parametrize("model_type,params", DISCRIMINATORS,
                         ids=[m for m, _ in DISCRIMINATORS])
def test_discriminator_matches_jax(model_type, params):
    """Every feature map within 2e-4 of the JAX module's with its weights
    and (u, v) carried across, in train mode (one power iteration, (u, v)
    after it equal too) and then in eval mode (none)."""
    x = (np.random.RandomState(2).randn(2, 101, 1) * 0.5).astype(np.float32)
    jm = jax_model_class(model_type)(**params)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(3), jnp.asarray(x)))
    port = get_model_class(model_type)(**params)
    port.load_state_dict(jax_params_to_state_dict(model_type, params, v), strict=True)
    xt = torch.from_numpy(x).transpose(1, 2)
    want, new = jm.apply(v, jnp.asarray(x), mutable=["spectral"])
    with torch.no_grad():
        got = port(xt)
    assert len(_flat(got)) == len(_flat(want))
    for g, w in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(g.numpy(), _nchw(np.asarray(w)), atol=2e-4)
    if "spectral" in v:
        sd = jax_params_to_state_dict(model_type, params, v["params"], new["spectral"])
        for k, t in port.state_dict().items():
            if k.endswith(("weight_u", "weight_v")):
                np.testing.assert_allclose(t.numpy(), sd[k].numpy(), atol=1e-5, err_msg=k)
    port.eval()
    want = jm.apply({"params": v["params"], **new}, jnp.asarray(x))
    with torch.no_grad():
        got = port(xt)
    for g, w in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(g.numpy(), _nchw(np.asarray(w)), atol=2e-4)


@pytest.mark.parametrize("model_type,params", DISCRIMINATORS,
                         ids=[m for m, _ in DISCRIMINATORS])
def test_converter_round_trip_is_exact(model_type, params):
    """port state dict -> JAX ``convert_state_dict`` -> the port's
    ``jax_params_to_state_dict`` gives every tensor back bit for bit, (u,
    v) through the ``spectral`` collection."""
    port = get_model_class(model_type)(**params, generator=torch.Generator().manual_seed(4))
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    jparams, extra = convert_state_dict(model_type, params, sd)
    assert ("spectral" in extra) == any(k.endswith("weight_u") for k in sd)
    back = jax_params_to_state_dict(model_type, params, jparams, extra.get("spectral"))
    assert sorted(back) == sorted(sd)
    for k, t in back.items():
        np.testing.assert_array_equal(t.numpy(), sd[k], err_msg=k)


def test_pooling_other_than_avgpool_raises():
    with pytest.raises(ValueError, match="scale_downsample_pooling.*MaxPool1d"):
        get_model_class(MSMPD)(**dict(SMALL_D, scale_downsample_pooling="MaxPool1d"))
    with pytest.raises(ValueError, match="downsample_pooling_params"):
        get_model_class("HiFiGANMultiScaleDiscriminator")(
            downsample_pooling_params={"ceil_mode": True})


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_base", [None, 10.0])
def test_mel_loss_and_grad_match_jax(log_base):
    """hifigan.v1.yaml's mel_loss_params (and base 10): the value and the
    gradient with respect to the generated wave, rtol 1e-5."""
    params = dict(fs=22050, fft_size=1024, hop_size=256, win_length=None, window="hann",
                  num_mels=80, fmin=0, fmax=11025, log_base=log_base)
    rs = np.random.RandomState(9)
    y_hat, y = ((0.3 * rs.randn(2, 4096)).astype(np.float32) for _ in range(2))
    want, grad = jax.value_and_grad(JaxMelLoss(**params))(jnp.asarray(y_hat), jnp.asarray(y))
    yt = torch.tensor(y_hat, requires_grad=True)
    got = MelSpectrogramLoss(**params)(yt, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(grad), rtol=1e-5,
                               atol=1e-5 * float(np.abs(grad).max()))


FM_FLAGS = [(a, b, c) for a in (True, False) for b in (True, False) for c in (True, False)]


@pytest.mark.parametrize("by_layers,by_ds,finals", FM_FLAGS)
def test_feature_matching_loss_matches_jax(by_layers, by_ds, finals):
    rs = np.random.RandomState(10)
    shapes = [[(2, 3, 7), (2, 4, 5), (2, 1, 5)], [(2, 2, 9), (2, 6)]]
    fake = [[rs.randn(*s).astype(np.float32) for s in d] for d in shapes]
    real = [[rs.randn(*s).astype(np.float32) for s in d] for d in shapes]
    flags = dict(average_by_layers=by_layers, average_by_discriminators=by_ds,
                 include_final_outputs=finals)
    want = JaxFeatureMatchLoss(**flags)(jax.tree_util.tree_map(jnp.asarray, fake),
                                        jax.tree_util.tree_map(jnp.asarray, real))
    fake_t, real_t = ([[torch.tensor(f, requires_grad=True) for f in d] for d in feats]
                      for feats in (fake, real))
    got = FeatureMatchLoss(**flags)(fake_t, real_t)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got.backward()
    assert all(f.grad is None for d in real_t for f in d)  # the real ones detached
    assert fake_t[0][0].grad is not None


# ---------------------------------------------------------------------------
# the train step, bin/train and checkpoints
# ---------------------------------------------------------------------------


def _batches(n, seed=8):
    rs = np.random.RandomState(seed)
    return [{"y": (rs.randn(2, 160, 1) * 0.3).astype(np.float32),
             "c": rs.randn(2, 10, 8).astype(np.float32)} for _ in range(n)]


def _to_jax(model_type, params, module):
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    return convert_state_dict(model_type, params, sd)


def test_train_step_matches_jax_build_train_step():
    """Four steps (G only, D only, G+D, G+D: v1's start steps) from carried
    weights and (u, v) on the same batches: every loss to 1e-5 relative,
    every parameter of both models and every (u, v) to 1e-5."""
    config = json.loads(json.dumps(CONFIG))
    gen = get_model_class(GEN)(**SMALL_G, generator=torch.Generator().manual_seed(0))
    dis = get_model_class(MSMPD)(**SMALL_D, generator=torch.Generator().manual_seed(1))
    jg, jd = jax_model_class(GEN)(**SMALL_G), jax_model_class(MSMPD)(**SMALL_D)
    jcfg = json.loads(json.dumps(CONFIG))
    jcrit = jax_criterion(jcfg)
    tx_g = jax_build_optimizer("Adam", jcfg["generator_optimizer_params"], "MultiStepLR",
                               jcfg["generator_scheduler_params"], -1)
    tx_d = jax_build_optimizer("Adam", jcfg["discriminator_optimizer_params"],
                               "MultiStepLR", jcfg["discriminator_scheduler_params"], -1)
    params_d, vars_d = _to_jax(MSMPD, SMALL_D, dis)
    state = init_train_state(_to_jax(GEN, SMALL_G, gen)[0], params_d, tx_g, tx_d,
                             vars_d=vars_d)
    phases = [(True, False), (False, True), (True, True), (True, True)]
    steps = {p: build_train_step(jcfg, jg, jd, jcrit, tx_g, tx_d, train_g=p[0],
                                 train_d=p[1], donate=False) for p in set(phases)}
    opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
    opt_d = build_optimizer_from_config(config, "discriminator", dis.parameters())
    step = TrainStep(config, gen, dis, build_criterion(config), opt_g, opt_d)
    for i, (batch, phase) in enumerate(zip(_batches(4), phases)):
        state, want = steps[phase](state, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jax.random.key(i))
        got = step(batch_to_device(batch, "cpu"), *phase, step=i)
        assert sorted(got) == sorted(want), i
        if phase[0] and phase[1]:
            assert {"mel_loss", "feature_matching_loss", "real_loss"} <= set(got)
        for k in want:
            rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
            assert rel <= 1e-5, (i, k, float(got[k]), float(want[k]))
    params_d, vars_d = _to_jax(MSMPD, SMALL_D, dis)
    for name, tree, got in (("G", state.params_g, _to_jax(GEN, SMALL_G, gen)[0]),
                            ("D", state.params_d, params_d),
                            ("D (u, v)", state.vars_d, vars_d)):
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        assert len(leaves) == len(jax.tree_util.tree_leaves(got))
        for (path, a), b in zip(leaves, jax.tree_util.tree_leaves(got)):
            err = float(np.abs(np.asarray(a) - b).max())
            assert err <= 1e-5, (name, jax.tree_util.keystr(path), err)
    assert len(jax.tree_util.tree_leaves(state.vars_d)) == 2 * 6  # scale 0's six convs


def _write_dump(root, n, seed):
    """npy dumps: random mels of 8 bins and their waves (hop 16)."""
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        frames = 12 + 3 * i
        np.save(os.path.join(root, f"u{i}-wave.npy"),
                (0.3 * rs.randn(frames * 16)).astype(np.float32))
        np.save(os.path.join(root, f"u{i}-feats.npy"), rs.randn(frames, 8).astype(np.float32))


def _train_args(tmp_path, config):
    _write_dump(str(tmp_path / "train"), 4, 0)
    _write_dump(str(tmp_path / "dev"), 2, 1)
    with open(tmp_path / "c.json", "w") as f:
        json.dump(config, f)

    def args(outdir, *extra):
        return ["--train-dumpdir", str(tmp_path / "train"), "--dev-dumpdir",
                str(tmp_path / "dev"), "--outdir", str(tmp_path / outdir),
                "--config", str(tmp_path / "c.json"), "--verbose", "0",
                "--device", "cpu", *extra]

    return args


def test_train_main_runs_4_steps_resume_reproduces_them_and_jax_loads_it(tmp_path):
    """v1's phases through ``bin/train.main`` on the CPU; a resume from step
    2 logs steps 3-4 as the uninterrupted run did and ends on the same
    state dicts, (u, v) bit for bit; JAX's ``load_model`` decodes the
    checkpoint as the port's generator does."""
    args = _train_args(tmp_path, CONFIG)
    first = train.main(args("exp"))
    assert first["steps"] == 4
    logged = {s: m for s, m in first["history"]
              if any(k.startswith("train/") for k in m)}
    assert sorted(logged) == [1, 2, 3, 4]
    assert "train/discriminator_loss" not in logged[1]  # G only
    assert "train/generator_loss" not in logged[2]  # D only
    for s in (3, 4):
        assert {"train/mel_loss", "train/adversarial_loss", "train/feature_matching_loss",
                "train/real_loss", "train/fake_loss"} <= set(logged[s])
    assert all(np.isfinite(v) for m in logged.values() for v in m.values())
    assert any("eval/feature_matching_loss" in m for _, m in first["history"])
    resumed = train.main(args("exp2", "--resume",
                              str(tmp_path / "exp" / "checkpoint-2steps.pkl")))
    again = {s: m for s, m in resumed["history"] if any(k.startswith("train/") for k in m)}
    assert sorted(again) == [3, 4]
    for s in (3, 4):
        assert again[s] == logged[s], s
    ckpt = str(tmp_path / "exp" / "checkpoint-4steps.pkl")
    a = torch.load(ckpt, weights_only=True)["model"]
    b = torch.load(str(tmp_path / "exp2" / "checkpoint-4steps.pkl"), weights_only=True)["model"]
    two = torch.load(str(tmp_path / "exp" / "checkpoint-2steps.pkl"), weights_only=True)
    uv = [k[:-1] + vec for k in a["discriminator"] if k.endswith("weight_u")
          for vec in "uv"]  # scale 0's six convs (a weight norm's v is weight_v too)
    assert len(uv) == 12
    for part in ("generator", "discriminator"):
        for k in a[part]:
            torch.testing.assert_close(a[part][k], b[part][k], rtol=0, atol=0)
    assert any(not torch.equal(a["discriminator"][k], two["model"]["discriminator"][k])
               for k in uv)  # steps 3-4 moved (u, v)

    from parallelwavegan_tpu_torch.utils.model import load_model

    mel = np.random.RandomState(7).randn(11, 8).astype(np.float32)
    want = np.asarray(jax_load_model(ckpt).inference(mel))
    got = load_model(ckpt, device="cpu").inference(mel)
    assert got.shape == want.shape == (11 * 16, 1)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("flag", ["use_pallas_tail", "use_pallas_mrf"])
def test_train_refuses_decode_only_kernel_flags(tmp_path, flag):
    config = dict(CONFIG, generator_params=dict(SMALL_G, **{flag: True}))
    args = _train_args(tmp_path, config)
    with pytest.raises(ValueError, match=f"{flag}.*decode only"):
        train.main(args("exp"))
    assert not os.path.exists(tmp_path / "exp")  # refused before any step


def test_chip_smoke_hifigan_v1_training_config_equals_shipped_config():
    """The config of chip_smoke.py's phases 23-24 is hifigan.v1.yaml
    verbatim."""
    import importlib.util

    yaml = pytest.importorskip("yaml")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    with open(os.path.join(ROOT, "egs/ljspeech/voc1/conf/hifigan.v1.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert json.loads(json.dumps(smoke.V1_HIFIGAN_CONFIG)) == cfg
    assert set(smoke.HIFIGAN_TRAIN_OVERRIDES) <= set(cfg)
    assert "generator_train_start_steps" not in smoke.HIFIGAN_TRAIN_OVERRIDES
