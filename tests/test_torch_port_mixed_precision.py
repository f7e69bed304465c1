"""``mixed_precision: true`` in the port held against the JAX package's
``build_train_step`` on the CPU, for the four trained families: HiFi-GAN
with the spectral-norm discriminator of tests/test_mixed_precision.py
(its config), Parallel WaveGAN, MelGAN with ``use_pallas_stacks_train``
(the bf16 modes of K6/K7: the port's plain versions, JAX's kernels in
interpret mode) and StyleMelGAN, with its plain blocks (as JAX runs them
without ``use_pallas_tade_train``) and with ``use_pallas_tade_train``
(the bf16 modes of K8/K9, likewise).

Both packages start from the same weights (the port's, carried across by
the JAX package's converter, spectral norm's (u, v) with them) and take
one G+D step on the same batch (StyleMelGAN's noise and window starts
pinned in it). Bounds:

* the first-step losses agree to 2e-2 relative (denominator at least
  0.1, as tests/test_mixed_precision.py:123 holds bf16 to float32 at
  3e-2; measured at most 1.1e-2, PWG's fake loss): the two packages round
  to bf16 at the points JAX's code casts (weight norm's formula,
  LeakyReLU's slope in x's type, the kernels' operands), but a bf16
  convolution in torch adds its bias before it rounds and XLA on the CPU
  after (with the bias added apart the gap was 2.5e-3 on MelGAN), and
  the discriminators' outputs carry that into the adversarial losses;
* the control: the port's float32 step on the same input differs from
  its bf16 step by more than 1e-4 relative in some loss (float32 noise of
  these losses is about 1e-6), so a flag that ran float32 would fail;
* the master parameters, their optimizer state and (u, v) are float32
  after the step; (u, v) after one bf16 train-mode forward of the
  discriminator match JAX's to 1e-6 (both run the power iteration in
  float32 on the same bf16 weights).
"""

import json

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
from parallelwavegan_tpu.optimizers import (  # noqa: E402
    build_optimizer_from_config as jax_optimizer,
)
from parallelwavegan_tpu.train.criterion import build_criterion as jax_criterion  # noqa: E402
from parallelwavegan_tpu.train.state import init_train_state  # noqa: E402
from parallelwavegan_tpu.train.step import build_train_step  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config  # noqa: E402
from parallelwavegan_tpu_torch.train import precision  # noqa: E402
from parallelwavegan_tpu_torch.train.criterion import build_criterion  # noqa: E402
from parallelwavegan_tpu_torch.train.step import TrainStep, batch_to_device  # noqa: E402

LOSS_BOUND = 2e-2

_OPT = {
    "generator_optimizer_type": "Adam",
    "generator_optimizer_params": {"lr": 1.0e-4},
    "discriminator_optimizer_type": "Adam",
    "discriminator_optimizer_params": {"lr": 1.0e-4},
    "generator_grad_norm": 10, "discriminator_grad_norm": 1,
}
_STFT = {"fft_sizes": [64, 128], "hop_sizes": [16, 32], "win_lengths": [32, 64],
         "window": "hann_window"}
# tests/test_mixed_precision.py:21-60 (the JAX package's own bf16 test)
HIFIGAN = dict(_OPT, **{
    "sampling_rate": 8000, "hop_size": 64, "num_mels": 10,
    "generator_type": "HiFiGANGenerator",
    "generator_params": {
        "in_channels": 10, "out_channels": 1, "channels": 16,
        "kernel_size": 3, "upsample_scales": [4, 4, 4],
        "upsample_kernel_sizes": [8, 8, 8],
        "resblock_kernel_sizes": [3], "resblock_dilations": [[1, 3]]},
    "discriminator_type": "HiFiGANMultiScaleMultiPeriodDiscriminator",
    "discriminator_params": {
        "scales": 1, "periods": [2],
        "follow_official_norm": True,  # spectral-norm path under bf16
        "scale_discriminator_params": {
            "in_channels": 1, "out_channels": 1, "kernel_sizes": [5, 5, 5, 3],
            "channels": 4, "max_downsample_channels": 8, "max_groups": 2,
            "downsample_scales": [2, 2]},
        "period_discriminator_params": {
            "in_channels": 1, "out_channels": 1, "kernel_sizes": [3, 3],
            "channels": 4, "downsample_scales": [2, 2], "max_downsample_channels": 8}},
    "use_stft_loss": True, "stft_loss_params": _STFT,
    "use_feat_match_loss": True,
    "lambda_aux": 1.0, "lambda_adv": 1.0, "lambda_feat_match": 2.0,
})
PWG = dict(_OPT, **{
    "sampling_rate": 8000, "hop_size": 16,
    "generator_type": "ParallelWaveGANGenerator",
    "generator_params": dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
                             skip_channels=8, aux_channels=10, aux_context_window=2,
                             upsample_params={"upsample_scales": [4, 4]}),
    "discriminator_type": "ParallelWaveGANDiscriminator",
    "discriminator_params": dict(layers=4, conv_channels=8),
    "stft_loss_params": _STFT, "lambda_adv": 4.0,
})
# both stages (32 and 16 channels) fused
MELGAN = dict(PWG, **{
    "generator_type": "MelGANGenerator",
    "generator_params": dict(in_channels=10, out_channels=1, kernel_size=7, channels=64,
                             upsample_scales=[4, 4], stack_kernel_size=3, stacks=2,
                             use_pallas_stacks_train=True),
})
STYLE = dict(_OPT, **{
    "sampling_rate": 8000, "hop_size": 4,
    "generator_type": "StyleMelGANGenerator",
    "generator_params": dict(in_channels=16, aux_channels=20, channels=64, out_channels=1,
                             kernel_size=9, dilation=2, noise_upsample_scales=[5, 2],
                             upsample_scales=[2, 2, 1]),
    "discriminator_type": "StyleMelGANDiscriminator",
    "discriminator_params": dict(
        repeats=2, window_sizes=[16, 32],
        pqmf_params=[[1, None, None, None], [2, 62, 0.267, 9.0]],
        discriminator_params=dict(channels=8, max_downsample_channels=32,
                                  downsample_scales=[2, 2])),
    "stft_loss_params": {"fft_sizes": [16, 32, 8], "hop_sizes": [4, 8, 2],
                         "win_lengths": [12, 24, 6], "window": "hann_window"},
    "generator_adv_loss_params": {"average_by_discriminators": False},
    "discriminator_adv_loss_params": {"average_by_discriminators": False},
})
# blocks 1 and 2 (inputs of 20 and 40 samples) fused: K8/K9's bf16 modes
# (the port's bf16 plain versions, JAX's kernels in interpret mode)
STYLE_TADE = dict(STYLE, generator_params=dict(
    STYLE["generator_params"], use_pallas_tade_train=True, pallas_tade_train_min_t=20))
CONFIGS = {"hifigan": HIFIGAN, "pwg": PWG, "melgan": MELGAN, "style_melgan": STYLE,
           "style_melgan_tade_train": STYLE_TADE}


def _batch(name):
    rs = np.random.RandomState(0)
    if name == "hifigan":
        return {"y": (rs.randn(2, 1024, 1) * 0.1).astype(np.float32),
                "c": rs.randn(2, 16, 10).astype(np.float32)}
    if name == "pwg":
        return {"y": (rs.randn(2, 1024, 1) * 0.3).astype(np.float32),
                "z": rs.randn(2, 1024, 1).astype(np.float32),
                "c": rs.randn(2, 68, 10).astype(np.float32)}
    if name == "melgan":
        return {"y": (rs.randn(2, 1024, 1) * 0.3).astype(np.float32),
                "c": rs.randn(2, 64, 10).astype(np.float32)}
    b = {"y": (rs.randn(2, 40, 1) * 0.3).astype(np.float32),
         "c": rs.randn(2, 10, 20).astype(np.float32),
         "z": rs.randn(2, 1, 16).astype(np.float32)}
    for key in ("adv", "real", "fake"):  # starts in [0, 40 - size)
        b[f"rwd_starts_{key}"] = np.array([rs.randint(0, 40 - ws) for ws in (16, 32) * 2],
                                          np.int32)
    return b


def _models(cfg):
    gen = get_model_class(cfg["generator_type"])(
        **cfg["generator_params"], generator=torch.Generator().manual_seed(0))
    dis = get_model_class(cfg["discriminator_type"])(
        **cfg["discriminator_params"], generator=torch.Generator().manual_seed(1))
    return gen, dis


def _to_jax(model_type, params, module):
    sd = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
    return convert_state_dict(model_type, params, sd)


def _port_step(cfg, batch):
    """(the port's first-step metrics, G, D, the two optimizers)."""
    gen, dis = _models(cfg)
    opt_g = build_optimizer_from_config(cfg, "generator", gen.parameters())
    opt_d = build_optimizer_from_config(cfg, "discriminator", dis.parameters())
    step = TrainStep(cfg, gen, dis, build_criterion(cfg), opt_g, opt_d)
    metrics = step(batch_to_device(batch, "cpu"), True, True, step=0)
    return {k: float(v) for k, v in metrics.items()}, gen, dis, opt_g, opt_d


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_first_bf16_step_matches_jax(name):
    cfg = json.loads(json.dumps(dict(CONFIGS[name], mixed_precision=True)))
    batch = _batch(name)
    gen, dis = _models(cfg)
    gp, dp = cfg["generator_params"], cfg["discriminator_params"]
    params_d, vars_d = _to_jax(cfg["discriminator_type"], dp, dis)
    tx_g, tx_d = jax_optimizer(cfg, "generator"), jax_optimizer(cfg, "discriminator")
    state = init_train_state(_to_jax(cfg["generator_type"], gp, gen)[0], params_d,
                             tx_g, tx_d, vars_d=vars_d)
    jstep = build_train_step(cfg, jax_model_class(cfg["generator_type"])(**gp),
                             jax_model_class(cfg["discriminator_type"])(**dp),
                             jax_criterion(cfg), tx_g, tx_d, train_g=True, train_d=True,
                             donate=False)
    _, want = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.key(0))
    got, gen, dis, opt_g, opt_d = _port_step(cfg, batch)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        rel = abs(got[k] - float(v)) / max(abs(float(v)), 0.1)
        assert rel <= LOSS_BOUND, (k, got[k], float(v))
    # the master state stays float32
    for module in (gen, dis):
        for key, v in module.state_dict().items():
            assert v.dtype == torch.float32, key
    for opt in (opt_g, opt_d):
        assert all(v.dtype == torch.float32 for s in opt.state.values() for v in s.values())
    # the control: the same step in float32 is another step
    f32 = _port_step(dict(cfg, mixed_precision=False), batch)[0]
    assert max(abs(f32[k] - got[k]) / max(abs(got[k]), 0.1) for k in got) > 1e-4


def test_spectral_vectors_after_a_bf16_forward_match_jax():
    """One train-mode forward of HiFi-GAN's discriminator on bf16 weights
    and a bf16 wave: the power iteration runs in float32 on the bf16
    weights in both packages, and the new (u, v) agree to 1e-6; the
    port's stay float32 buffers, and differ from a float32 forward's."""
    cfg = HIFIGAN
    dtype, dp = cfg["discriminator_type"], cfg["discriminator_params"]
    _, dis = _models(cfg)
    params, variables = _to_jax(dtype, dp, dis)
    y = (np.random.RandomState(3).randn(2, 1024, 1) * 0.1).astype(np.float32)
    jd = jax_model_class(dtype)(**dp)
    _, new = jd.apply({"params": jax.tree_util.tree_map(
        lambda v: v.astype(jnp.bfloat16), params), **variables},
        jnp.asarray(y).astype(jnp.bfloat16), mutable=["spectral"])
    dis32 = _models(cfg)[1]
    dis.train()
    dis32.train()
    with torch.no_grad():
        precision.call(dis, precision.bf16_params(dis),
                       torch.from_numpy(y).transpose(1, 2).to(torch.bfloat16))
        dis32(torch.from_numpy(y).transpose(1, 2))
    sd = dis.state_dict()
    bufs = {k[:-1] + e: sd[k[:-1] + e] for k in sd if k.endswith("weight_u") for e in "uv"}
    assert len(bufs) >= 2 and all(v.dtype == torch.float32 for v in bufs.values())
    got = _to_jax(dtype, dp, dis)[1]["spectral"]
    pairs = list(zip(jax.tree_util.tree_leaves_with_path(new["spectral"]),
                     jax.tree_util.tree_leaves(got)))
    assert len(pairs) == len(bufs)
    for (path, a), b in pairs:
        err = float(np.abs(np.asarray(a) - np.asarray(b)).max())
        assert err <= 1e-6, (jax.tree_util.keystr(path), err)
    f32 = {k: v for k, v in dis32.state_dict().items() if k in bufs}
    assert max(float((f32[k] - bufs[k]).abs().max()) for k in bufs) > 1e-6


def test_chip_smoke_hifigan_v1_bf16_config_equals_shipped_config():
    """The config of chip_smoke.py's phase 26 is
    hifigan.v1.fullscale.bf16.yaml verbatim."""
    import importlib.util
    import os

    yaml = pytest.importorskip("yaml")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    with open(os.path.join(root, "egs/yesno/voc1/conf/hifigan.v1.fullscale.bf16.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert json.loads(json.dumps(smoke.V1_HIFIGAN_BF16_CONFIG)) == cfg
    assert cfg["mixed_precision"] is True
    assert set(smoke.HIFIGAN_TRAIN_OVERRIDES) <= set(cfg)


def test_train_main_runs_mixed_precision(tmp_path):
    """``bin/train.main`` takes ``mixed_precision: true`` (HiFi-GAN with the
    spectral-norm discriminator): two steps, a checkpoint whose every
    tensor is float32, and a resume from it."""
    import os

    from parallelwavegan_tpu_torch.bin import train

    rs = np.random.RandomState(0)
    os.makedirs(tmp_path / "dump")
    for i in range(2):
        frames = 20 + 3 * i
        np.save(tmp_path / "dump" / f"u{i}-wave.npy",
                (0.1 * rs.randn(frames * 64)).astype(np.float32))
        np.save(tmp_path / "dump" / f"u{i}-feats.npy", rs.randn(frames, 10).astype(np.float32))
    cfg = dict(HIFIGAN, mixed_precision=True, format="npy", batch_size=2,
               batch_max_steps=1024, num_workers=1, train_max_steps=2,
               save_interval_steps=1, eval_interval_steps=100, log_interval_steps=1)
    with open(tmp_path / "c.json", "w") as f:
        json.dump(cfg, f)

    def run(outdir, *extra):
        return train.main(["--train-dumpdir", str(tmp_path / "dump"), "--dev-dumpdir",
                           str(tmp_path / "dump"), "--outdir", str(tmp_path / outdir),
                           "--config", str(tmp_path / "c.json"), "--verbose", "0",
                           "--device", "cpu", *extra])

    assert run("exp")["steps"] == 2
    ckpt = torch.load(tmp_path / "exp" / "checkpoint-2steps.pkl", weights_only=True)
    tensors = [v for part in ("model", "optimizer") for sd in ckpt[part].values()
               for v in (sd.values() if part == "model" else
                         [t for st in sd["state"].values() for t in st.values()])]
    assert tensors and all(t.dtype == torch.float32 for t in tensors)
    resumed = run("exp2", "--resume", str(tmp_path / "exp" / "checkpoint-1steps.pkl"))
    assert resumed["steps"] == 2

