"""The rest of the Parallel WaveGAN family held against the JAX package on
the CPU: the causal generator (plain, and with ``use_pallas_kernels``
through K5's causal call, whose CPU path is the plain block), its padded
decode, the generator with ``upsample_net: MelGANGenerator``, and
``ResidualParallelWaveGANDiscriminator`` (values, every gradient, upstream
keys through JAX's ``convert_state_dict``, its train step against JAX's
``build_train_step`` and ``bin/train.main``). Parameters made by the JAX
``init`` go into the port through ``jax_params_to_state_dict``; inputs are
made with numpy from seeds. Tolerances: 2e-4 on values and gradients
(float32 convolutions summed in other orders), 1e-5 relative on the train
step's losses and absolute on its parameters after four steps, as
tests/test_torch_port_train_host.py holds the PWG step.
"""

import json
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
from parallelwavegan_tpu.utils.model import InferenceModel as JaxInferenceModel  # noqa: E402
from parallelwavegan_tpu_torch.bin import train  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.wavenet import (  # noqa: E402
    fused_gated_resblock,
)
from parallelwavegan_tpu_torch.ops.mel import logmelfilterbank  # noqa: E402
from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config  # noqa: E402
from parallelwavegan_tpu_torch.train.criterion import build_criterion  # noqa: E402
from parallelwavegan_tpu_torch.train.step import TrainStep, batch_to_device  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import InferenceModel  # noqa: E402

PWG, RES_D = "ParallelWaveGANGenerator", "ResidualParallelWaveGANDiscriminator"
SMALL = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
             skip_channels=8, aux_channels=10, aux_context_window=2,
             upsample_params={"upsample_scales": [4, 4]})
CAUSAL = dict(SMALL, use_causal_conv=True)
MELGAN_UP = dict(SMALL, aux_context_window=0, upsample_net="MelGANGenerator",
                 upsample_params=dict(in_channels=10, out_channels=10, channels=32,
                                      kernel_size=7, upsample_scales=[4, 4], stacks=2))
SMALL_D = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
               skip_channels=8)
FRAMES = 12
RS = np.random.RandomState(0)
Z = RS.randn(2, FRAMES * 16, 1).astype(np.float32)
C = RS.randn(2, FRAMES + 4, 10).astype(np.float32)


def _ncl(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _round_trip(model_type, params, v):
    """The port's state dict of JAX params, back through JAX's
    ``convert_state_dict``: every leaf equal."""
    sd = jax_params_to_state_dict(model_type, params, v)
    back, _ = convert_state_dict(model_type, params, {k: t.numpy() for k, t in sd.items()})
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert want.keys() == got.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a, err_msg=str(path))
    return sd


# ---------------------------------------------------------------------------
# the causal generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", [None, "use_pallas_kernels", "use_pallas_stack_train"])
def test_causal_generator_matches_jax(flag):
    """Causal blocks and upsample net; with ``use_pallas_kernels`` each block
    is K5's causal call (JAX's causal ``fused_gated_resblock`` in interpret
    mode); the stack flags leave the causal generator on its blocks, as
    JAX's gate does (:144-146)."""
    kw = {flag: True} if flag else {}
    jg = jax_model_class(PWG)(**CAUSAL, **kw)
    v = _np(jg.init(jax.random.key(1), jnp.asarray(Z), jnp.asarray(C)))
    want = np.asarray(jg.apply(v, jnp.asarray(Z), jnp.asarray(C)))
    port = get_model_class(PWG)(**CAUSAL, **kw)
    port.load_state_dict(_round_trip(PWG, CAUSAL, v), strict=True)
    assert not port.use_stack
    assert port.conv_layers[0].use_fused == (flag == "use_pallas_kernels")
    assert all(blk.use_causal_conv for blk in port.conv_layers)
    port.eval()
    before = fused_gated_resblock.launches
    with torch.no_grad():
        got = port(_ncl(Z), _ncl(C)).numpy().transpose(0, 2, 1)
        port.remove_weight_norm()
        port.prepare_kernels()
        prepared = port(_ncl(Z), _ncl(C)).numpy().transpose(0, 2, 1)
    assert fused_gated_resblock.launches == before
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(prepared, want, atol=2e-4)
    # causal: the first n samples do not see the noise after them
    z2 = Z.copy()
    z2[:, 100:] = 0.0
    with torch.no_grad():
        cut = port(_ncl(z2), _ncl(C)).numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(cut[:, :100], prepared[:, :100])


def test_causal_padded_decode_matches_jax():
    """``InferenceModel.forward_padded`` (the mel edge-padded by the context
    window, the noise of the padded length) against JAX's ``_forward_fn``."""
    gp = dict(CAUSAL, use_pallas_kernels=True)
    jg = jax_model_class(PWG)(**gp)
    v = _np(jg.init(jax.random.key(2), jnp.asarray(Z), jnp.asarray(C)))
    config = {"generator_type": PWG, "generator_params": gp}
    rs = np.random.RandomState(5)
    c = rs.randn(32, 10).astype(np.float32)
    z = rs.randn(32 * 16).astype(np.float32)
    want = np.asarray(JaxInferenceModel(jg, v["params"], config)._forward_fn()(
        jnp.asarray(c), jnp.asarray(z)))
    gen = get_model_class(PWG)(**gp)
    gen.load_state_dict(jax_params_to_state_dict(PWG, gp, v))
    gen.remove_weight_norm()
    gen.eval()
    gen.prepare_kernels()
    with torch.inference_mode():
        got = InferenceModel(gen, "cpu").forward_padded(
            torch.from_numpy(c), torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (32 * 16, 1)
    np.testing.assert_allclose(got, want, atol=2e-4)


# ---------------------------------------------------------------------------
# the MelGAN upsample net
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stacks_flag", [False, True])
def test_melgan_upsample_net_matches_jax(stacks_flag):
    """``upsample_net: MelGANGenerator`` (JAX :54-60): weight norm as the
    generator's, no final tanh, keys ``upsample_net.melgan.*``; with
    ``use_pallas_stacks`` in its params the stacks run through K6's CPU
    path (the plain stacks), JAX's through its kernel in interpret mode."""
    gp = json.loads(json.dumps(MELGAN_UP))
    gp["upsample_params"]["use_pallas_stacks"] = stacks_flag
    c = C[:, 2:-2]  # no context window
    jg = jax_model_class(PWG)(**gp)
    v = _np(jg.init(jax.random.key(3), jnp.asarray(Z), jnp.asarray(c)))
    want = np.asarray(jg.apply(v, jnp.asarray(Z), jnp.asarray(c)))
    sd = _round_trip(PWG, gp, v)
    assert "upsample_net.melgan.1.weight_g" in sd and "upsample_net.melgan.3.weight_v" in sd
    port = get_model_class(PWG)(**gp)
    port.load_state_dict(sd, strict=True)
    assert port.upsample_factor == jg.upsample_factor == 16
    assert not port.upsample_net.use_final_nonlinear_activation
    assert bool(port.upsample_net.fused_stages) == stacks_flag
    port.eval()
    with torch.no_grad():
        got = port(_ncl(Z), _ncl(c)).numpy().transpose(0, 2, 1)
        port.remove_weight_norm()
        port.prepare_kernels()
        assert bool(port.upsample_net._kernel_cache) == stacks_flag
        prepared = port(_ncl(Z), _ncl(c)).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(prepared, got, atol=1e-5)
    # loading weights drops the upsample net's prepared weights too
    port.load_state_dict(port.state_dict())
    assert port.upsample_net._kernel_cache is None


def test_melgan_upsample_net_needs_no_context_window():
    with pytest.raises(ValueError, match="aux_context_window"):
        get_model_class(PWG)(**dict(MELGAN_UP, aux_context_window=2))


# ---------------------------------------------------------------------------
# ResidualParallelWaveGANDiscriminator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def residual_d():
    jd = jax_model_class(RES_D)(**SMALL_D)
    x = (np.random.RandomState(7).randn(2, 300, 1) * 0.5).astype(np.float32)
    v = _np(jd.init(jax.random.key(4), jnp.asarray(x)))
    return jd, v, x


def test_residual_discriminator_keys_round_trip(residual_d):
    _, v, _ = residual_d
    sd = _round_trip(RES_D, SMALL_D, v)
    port = get_model_class(RES_D)(**SMALL_D)
    port.load_state_dict(sd, strict=True)
    keys = set(port.state_dict())
    for k in ("first_conv.0.weight_g", "first_conv.0.bias", "conv_layers.3.conv.weight_v",
              "conv_layers.0.conv1x1_skip.bias", "conv_layers.1.conv1x1_out.weight_g",
              "last_conv_layers.1.weight_v", "last_conv_layers.3.bias"):
        assert k in keys, k
    assert not any("conv1x1_aux" in k for k in keys)
    assert [blk.dilation for blk in port.conv_layers] == [1, 2, 1, 2]


@pytest.mark.parametrize("use_weight_norm", [True, False])
def test_residual_discriminator_values_and_grads_match_jax(use_weight_norm):
    """Values, and the gradients of every parameter and of the input under a
    unit random cotangent, within 2e-4."""
    params = dict(SMALL_D, use_weight_norm=use_weight_norm)
    jd = jax_model_class(RES_D)(**params)
    rs = np.random.RandomState(8)
    x = (rs.randn(2, 300, 1) * 0.5).astype(np.float32)
    cot = rs.randn(2, 300, 1).astype(np.float32)
    v = _np(jd.init(jax.random.key(5), jnp.asarray(x)))
    want, vjp = jax.vjp(lambda p, xx: jd.apply({"params": p}, xx), v["params"], jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(cot))
    port = get_model_class(RES_D)(**params)
    port.load_state_dict(jax_params_to_state_dict(RES_D, params, v), strict=True)
    xt = _ncl(x).requires_grad_()
    out = port(xt)
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 1), np.asarray(want),
                               atol=2e-4)
    out.backward(_ncl(cot))
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 1), np.asarray(dx), atol=2e-4)
    # the last block's residual output is unused: no gradient reaches its
    # conv1x1_out (zero in JAX), every other one is nonzero
    unused = f"conv_layers.{SMALL_D['layers'] - 1}.conv1x1_out."
    grads = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
             for k, p in port.named_parameters()}
    assert all((np.abs(g).max() > 0) != k.startswith(unused) for k, g in grads.items())
    want_sd = jax_params_to_state_dict(RES_D, params, {"params": _np(dparams)})
    assert set(want_sd) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want_sd[k].numpy(), atol=2e-4, err_msg=k)


# ---------------------------------------------------------------------------
# training with it
# ---------------------------------------------------------------------------

CONFIG = {
    "sampling_rate": 8000, "hop_size": 16, "format": "npy",
    "generator_type": PWG, "generator_params": SMALL,
    "discriminator_type": RES_D, "discriminator_params": SMALL_D,
    "stft_loss_params": {"fft_sizes": [64, 128, 256], "hop_sizes": [16, 32, 32],
                         "win_lengths": [32, 64, 200], "window": "hann_window"},
    "lambda_adv": 4.0, "batch_size": 2, "batch_max_steps": 1024,
    "remove_short_samples": True, "num_workers": 1,
    "generator_optimizer_params": {"lr": 1e-4, "eps": 1e-6, "weight_decay": 0.0},
    "generator_scheduler_params": {"step_size": 2, "gamma": 0.5},
    "generator_grad_norm": 10,
    "discriminator_optimizer_params": {"lr": 5e-5, "eps": 1e-6, "weight_decay": 0.0},
    "discriminator_scheduler_params": {"step_size": 2, "gamma": 0.5},
    "discriminator_grad_norm": 1,
    "discriminator_train_start_steps": 0, "train_max_steps": 2,
    "save_interval_steps": 2, "eval_interval_steps": 2, "log_interval_steps": 1,
}


def _to_jax(model_type, params, module):
    sd = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
    return convert_state_dict(model_type, params, sd)[0]


@pytest.mark.parametrize("gp", [SMALL, CAUSAL], ids=["pwg", "causal"])
def test_train_step_with_residual_discriminator_matches_jax(gp):
    """Four steps (2 G-only, 2 G+D) from carried weights on the same batches:
    the port's train step against JAX's jitted steps."""
    config = json.loads(json.dumps(dict(CONFIG, generator_params=gp)))
    gen = get_model_class(PWG)(**gp, generator=torch.Generator().manual_seed(0))
    dis = get_model_class(RES_D)(**SMALL_D, generator=torch.Generator().manual_seed(1))
    jg, jd = jax_model_class(PWG)(**gp), jax_model_class(RES_D)(**SMALL_D)
    jcrit = jax_criterion(config)
    tx_g = jax_build_optimizer("RAdam", config["generator_optimizer_params"], "StepLR",
                               config["generator_scheduler_params"], 10)
    tx_d = jax_build_optimizer("RAdam", config["discriminator_optimizer_params"],
                               "StepLR", config["discriminator_scheduler_params"], 1)
    state = init_train_state(_to_jax(PWG, gp, gen), _to_jax(RES_D, SMALL_D, dis), tx_g, tx_d)
    steps = {(g, d): build_train_step(config, jg, jd, jcrit, tx_g, tx_d, train_g=g,
                                      train_d=d, donate=False)
             for g, d in ((True, False), (True, True))}
    opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
    opt_d = build_optimizer_from_config(config, "discriminator", dis.parameters())
    step = TrainStep(config, gen, dis, build_criterion(config), opt_g, opt_d)
    rs = np.random.RandomState(8)
    worst_loss = 0.0
    for i in range(4):
        batch = {"y": (rs.randn(2, 1024, 1) * 0.3).astype(np.float32),
                 "c": rs.randn(2, 64 + 4, 10).astype(np.float32),
                 "z": rs.randn(2, 1024, 1).astype(np.float32)}
        phase = (True, i >= 2)
        state, want = steps[phase](state, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jax.random.key(i))
        got = step(batch_to_device(batch, "cpu"), *phase)
        assert sorted(got) == sorted(want)
        for k in want:
            rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
            worst_loss = max(worst_loss, rel)
            assert rel <= 1e-5, (i, k, float(got[k]), float(want[k]))
    worst = 0.0
    for model_type, params, module, tree in (
            (PWG, gp, gen, state.params_g), (RES_D, SMALL_D, dis, state.params_d)):
        got = _to_jax(model_type, params, module)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves(got)):
            err = float(np.abs(np.asarray(a) - b).max())
            worst = max(worst, err)
            assert err <= 1e-5, (model_type, jax.tree_util.keystr(path), err)
    print(f"port vs JAX train step with {RES_D}: losses {worst_loss:.2e} relative, "
          f"parameters after 4 steps {worst:.2e} absolute")


def _write_dump(root, n, seed):
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        frames = 70 + 11 * i
        audio = (0.3 * np.sin(2 * np.pi * 300 * np.arange(frames * 16) / 8000)
                 + 0.05 * rs.randn(frames * 16)).astype(np.float32)
        mel = logmelfilterbank(audio, 8000, fft_size=128, hop_size=16, num_mels=10,
                               fmin=0, fmax=4000)[:frames]
        np.save(os.path.join(root, f"u{i}-wave.npy"), audio)
        np.save(os.path.join(root, f"u{i}-feats.npy"), mel.astype(np.float32))


@pytest.mark.parametrize("gp", [
    dict(SMALL, use_pallas_stack_train=True, pallas_stack_bf16=True), CAUSAL],
    ids=["both_stack_flags", "causal"])
def test_train_main_runs_with_residual_discriminator(tmp_path, gp):
    """Two steps of ``bin/train.main --device cpu`` with
    ``ResidualParallelWaveGANDiscriminator``: the PWG generator with both
    stack flags (``pallas_stack_bf16`` ignored, as JAX ignores it under
    ``use_pallas_stack_train``), and the causal generator."""
    _write_dump(str(tmp_path / "train"), 4, 0)
    _write_dump(str(tmp_path / "dev"), 2, 1)
    with open(tmp_path / "c.json", "w") as f:
        json.dump(dict(CONFIG, generator_params=gp), f)
    res = train.main(["--train-dumpdir", str(tmp_path / "train"), "--dev-dumpdir",
                      str(tmp_path / "dev"), "--outdir", str(tmp_path / "exp"),
                      "--config", str(tmp_path / "c.json"), "--verbose", "0",
                      "--device", "cpu"])
    assert res["steps"] == 2
    logged = {s: m for s, m in res["history"] if "train/generator_loss" in m}
    assert sorted(logged) == [1, 2]
    assert "train/discriminator_loss" in logged[2]
    assert all(np.isfinite(v) for m in logged.values() for v in m.values())
    ckpt = torch.load(tmp_path / "exp" / "checkpoint-2steps.pkl", weights_only=True)
    assert "first_conv.0.weight_v" in ckpt["model"]["discriminator"]
