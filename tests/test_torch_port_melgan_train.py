"""MelGAN training in the port held against the JAX package on the CPU: the
plain version of the K7 backward, the generator's gradients through
``use_pallas_stacks_train``, the train step against JAX
``build_train_step``, ``bin/train.main`` with resume, a training
checkpoint decoded by both packages, and chip_smoke's MelGAN v1 config.

Inputs are made with numpy from seeds and fed to both packages. The JAX
side of the K7 cases is ``fused_melgan_stacks_train(..., interpret=True)``
(jitted) on the cases of tests/test_melgan_stack_train_kernel.py:51-132,
plus replicate ("edge") padding. The loss is the output against a random
cotangent of unit scale, so every gradient is of order one or more and
the 2e-4 term cannot pass a wrong one; each gradient is held to atol
2e-4, rtol 1e-3 (:39-47, :76) and to max|diff| <= 1e-4 max|JAX|, and
controls (each gradient zeroed, dx moved 1 % toward its one-sample shift)
must be rejected. The loss agrees to rtol 1e-5; the train step to 1e-5,
as PWG's does.
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
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.ops.pallas_kernels.melgan_stack_train import (  # noqa: E402
    fused_melgan_stacks_train as jax_stacks_train,
)
from parallelwavegan_tpu.optimizers import build_optimizer as jax_build_optimizer  # noqa: E402
from parallelwavegan_tpu.train.criterion import build_criterion as jax_criterion  # noqa: E402
from parallelwavegan_tpu.train.state import init_train_state  # noqa: E402
from parallelwavegan_tpu.train.step import build_train_step  # noqa: E402
from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.bin import train  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import melgan_stack as k6  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as k7  # noqa: E402
from parallelwavegan_tpu_torch.ops.mel import logmelfilterbank  # noqa: E402
from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config  # noqa: E402
from parallelwavegan_tpu_torch.train.criterion import build_criterion  # noqa: E402
from parallelwavegan_tpu_torch.train.step import TrainStep, batch_to_device  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import load_model  # noqa: E402

MELGAN, PWG_D = "MelGANGenerator", "ParallelWaveGANDiscriminator"
KEYS = k7.STACK_KEYS
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 2 stages at 32 and 16 channels, both fused; hop 16
SMALL = dict(in_channels=10, out_channels=1, kernel_size=7, channels=64,
             upsample_scales=[4, 4], stack_kernel_size=3, stacks=2,
             use_pallas_stacks_train=True)
SMALL_D = dict(layers=4, conv_channels=8)
CONFIG = {
    "sampling_rate": 8000, "hop_size": 16, "format": "npy",
    "generator_type": MELGAN, "generator_params": SMALL,
    "discriminator_type": PWG_D, "discriminator_params": SMALL_D,
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
    "discriminator_train_start_steps": 1, "train_max_steps": 4,
    "save_interval_steps": 2, "eval_interval_steps": 4, "log_interval_steps": 1,
}


# ---------------------------------------------------------------------------
# K7's plain version against the JAX kernel
# ---------------------------------------------------------------------------


def _rand_stacks(rs, c, bias=True):
    """tests/test_melgan_stack_train_kernel.py:24-36 (3 stacks, d 1, 3, 9)."""
    def w(k):
        return (rs.randn(k, c, c) * 0.1).astype(np.float32)

    def b():
        return (rs.randn(c) * 0.05).astype(np.float32) if bias else None

    return [{"wd": w(3), "bd": b(), "w1": w(1), "b1": b(), "ws": w(1), "bs": b(),
             "dilation": 3 ** j} for j in range(3)]


def _jax_grads(x, stacks, final, pad_mode, t_tile, loss):
    """(loss, dx, [dstack dicts], dfinal) of the JAX kernel in interpret mode."""
    dils = [st["dilation"] for st in stacks]
    keys = [k for k in KEYS if stacks[0][k] is not None]
    ws = [{k: jnp.asarray(st[k]) for k in keys} for st in stacks]
    fin = None if final is None else tuple(jnp.asarray(v) for v in final)

    @jax.jit
    def run(x, ws, fin):
        def f(x, ws, fin):
            sts = [dict(w, dilation=d, **{k: None for k in KEYS if k not in keys})
                   for w, d in zip(ws, dils)]
            y = jax_stacks_train(x, sts, final=fin, pad_mode=pad_mode,
                                 t_tile=t_tile, interpret=True)
            return loss(y)

        return jax.value_and_grad(f, argnums=(0, 1, 2))(x, ws, fin)

    v, (gx, gws, gf) = run(jnp.asarray(x), ws, fin)
    return float(v), np.asarray(gx), [{k: np.asarray(g[k]) for k in g} for g in gws], gf


def _port_grads(x, stacks, final, pad_mode, loss):
    xv = torch.tensor(x, requires_grad=True)
    sts = [{k: (v if k == "dilation" or v is None else torch.tensor(v, requires_grad=True))
            for k, v in st.items()} for st in stacks]
    fin = None if final is None else tuple(torch.tensor(v, requires_grad=True)
                                           for v in final)
    launches = k7.melgan_stacks_backward.launches
    y = k7.fused_melgan_stacks_train(xv, sts, final=fin, pad_mode=pad_mode, t_tile=16)
    out = loss(y)
    out.backward()
    assert k7.melgan_stacks_backward.launches == launches  # no kernel on the CPU
    return float(out.detach()), xv.grad.numpy(), sts, fin


def _misses(got, want) -> bool:
    """True where ``got`` misses ``want``: |diff| > 2e-4 + 1e-3 |want|
    anywhere, or max|diff| > 1e-4 max|want|."""
    diff = np.abs(got - want)
    return (got.shape != want.shape or not np.isfinite(got).all()
            or not (diff <= 2e-4 + 1e-3 * np.abs(want)).all()
            or float(diff.max()) > 1e-4 * float(np.abs(want).max()))


def _assert_grads_match(pairs, dx=None):
    """Every (name, got, want) within tolerance, and the controls rejected:
    each ``got`` zeroed in turn and, for the pair named ``dx``, dx moved 1 %
    toward its one-sample shift along T."""
    bad = [name for name, g, w in pairs if _misses(g, w)]
    assert not bad, [(n, float(np.abs(g - w).max())) for n, g, w in pairs if n in bad]
    for name, g, w in pairs:
        assert _misses(np.zeros_like(g), w), f"zeroed {name} passed"
    if dx is not None:
        g, w = next((g, w) for n, g, w in pairs if n == dx)
        assert _misses(g + 0.01 * (np.roll(g, 1, axis=1) - g), w), "shifted dx passed"


def _compare(x, stacks, final, pad_mode, t_tile, seed=5):
    out_ch = x.shape[-1] if final is None else final[0].shape[-1]
    cot = np.random.RandomState(seed).randn(*x.shape[:-1], out_ch).astype(np.float32)
    v_ref, gx, gws, gf = _jax_grads(x, stacks, final, pad_mode, t_tile,
                                    lambda y: jnp.sum(y * cot))
    v, dx, sts, fin = _port_grads(x, stacks, final, pad_mode,
                                  lambda y: (y * torch.from_numpy(cot)).sum())
    np.testing.assert_allclose(v, v_ref, rtol=1e-5)
    pairs = [("dx", dx, gx)]
    for i, (st, g) in enumerate(zip(sts, gws)):
        assert sorted(g) == sorted(k for k in KEYS if st[k] is not None)
        pairs += [(f"stacks[{i}].{k}", st[k].grad.numpy(), g[k]) for k in g]
    if final is not None:
        pairs += [(f"final {name}", t.grad.numpy(), np.asarray(g))
                  for name, t, g in zip(("w", "b"), fin, gf)]
    _assert_grads_match(pairs, dx="dx")


@pytest.mark.parametrize("c,t,t_tile,pad_mode", [
    (c, t, t_tile, mode) for c in (32, 64) for t, t_tile in ((256, 64), (272, 16))
    for mode in ("reflect", "constant")] + [(64, 272, 16, "edge")])
def test_k7_plain_version_matches_jax_kernel(c, t, t_tile, pad_mode):
    rs = np.random.RandomState(0)
    stacks = _rand_stacks(rs, c)
    x = (rs.randn(2, t, c) * 0.5).astype(np.float32)
    _compare(x, stacks, None, pad_mode, t_tile)


@pytest.mark.parametrize("out_ch,pad_mode", [(1, "reflect"), (4, "reflect"), (4, "edge")])
def test_k7_plain_version_with_final_matches_jax_kernel(out_ch, pad_mode):
    """The last stage: the trailing act -> k7 out conv -> tanh (:80-109)."""
    c, t = 32, 192
    rs = np.random.RandomState(1)
    stacks = _rand_stacks(rs, c)
    final = ((rs.randn(7, c, out_ch) * 0.1).astype(np.float32),
             (rs.randn(out_ch) * 0.05).astype(np.float32))
    x = (rs.randn(1, t, c) * 0.5).astype(np.float32)
    _compare(x, stacks, final, pad_mode, 16)


def test_k7_plain_version_without_biases_matches_jax_kernel():
    rs = np.random.RandomState(2)
    stacks = _rand_stacks(rs, 32, bias=False)
    x = (rs.randn(1, 160, 32) * 0.5).astype(np.float32)
    _compare(x, stacks, None, "reflect", 16)


def test_backward_on_the_cpu_is_the_plain_version():
    """``melgan_stacks_backward`` on CPU tensors returns its plain version
    and counts no launch; ``fused_melgan_stacks_train``'s forward is the
    plain forward and its gradients are the plain version's."""
    rs = np.random.RandomState(3)
    stacks = [{k: (v if k == "dilation" or v is None else torch.from_numpy(v))
               for k, v in st.items()} for st in _rand_stacks(rs, 16)]
    final = (torch.from_numpy((rs.randn(7, 16, 2) * 0.1).astype(np.float32)), None)
    x = torch.from_numpy(rs.randn(2, 50, 16).astype(np.float32))
    dy = torch.from_numpy(rs.randn(2, 50, 2).astype(np.float32))
    args = (x, stacks, final, 0.2, "edge", dy)
    before = (k7.melgan_stacks_backward.launches, k6.fused_melgan_stacks.launches)
    got = k7.melgan_stacks_backward(*args)
    want = k7.melgan_stacks_backward_reference(*args)
    assert (k7.melgan_stacks_backward.launches, k6.fused_melgan_stacks.launches) == before
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert got[2][1] is None and want[2][1] is None
    for a, b in zip(got[1], want[1]):
        for k in KEYS:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)

    leaves = [x.clone().requires_grad_()] + [
        st[k].clone().requires_grad_() for st in stacks for k in KEYS]
    sts = [dict(zip(KEYS, leaves[1 + 6 * i:7 + 6 * i]), dilation=st["dilation"])
           for i, st in enumerate(stacks)]
    y = k7.fused_melgan_stacks_train(leaves[0], sts, final=final, pad_mode="edge")
    torch.testing.assert_close(
        y.detach(), k6.melgan_stacks_reference(x, stacks, final=final, pad_mode="edge"),
        rtol=0, atol=0)
    y.backward(dy)
    torch.testing.assert_close(leaves[0].grad, want[0], rtol=0, atol=0)
    for leaf, (i, k) in zip(leaves[1:], [(i, k) for i in range(3) for k in KEYS]):
        torch.testing.assert_close(leaf.grad, want[1][i][k], rtol=0, atol=0)


def test_pad_mode_is_checked():
    x = torch.zeros(1, 20, 16)
    with pytest.raises(ValueError, match="pad_mode 'wrap'"):
        k7.fused_melgan_stacks_train(x, [], pad_mode="wrap")
    with pytest.raises(ValueError, match="pad_mode 'wrap'"):
        k7.melgan_stacks_backward(x, [], None, 0.2, "wrap", x)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


def _grads_to_jax(params, module) -> dict:
    """The port's parameter gradients as a JAX tree (the converter's maps
    are linear, so they carry gradients as they carry weights)."""
    sd = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
          for k, p in module.named_parameters()}
    return convert_state_dict(MELGAN, params, sd)[0]


def _unit_scales(params):
    """JAX's N(0, 0.02) init leaves the generator's output near 1e-7 and its
    gradients far under the 2e-4 term: weight norm's every scale g set to 1
    gives unit-norm filters, which keep activations and gradients of order
    one (the converter carries g to ``weight_g``)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.ones_like(a) if jax.tree_util.keystr(p).endswith("['g']") else a,
        params)


def test_generator_grads_through_the_train_path_match_jax():
    """tests/test_melgan_stack_train_kernel.py:135-165's generator, both
    stages fused: the port's gradients reach ``weight_g``/``weight_v`` of
    every conv as the JAX generator's do (its XLA path, which that test
    holds to its kernels within 2e-4), each leaf within tolerance and each
    zeroed leaf rejected."""
    kw = dict(in_channels=20, out_channels=1, channels=128, kernel_size=7,
              upsample_scales=[4, 2], stacks=2)
    c = np.random.RandomState(3).randn(2, 24, 20).astype(np.float32)
    cot = np.random.RandomState(4).randn(2, 24 * 8, 1).astype(np.float32)
    jg = jax_model_class(MELGAN)(**kw)
    v = jax.tree_util.tree_map(np.asarray, jg.init(jax.random.key(0), jnp.asarray(c)))
    v = {"params": _unit_scales(v["params"])}

    def loss(params):
        return jnp.sum(jg.apply({"params": params}, jnp.asarray(c)) * cot)

    v_ref, g_ref = jax.jit(jax.value_and_grad(loss))(v["params"])
    port = get_model_class(MELGAN)(**kw, use_pallas_stacks_train=True)
    port.load_state_dict(jax_params_to_state_dict(MELGAN, kw, v), strict=True)
    assert port.fused_stages == (0, 1)
    out = (port(torch.from_numpy(c).transpose(1, 2))
           * torch.from_numpy(cot).transpose(1, 2)).sum()
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(v_ref), rtol=1e-5)
    got = _grads_to_jax(kw, port)
    want = dict(jax.tree_util.tree_leaves_with_path(g_ref))
    pairs = [(jax.tree_util.keystr(path), np.asarray(g), np.asarray(want[path]))
             for path, g in jax.tree_util.tree_leaves_with_path(got)]
    assert len(pairs) == len(want)
    _assert_grads_match(pairs)


# ---------------------------------------------------------------------------
# the train step, bin/train and checkpoints
# ---------------------------------------------------------------------------


def _batches(n, seed=8):
    rs = np.random.RandomState(seed)
    return [{"y": (rs.randn(2, 1024, 1) * 0.3).astype(np.float32),
             "c": rs.randn(2, 64, 10).astype(np.float32)} for _ in range(n)]


def _to_jax(model_type, params, module):
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    return convert_state_dict(model_type, params, sd)[0]


def test_train_step_matches_jax_build_train_step():
    """Four steps (2 G-only, 2 G+D) from carried weights on the same
    batches: the port (its stages through ``use_pallas_stacks_train``)
    against JAX's jitted steps (its XLA path)."""
    config = json.loads(json.dumps(CONFIG))
    gen = get_model_class(MELGAN)(**SMALL, generator=torch.Generator().manual_seed(0))
    dis = get_model_class(PWG_D)(**SMALL_D, generator=torch.Generator().manual_seed(1))
    plain = {k: v for k, v in SMALL.items() if k != "use_pallas_stacks_train"}
    jg, jd = jax_model_class(MELGAN)(**plain), jax_model_class(PWG_D)(**SMALL_D)
    jcfg = json.loads(json.dumps(CONFIG))
    jcrit = jax_criterion(jcfg)
    tx_g = jax_build_optimizer("RAdam", jcfg["generator_optimizer_params"], "StepLR",
                               jcfg["generator_scheduler_params"], 10)
    tx_d = jax_build_optimizer("RAdam", jcfg["discriminator_optimizer_params"],
                               "StepLR", jcfg["discriminator_scheduler_params"], 1)
    state = init_train_state(_to_jax(MELGAN, plain, gen), _to_jax(PWG_D, SMALL_D, dis),
                             tx_g, tx_d)
    steps = {(g, d): build_train_step(jcfg, jg, jd, jcrit, tx_g, tx_d, train_g=g,
                                      train_d=d, donate=False)
             for g, d in ((True, False), (True, True))}
    opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
    opt_d = build_optimizer_from_config(config, "discriminator", dis.parameters())
    step = TrainStep(config, gen, dis, build_criterion(config), opt_g, opt_d)
    assert gen.fused_stages == (0, 1)

    for i, batch in enumerate(_batches(4)):
        phase = (True, i >= 2)
        state, want = steps[phase](state, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jax.random.key(i))
        got = step(batch_to_device(batch, "cpu"), *phase)
        assert sorted(got) == sorted(want)
        for k in want:
            rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
            assert rel <= 1e-5, (i, k, float(got[k]), float(want[k]))
    for model_type, params, module, tree in (
            (MELGAN, plain, gen, state.params_g), (PWG_D, SMALL_D, dis, state.params_d)):
        got = _to_jax(model_type, params, module)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves(got)):
            err = float(np.abs(np.asarray(a) - b).max())
            assert err <= 1e-5, (model_type, jax.tree_util.keystr(path), err)


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


def test_train_main_runs_4_steps_resume_reproduces_them_and_both_packages_decode(
        tmp_path):
    _write_dump(str(tmp_path / "train"), 6, 0)
    _write_dump(str(tmp_path / "dev"), 2, 1)
    with open(tmp_path / "c.json", "w") as f:
        json.dump(CONFIG, f)

    def args(outdir, *extra):
        return ["--train-dumpdir", str(tmp_path / "train"), "--dev-dumpdir",
                str(tmp_path / "dev"), "--outdir", str(tmp_path / outdir),
                "--config", str(tmp_path / "c.json"), "--verbose", "0",
                "--device", "cpu", *extra]

    first = train.main(args("exp"))
    assert first["steps"] == 4
    assert {"0_gen.wav", "0_ref.wav", "1_gen.wav"} <= set(
        os.listdir(tmp_path / "exp" / "predictions" / "4steps"))
    logged = {s: m for s, m in first["history"] if "train/generator_loss" in m}
    assert sorted(logged) == [1, 2, 3, 4]
    assert "train/discriminator_loss" not in logged[2]
    assert "train/real_loss" in logged[4]
    assert any("eval/generator_loss" in m for _, m in first["history"])
    resumed = train.main(args("exp2", "--resume",
                              str(tmp_path / "exp" / "checkpoint-2steps.pkl")))
    again = {s: m for s, m in resumed["history"] if "train/generator_loss" in m}
    assert sorted(again) == [3, 4]
    for s in (3, 4):
        assert again[s] == logged[s], s

    # the step-4 training checkpoint decodes in both packages alike
    ckpt = str(tmp_path / "exp" / "checkpoint-4steps.pkl")
    jax_model = jax_load_model(ckpt)  # reads config.yml beside the checkpoint
    port = load_model(ckpt, device="cpu")
    mel = np.random.RandomState(7).randn(33, 10).astype(np.float32)
    got = port.inference(mel)
    want = np.asarray(jax_model.inference(mel))
    assert got.shape == want.shape == (33 * 16, 1)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_multi_band_criterion_synthesises_the_sub_bands():
    """A generator of 2 sub-bands gets PQMF in the criterion (no sub-band
    STFT loss unless asked for); ``aux_losses`` synthesises its output to
    the full band, which is what the STFT loss sees."""
    from parallelwavegan_tpu_torch.train.step import aux_losses

    crit = build_criterion(dict(CONFIG, generator_params=dict(SMALL, out_channels=2)))
    assert crit.pqmf is not None and crit.pqmf.subbands == 2 and crit.sub_stft is None
    rs = np.random.RandomState(9)
    y_mb = torch.from_numpy(rs.randn(2, 2, 512).astype(np.float32))
    y = torch.from_numpy(rs.randn(2, 1, 1024).astype(np.float32))
    metrics = {}
    loss, full = aux_losses(crit, y_mb, y, metrics)
    want = crit.pqmf.synthesis(y_mb.transpose(1, 2)).transpose(1, 2)
    assert full.shape == (2, 1, 1024)
    torch.testing.assert_close(full, want, rtol=0, atol=0)
    sc, mag = crit.stft(want[:, 0], y[:, 0])
    torch.testing.assert_close(loss, sc + mag, rtol=0, atol=0)
    assert sorted(metrics) == ["log_stft_magnitude_loss", "spectral_convergence_loss"]


def test_chip_smoke_melgan_v1_training_config_equals_shipped_config():
    """The config of chip_smoke.py's phases 18-19 is melgan.v1.yaml
    verbatim; the phases add ``use_pallas_stacks_train`` and overrides of
    keys the YAML has."""
    import importlib.util

    yaml = pytest.importorskip("yaml")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    with open(os.path.join(ROOT, "egs/ljspeech/voc1/conf/melgan.v1.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert json.loads(json.dumps(smoke.V1_MELGAN_CONFIG)) == cfg
    assert set(smoke.TRAIN_OVERRIDES) <= set(cfg)
    assert "use_pallas_stacks_train" not in cfg["generator_params"]
