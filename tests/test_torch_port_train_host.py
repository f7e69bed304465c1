"""The port's training host code held against the JAX package on the CPU:
STFT magnitude and the MR-STFT loss, the adversarial losses, the
optimizers (RAdam against ``optax.radam`` past its step-6 rectification,
Adam, StepLR/MultiStepLR, global-norm clipping, weight decay), collater
and loader, the train step against JAX ``build_train_step`` from carried
weights, and the trainer and ``bin/train.main`` (checkpoint, resume,
SIGTERM, the device rule). Inputs are made with numpy from seeds.
"""

import json
import os
import signal
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from parallelwavegan_tpu.convert.torch_checkpoint import (  # noqa: E402
    convert_state_dict,
)
from parallelwavegan_tpu.data import Collater as JaxCollater  # noqa: E402
from parallelwavegan_tpu.data import DataLoader as JaxDataLoader  # noqa: E402
from parallelwavegan_tpu.losses import adversarial_loss as jax_adv  # noqa: E402
from parallelwavegan_tpu.losses import stft_loss as jax_stft_loss  # noqa: E402
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.ops.stft import stft_magnitude as jax_stft_magnitude  # noqa: E402
from parallelwavegan_tpu.optimizers import build_optimizer as jax_build_optimizer  # noqa: E402
from parallelwavegan_tpu.train.criterion import build_criterion as jax_criterion  # noqa: E402
from parallelwavegan_tpu.train.state import init_train_state  # noqa: E402
from parallelwavegan_tpu.train.step import build_train_step  # noqa: E402
from parallelwavegan_tpu_torch.bin import train  # noqa: E402
from parallelwavegan_tpu_torch.data.collater import Collater  # noqa: E402
from parallelwavegan_tpu_torch.data.loader import DataLoader  # noqa: E402
from parallelwavegan_tpu_torch.losses import (  # noqa: E402
    DiscriminatorAdversarialLoss,
    GeneratorAdversarialLoss,
    MultiResolutionSTFTLoss,
)
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.mel import logmelfilterbank  # noqa: E402
from parallelwavegan_tpu_torch.ops.stft import stft_magnitude  # noqa: E402
from parallelwavegan_tpu_torch.optimizers import (  # noqa: E402
    build_optimizer,
    build_optimizer_from_config,
)
from parallelwavegan_tpu_torch.train.criterion import build_criterion  # noqa: E402
from parallelwavegan_tpu_torch.train.step import TrainStep, batch_to_device  # noqa: E402
from parallelwavegan_tpu_torch.train.trainer import Trainer  # noqa: E402

PWG, PWG_D = "ParallelWaveGANGenerator", "ParallelWaveGANDiscriminator"
SMALL = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
             skip_channels=8, aux_channels=10, aux_context_window=2,
             upsample_params={"upsample_scales": [4, 4]})
SMALL_D = dict(layers=4, conv_channels=8)
CONFIG = {
    "sampling_rate": 8000, "hop_size": 16, "format": "npy",
    "generator_type": PWG, "generator_params": SMALL,
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
# STFT and losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fft,hop,win", [(1024, 120, 600), (2048, 240, 1200),
                                         (512, 50, 240)])
def test_stft_magnitude_and_grad_match_jax(fft, hop, win):
    x = np.random.RandomState(0).randn(2, 4000).astype(np.float32)
    x[1, 1000:3000] = 0.0  # silence: the clamp of the power at 1e-7
    want, vjp = jax.vjp(lambda v: jax_stft_magnitude(v, fft, hop, win), x)
    xt = torch.tensor(x, requires_grad=True)
    got = stft_magnitude(xt, fft, hop, win)
    assert got.shape == want.shape == (2, 4000 // hop + 1, fft // 2 + 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    ct = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                               rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("shape", [(2, 6000), (2, 3000, 3)])
def test_mr_stft_loss_and_grads_match_jax(shape):
    rs = np.random.RandomState(2)
    x, y = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    params = dict(fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                  win_lengths=(600, 1200, 240))
    jl = jax_stft_loss.MultiResolutionSTFTLoss(**params)

    def jax_total(x):
        sc, mag = jl(x, jnp.asarray(y))
        return sc + mag, (sc, mag)

    (_, (sc0, mag0)), g0 = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(x)
    xt = torch.tensor(x, requires_grad=True)
    sc, mag = MultiResolutionSTFTLoss(**params)(xt, torch.from_numpy(y))
    (sc + mag).backward()
    np.testing.assert_allclose(float(sc.detach()), float(sc0), rtol=1e-5)
    np.testing.assert_allclose(float(mag.detach()), float(mag0), rtol=1e-5)
    # d log|X| / dx grows as 1/|X|, so float32 FFT rounding at the bins of
    # small magnitude dominates the gradient's error: against a float64
    # run, the port's is within 3.4e-3 of the gradient's scale and JAX's
    # within 5.8e-4 on these inputs
    g0 = np.asarray(g0)
    np.testing.assert_allclose(xt.grad.numpy(), g0, rtol=0,
                               atol=5e-3 * np.abs(g0).max())


@pytest.mark.parametrize("loss_type", ["mse", "hinge"])
@pytest.mark.parametrize("average", [True, False])
def test_adversarial_losses_match_jax(loss_type, average):
    rs = np.random.RandomState(3)
    flat = rs.randn(2, 1, 50).astype(np.float32)
    nested = [[rs.randn(2, 4, 9).astype(np.float32), rs.randn(2, 1, 9).astype(np.float32)],
              rs.randn(2, 1, 7).astype(np.float32)]
    nested_hat = [[a + 0.3 for a in nested[0]], nested[1] - 0.2]
    kw = dict(average_by_discriminators=average, loss_type=loss_type)

    def tt(o):
        return [tt(v) for v in o] if isinstance(o, list) else torch.from_numpy(o)

    for outs, outs_hat in ((flat, flat * 0.5), (nested, nested_hat)):
        want = jax_adv.GeneratorAdversarialLoss(**kw)(outs_hat)
        np.testing.assert_allclose(
            float(GeneratorAdversarialLoss(**kw)(tt(outs_hat))), float(want), rtol=1e-6)
        wr, wf = jax_adv.DiscriminatorAdversarialLoss(**kw)(outs_hat, outs)
        gr, gf = DiscriminatorAdversarialLoss(**kw)(tt(outs_hat), tt(outs))
        np.testing.assert_allclose([float(gr), float(gf)], [float(wr), float(wf)],
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="unsupported"):
        GeneratorAdversarialLoss(loss_type="wasserstein")


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _params_and_grads(n_steps, seed=4, scale=1.0):
    rs = np.random.RandomState(seed)
    shapes = [(3, 4), (7,), (2, 3, 5)]
    params = [(rs.uniform(0.5, 1.5, s) * np.sign(rs.randn(*s))).astype(np.float32)
              for s in shapes]
    grads = [[(rs.randn(*s) * scale).astype(np.float32) for s in shapes]
             for _ in range(n_steps)]
    return params, grads


def _run_both(tx, port_opt_factory, params, grads):
    """[(jax params, port params)] after each of the fixed gradients."""
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = port_opt_factory(tp)
    out = []
    for g in grads:
        updates, state = tx.update([jnp.asarray(v) for v in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, v in zip(tp, g):
            p.grad = torch.from_numpy(v)
        opt.step()
        out.append(([np.asarray(p) for p in jp], [p.detach().numpy().copy() for p in tp]))
    return out


def test_radam_matches_optax_for_20_steps():
    """eps 1e-6 (PWG v1): rho_t >= 5 from step 6 on; the two agree to 1e-6
    relative at every step, where ``torch.optim.RAdam`` does not."""
    params, grads = _params_and_grads(20)
    steps = _run_both(optax.radam(1e-4, eps=1e-6),
                      lambda tp: build_optimizer(tp, "RAdam", {"lr": 1e-4, "eps": 1e-6}),
                      params, grads)
    for i, (jp, tp) in enumerate(steps, start=1):
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f"step {i}")
    # torch.optim.RAdam's eps acts as eps / sqrt(1 - beta2^t): with gradients
    # near eps its updates are a different function
    params, grads = _params_and_grads(20, scale=1e-6)
    steps = _run_both(optax.radam(1e-4, eps=1e-6),
                      lambda tp: torch.optim.RAdam(tp, lr=1e-4, eps=1e-6),
                      params, grads)
    moved = [a - p for a, p in zip(steps[-1][0], params)]
    diff = max(float(np.abs(b - a).max()) for a, b in zip(*steps[-1]))
    assert diff > 0.1 * max(float(np.abs(m).max()) for m in moved)


@pytest.mark.parametrize("opt_type,sched,sched_params,grad_norm,wd", [
    ("RAdam", "StepLR", {"step_size": 3, "gamma": 0.5}, 1.0, 0.0),
    ("Adam", "MultiStepLR", {"milestones": [2, 5, 5], "gamma": 0.3}, 10.0, 1e-2),
    ("Adam", None, None, -1, 0.0),
])
def test_schedules_clipping_and_decay_match_build_optimizer(opt_type, sched,
                                                            sched_params,
                                                            grad_norm, wd):
    params, grads = _params_and_grads(8, seed=5, scale=3.0)
    opt_params = {"lr": 1e-3, "betas": (0.8, 0.99), "weight_decay": wd}
    tx = jax_build_optimizer(opt_type, opt_params, sched, sched_params, grad_norm)
    steps = _run_both(tx, lambda tp: build_optimizer(tp, opt_type, opt_params, sched,
                                                     sched_params, grad_norm),
                      params, grads)
    for i, (jp, tp) in enumerate(steps, start=1):
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9, err_msg=f"step {i}")


def test_optimizer_state_round_trips_and_unported_types_raise():
    params, grads = _params_and_grads(3)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    config = {"generator_optimizer_params": {"lr": 1e-4},
              "generator_scheduler_params": {"step_size": 1, "gamma": 0.5}}
    opt = build_optimizer_from_config(config, "generator", tp)
    for g in grads:
        for p, v in zip(tp, g):
            p.grad = torch.from_numpy(v)
        opt.step()
    assert opt.step_count == 3 and opt.lr_schedule(3) == 1e-4 * 0.125
    again = build_optimizer_from_config(config, "generator", tp)
    again.load_state_dict(opt.state_dict())
    assert again.step_count == 3
    torch.testing.assert_close(again.state[tp[0]]["exp_avg"], opt.state[tp[0]]["exp_avg"])
    for kind in ("NAdam", "SGD", "Lion"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build_optimizer(tp, kind, {})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_optimizer(tp, "Adam", {}, "CosineAnnealingLR", {"T_max": 3})
    with pytest.raises(ValueError, match="step_size"):
        build_optimizer(tp, "RAdam", {}, "StepLR", {})


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _items(n=7, hop=16, seed=6):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        frames = 70 + 9 * i
        out.append((rs.randn(frames * hop - 5 * (i % 2)).astype(np.float32),
                    rs.randn(frames, 10).astype(np.float32)))
    return out


@pytest.mark.parametrize("workers", [1, 2])
def test_collater_and_loader_equal_jax(workers):
    items = _items()
    kw = dict(batch_max_steps=1024, hop_size=16, aux_context_window=2,
              use_noise_input=True)
    port = DataLoader(items, Collater(**kw, rng=np.random.default_rng(0)),
                      batch_size=2, seed=3, num_workers=workers)
    ref = JaxDataLoader(items, JaxCollater(**kw, rng=np.random.default_rng(0)),
                        batch_size=2, seed=3, num_workers=workers)
    got_stream, want_stream = iter(port), iter(ref)
    for _ in range(8):  # crosses epochs (3 batches each)
        got, want = next(got_stream), next(want_stream)
        assert sorted(got) == sorted(want) == ["c", "y", "z"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got_stream.close()
    want_stream.close()
    assert port.min_batches_across_shards == ref.min_batches_across_shards == 3
    for got, want in zip(port.epoch_batches(0), ref.epoch_batches(0)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert got["y"].shape == (2, 1024, 1) and got["c"].shape == (2, 68, 10)


def test_loader_start_seq_skips_the_first_batches():
    items = _items()
    kw = dict(batch_max_steps=1024, hop_size=16, use_noise_input=True)
    full = DataLoader(items, Collater(**kw), batch_size=2, seed=1)
    stream = iter(full)
    want = [next(stream) for _ in range(5)][3:]
    stream.close()
    resumed = DataLoader(items, Collater(**kw), batch_size=2, seed=1)
    resumed.start_seq = 3
    stream = iter(resumed)
    for w in want:
        got = next(stream)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k])
    stream.close()


# ---------------------------------------------------------------------------
# the train step against JAX
# ---------------------------------------------------------------------------


def _batches(n, seed=8):
    rs = np.random.RandomState(seed)
    return [{"y": (rs.randn(2, 1024, 1) * 0.3).astype(np.float32),
             "c": rs.randn(2, 64 + 4, 10).astype(np.float32),
             "z": rs.randn(2, 1024, 1).astype(np.float32)} for _ in range(n)]


def _port_models():
    gen = get_model_class(PWG)(**SMALL, use_pallas_stack_train=True,
                               pallas_stack_train_layers_per_call=1,
                               generator=torch.Generator().manual_seed(0))
    dis = get_model_class(PWG_D)(**SMALL_D, generator=torch.Generator().manual_seed(1))
    return gen, dis


def _to_jax(model_type, params, module):
    sd = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
    return convert_state_dict(model_type, params, sd)[0]


def test_train_step_matches_jax_build_train_step():
    """One step, then four (2 G-only, 2 G+D), from carried weights on the
    same batches: the port (its generator through ``use_pallas_stack_train``,
    the differentiable cycle) against JAX's jitted steps (its XLA path)."""
    config = json.loads(json.dumps(CONFIG))
    gen, dis = _port_models()
    jg, jd = jax_model_class(PWG)(**SMALL), jax_model_class(PWG_D)(**SMALL_D)
    jcfg = json.loads(json.dumps(CONFIG))
    jcrit = jax_criterion(jcfg)
    tx_g = jax_build_optimizer("RAdam", jcfg["generator_optimizer_params"], "StepLR",
                               jcfg["generator_scheduler_params"], 10)
    tx_d = jax_build_optimizer("RAdam", jcfg["discriminator_optimizer_params"],
                               "StepLR", jcfg["discriminator_scheduler_params"], 1)
    state = init_train_state(_to_jax(PWG, SMALL, gen), _to_jax(PWG_D, SMALL_D, dis),
                             tx_g, tx_d)
    steps = {(g, d): build_train_step(jcfg, jg, jd, jcrit, tx_g, tx_d, train_g=g,
                                      train_d=d, donate=False)
             for g, d in ((True, False), (True, True))}
    opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
    opt_d = build_optimizer_from_config(config, "discriminator", dis.parameters())
    step = TrainStep(config, gen, dis, build_criterion(config), opt_g, opt_d)

    worst_loss = 0.0
    for i, batch in enumerate(_batches(4)):
        phase = (True, i >= 2)
        state, want = steps[phase](state, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jax.random.key(i))
        got = step(batch_to_device(batch, "cpu"), *phase)
        assert sorted(got) == sorted(want)
        if i in (0, 2):  # the first G-only and the first G+D step
            for k in want:
                rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
                worst_loss = max(worst_loss, rel)
                assert rel <= 1e-5, (i, k, float(got[k]), float(want[k]))
    worst = 0.0
    for model_type, params, module, tree in (
            (PWG, SMALL, gen, state.params_g), (PWG_D, SMALL_D, dis, state.params_d)):
        got = _to_jax(model_type, params, module)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves(got)):
            err = float(np.abs(np.asarray(a) - b).max())
            worst = max(worst, err)
            assert err <= 1e-5, (model_type, jax.tree_util.keystr(path), err)
    print(f"port vs JAX train step: losses {worst_loss:.2e} relative, "
          f"parameters after 4 steps {worst:.2e} absolute")


# ---------------------------------------------------------------------------
# trainer and bin/train
# ---------------------------------------------------------------------------


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


@pytest.fixture
def train_args(tmp_path):
    _write_dump(str(tmp_path / "train"), 6, 0)
    _write_dump(str(tmp_path / "dev"), 2, 1)
    config = dict(CONFIG, generator_params=dict(SMALL, use_pallas_stack_train=True))
    with open(tmp_path / "c.json", "w") as f:
        json.dump(config, f)

    def args(outdir, *extra):
        return ["--train-dumpdir", str(tmp_path / "train"), "--dev-dumpdir",
                str(tmp_path / "dev"), "--outdir", str(tmp_path / outdir),
                "--config", str(tmp_path / "c.json"), "--verbose", "0", *extra]

    return args


def test_train_main_runs_4_steps_and_resume_reproduces_them(train_args, tmp_path):
    first = train.main(train_args("exp", "--device", "cpu"))
    assert first["steps"] == 4
    names = sorted(os.listdir(tmp_path / "exp"))
    assert {"checkpoint-2steps.pkl", "checkpoint-4steps.pkl", "config.yml",
            "predictions"} <= set(names)
    assert {"0_gen.wav", "0_ref.wav", "1_gen.wav"} <= set(
        os.listdir(tmp_path / "exp" / "predictions" / "4steps"))
    logged = {s: m for s, m in first["history"] if "train/generator_loss" in m}
    assert sorted(logged) == [1, 2, 3, 4]
    # discriminator_train_start_steps 1: steps 1-2 train G, steps 3-4 both
    assert "train/discriminator_loss" not in logged[2]
    assert "train/adversarial_loss" in logged[3] and "train/real_loss" in logged[4]
    assert any("eval/generator_loss" in m for _, m in first["history"])

    resumed = train.main(train_args("exp2", "--device", "cpu", "--resume",
                                    str(tmp_path / "exp" / "checkpoint-2steps.pkl")))
    again = {s: m for s, m in resumed["history"] if "train/generator_loss" in m}
    assert sorted(again) == [3, 4]
    for s in (3, 4):
        assert again[s] == logged[s], s
    a = torch.load(tmp_path / "exp" / "checkpoint-4steps.pkl", weights_only=True)
    b = torch.load(tmp_path / "exp2" / "checkpoint-4steps.pkl", weights_only=True)
    assert a["steps"] == b["steps"] == 4
    assert a["scheduler"]["generator"] == {"last_epoch": 4}
    for part in ("generator", "discriminator"):
        for k, v in a["model"][part].items():
            torch.testing.assert_close(b["model"][part][k], v, rtol=0, atol=0)

    pre = train.main(train_args("exp3", "--device", "cpu", "--pretrain",
                                str(tmp_path / "exp" / "checkpoint-2steps.pkl")))
    assert pre["steps"] == 4 and min(s for s, _ in pre["history"]) == 1


def test_sigterm_stops_before_eval_and_save(tmp_path):
    """The flag set by SIGTERM after a step skips that step's eval and save
    hooks; the final checkpoint is still written."""
    config = json.loads(json.dumps(dict(CONFIG, eval_interval_steps=2)))
    gen, dis = _port_models()
    opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
    opt_d = build_optimizer_from_config(config, "discriminator", dis.parameters())
    batches = _batches(4)
    trainer = Trainer(config, gen, dis, build_criterion(config), opt_g, opt_d,
                      iter(batches), dev_loader=None, outdir=str(tmp_path),
                      device="cpu", writer=False)
    real_step, saved = trainer.step_fn, []

    def step_then_term(batch, train_g, train_d, step):
        out = real_step(batch, train_g, train_d, step)
        if trainer.steps == 1:  # the counter moves after this call: step 2
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.step_fn = step_then_term
    trainer._check_eval_interval = lambda: saved.append(f"eval hook {trainer.steps}")
    real_save = trainer.save_checkpoint
    trainer.save_checkpoint = lambda path: (saved.append(os.path.basename(path)),
                                            real_save(path))
    handler = signal.getsignal(signal.SIGTERM)
    trainer.run()
    assert signal.getsignal(signal.SIGTERM) is handler
    assert trainer.preempted and trainer.steps == 2
    # step 1 reached the eval hook; step 2 went from the flag to the final save
    assert saved == ["eval hook 1", "checkpoint-2steps.pkl"]
    assert os.path.exists(tmp_path / "checkpoint-2steps.pkl")


def test_train_main_needs_a_card_unless_cpu_is_asked_for(train_args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device.*--device cpu"):
        train.main(train_args("exp"))


@pytest.mark.parametrize("override,argv,what", [
    ({"distributed": True}, [], "distributed"),
    ({"generator_optimizer_type": "SGD"}, [], "optimizer SGD"),
    ({"generator_scheduler_type": "CosineAnnealingLR"}, [], "scheduler CosineAnnealingLR"),
    ({"discriminator_scheduler_type": "LinearLR"}, [], "scheduler LinearLR"),
    ({"discriminator_optimizer_type": "Lion"}, [], "optimizer Lion"),
])
def test_unported_training_options_raise(tmp_path, train_args, override, argv, what):
    with open(tmp_path / "c.json") as f:
        config = json.load(f)
    config.update(override)
    with open(tmp_path / "c.json", "w") as f:
        json.dump(config, f)
    with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP.md"):
        train.main(train_args("exp", "--device", "cpu", *argv))


def test_train_main_runs_mixed_precision_through_the_tade_kernels(tmp_path, monkeypatch):
    """``mixed_precision`` with ``use_pallas_tade_train`` (refused until the
    bf16 modes of K8/K9 were ported): a small StyleMelGAN through
    ``bin/train.main`` on the CPU for two steps, its long blocks through the
    bf16 plain versions of K8a/K8b (counted), the losses finite, every
    checkpoint tensor float32."""
    from parallelwavegan_tpu_torch.ops.kernels import tade_train

    rs = np.random.RandomState(0)
    os.makedirs(tmp_path / "dump")
    for i in range(2):
        frames = 12 + 3 * i
        np.save(tmp_path / "dump" / f"u{i}-wave.npy",
                (0.1 * rs.randn(frames * 4)).astype(np.float32))
        np.save(tmp_path / "dump" / f"u{i}-feats.npy", rs.randn(frames, 20).astype(np.float32))
    config = {
        "sampling_rate": 8000, "hop_size": 4, "format": "npy", "mixed_precision": True,
        "generator_type": "StyleMelGANGenerator",
        # block inputs 10, 20, 40: blocks 1 and 2 fused
        "generator_params": dict(in_channels=16, aux_channels=20, channels=64,
                                 out_channels=1, kernel_size=9, dilation=2,
                                 noise_upsample_scales=[5, 2], upsample_scales=[2, 2, 1],
                                 use_pallas_tade_train=True, pallas_tade_train_min_t=20),
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
        "generator_optimizer_type": "Adam", "generator_optimizer_params": {"lr": 1e-4},
        "discriminator_optimizer_type": "Adam",
        "discriminator_optimizer_params": {"lr": 1e-4},
        "generator_grad_norm": 10, "discriminator_grad_norm": 1,
        "batch_size": 2, "batch_max_steps": 40, "num_workers": 1, "train_max_steps": 2,
        "save_interval_steps": 1, "eval_interval_steps": 100, "log_interval_steps": 1,
    }
    with open(tmp_path / "c.json", "w") as f:
        json.dump(config, f)
    calls = []
    real = tade_train.tade1_reference_bf16
    monkeypatch.setattr(tade_train, "tade1_reference_bf16",
                        lambda *a, **k: calls.append(a[0].dtype) or real(*a, **k))
    out = train.main(["--train-dumpdir", str(tmp_path / "dump"), "--dev-dumpdir",
                      str(tmp_path / "dump"), "--outdir", str(tmp_path / "exp"),
                      "--config", str(tmp_path / "c.json"), "--verbose", "0",
                      "--device", "cpu"])
    assert out["steps"] == 2
    # two fused blocks per generator forward, two G phases at least
    assert len(calls) >= 4 and set(calls) == {torch.bfloat16}
    logged = [m for _, m in out["history"] if "train/generator_loss" in m]
    assert len(logged) == 2 and all(np.isfinite(v) for m in logged for v in m.values())
    ckpt = torch.load(tmp_path / "exp" / "checkpoint-2steps.pkl", weights_only=True)
    tensors = [v for part in ("model", "optimizer") for sd in ckpt[part].values()
               for v in (sd.values() if part == "model" else
                         [t for st in sd["state"].values() for t in st.values()])]
    assert tensors and all(t.dtype == torch.float32 for t in tensors)


def test_load_config_without_pyyaml(tmp_path, monkeypatch):
    """Without PyYAML a .yml file that holds JSON is read, and a real YAML
    config raises an error that names PyYAML."""
    from parallelwavegan_tpu_torch.utils.config import load_config

    monkeypatch.setitem(sys.modules, "yaml", None)
    with open(tmp_path / "config.yml", "w") as f:
        json.dump({"batch_size": 6}, f)
    assert load_config(str(tmp_path / "config.yml")) == {"batch_size": 6}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with pytest.raises(ImportError, match="needs PyYAML"):
        load_config(os.path.join(root, "egs/ljspeech/voc1/conf/parallel_wavegan.v1.yaml"))


def test_chip_smoke_pwg_v1_training_config_equals_shipped_config():
    """The training config of chip_smoke.py's phases 15-16 is
    parallel_wavegan.v1.yaml verbatim; its overrides change only keys the
    YAML has."""
    import importlib.util

    yaml = pytest.importorskip("yaml")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    with open(os.path.join(root, "egs/ljspeech/voc1/conf/parallel_wavegan.v1.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert json.loads(json.dumps(smoke.V1_PWG_CONFIG)) == cfg
    assert set(smoke.TRAIN_OVERRIDES) <= set(cfg)
