"""Multi-band MelGAN training in the port held against the JAX package on the
CPU: the pooling and ``MelGANMultiScaleDiscriminator``, AMSGrad against
``optax.amsgrad``, the multi-band auxiliary losses (PQMF in the criterion,
the sub-band STFT loss at multi_band_melgan.v2.yaml's odd FFT sizes)
against JAX's ``_generator_losses``, the train step against JAX's
``build_train_step`` (the port's stages through ``use_pallas_stacks_train``,
so K6/K7's plain versions), ``bin/train.main`` with a resume and a decode in
both packages, and the causal ResidualStack, MelGAN generator and PWG
generator with the MelGAN upsample net.

Inputs are made with numpy from seeds; JAX's ``init`` makes the weights,
which go into the port through ``jax_params_to_state_dict``, with weight
norm's every scale g set to 1 where values are compared (MelGAN's N(0,
0.02) init leaves outputs near 1e-7 otherwise, under any tolerance).
Tolerances: 2e-4 on values (float32 convolutions summed in other orders),
1e-5 relative on losses, 1e-5 on parameters and optimizer state after
four steps, as tests/test_torch_port_melgan_train.py holds MelGAN's step.
Each comparison has a control that it must reject.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import torch.nn.functional as F  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from parallelwavegan_tpu.convert.torch_checkpoint import (  # noqa: E402
    convert_state_dict,
)
from parallelwavegan_tpu.layers.residual_stack import (  # noqa: E402
    ResidualStack as JaxResidualStack,
)
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.models.melgan import avg_pool1d as jax_avg_pool1d  # noqa: E402
from parallelwavegan_tpu.optimizers import build_optimizer as jax_build_optimizer  # noqa: E402
from parallelwavegan_tpu.train.criterion import build_criterion as jax_criterion  # noqa: E402
from parallelwavegan_tpu.train.state import init_train_state  # noqa: E402
from parallelwavegan_tpu.train.step import (  # noqa: E402
    _generator_losses,
    build_train_step,
)
from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.bin import train  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.layers.residual_stack import ResidualStack  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import melgan_stack as k6  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as k7  # noqa: E402
from parallelwavegan_tpu_torch.ops.mel import logmelfilterbank  # noqa: E402
from parallelwavegan_tpu_torch.optimizers import (  # noqa: E402
    AMSGrad,
    build_optimizer,
    build_optimizer_from_config,
)
from parallelwavegan_tpu_torch.train.criterion import build_criterion  # noqa: E402
from parallelwavegan_tpu_torch.train.step import (  # noqa: E402
    TrainStep,
    aux_losses,
    batch_to_device,
)
from parallelwavegan_tpu_torch.utils.config import load_config  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import load_model  # noqa: E402

MELGAN, MSD, PWG = "MelGANGenerator", "MelGANMultiScaleDiscriminator", "ParallelWaveGANGenerator"
# 4 sub-bands, 2 stages at 32 and 16 channels (both fused), hop 8 x 4 = 32
SMALL = dict(in_channels=10, out_channels=4, kernel_size=7, channels=64,
             upsample_scales=[4, 2], stack_kernel_size=3, stacks=2,
             use_pallas_stacks_train=True)
PLAIN = {k: v for k, v in SMALL.items() if k != "use_pallas_stacks_train"}
# multi_band_melgan.v2.yaml's discriminator at narrow widths
SMALL_D = dict(in_channels=1, out_channels=1, scales=3, downsample_pooling="AvgPool1d",
               downsample_pooling_params=dict(kernel_size=4, stride=2, padding=1,
                                              count_include_pad=False),
               kernel_sizes=[5, 3], channels=8, max_downsample_channels=32,
               downsample_scales=[4, 4], nonlinear_activation="LeakyReLU",
               nonlinear_activation_params={"negative_slope": 0.2}, use_weight_norm=True)
# multi_band_melgan.v2.yaml's losses and optimizers; D from step 3, lr
# halved at update 2
V2_STFT = dict(fft_sizes=[1024, 2048, 512], hop_sizes=[120, 240, 50],
               win_lengths=[600, 1200, 240], window="hann_window")
V2_SUB_STFT = dict(fft_sizes=[384, 683, 171], hop_sizes=[30, 60, 10],
                   win_lengths=[150, 300, 60], window="hann_window")
AMS = dict(lr=1e-3, eps=1e-7, weight_decay=0.0, amsgrad=True)
HOP = 32
CONFIG = {
    "sampling_rate": 8000, "hop_size": HOP, "format": "npy",
    "generator_type": MELGAN, "generator_params": SMALL,
    "discriminator_type": MSD, "discriminator_params": SMALL_D,
    "stft_loss_params": V2_STFT, "use_subband_stft_loss": True,
    "subband_stft_loss_params": V2_SUB_STFT, "use_feat_match_loss": False,
    "lambda_adv": 2.5, "batch_size": 2, "batch_max_steps": 1536,
    "remove_short_samples": True, "num_workers": 1,
    "generator_optimizer_type": "Adam", "generator_optimizer_params": AMS,
    "generator_grad_norm": -1, "generator_scheduler_type": "MultiStepLR",
    "generator_scheduler_params": {"gamma": 0.5, "milestones": [2]},
    "discriminator_optimizer_type": "Adam", "discriminator_optimizer_params": AMS,
    "discriminator_grad_norm": -1, "discriminator_scheduler_type": "MultiStepLR",
    "discriminator_scheduler_params": {"gamma": 0.5, "milestones": [2]},
    "discriminator_train_start_steps": 2, "train_max_steps": 4,
    "save_interval_steps": 2, "eval_interval_steps": 4, "log_interval_steps": 1,
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _unit_scales(params):
    """Every weight-norm scale g set to 1: unit-norm filters keep values of
    order one (the converter carries g to ``weight_g``)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.ones_like(a) if jax.tree_util.keystr(p).endswith("['g']") else a,
        params)


def _ncl(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))


def _nlc(t):
    return t.detach().numpy().transpose(0, 2, 1)


def _misses(got, want, atol) -> bool:
    return got.shape != want.shape or not float(np.abs(got - want).max()) <= atol


# ---------------------------------------------------------------------------
# avg_pool1d and MelGANMultiScaleDiscriminator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [300, 301])
@pytest.mark.parametrize("count_include_pad", [False, True])
def test_avg_pool1d_matches_jax(t, count_include_pad):
    """torch's ``avg_pool1d`` (what the port's multi-scale discriminator
    pools with) against JAX's at AvgPool1d(4, 2, 1) and lengths whose edge
    windows hold 3 of 4 samples: the pool with the other
    ``count_include_pad`` is rejected."""
    x = np.random.RandomState(t).randn(2, t, 3).astype(np.float32) + 2.0
    kw = dict(kernel_size=4, stride=2, padding=1)
    want = np.asarray(jax_avg_pool1d(jnp.asarray(x), **kw,
                                     count_include_pad=count_include_pad))
    got = _nlc(F.avg_pool1d(_ncl(x), **kw, count_include_pad=count_include_pad))
    assert got.shape == want.shape == (2, (t + 2 - 4) // 2 + 1, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    other = _nlc(F.avg_pool1d(_ncl(x), **kw, count_include_pad=not count_include_pad))
    assert _misses(other, want, 1e-6)


@pytest.mark.parametrize("t", [1200, 1203])
@pytest.mark.parametrize("count_include_pad", [False, True])
def test_multi_scale_discriminator_matches_jax(t, count_include_pad):
    """Every scale's every feature map within 2e-4 (unit-norm filters, so
    of order one), upstream's keys ``discriminators.{i}.layers.*`` (JAX's
    ``convert_state_dict`` takes the port's state dict back leaf for leaf);
    the discriminator pooling with the other ``count_include_pad`` is
    rejected."""
    params = dict(SMALL_D, downsample_pooling_params=dict(
        SMALL_D["downsample_pooling_params"], count_include_pad=count_include_pad))
    x = (np.random.RandomState(1).randn(2, t, 1) * 0.5).astype(np.float32)
    jd = jax_model_class(MSD)(**params)
    v = {"params": _unit_scales(_np(jd.init(jax.random.key(0), jnp.asarray(x)))["params"])}
    want = jd.apply(v, jnp.asarray(x))
    sd = jax_params_to_state_dict(MSD, params, v)
    back, _ = convert_state_dict(MSD, params, {k: t_.numpy() for k, t_ in sd.items()})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(v["params"]),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=jax.tree_util.keystr(path))
    assert all(k.startswith(("discriminators.0.layers.", "discriminators.1.layers.",
                             "discriminators.2.layers.")) for k in sd)

    def run(p):
        port = get_model_class(MSD)(**p)
        port.load_state_dict(sd, strict=True)
        with torch.no_grad():
            return [[_nlc(f) for f in scale] for scale in port(_ncl(x))]

    got = run(params)
    assert [len(s) for s in got] == [len(s) for s in want] == [5, 5, 5]
    for i, (gs, ws) in enumerate(zip(got, want)):
        for j, (g, w) in enumerate(zip(gs, ws)):
            w = np.asarray(w)
            assert float(np.abs(w).max()) > 0.01, (i, j)
            np.testing.assert_allclose(g, w, atol=2e-4, err_msg=f"scale {i} layer {j}")
    other = run(dict(params, downsample_pooling_params=dict(
        params["downsample_pooling_params"], count_include_pad=not count_include_pad)))
    assert any(_misses(g, np.asarray(w), 2e-4) for g, w in zip(other[1], want[1]))


def test_multi_scale_discriminator_refuses_other_pooling():
    with pytest.raises(ValueError, match="downsample_pooling 'MaxPool1d'"):
        get_model_class(MSD)(**dict(SMALL_D, downsample_pooling="MaxPool1d"))


# ---------------------------------------------------------------------------
# AMSGrad
# ---------------------------------------------------------------------------


def _grads(n=20, seed=3):
    """Gradients of two tensors whose scale falls by 10 over the run, so
    that the bias-corrected and the raw second moments peak apart."""
    rs = np.random.RandomState(seed)
    return [{"a": (rs.randn(4, 3) * 10 ** (-i / 19)).astype(np.float32),
             "b": (rs.randn(5) * 10 ** (-i / 19)).astype(np.float32)} for i in range(n)]


def _nu_max(opt_state):
    found = [s.nu_max for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "nu_max")) if hasattr(s, "nu_max")]
    assert len(found) == 1
    return found[0]


@pytest.mark.parametrize("weight_decay,grad_norm", [(0.0, -1), (1e-2, 1.0)])
def test_amsgrad_matches_optax_over_20_steps(weight_decay, grad_norm):
    """The JAX package's chain (clip, L2 decay, ``optax.amsgrad``, eps 1e-7,
    the lr halved after update 10) against the port's: parameters and
    ``nu_max`` after every step to 1e-6 relative. ``torch.optim.Adam(amsgrad=
    True)`` on the same gradients must miss."""
    rs = np.random.RandomState(0)
    p0 = {"a": rs.randn(4, 3).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    opt = dict(lr=1e-3, eps=1e-7, weight_decay=weight_decay, amsgrad=True)
    sched = {"gamma": 0.5, "milestones": [10]}
    tx = jax_build_optimizer("Adam", opt, "MultiStepLR", sched, grad_norm)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    port = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    popt = build_optimizer(list(port.values()), "Adam", opt, "MultiStepLR", sched, grad_norm)
    assert isinstance(popt, AMSGrad)
    ctrl = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = torch.optim.Adam(list(ctrl.values()), lr=1e-3, eps=1e-7, amsgrad=True)

    def close(got, want):
        return np.allclose(got, want, rtol=1e-6, atol=1e-7)

    ctrl_missed = False
    for i, g in enumerate(_grads()):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in port.items():
            p.grad = torch.from_numpy(g[k])
        popt.step()
        nu_max = _nu_max(state)
        for k, p in port.items():
            assert close(p.detach().numpy(), np.asarray(params[k])), (i, k)
            assert close(popt.state[p]["nu_max"].numpy(), np.asarray(nu_max[k])), (i, k)
        if i < 10 and grad_norm < 0 and weight_decay == 0:
            for k, p in ctrl.items():
                p.grad = torch.from_numpy(g[k])
            topt.step()
            ctrl_missed |= not all(close(p.detach().numpy(), np.asarray(params[k]))
                                   for k, p in ctrl.items())
    if grad_norm < 0 and weight_decay == 0:
        assert ctrl_missed, "torch.optim.Adam(amsgrad=True) passed as optax.amsgrad"


def test_amsgrad_state_round_trips_through_state_dict():
    p = torch.zeros(3, requires_grad=True)
    opt = build_optimizer([p], "Adam", AMS)
    p.grad = torch.ones(3)
    opt.step()
    state = opt.state_dict()
    q = torch.zeros(3, requires_grad=True)
    again = build_optimizer([q], "Adam", AMS)
    again.load_state_dict(state)
    assert sorted(again.state[q]) == ["exp_avg", "exp_avg_sq", "nu_max"]
    torch.testing.assert_close(again.state[q]["nu_max"], opt.state[p]["nu_max"])
    assert again.step_count == 1


# ---------------------------------------------------------------------------
# the multi-band auxiliary losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_stft,use_sub", [(True, True), (False, True), (True, False)])
def test_multi_band_aux_losses_match_jax(use_stft, use_sub):
    """JAX ``_generator_losses`` on sub-bands (B, T/4, 4) against the port's
    ``aux_losses`` on the same values in (B, 4, T/4): every metric and the
    total to 1e-5 relative, the full band to 1e-6, the gradient with
    respect to the sub-bands to 2e-4 of its largest. The port fed the
    sub-bands' memory read as (B, 4, T/4) without the transpose is
    rejected."""
    t = 2048  # sub-bands of 512 > the 683-point FFT's reflect pad of 341
    rs = np.random.RandomState(4)
    y_mb_ = (rs.randn(2, t // 4, 4) * 0.1).astype(np.float32)
    y = (rs.randn(2, t, 1) * 0.3).astype(np.float32)
    config = dict(CONFIG, use_stft_loss=use_stft, use_subband_stft_loss=use_sub)
    jcrit = jax_criterion(json.loads(json.dumps(config)))
    crit = build_criterion(json.loads(json.dumps(config)))

    def jax_total(mb):
        m = {}
        total, y_full, _ = _generator_losses(jcrit, config, mb, jnp.asarray(y), m)
        return total, (m, y_full)

    (want, (wm, wfull)), wgrad = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        jnp.asarray(y_mb_))
    mb = _ncl(y_mb_).requires_grad_()
    gm = {}
    got, full = aux_losses(crit, mb, _ncl(y), gm)
    got.backward()
    assert sorted(gm) == sorted(wm)
    assert ("sub_spectral_convergence_loss" in gm) == use_sub
    for k in wm:
        np.testing.assert_allclose(float(gm[k].detach()), float(wm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert full.shape == (2, 1, t)
    np.testing.assert_allclose(_nlc(full), np.asarray(wfull), atol=1e-6)
    wgrad, ggrad = np.asarray(wgrad), _nlc(mb.grad)

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a))))

    # both float32 gradients sit 2e-4 to 4e-4 rms from the port's float64
    # one (the log-magnitude loss at small magnitudes); a zero gradient misses
    for g in (ggrad, np.zeros_like(ggrad)):
        ok = (rms(g - wgrad) <= 2e-3 * rms(wgrad)
              and float(np.abs(g - wgrad).max()) <= 5e-3 * float(np.abs(wgrad).max()))
        assert ok == (g is ggrad), (rms(g - wgrad) / rms(wgrad))
    wrong = torch.from_numpy(y_mb_.reshape(2, 4, t // 4).copy())
    bad, _ = aux_losses(crit, wrong, _ncl(y), {})
    assert abs(float(bad) - float(want)) > 1e-3 * abs(float(want))


def test_sub_band_loss_needs_a_multi_band_generator():
    config = dict(CONFIG, generator_params=dict(SMALL, out_channels=1))
    with pytest.raises(ValueError, match="use_subband_stft_loss needs"):
        build_criterion(json.loads(json.dumps(config)))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _batches(n, seed=8):
    rs = np.random.RandomState(seed)
    t = CONFIG["batch_max_steps"]
    return [{"y": rs.randn(2, t, 1) * 0.3, "c": rs.randn(2, t // HOP, 10)}
            for _ in range(n)]


def _to_jax(model_type, params, sd):
    return convert_state_dict(model_type, params, sd)[0]


def _with_amsgrad(opt_state, **moments):
    """An optax chain's state with the AMSGrad state's moments replaced."""
    if hasattr(opt_state, "nu_max"):
        return opt_state._replace(**moments)
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        return tuple(_with_amsgrad(s, **moments) for s in opt_state)
    return opt_state


def test_train_step_matches_jax_build_train_step():
    """Four steps (2 G-only, 2 G+D) on the same batches: the port (its
    stages through ``use_pallas_stacks_train``, K6/K7's plain versions here)
    against JAX's jitted steps (its XLA path), each step from the port's
    state carried into JAX (G and D, and AMSGrad's mu, nu and nu_max of
    both): every loss to 1e-5 relative, and after the step every parameter
    to 1e-5 and ``nu_max`` to 1e-5 of its largest.

    Both run in float64 (JAX under ``enable_x64``), G with unit-norm
    filters. In float32 the STFT log-magnitude loss's gradient carries 2e-4
    to 4e-4 rms of rounding in either package (the float64 gradient as the
    reference; test_multi_band_aux_losses_match_jax), and Adam's first
    update, about lr sign(g), takes the elements whose gradient is below
    that noise (7 of 26k here) 2 lr apart. In float64 the gradients agree
    to 1e-7 of their largest (bins at the STFT's magnitude clamp and the
    L1's kink), and a step from the same state to 1e-8; carried over four
    steps the training's own growth takes that to 1e-4, hence the state
    carried into JAX at each step."""
    config = json.loads(json.dumps(CONFIG))
    gen = get_model_class(MELGAN)(**SMALL, generator=torch.Generator().manual_seed(0))
    dis = get_model_class(MSD)(**SMALL_D, generator=torch.Generator().manual_seed(1))
    gen, dis = gen.double(), dis.double()
    assert gen.fused_stages == (0, 1)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("weight_g"):
                p.fill_(1.0)
    opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
    opt_d = build_optimizer_from_config(config, "discriminator", dis.parameters())
    assert isinstance(opt_g, AMSGrad) and isinstance(opt_d, AMSGrad)
    step = TrainStep(config, gen, dis, build_criterion(config), opt_g, opt_d)
    models = ((MELGAN, PLAIN, gen, opt_g), (MSD, SMALL_D, dis, opt_d))

    def port_state():
        """(params, {mu, nu, nu_max}) of G and D as JAX trees (float64)."""
        out = []
        for model_type, params, module, opt in models:
            named = dict(module.named_parameters())
            sd = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
            moments = {m: _to_jax(model_type, params, {
                k: opt.state[p][key].numpy() for k, p in named.items()})
                for m, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"), ("nu_max", "nu_max"))
                if opt.state}
            out.append((_to_jax(model_type, params, sd), moments))
        return out

    with jax.enable_x64(True):
        jg, jd = jax_model_class(MELGAN)(**PLAIN), jax_model_class(MSD)(**SMALL_D)
        jcfg = json.loads(json.dumps(CONFIG))
        jcrit = jax_criterion(jcfg)
        txs = [jax_build_optimizer("Adam", AMS, "MultiStepLR",
                                   jcfg[f"{p}_scheduler_params"], -1)
               for p in ("generator", "discriminator")]
        steps = {(g, d): build_train_step(jcfg, jg, jd, jcrit, *txs, train_g=g,
                                          train_d=d, donate=False)
                 for g, d in ((True, False), (True, True))}
    state = None
    before = (k6.fused_melgan_stacks.launches, k7.melgan_stacks_backward.launches)
    for i, batch in enumerate(_batches(4)):
        phase = (True, i >= 2)
        (pg, mg), (pd, md) = port_state()
        with jax.enable_x64(True):
            if state is None:
                state = init_train_state(*(jax.tree_util.tree_map(jnp.asarray, t)
                                           for t in (pg, pd)), *txs)
            state = state.replace(
                params_g=pg, params_d=pd,
                opt_g=_with_amsgrad(state.opt_g, **mg) if mg else state.opt_g,
                opt_d=_with_amsgrad(state.opt_d, **md) if md else state.opt_d)
            state, want = steps[phase](state, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jax.random.key(i))
            state = jax.tree_util.tree_map(np.asarray, state)
        got = step(batch_to_device(batch, "cpu"), *phase)
        assert sorted(got) == sorted(want)
        assert "sub_spectral_convergence_loss" in got
        assert ("real_loss" in got) == phase[1]
        for k in want:
            assert want[k].dtype == np.float64 and got[k].dtype == torch.float64
            rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
            assert rel <= 1e-5, (i, k, float(got[k]), float(want[k]))
        (pg, mg), (pd, md) = port_state()
        for model_type, params, moments, tree, opt_state in (
                (MELGAN, pg, mg, state.params_g, state.opt_g),
                (MSD, pd, md, state.params_d, state.opt_d)):
            if model_type == MSD and not phase[1]:
                continue
            for name, got_tree, want_tree in (("params", params, tree),
                                              ("nu_max", moments["nu_max"],
                                               _nu_max(opt_state))):
                leaves = jax.tree_util.tree_leaves_with_path(want_tree)
                assert len(leaves) == len(jax.tree_util.tree_leaves(got_tree))
                for (path, a), b in zip(leaves, jax.tree_util.tree_leaves(got_tree)):
                    a = np.asarray(a)
                    err = float(np.abs(a - b).max())
                    bound = 1e-5 * (float(np.abs(a).max()) if name == "nu_max" else 1.0)
                    assert err <= bound, (i, model_type, name, jax.tree_util.keystr(path), err)
    assert (k6.fused_melgan_stacks.launches,
            k7.melgan_stacks_backward.launches) == before  # no kernel on the CPU
    assert (opt_g.step_count, opt_d.step_count) == (4, 2)


# ---------------------------------------------------------------------------
# bin/train and checkpoints
# ---------------------------------------------------------------------------


def _write_dump(root, n, seed):
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        frames = 60 + 7 * i
        audio = (0.3 * np.sin(2 * np.pi * 300 * np.arange(frames * HOP) / 8000)
                 + 0.05 * rs.randn(frames * HOP)).astype(np.float32)
        mel = logmelfilterbank(audio, 8000, fft_size=128, hop_size=HOP, num_mels=10,
                               fmin=0, fmax=4000)[:frames]
        np.save(os.path.join(root, f"u{i}-wave.npy"), audio)
        np.save(os.path.join(root, f"u{i}-feats.npy"), mel.astype(np.float32))


def test_train_main_runs_4_steps_resume_reproduces_them_and_both_packages_decode(
        tmp_path):
    """MB-MelGAN through ``bin/train.main --device cpu``: 4 steps with D
    from step 3, the eval dumps synthesised to the full band, AMSGrad's
    ``nu_max`` in the checkpoint; a resume from step 2 logs steps 3-4 as
    the uninterrupted run did, bit for bit; the step-4 checkpoint decodes
    in both packages alike (PQMF synthesis after the generator), through
    the PQMF its criterion trained with: ``config.yml`` carries it as
    explicit ``pqmf_params`` (cutoff 0.142, where a config of version 0.1.0
    without them decodes through the legacy cutoff 0.15), and the port's
    decode filters equal the criterion's."""
    from scipy.io import wavfile

    _write_dump(str(tmp_path / "train"), 5, 0)
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
    pred = tmp_path / "exp" / "predictions" / "4steps"
    assert {"0_gen.wav", "0_ref.wav", "1_gen.wav"} <= set(os.listdir(pred))
    for i in range(2):  # full band: as long as the reference
        gen, ref = (wavfile.read(pred / f"{i}_{k}.wav")[1] for k in ("gen", "ref"))
        assert gen.shape == ref.shape == (CONFIG["batch_max_steps"],)
    logged = {s: m for s, m in first["history"] if "train/generator_loss" in m}
    assert sorted(logged) == [1, 2, 3, 4]
    assert "train/discriminator_loss" not in logged[2]
    assert "train/real_loss" in logged[4]
    assert "train/sub_log_stft_magnitude_loss" in logged[1]
    assert any("eval/sub_spectral_convergence_loss" in m for _, m in first["history"])
    ckpt = torch.load(tmp_path / "exp" / "checkpoint-4steps.pkl", weights_only=True)
    for who in ("generator", "discriminator"):
        states = ckpt["optimizer"][who]["state"].values()
        assert states and all(sorted(s) == ["exp_avg", "exp_avg_sq", "nu_max"]
                              for s in states)
    resumed = train.main(args("exp2", "--resume",
                              str(tmp_path / "exp" / "checkpoint-2steps.pkl")))
    again = {s: m for s, m in resumed["history"] if "train/generator_loss" in m}
    assert sorted(again) == [3, 4]
    for s in (3, 4):
        assert again[s] == logged[s], s

    trained = build_criterion(json.loads(json.dumps(CONFIG))).pqmf
    written = load_config(str(tmp_path / "exp" / "config.yml"))
    assert "pqmf_params" not in CONFIG and written["version"] == "0.1.0"
    assert written["pqmf_params"] == {"taps": 62, "cutoff_ratio": 0.142, "beta": 9.0} == {
        "taps": trained.taps, "cutoff_ratio": trained.cutoff_ratio, "beta": trained.beta}
    ckpt = str(tmp_path / "exp" / "checkpoint-4steps.pkl")
    jax_model = jax_load_model(ckpt)  # reads config.yml beside the checkpoint
    port = load_model(ckpt, device="cpu")
    assert port.pqmf is not None and port.upsample_factor == HOP
    for a, b in zip(port.pqmf._filters["cpu"], trained._filters["cpu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    legacy = load_model(ckpt, dict(written, pqmf_params={}), device="cpu").pqmf
    assert not torch.equal(legacy._filters["cpu"][0], trained._filters["cpu"][0])
    np.testing.assert_array_equal(np.asarray(jax_model.pqmf._analysis_kernel)[:, 0, :].T,
                                  trained._filters["cpu"][0][:, 0, :].numpy())
    mel = np.random.RandomState(7).randn(33, 10).astype(np.float32)
    got = port.inference(mel)
    want = np.asarray(jax_model.inference(mel))
    assert got.shape == want.shape == (33 * HOP, 1)
    np.testing.assert_allclose(got, want, atol=2e-4)


# ---------------------------------------------------------------------------
# the causal modules
# ---------------------------------------------------------------------------


def _causal_check(jax_out, port_fn, x, cut):
    """The port's output within 2e-4 of JAX's (of order one), and causal:
    zeroing the input from ``cut`` on leaves the output before it as it was."""
    got = port_fn(x)
    want = np.asarray(jax_out)
    assert got.shape == want.shape
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got, want, atol=2e-4)
    x2 = x.copy()
    x2[:, cut:] = 0.0
    return got, port_fn(x2)


@pytest.mark.parametrize("pad", ["ReflectionPad1d", "ReplicationPad1d", "ConstantPad1d"])
def test_causal_residual_stack_matches_jax(pad):
    kw = dict(kernel_size=3, channels=8, dilation=3, pad=pad, use_causal_conv=True)
    x = np.random.RandomState(2).randn(2, 40, 8).astype(np.float32)
    js = JaxResidualStack(**kw)
    v = {"params": _unit_scales(_np(js.init(jax.random.key(0), jnp.asarray(x)))["params"])}
    port = ResidualStack(**kw)
    sd = jax_params_to_state_dict("ResidualStack", kw, v)
    assert {k.rsplit(".", 1)[0] for k in sd} == {"stack.1.conv", "stack.3", "skip_layer"}
    port.load_state_dict(sd, strict=True)

    def run(a):
        with torch.no_grad():
            return _nlc(port(_ncl(a)))

    got, cut = _causal_check(js.apply(v, jnp.asarray(x)), run, x, 25)
    np.testing.assert_array_equal(cut[:, :25], got[:, :25])


def test_causal_melgan_generator_matches_jax():
    """The causal generator (4 sub-bands; kernel flags set, which its gate
    ignores, as JAX's does) through the converter's causal keys."""
    kw = dict(PLAIN, use_causal_conv=True, use_pallas_stacks_train=True)
    c = np.random.RandomState(3).randn(2, 20, 10).astype(np.float32)
    jg = jax_model_class(MELGAN)(**kw)
    v = {"params": _unit_scales(_np(jg.init(jax.random.key(1), jnp.asarray(c)))["params"])}
    port = get_model_class(MELGAN)(**kw)
    assert port.fused_stages == ()
    port.load_state_dict(jax_params_to_state_dict(MELGAN, kw, v), strict=True)

    def run(a):
        with torch.no_grad():
            return _nlc(port(_ncl(a)))

    got, cut = _causal_check(jg.apply(v, jnp.asarray(c)), run, c, 12)
    assert got.shape == (2, 20 * 8, 4)
    np.testing.assert_array_equal(cut[:, :12 * 8], got[:, :12 * 8])


def test_causal_pwg_generator_with_melgan_upsample_net_matches_jax():
    up = dict(in_channels=10, out_channels=10, channels=32, kernel_size=7,
              upsample_scales=[4, 4], stacks=2)
    kw = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
              skip_channels=8, aux_channels=10, aux_context_window=0,
              upsample_net="MelGANGenerator", upsample_params=up, use_causal_conv=True)
    rs = np.random.RandomState(5)
    z = rs.randn(2, 12 * 16, 1).astype(np.float32)
    c = rs.randn(2, 12, 10).astype(np.float32)
    jg = jax_model_class(PWG)(**kw)
    v = {"params": _unit_scales(_np(jg.init(jax.random.key(2), jnp.asarray(z),
                                            jnp.asarray(c)))["params"])}
    port = get_model_class(PWG)(**kw)
    sd = jax_params_to_state_dict(PWG, kw, v)
    assert "upsample_net.melgan.0.conv.weight_v" in sd
    assert "upsample_net.melgan.2.deconv.weight_v" in sd
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = _nlc(port(_ncl(z), _ncl(c)))
    want = np.asarray(jg.apply(v, jnp.asarray(z), jnp.asarray(c)))
    assert got.shape == want.shape == (2, 12 * 16, 1)
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got, want, atol=2e-4)


# ---------------------------------------------------------------------------
# chip_smoke's MB-MelGAN v2 training config
# ---------------------------------------------------------------------------


def test_chip_smoke_mb_melgan_v2_training_config_equals_shipped_config():
    """The config of chip_smoke.py's MB-MelGAN v2 training phases is
    multi_band_melgan.v2.yaml verbatim; the phases add
    ``use_pallas_stacks_train`` and overrides of keys the YAML has."""
    import importlib.util

    yaml = pytest.importorskip("yaml")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    with open(os.path.join(root, "egs/ljspeech/voc1/conf/multi_band_melgan.v2.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert json.loads(json.dumps(smoke.V2_MB_CONFIG)) == cfg
    assert set(smoke.TRAIN_OVERRIDES) <= set(cfg)
    assert "use_pallas_stacks_train" not in cfg["generator_params"]
