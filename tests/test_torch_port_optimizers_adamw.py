"""The port's AdamW and ExponentialLR held against optax on the CPU, as
RAdam and AMSGrad are (``test_torch_port_train_host.py``): 20 updates on
fixed gradients, every parameter to 1e-6 relative after each, through
``optax.adamw`` directly and through the JAX package's
``build_optimizer`` (its chains: clipping, then AdamW's decoupled decay
with the config's own weight decay), and the U-Net HiFi-GAN debug
recipe's optimizer config (AdamW + ExponentialLR) as it ships.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from parallelwavegan_tpu.optimizers import build_lr_schedule as jax_lr_schedule  # noqa: E402
from parallelwavegan_tpu.optimizers import build_optimizer as jax_build_optimizer  # noqa: E402
from parallelwavegan_tpu.optimizers import (  # noqa: E402
    build_optimizer_from_config as jax_optimizer_from_config,
)
from parallelwavegan_tpu_torch.optimizers import (  # noqa: E402
    AdamW,
    build_lr_schedule,
    build_optimizer,
    build_optimizer_from_config,
)

yaml = pytest.importorskip("yaml")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _assert_steps_close(steps, rtol=1e-6, atol=0.0):
    for i, (jp, tp) in enumerate(steps, start=1):
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=f"step {i}")


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adamw_matches_optax_adamw_for_20_steps(wd):
    """``optax.adamw`` with weight decay 0 (the shipped configs') and with
    a decay large enough to move the parameters apart from Adam's."""
    params, grads = _params_and_grads(20)
    steps = _run_both(optax.adamw(1e-3, b1=0.8, b2=0.99, eps=1e-8, weight_decay=wd),
                      lambda tp: build_optimizer(tp, "AdamW", {
                          "lr": 1e-3, "betas": (0.8, 0.99), "weight_decay": wd}),
                      params, grads)
    _assert_steps_close(steps)
    if wd:  # the decay is decoupled: Adam's L2-in-gradient decay is another function
        l2 = _run_both(optax.adamw(1e-3, b1=0.8, b2=0.99, eps=1e-8, weight_decay=wd),
                       lambda tp: build_optimizer(tp, "Adam", {
                           "lr": 1e-3, "betas": (0.8, 0.99), "weight_decay": wd}),
                       params, grads)
        diff = max(float(np.abs(b - a).max()) for a, b in zip(*l2[-1]))
        assert diff > 1e-4


def test_adamw_default_decay_is_zero_not_torchs():
    """Without ``weight_decay`` the port's AdamW does not decay (torch's
    AdamW would at 0.01), as the JAX package's does not."""
    tp = [torch.zeros(3, requires_grad=True)]
    opt = build_optimizer(tp, "AdamW", {"lr": 1e-3})
    assert isinstance(opt, AdamW) and opt.param_groups[0]["weight_decay"] == 0.0


@pytest.mark.parametrize("gamma", [0.999, 0.7])
def test_exponential_lr_matches_jax_schedule(gamma):
    """lr * gamma ** n in float32, bit for bit as the jitted train step
    computes it on optax's int32 count (a float32 pow). Outside jit JAX
    takes the power by repeated squaring, which parts from it by up to
    8e-6 relative at n = 1000; the 20-step tests here run optax outside
    jit and stay within 1e-6."""
    jax_sched = jax.jit(jax_lr_schedule(2e-4, "ExponentialLR", {"gamma": gamma}))
    sched = build_lr_schedule(2e-4, "ExponentialLR", {"gamma": gamma})
    for n in (0, 1, 2, 7, 19, 1000):
        assert sched(n) == float(jax_sched(jnp.asarray(n, jnp.int32))), n


@pytest.mark.parametrize("grad_norm,wd,amsgrad", [
    (-1, 0.0, False),
    (1.0, 1e-2, False),
    (10.0, 1e-2, True),
])
def test_adamw_exponential_lr_match_build_optimizer_for_20_steps(grad_norm, wd, amsgrad):
    """The JAX package's chains: clipping first, AdamW's decay after the
    scaling; AdamW with ``amsgrad`` is optax's AMSGrad without decay."""
    params, grads = _params_and_grads(20, seed=5, scale=3.0)
    opt_params = {"lr": 1e-3, "betas": (0.8, 0.99), "weight_decay": wd,
                  "amsgrad": amsgrad}
    sched = ("ExponentialLR", {"gamma": 0.9})
    tx = jax_build_optimizer("AdamW", dict(opt_params), *sched, grad_norm)
    steps = _run_both(tx, lambda tp: build_optimizer(tp, "AdamW", dict(opt_params), *sched,
                                                     grad_norm), params, grads)
    _assert_steps_close(steps, atol=1e-9)


def test_uhifigan_debug_recipe_optimizers_match_jax_for_20_steps():
    """``egs/yesno/voc1/conf/uhifigan.v1.debug.yaml``'s generator and
    discriminator optimizers as they ship (AdamW, betas 0.8/0.99, decay 0,
    ExponentialLR gamma 0.999, no clipping) through both packages'
    ``build_optimizer_from_config``; the schedule's step counts carry
    through a state dict."""
    with open(os.path.join(ROOT, "egs/yesno/voc1/conf/uhifigan.v1.debug.yaml")) as f:
        config = yaml.safe_load(f)
    params, grads = _params_and_grads(20, seed=6)
    for who in ("generator", "discriminator"):
        assert config[f"{who}_optimizer_type"] == "AdamW"
        assert config[f"{who}_scheduler_type"] == "ExponentialLR"
        steps = _run_both(jax_optimizer_from_config(config, who),
                          lambda tp: build_optimizer_from_config(config, who, tp),
                          params, grads)
        _assert_steps_close(steps)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = build_optimizer_from_config(config, "generator", tp)
    for g in grads[:3]:
        for p, v in zip(tp, g):
            p.grad = torch.from_numpy(v)
        opt.step()
    again = build_optimizer_from_config(config, "generator", tp)
    again.load_state_dict(opt.state_dict())
    assert again.step_count == 3
    assert again.lr_schedule(3) == float(np.float32(2e-4) * np.float32(0.999) ** 3)
