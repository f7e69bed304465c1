"""StyleMelGAN training in the port held against the JAX package on the
CPU: the plain version of the K9 backward and ``tade_block_train``, the
MelGAN and StyleMelGAN discriminators through the converter, the
generator's gradients through ``use_pallas_tade_train``, the train step
against JAX ``build_train_step``, ``bin/train.main`` with resume and a
decode of its checkpoint, and chip_smoke's StyleMelGAN v1 config.

Inputs are made with numpy from seeds and fed to both packages. The JAX
side of the K9 cases is ``fused_tade_blocks_train(..., min_fused_t=1,
interpret=True)`` (as tests/test_tade_train_kernel.py:56-65 runs it) and
``jax.vjp`` of ``tade_block_xla``, on unit-gain convs under a random
cotangent of unit scale, so every gradient is of order one or more and
the 2e-4 term cannot pass a wrong one: each gradient is held to atol
2e-4, rtol 1e-3 (that test's) and to max|diff| <= 1e-4 max|JAX|, and
controls (each gradient zeroed, dx times 1.001) must be rejected. The
train step agrees to 1e-5 on the losses and every parameter after 4
steps, as the PWG and MelGAN A/Bs do.
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
from parallelwavegan_tpu.ops.pallas_kernels.tade_decode import (  # noqa: E402
    tade_block_xla,
)
from parallelwavegan_tpu.ops.pallas_kernels.tade_train import (  # noqa: E402
    fused_tade_blocks_train as jax_blocks_train,
)
from parallelwavegan_tpu.optimizers import build_optimizer as jax_build_optimizer  # noqa: E402
from parallelwavegan_tpu.train.criterion import build_criterion as jax_criterion  # noqa: E402
from parallelwavegan_tpu.train.state import init_train_state  # noqa: E402
from parallelwavegan_tpu.train.step import build_train_step  # noqa: E402
from parallelwavegan_tpu_torch.bin import decode, train  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_decode as k8  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9  # noqa: E402
from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config  # noqa: E402
from parallelwavegan_tpu_torch.train.criterion import build_criterion  # noqa: E402
from parallelwavegan_tpu_torch.train.step import TrainStep, batch_to_device  # noqa: E402

STYLE, STYLE_D, MELGAN_D = ("StyleMelGANGenerator", "StyleMelGANDiscriminator",
                            "MelGANDiscriminator")
C = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# width 64 (the kernels'), noise x10, blocks x2, x2, x1: inputs 10, 20, 40
# per noise sample; min_t 20 gates blocks 1 and 2 (aux 64, even T)
SMALL = dict(in_channels=16, aux_channels=20, channels=64, out_channels=1,
             kernel_size=9, dilation=2, noise_upsample_scales=[5, 2],
             upsample_scales=[2, 2, 1])
TRAIN_FLAGS = dict(use_pallas_tade_train=True, pallas_tade_train_min_t=20)
# two windows of 16 samples per band: 16 samples whole and 32 in 2 bands
SMALL_D = dict(repeats=2, window_sizes=[16, 32],
               pqmf_params=[[1, None, None, None], [2, 62, 0.267, 9.0]],
               discriminator_params=dict(channels=8, max_downsample_channels=32,
                                         downsample_scales=[2, 2]))
CONFIG = {
    "sampling_rate": 8000, "hop_size": 4, "format": "npy",
    "generator_type": STYLE, "generator_params": dict(SMALL, **TRAIN_FLAGS),
    "discriminator_type": STYLE_D, "discriminator_params": SMALL_D,
    "stft_loss_params": {"fft_sizes": [16, 32, 8], "hop_sizes": [4, 8, 2],
                         "win_lengths": [12, 24, 6], "window": "hann_window"},
    "lambda_aux": 1.0, "lambda_adv": 1.0,
    "generator_adv_loss_params": {"average_by_discriminators": False},
    "discriminator_adv_loss_params": {"average_by_discriminators": False},
    "batch_size": 2, "batch_max_steps": 40, "num_workers": 1,
    "generator_optimizer_type": "Adam",
    # style_melgan.v1.yaml's learning rates, and eps 1e-6 as the PWG and
    # MelGAN A/Bs: both packages' gradients agree to about 1e-5 of each
    # leaf's max (float32), and Adam turns a difference e in an element near
    # 0 into a step difference of up to lr e / eps (lr with eps 1e-8)
    "generator_optimizer_params": {"lr": 1e-4, "betas": [0.5, 0.9], "eps": 1e-6,
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
    "discriminator_train_start_steps": 1, "train_max_steps": 4,
    "save_interval_steps": 2, "eval_interval_steps": 4, "log_interval_steps": 1,
}


def _misses(got, want) -> bool:
    """True where ``got`` misses ``want``: |diff| > 2e-4 + 1e-3 |want|
    anywhere, or max|diff| > 1e-4 max|want|."""
    diff = np.abs(got - want)
    return (got.shape != want.shape or not np.isfinite(got).all()
            or not (diff <= 2e-4 + 1e-3 * np.abs(want)).all()
            or float(diff.max()) > 1e-4 * float(np.abs(want).max()))


def _assert_grads_match(pairs, dx=None):
    """Every (name, got, want) within tolerance, and the controls rejected:
    each ``got`` zeroed in turn and, for the pair named ``dx``, dx times
    1.001."""
    bad = [name for name, g, w in pairs if _misses(g, w)]
    assert not bad, [(n, float(np.abs(g - w).max())) for n, g, w in pairs if n in bad]
    for name, g, w in pairs:
        assert _misses(np.zeros_like(g), w), f"zeroed {name} passed"
    if dx is not None:
        g, w = next((g, w) for n, g, w in pairs if n == dx)
        assert _misses(g * 1.001, w), "dx x 1.001 passed"


# ---------------------------------------------------------------------------
# K9's plain version and tade_block_train against the JAX kernels
# ---------------------------------------------------------------------------


def _rand_block(rs, scale, dilation=2):
    """Unit-gain convs (weights N(0, 1/(9 Cin))), biases N(0, 0.1^2)."""
    out = {"scale": scale, "dilation": dilation}
    for key in k8.WEIGHT_KEYS:
        cout = C if key.startswith("aux") else 2 * C
        out[f"{key}_w"] = (rs.randn(9, C, cout) / np.sqrt(9 * C)).astype(np.float32)
        out[f"{key}_b"] = (rs.randn(cout) * 0.1).astype(np.float32)
    return out


def _jax_chain_grads(x, c, blocks, gated, cots, fused):
    """(dx, dc, [per-block dicts]) of sum(out * u) + sum(c_out * v): JAX's
    fused train chain in interpret mode, or jax.vjp of tade_block_xla."""
    ws = [{k: jnp.asarray(b[k]) for k in k9.WEIGHTS} for b in blocks]
    statics = [(b["scale"], b["dilation"]) for b in blocks]

    def chain(x, c, ws):
        full = [dict(w, scale=s, dilation=d) for w, (s, d) in zip(ws, statics)]
        if fused:
            return jax_blocks_train(x, c, full, gated_function=gated, min_fused_t=1,
                                    t_tile=8, interpret=True)
        for blk in full:
            x, c = tade_block_xla(x, c, blk, gated_function=gated)
        return x, c

    _, vjp = jax.vjp(chain, jnp.asarray(x), jnp.asarray(c), ws)
    gx, gc, gws = vjp(tuple(jnp.asarray(u) for u in cots))
    return np.asarray(gx), np.asarray(gc), [{k: np.asarray(g[k]) for k in g} for g in gws]


def _port_chain_grads(x, c, blocks, gated, cots):
    """The same through the port's ``fused_tade_blocks_train`` (its blocks
    each a ``tade_block_train`` on the CPU)."""
    xv, cv = torch.tensor(x, requires_grad=True), torch.tensor(c, requires_grad=True)
    tb = [{k: (torch.tensor(v, requires_grad=True) if isinstance(v, np.ndarray) else v)
           for k, v in b.items()} for b in blocks]
    before = (k9.tade_block_backward.launches_k9a, k9.tade_block_backward.launches_k9b)
    y, cy = k9.fused_tade_blocks_train(xv, cv, tb, gated_function=gated, min_fused_t=1)
    ((y * torch.from_numpy(cots[0])).sum() + (cy * torch.from_numpy(cots[1])).sum()).backward()
    assert (k9.tade_block_backward.launches_k9a,
            k9.tade_block_backward.launches_k9b) == before  # no kernel on the CPU
    return xv.grad.numpy(), cv.grad.numpy(), [{k: b[k].grad.numpy() for k in k9.WEIGHTS}
                                              for b in tb]


@pytest.mark.parametrize("scales,gated", [
    ((2,), "softmax"), ((1,), "softmax"), ((2,), "sigmoid"), ((1,), "sigmoid"),
    ((2, 1), "softmax")])
def test_k9_plain_version_matches_jax_kernels(scales, gated):
    """One block at scale 2 or 1 (d = 2), both gates, and the two-block
    chain of tests/test_tade_train_kernel.py; T = 40, ragged against the
    JAX kernels' 8-row tiles."""
    rs = np.random.RandomState(0)
    blocks = [_rand_block(rs, s) for s in scales]
    b, t = 2, 40
    x = rs.randn(b, t, C).astype(np.float32)
    c = rs.randn(b, t, C).astype(np.float32)
    t_out = t * int(np.prod(scales))
    cots = [rs.randn(b, t_out, C).astype(np.float32) for _ in range(2)]
    got = _port_chain_grads(x, c, blocks, gated, cots)
    for fused in (True, False):
        want = _jax_chain_grads(x, c, blocks, gated, cots, fused)
        pairs = [("dx", got[0], want[0]), ("dc", got[1], want[1])]
        pairs += [(f"blocks[{i}].{k}", g[k], w[k]) for i, (g, w) in
                  enumerate(zip(got[2], want[2])) for k in k9.WEIGHTS]
        _assert_grads_match(pairs, dx="dx")


def test_backward_pieces_compose_to_the_block_backward():
    """``tade_block_backward`` on CPU tensors is the plain version (no
    launch), and K9b's then K9a's plain versions with the glue between them
    (stretch adjoint, instance-norm backward) give it too."""
    rs = np.random.RandomState(1)
    blk = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in _rand_block(rs, 2).items()}
    x, c = (torch.from_numpy(rs.randn(2, 30, C).astype(np.float32)) for _ in range(2))
    dxo, dco = (torch.from_numpy(rs.randn(2, 60, C).astype(np.float32)) for _ in range(2))
    x2, a = k8.tade1_reference(x, c, blk)
    want = k9.tade_block_backward_reference(x, c, blk, "softmax", dxo, dco)
    got = k9.tade_block_backward(x, c, x2, a, blk, "softmax", dxo, dco)
    dxr, dx2, da, g2 = k9.tade2_backward_reference(x, x2, a, blk, "softmax", dxo, dco)
    dx1, dc1, g1 = k9.tade1_backward_reference(x, c, blk, "softmax", dx2, da)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(dx1 + dxr, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dc1, want[1], rtol=1e-5, atol=1e-5)
    for k in k9.WEIGHTS:
        torch.testing.assert_close({**g1, **g2}[k], want[2][k], rtol=1e-5, atol=1e-5)
    # the glue on its own: the adjoints of up() and of the instance norm
    z = torch.randn(2, 30, C, requires_grad=True)
    up = z.repeat_interleave(2, dim=1)
    gz, = torch.autograd.grad(up, z, dxo)
    torch.testing.assert_close(k9.stretch_adjoint(dxo, 2), gz, rtol=1e-6, atol=1e-6)
    from parallelwavegan_tpu_torch.layers.tade import instance_norm_1d

    xn = instance_norm_1d(z, dim=1)
    gx, = torch.autograd.grad(xn, z, dco[:, :30])
    mean, rstd = k8._stats(z.detach())
    torch.testing.assert_close(k9.instance_norm_backward(dco[:, :30], z.detach(), mean, rstd),
                               gx, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the discriminators
# ---------------------------------------------------------------------------


def _jax_d(model_type, params, x, seed, starts=None):
    m = jax_model_class(model_type)(**params)
    args = (jnp.asarray(x),) if starts is None else (jnp.asarray(x), jnp.asarray(starts))
    v = m.init({"params": jax.random.key(seed), "rwd": jax.random.key(0)}, *args)
    return m, jax.tree_util.tree_map(np.asarray, v)


def _flat(outs):
    return [o for group in outs for o in group] if isinstance(outs[0], list) else outs


@pytest.mark.parametrize("model_type,params,starts", [
    (MELGAN_D, dict(in_channels=2, channels=8, max_downsample_channels=32,
                    downsample_scales=[4, 2], kernel_sizes=[5, 3]), None),
    (STYLE_D, SMALL_D, [3, 5, 0, 8]),
    (STYLE_D, dict(SMALL_D, discriminator_params=dict(
        SMALL_D["discriminator_params"], bias=False), use_weight_norm=False), [1, 0, 6, 2])])
def test_discriminator_matches_jax(model_type, params, starts):
    """Every feature map within 2e-4 of the JAX module's with the same
    weights (JAX init -> the converter) and the same window starts; the
    converter's round trip is exact."""
    rs = np.random.RandomState(2)
    ch = params.get("in_channels", 1)
    x = (rs.randn(2, 48, ch) * 0.5).astype(np.float32)
    jm, v = _jax_d(model_type, params, x, 3, starts)
    want = jm.apply(v, jnp.asarray(x), *(() if starts is None else (jnp.asarray(starts),)),
                    rngs={"rwd": jax.random.key(1)})
    port = get_model_class(model_type)(**params)
    sd = jax_params_to_state_dict(model_type, params, v)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2), *(() if starts is None else (starts,)))
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) == (len(params.get("downsample_scales", [])) + 3
                                     if starts is None else 2 * 2 * 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w), atol=2e-4)
    back, _ = convert_state_dict(model_type, params, {k: t.numpy() for k, t in sd.items()})
    wl = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    bl = dict(jax.tree_util.tree_leaves_with_path(back))
    assert wl.keys() == bl.keys()
    for path, a in wl.items():
        np.testing.assert_array_equal(bl[path], a, err_msg=str(path))


def test_random_windows_come_from_the_cpu_generator():
    d = get_model_class(STYLE_D)(**SMALL_D, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 1, 64)
    starts = d.draw_starts(64, torch.Generator().manual_seed(5))
    assert len(starts) == 4 and all(0 <= s < 64 - ws for s, ws in zip(starts, [16, 32] * 2))
    with torch.no_grad():
        a = d(x, generator=torch.Generator().manual_seed(5))
        b = d(x, starts)
    for fa, fb in zip(_flat(a), _flat(b)):
        torch.testing.assert_close(fa, fb, rtol=0, atol=0)
    with pytest.raises(ValueError, match="3 starts"):
        d(x, [0, 0, 0])


# ---------------------------------------------------------------------------
# the generator under grad
# ---------------------------------------------------------------------------


def _unit_scales(params):
    """Every weight-norm scale g set to 1: unit-norm filters keep the
    generator's activations and gradients of order one (its N(0, 0.02)
    init leaves them under the 2e-4 term)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.ones_like(a) if jax.tree_util.keystr(p).endswith("['g']") else a,
        params)


def _grads_to_jax(model_type, params, module) -> dict:
    sd = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
          for k, p in module.named_parameters()}
    return convert_state_dict(model_type, params, sd)[0]


def _spy_blocks(monkeypatch) -> list:
    """The input lengths of the blocks that ``tade_block_train`` runs."""
    seen, real = [], k9.tade_block_train.apply

    def spy(x, *args):
        seen.append(x.shape[1])
        return real(x, *args)

    monkeypatch.setattr(k9.tade_block_train, "apply", spy)
    return seen


def test_generator_grads_through_the_train_path_match_jax(monkeypatch):
    """Blocks 1 and 2 through ``fused_tade_blocks_train`` under grad: every
    parameter's gradient, through weight norm, against the JAX generator's
    (its XLA path, which tests/test_tade_train_kernel.py holds to its
    kernels); each zeroed leaf rejected. Without gradients the same route
    gives the same output."""
    rs = np.random.RandomState(3)
    c = rs.randn(2, 40, 20).astype(np.float32)
    z = rs.randn(2, 4, 16).astype(np.float32)
    cot = rs.randn(2, 160, 1).astype(np.float32)
    jg = jax_model_class(STYLE)(**SMALL)
    v = jax.tree_util.tree_map(np.asarray, jg.init(jax.random.key(0), jnp.asarray(c),
                                                   jnp.asarray(z)))
    v = {"params": _unit_scales(v["params"])}

    def loss(params):
        return jnp.sum(jg.apply({"params": params}, jnp.asarray(c), jnp.asarray(z)) * cot)

    v_ref, g_ref = jax.jit(jax.value_and_grad(loss))(v["params"])
    port = get_model_class(STYLE)(**SMALL, **TRAIN_FLAGS)
    port.load_state_dict(jax_params_to_state_dict(STYLE, SMALL, v), strict=True)
    seen = _spy_blocks(monkeypatch)
    out = (port(torch.from_numpy(c).transpose(1, 2), torch.from_numpy(z).transpose(1, 2))
           * torch.from_numpy(cot).transpose(1, 2)).sum()
    assert seen == [80, 160]
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(v_ref), rtol=1e-5)
    for mode in (torch.no_grad, torch.inference_mode):  # the D phase's re-run, decode
        with mode():
            again = port(torch.from_numpy(c).transpose(1, 2),
                         torch.from_numpy(z).transpose(1, 2))
        torch.testing.assert_close((again * torch.from_numpy(cot).transpose(1, 2)).sum(),
                                   out.detach(), rtol=0, atol=0)
    assert seen == [80, 160] * 3
    got = _grads_to_jax(STYLE, SMALL, port)
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
    out = []
    for _ in range(n):
        b = {"y": (rs.randn(2, 40, 1) * 0.3).astype(np.float32),
             "c": rs.randn(2, 10, 20).astype(np.float32),
             "z": rs.randn(2, 1, 16).astype(np.float32)}
        for key in ("adv", "real", "fake"):  # starts in [0, 40 - size)
            b[f"rwd_starts_{key}"] = np.array(
                [rs.randint(0, 40 - ws) for ws in SMALL_D["window_sizes"] * 2], np.int32)
        out.append(b)
    return out


def _to_jax(model_type, params, module):
    sd = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
    return convert_state_dict(model_type, params, sd)[0]


def test_train_step_matches_jax_build_train_step(monkeypatch):
    """Four steps (2 G-only, 2 G+D) from carried weights on the same
    batches, z and window starts: the port (its blocks 1-2 through
    ``use_pallas_tade_train``) against JAX's jitted steps (its XLA path)."""
    config = json.loads(json.dumps(CONFIG))
    gen = get_model_class(STYLE)(**config["generator_params"],
                                 generator=torch.Generator().manual_seed(0))
    dis = get_model_class(STYLE_D)(**SMALL_D, generator=torch.Generator().manual_seed(1))
    jg, jd = jax_model_class(STYLE)(**SMALL), jax_model_class(STYLE_D)(**SMALL_D)
    jcfg = json.loads(json.dumps(CONFIG))
    jcrit = jax_criterion(jcfg)
    tx_g = jax_build_optimizer("Adam", jcfg["generator_optimizer_params"], "MultiStepLR",
                               jcfg["generator_scheduler_params"], -1)
    tx_d = jax_build_optimizer("Adam", jcfg["discriminator_optimizer_params"],
                               "MultiStepLR", jcfg["discriminator_scheduler_params"], -1)
    state = init_train_state(_to_jax(STYLE, SMALL, gen), _to_jax(STYLE_D, SMALL_D, dis),
                             tx_g, tx_d)
    steps = {(g, d): build_train_step(jcfg, jg, jd, jcrit, tx_g, tx_d, train_g=g,
                                      train_d=d, donate=False)
             for g, d in ((True, False), (True, True))}
    opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
    opt_d = build_optimizer_from_config(config, "discriminator", dis.parameters())
    step = TrainStep(config, gen, dis, build_criterion(config), opt_g, opt_d)
    seen = _spy_blocks(monkeypatch)
    for i, batch in enumerate(_batches(4)):
        phase = (True, i >= 2)
        state, want = steps[phase](state, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jax.random.key(i))
        got = step(batch_to_device(batch, "cpu"), *phase, step=i)
        assert sorted(got) == sorted(want)
        for k in want:
            rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
            assert rel <= 1e-5, (i, k, float(got[k]), float(want[k]))
    # the G phases' forwards under grad, and the D phases' re-runs of G
    # (steps 2-3) without: the train flag has one route, as in JAX
    assert seen == [20, 40] * 6
    for model_type, params, module, tree in (
            (STYLE, SMALL, gen, state.params_g), (STYLE_D, SMALL_D, dis, state.params_d)):
        got = _to_jax(model_type, params, module)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves(got)):
            err = float(np.abs(np.asarray(a) - b).max())
            assert err <= 1e-5, (model_type, jax.tree_util.keystr(path), err)


def _write_dump(root, n, seed):
    """npy dumps: random mels of 20 bins and their waves (hop 4)."""
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        frames = 30 + 7 * i
        np.save(os.path.join(root, f"u{i}-wave.npy"),
                (0.3 * rs.randn(frames * 4)).astype(np.float32))
        np.save(os.path.join(root, f"u{i}-feats.npy"), rs.randn(frames, 20).astype(np.float32))


def test_train_main_runs_4_steps_resume_reproduces_them_and_the_checkpoint_decodes(
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
    assert "train/discriminator_loss" not in logged[1]
    assert "train/real_loss" in logged[4] and "train/adversarial_loss" in logged[4]
    assert any("eval/generator_loss" in m for _, m in first["history"])
    resumed = train.main(args("exp2", "--resume",
                              str(tmp_path / "exp" / "checkpoint-2steps.pkl")))
    again = {s: m for s, m in resumed["history"] if "train/generator_loss" in m}
    assert sorted(again) == [3, 4]
    for s in (3, 4):
        assert again[s] == logged[s], s

    from scipy.io import wavfile

    ckpt = str(tmp_path / "exp" / "checkpoint-4steps.pkl")
    decode.main(["--dumpdir", str(tmp_path / "dev"), "--outdir", str(tmp_path / "wav"),
                 "--checkpoint", ckpt, "--device", "cpu", "--verbose", "0"])
    for i in range(2):
        _, wav = wavfile.read(tmp_path / "wav" / f"u{i}-feats_gen.wav")
        assert wav.shape == ((30 + 7 * i) * 4,) and np.abs(wav).max() > 0


def test_chip_smoke_style_melgan_v1_training_config_equals_shipped_config():
    """The config of chip_smoke.py's phases 20-22 is style_melgan.v1.yaml
    verbatim; the phases add ``use_pallas_tade_train`` and overrides of
    keys the YAML has."""
    import importlib.util

    yaml = pytest.importorskip("yaml")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    with open(os.path.join(ROOT, "egs/ljspeech/voc1/conf/style_melgan.v1.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert json.loads(json.dumps(smoke.V1_STYLE_CONFIG)) == cfg
    assert set(smoke.TRAIN_OVERRIDES) <= set(cfg)
    assert "use_pallas_tade_train" not in cfg["generator_params"]
    gen = get_model_class(STYLE)(**dict(cfg["generator_params"], use_pallas_tade_train=True))
    assert gen.fused_train and gen.min_fused_t == 1024
    # the training input of 88 frames: blocks 4-8 (T = 1408 .. 22528) pass the gate
    t, gated = 88, []
    for i, blk in enumerate(gen.block_weights()):
        if k8.gated(t, blk, min_fused_t=gen.min_fused_t, train=True):
            gated.append((i, t))
        t *= blk["scale"]
    assert gated == [(4, 1408), (5, 2816), (6, 5632), (7, 11264), (8, 22528)]
