"""Parallel WaveGAN training modules of the port held against the JAX package
on the CPU: the plain version of the K4 backward, the generator's
gradients through ``use_pallas_stack_train``, the discriminator, a
training checkpoint decoded by both packages, and the K3/K4 path on bf16
inputs (mixed precision: widened to float32, as JAX's).

Inputs are made with numpy from seeds and fed to both packages. The JAX
side of the K4 cases is ``fused_wavenet_cycle_train(..., interpret=True)``
(jitted), on the four cases of tests/test_wavenet_stack_train.py:38-46 and
its chunked case (:113); tolerance loss rtol 1e-5, gradients atol 2e-4,
rtol 1e-3 (:64-72). Module tolerances are 2e-4 (ROADMAP.md's parity TOL).
"""

import functools

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
from parallelwavegan_tpu.ops.pallas_kernels.wavenet_stack import (  # noqa: E402
    wavenet_stack_xla,
)
from parallelwavegan_tpu.ops.pallas_kernels.wavenet_stack_train import (  # noqa: E402
    fused_wavenet_cycle_train as jax_cycle_train,
)
from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.bin import decode  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.wavenet import WEIGHT_KEYS  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.wavenet_train import (  # noqa: E402
    fused_wavenet_cycle_train,
    wavenet_stack_backward,
    wavenet_stack_backward_reference,
)
from parallelwavegan_tpu_torch.optimizers import build_optimizer  # noqa: E402
from parallelwavegan_tpu_torch.utils.checkpoint import (  # noqa: E402
    save_training_checkpoint,
)
from parallelwavegan_tpu_torch.utils.config import write_config  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import load_model  # noqa: E402

PWG, PWG_D = "ParallelWaveGANGenerator", "ParallelWaveGANDiscriminator"
SMALL = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
             skip_channels=8, aux_channels=10, aux_context_window=2,
             upsample_params={"upsample_scales": [4, 4]})
SMALL_D = dict(layers=4, conv_channels=8)


def _make(n_layers, b, t, seed=0):
    """The inputs of tests/test_wavenet_stack_train.py:22-35 (Cr 8, Cg 16,
    Ca 8, Cs 8)."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, t, 8) * 0.3).astype(np.float32)
    c = (rs.randn(b, t, 8) * 0.3).astype(np.float32)
    shapes = {"wconv": ((n_layers, 3, 8, 16), 0.2), "bconv": ((n_layers, 16), 0.1),
              "waux": ((n_layers, 8, 16), 0.2), "wskip": ((n_layers, 8, 8), 0.2),
              "bskip": ((n_layers, 8), 0.1), "wres": ((n_layers, 8, 8), 0.2),
              "bres": ((n_layers, 8), 0.1)}
    w = {k: (rs.randn(*s) * scale).astype(np.float32) for k, (s, scale) in shapes.items()}
    return x, c, w


def _port_cycle_grads(x, c, w, dils, per_call, skip_weight):
    xv, cv = torch.tensor(x, requires_grad=True), torch.tensor(c, requires_grad=True)
    wv = {k: torch.tensor(w[k], requires_grad=True) for k in WEIGHT_KEYS}
    xo, sk = fused_wavenet_cycle_train(xv, cv, wv, dils, max_layers_per_call=per_call)
    loss = (xo ** 2).mean() + skip_weight * (sk ** 2).mean()
    loss.backward()
    return float(loss.detach()), [xv.grad, cv.grad] + [wv[k].grad for k in WEIGHT_KEYS]


@pytest.mark.parametrize("n_layers,b,t,t_tile", [
    (4, 2, 256, 256), (4, 2, 512, 128), (4, 1, 300, 128), (10, 1, 512, 256)])
def test_k4_plain_version_matches_jax_kernel(n_layers, b, t, t_tile):
    dils = tuple(2 ** (i % 10) for i in range(n_layers))
    x, c, w = _make(n_layers, b, t)

    @jax.jit
    def jax_grads(x, c, w):
        def loss(x, c, w):
            xo, sk = jax_cycle_train(x, c, w, dils, t_tile=t_tile, interpret=True)
            return jnp.mean(xo ** 2) + 0.5 * jnp.mean(sk ** 2)

        return jax.value_and_grad(loss, argnums=(0, 1, 2))(x, c, w)

    v_ref, (gx, gc, gw) = jax_grads(x, c, w)
    want = [gx, gc] + [gw[k] for k in WEIGHT_KEYS]
    v, got = _port_cycle_grads(x, c, w, dils, 10, 0.5)
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-5)
    for name, g, r in zip(("dx", "dc") + WEIGHT_KEYS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4, rtol=1e-3,
                                   err_msg=name)


def test_k4_chunked_plain_version_matches_jax_kernel():
    dils = tuple(2 ** (i % 3) for i in range(6))
    x, c, w = _make(6, 2, 256)

    @jax.jit
    def jax_grads(w):
        def loss(w):
            xo, sk = jax_cycle_train(x, c, w, dils, t_tile=128,
                                     max_layers_per_call=2, interpret=True)
            return jnp.mean(xo ** 2) + jnp.mean(sk ** 2)

        return jax.grad(loss)(w)

    want = jax_grads(w)
    _, got = _port_cycle_grads(x, c, w, dils, 2, 1.0)
    for name, g in zip(WEIGHT_KEYS, got[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), atol=2e-4,
                                   rtol=1e-3, err_msg=name)


def test_wavenet_cycle_train_under_bf16_computes_as_jax():
    """Parallel WaveGAN's K3/K4 path on bf16 inputs (``mixed_precision``
    with ``use_pallas_stack_train``): the port widens the chunk to float32,
    as JAX's ``fused_wavenet_cycle_train`` does (wavenet_stack_train.py:
    223-238), returns outputs in x's type and gradients in their inputs'
    types (:361-362). Against JAX in interpret mode, two layers a call (the
    chunks' outputs and skip sums rounded to bf16 in both): the outputs and
    gradients agree to rms|diff| <= 1e-3 rms|JAX| and max|diff| <= 1e-2
    max|JAX| (the same roundings; float32 sums in other orders)."""
    rs = np.random.RandomState(0)
    dils = (1, 2, 4, 1)
    x, c = ((rs.randn(2, 256, 8) * 0.3).astype(np.float32) for _ in range(2))
    shapes = {"wconv": (4, 3, 8, 16), "bconv": (4, 16), "waux": (4, 8, 16),
              "wskip": (4, 8, 8), "bskip": (4, 8), "wres": (4, 8, 8), "bres": (4, 8)}
    w = {k: (rs.randn(*s) * 0.2).astype(np.float32) for k, s in shapes.items()}
    cot = [rs.randn(2, 256, 8).astype(np.float32) for _ in range(2)]
    bf = jnp.bfloat16
    jw = {k: jnp.asarray(v).astype(bf) for k, v in w.items()}
    outs, vjp = jax.vjp(lambda x, c, w: jax_cycle_train(
        x, c, w, dils, t_tile=128, max_layers_per_call=2, interpret=True),
        jnp.asarray(x).astype(bf), jnp.asarray(c).astype(bf), jw)
    gx, gc, gw = vjp(tuple(jnp.asarray(u).astype(bf) for u in cot))
    want = list(outs) + [gx, gc] + [gw[k] for k in WEIGHT_KEYS]

    leaves = [torch.from_numpy(v).to(torch.bfloat16).requires_grad_() for v in (x, c)]
    tw = {k: torch.from_numpy(w[k]).to(torch.bfloat16).requires_grad_() for k in WEIGHT_KEYS}
    xo, sk = fused_wavenet_cycle_train(*leaves, tw, dils, max_layers_per_call=2)
    grads = torch.autograd.grad((xo, sk), leaves + [tw[k] for k in WEIGHT_KEYS],
                                [torch.from_numpy(u).to(torch.bfloat16) for u in cot])
    got = [xo, sk] + list(grads)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for name, g, r in zip(("x_out", "skips", "dx", "dc") + WEIGHT_KEYS, got, want):
        g, r = g.detach().float().numpy(), np.asarray(r.astype(jnp.float32))
        d = g - r
        assert np.sqrt((d ** 2).mean()) <= 1e-3 * np.sqrt((r ** 2).mean()), name
        assert np.abs(d).max() <= 1e-2 * np.abs(r).max(), name


def test_backward_on_the_cpu_is_the_plain_version():
    """``wavenet_stack_backward`` on CPU tensors returns its plain version,
    which is autograd of the JAX XLA twin's port, and counts no launch."""
    dils = (1, 2, 4)
    x, c, w = _make(3, 2, 100, seed=3)
    rs = np.random.RandomState(4)
    dxo, dsk = (rs.randn(2, 100, 8).astype(np.float32) for _ in range(2))
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    args = (torch.from_numpy(x), torch.from_numpy(c), tw, dils,
            torch.from_numpy(dxo), torch.from_numpy(dsk))
    before = wavenet_stack_backward.launches
    got = wavenet_stack_backward(*args)
    want = wavenet_stack_backward_reference(*args)
    assert wavenet_stack_backward.launches == before
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, vjp = jax.vjp(lambda x, c, w: wavenet_stack_xla(x, c, w, dils), x, c, w)
    jx, jc, jw = vjp((jnp.asarray(dxo), jnp.asarray(dsk)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jx), atol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jc), atol=2e-5)
    for k in WEIGHT_KEYS:
        np.testing.assert_allclose(got[2][k].numpy(), np.asarray(jw[k]),
                                   atol=2e-4, rtol=1e-4, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_generator_params():
    rs = np.random.RandomState(0)
    z = rs.randn(2, 12 * 16, 1).astype(np.float32)
    c = rs.randn(2, 12 + 4, 10).astype(np.float32)
    v = jax_model_class(PWG)(**SMALL).init(jax.random.key(0), jnp.asarray(z),
                                           jnp.asarray(c))
    return jax.tree_util.tree_map(np.asarray, v), z, c


def _ncl(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


def _grads_to_jax(model_type, params, module) -> dict:
    """The port's parameter gradients as a JAX tree (the converter's maps
    are linear, so they carry gradients as they carry weights)."""
    sd = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
          for k, p in module.named_parameters()}
    return convert_state_dict(model_type, params, sd)[0]


def test_generator_grads_through_the_train_path_match_jax():
    """``use_pallas_stack_train`` trains the 4 gated layers through the
    differentiable cycle (chunks of 1 layer), and its gradients reach
    ``weight_g``/``weight_v`` of every conv as the JAX generator's do."""
    v, z, c = _jax_generator_params()

    def loss(params):
        y = jax_model_class(PWG)(**SMALL).apply({"params": params}, z, c)
        return jnp.mean(y ** 2)

    v_ref, g_ref = jax.jit(jax.value_and_grad(loss))(v["params"])
    port = get_model_class(PWG)(**SMALL, use_pallas_stack_train=True,
                                pallas_stack_train_layers_per_call=1)
    port.load_state_dict(jax_params_to_state_dict(PWG, SMALL, v), strict=True)
    out = (port(_ncl(z), _ncl(c)) ** 2).mean()
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(v_ref), rtol=1e-5)
    assert port.conv_layers[2].conv.weight_v.grad.abs().sum() > 0
    got = _grads_to_jax(PWG, SMALL, port)
    want = dict(jax.tree_util.tree_leaves_with_path(g_ref))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(g, np.asarray(want[path]), atol=2e-4, rtol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kw", [{}, dict(dilation_factor=2, bias=False,
                                         use_weight_norm=False)])
def test_discriminator_forward_and_grads_match_jax(kw):
    params = dict(SMALL_D, **kw)
    rs = np.random.RandomState(5)
    x = rs.randn(2, 300, 1).astype(np.float32)
    jd = jax_model_class(PWG_D)(**params)
    v = jax.tree_util.tree_map(np.asarray, jd.init(jax.random.key(1), jnp.asarray(x)))
    port = get_model_class(PWG_D)(**params)
    port.load_state_dict(jax_params_to_state_dict(PWG_D, params, v), strict=True)
    keys = set(port.state_dict())
    if not kw:
        assert {"conv_layers.0.weight_g", "conv_layers.0.weight_v",
                "conv_layers.0.bias", "conv_layers.6.weight_v"} <= keys
    back, _ = convert_state_dict(PWG_D, params,
                                 {k: t.numpy() for k, t in port.state_dict().items()})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(v["params"]),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))

    def loss(p):
        return jnp.mean(jd.apply({"params": p}, jnp.asarray(x)) ** 2)

    v_ref, g_ref = jax.value_and_grad(loss)(v["params"])
    y = port(_ncl(x))
    assert y.shape == (2, 1, 300)
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 1),
                               np.asarray(jd.apply(v, jnp.asarray(x))), atol=2e-4)
    (y ** 2).mean().backward()
    got = _grads_to_jax(PWG_D, params, port)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_ref),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=2e-4, rtol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))


def test_training_checkpoint_decodes_in_both_packages(tmp_path):
    """A checkpoint of the whole training state decodes through the port's
    ``bin/decode --device cpu`` and through the JAX ``load_model``, and the
    two generators give the same padded forward."""
    gp = dict(SMALL, use_pallas_stack_train=True)
    gen = get_model_class(PWG)(**gp, generator=torch.Generator().manual_seed(3))
    dis = get_model_class(PWG_D)(**SMALL_D, generator=torch.Generator().manual_seed(4))
    opt_g = build_optimizer(gen.parameters(), "RAdam", {"lr": 1e-4})
    opt_d = build_optimizer(dis.parameters(), "RAdam", {"lr": 5e-5})
    exp, dump = tmp_path / "exp", tmp_path / "dump"
    dump.mkdir()
    config = {"sampling_rate": 16000, "hop_size": 16, "format": "npy",
              "generator_type": PWG, "generator_params": gp,
              "discriminator_type": PWG_D, "discriminator_params": SMALL_D}
    ckpt = str(exp / "checkpoint-7steps.pkl")
    save_training_checkpoint(ckpt, gen, dis, opt_g, opt_d, steps=7)
    write_config(str(exp / "config.yml"), config)
    mel = np.random.RandomState(6).randn(33, 10).astype(np.float32)
    np.save(dump / "utt-feats.npy", mel)
    res = decode.main(["--dumpdir", str(dump), "--outdir", str(tmp_path / "wav"),
                       "--checkpoint", ckpt, "--device", "cpu", "--verbose", "0"])
    assert len(res["rtfs"]) == 1
    assert (tmp_path / "wav" / "utt-feats_gen.wav").exists()

    jax_model = jax_load_model(ckpt)  # reads config.yml beside the checkpoint
    port = load_model(ckpt, device="cpu")
    rs = np.random.RandomState(7)
    c = rs.randn(32, 10).astype(np.float32)
    z = rs.randn(32 * 16).astype(np.float32)
    want = np.asarray(jax_model._forward_fn()(jnp.asarray(c), jnp.asarray(z)))
    with torch.inference_mode():
        got = port.forward_padded(torch.from_numpy(c), torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
