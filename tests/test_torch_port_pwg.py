"""Port of the Parallel WaveGAN generator held against the JAX package.

Parameters made by the JAX ``init`` go into the port through
``jax_params_to_state_dict``; the same numpy noise and mel go through both
packages. Widths are those of tests/test_wavenet_stack.py:51-56 (4 layers
in 2 cycles, residual 8, gate 16, skip 8, aux 10, scales 4*4, aux context
window 2). Tolerance atol 1e-4 on the generator output: float32
convolutions and matmuls summed in another order by XLA and PyTorch
through 4 gated layers, the upsample net and two 1x1 heads; 3e-5 on
single modules.
"""

import functools
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
from parallelwavegan_tpu.layers import residual_block as jax_rb  # noqa: E402
from parallelwavegan_tpu.layers import upsample as jax_up  # noqa: E402
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.ops.pallas_kernels.wavenet import (  # noqa: E402
    fused_gated_resblock as jax_fused_gated_resblock,
)
from parallelwavegan_tpu.utils.model import InferenceModel as JaxInferenceModel  # noqa: E402
from parallelwavegan_tpu_torch.bin import decode  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.layers.residual_block import (  # noqa: E402
    WaveNetResidualBlock,
)
from parallelwavegan_tpu_torch.layers.upsample import (  # noqa: E402
    ConvInUpsampleNetwork,
    UpsampleNetwork,
    stretch_time,
)
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.wavenet import (  # noqa: E402
    fused_gated_resblock,
    fused_wavenet_stack,
)
from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import load_model  # noqa: E402

PWG = "ParallelWaveGANGenerator"
SMALL = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
             skip_channels=8, aux_channels=10, aux_context_window=2,
             upsample_params={"upsample_scales": [4, 4]})
FLAGS = ("use_pallas_stack", "use_pallas_stack_train", "use_pallas_kernels")
FRAMES = 12  # mel frames, before the context window
RS = np.random.RandomState(0)
Z = RS.randn(2, FRAMES * 16, 1).astype(np.float32)
C = RS.randn(2, FRAMES + 4, 10).astype(np.float32)


def _ncl(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


@functools.lru_cache(maxsize=None)
def _jax_params(use_weight_norm=True, act=False):
    g = jax_model_class(PWG)(**_small(use_weight_norm, act))
    v = g.init(jax.random.key(0), jnp.asarray(Z), jnp.asarray(C))
    return jax.tree_util.tree_map(np.asarray, v)


def _small(use_weight_norm=True, act=False):
    params = dict(SMALL, use_weight_norm=use_weight_norm)
    if act:
        params["upsample_params"] = dict(
            SMALL["upsample_params"], nonlinear_activation="LeakyReLU",
            nonlinear_activation_params={"negative_slope": 0.2})
    return params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("use_weight_norm,act", [(True, False), (False, False),
                                                 (True, True)])
def test_jax_params_round_trip_exact(use_weight_norm, act):
    params = _small(use_weight_norm, act)
    v = _jax_params(use_weight_norm, act)
    sd = jax_params_to_state_dict(PWG, params, v)
    back, _ = convert_state_dict(PWG, params, {k: t.numpy() for k, t in sd.items()})
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert want.keys() == got.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a, err_msg=str(path))
    port = get_model_class(PWG)(**params)
    port.load_state_dict(sd, strict=True)


def test_port_state_dict_has_upstream_keys():
    port = get_model_class(PWG)(**SMALL)
    keys = set(port.state_dict())
    for k in ("first_conv.weight_g", "first_conv.weight_v", "first_conv.bias",
              "upsample_net.conv_in.weight_g", "upsample_net.conv_in.weight_v",
              "upsample_net.upsample.up_layers.1.weight_g",
              "upsample_net.upsample.up_layers.3.weight_v",
              "conv_layers.3.conv.weight_v", "conv_layers.0.conv.bias",
              "conv_layers.1.conv1x1_aux.weight_g",
              "conv_layers.2.conv1x1_skip.bias", "conv_layers.2.conv1x1_out.weight_v",
              "last_conv_layers.1.weight_g", "last_conv_layers.3.bias"):
        assert k in keys, k
    assert "upsample_net.conv_in.bias" not in keys
    assert "conv_layers.0.conv1x1_aux.bias" not in keys
    assert port.upsample_net.upsample.up_layers[1].weight_v.shape == (1, 1, 1, 9)
    assert port.conv_layers[0].conv.weight_g.shape == (16, 1, 1)


def test_properties_equal_jax():
    for params in (SMALL, {}):
        jax_g = jax_model_class(PWG)(**params)
        port = get_model_class(PWG)(**params)
        assert port.upsample_factor == jax_g.upsample_factor
        assert port.receptive_field_size == jax_g.receptive_field_size
        assert [blk.dilation for blk in port.conv_layers] == [
            2 ** (i % (port.layers // port.stacks)) for i in range(port.layers)]


@pytest.mark.parametrize("flag", (None,) + FLAGS)
def test_generator_matches_jax(flag):
    kw = {flag: True} if flag else {}
    v = _jax_params()
    want = np.asarray(jax_model_class(PWG)(**SMALL, **kw).apply(
        v, jnp.asarray(Z), jnp.asarray(C)))
    port = get_model_class(PWG)(**SMALL, **kw)
    assert port.use_stack == (flag in FLAGS[:2])
    assert port.conv_layers[0].use_fused == (flag == "use_pallas_kernels")
    port.load_state_dict(jax_params_to_state_dict(PWG, SMALL, v))
    port.eval()
    with torch.no_grad():
        got = port(_ncl(Z), _ncl(C)).numpy()
        port.remove_weight_norm()
        folded = port(_ncl(Z), _ncl(C)).numpy()
        port.prepare_kernels()
        prepared = port(_ncl(Z), _ncl(C)).numpy()
    assert got.shape == (2, 1, FRAMES * 16)
    np.testing.assert_allclose(got.transpose(0, 2, 1), want, atol=1e-4)
    np.testing.assert_allclose(folded, got, atol=1e-5)
    np.testing.assert_array_equal(prepared, folded)


@pytest.mark.parametrize("flag", FLAGS[:2])
def test_stack_without_biases_matches_jax(flag):
    """``bias: false`` keeps the stack path (with zero biases for the
    kernel). The JAX reference runs its plain path: its stack path stacks
    the bias leaves, which do not exist without biases."""
    params = dict(SMALL, bias=False)
    v = _np(jax_model_class(PWG)(**params).init(
        jax.random.key(2), jnp.asarray(Z), jnp.asarray(C)))
    want = np.asarray(jax_model_class(PWG)(**params).apply(
        v, jnp.asarray(Z), jnp.asarray(C)))
    port = get_model_class(PWG)(**params, **{flag: True})
    port.load_state_dict(jax_params_to_state_dict(PWG, params, v), strict=True)
    assert port.use_stack and "conv_layers.0.conv.bias" not in port.state_dict()
    port.eval()
    w, _ = port.stack_weights()
    assert w["bconv"].shape == (4, 16) and not w["bconv"].any()
    assert w["bskip"].shape == w["bres"].shape == (4, 8)
    with torch.no_grad():
        port.prepare_kernels()
        got = port(_ncl(Z), _ncl(C)).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 1), want, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_residual_block_matches_jax(causal):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 50, 8).astype(np.float32)
    c = rs.randn(2, 50, 10).astype(np.float32)
    kw = dict(kernel_size=3, residual_channels=8, gate_channels=16,
              skip_channels=8, aux_channels=10, dilation=4,
              use_causal_conv=causal)
    blk = jax_rb.WaveNetResidualBlock(**kw)
    v = _np(blk.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(c)))
    r0, s0 = blk.apply(v, jnp.asarray(x), jnp.asarray(c))
    sd = jax_params_to_state_dict(PWG, {}, v)
    for use_pallas in (False, True):
        port = WaveNetResidualBlock(**kw, use_pallas=use_pallas)
        port.load_state_dict(sd, strict=True)
        with torch.no_grad():
            r1, s1 = port(_ncl(x), _ncl(c))
        np.testing.assert_allclose(r1.numpy().transpose(0, 2, 1), r0, atol=3e-5)
        np.testing.assert_allclose(s1.numpy().transpose(0, 2, 1), s0, atol=3e-5)
    w = port.gather_weights()
    want = v["params"]["conv"]
    np.testing.assert_allclose(
        w["wconv"].numpy(),
        want["g"] * want["v"] / np.sqrt((want["v"] ** 2).sum((0, 1), keepdims=True)),
        atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("act", [False, True])
def test_upsample_networks_match_jax(causal, act):
    rs = np.random.RandomState(4)
    kw = dict(upsample_scales=(2, 3), use_causal_conv=causal,
              freq_axis_kernel_size=3)
    if act:
        kw.update(nonlinear_activation="ReLU")
    c = rs.randn(2, 9, 10).astype(np.float32)
    up = jax_up.UpsampleNetwork(**kw, norm="weight")
    v = _np(up.init(jax.random.key(2), jnp.asarray(c)))
    # perturb g so that the weight norm is not the identity
    v["params"]["conv_1_g"] = v["params"]["conv_1_g"] * 1.7
    want = np.asarray(up.apply(v, jnp.asarray(c)))
    sd = jax_params_to_state_dict(PWG, {"upsample_params": kw},
                                  {"upsample": v["params"]})
    port = UpsampleNetwork(**kw, use_weight_norm=True)
    port.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = port(_ncl(c)).numpy().transpose(0, 2, 1)
    assert got.shape == (2, 9 * 6, 10)
    np.testing.assert_allclose(got, want, atol=3e-5)

    conv_in = jax_up.ConvInUpsampleNetwork(**kw, aux_channels=10,
                                           aux_context_window=2, norm="weight")
    v = _np(conv_in.init(jax.random.key(3), jnp.asarray(c)))
    want = np.asarray(conv_in.apply(v, jnp.asarray(c)))
    port = ConvInUpsampleNetwork(**kw, aux_channels=10, aux_context_window=2,
                                 use_weight_norm=True)
    port.load_state_dict(jax_params_to_state_dict(
        PWG, {"upsample_params": kw}, v), strict=True)
    with torch.no_grad():
        got = port(_ncl(c)).numpy().transpose(0, 2, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_stretch_time_is_nearest():
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert stretch_time(x, 2).tolist() == [[[0, 0, 1, 1, 2, 2], [3, 3, 4, 4, 5, 5]]]
    assert stretch_time(x, 1) is x


def _jax_inference_model(v, flag=None):
    gp = dict(SMALL, **({flag: True} if flag else {}))
    config = {"generator_type": PWG, "generator_params": gp}
    return JaxInferenceModel(jax_model_class(PWG)(**gp), v["params"], config)


def _port_inference_model(v, flag=None):
    gp = dict(SMALL, **({flag: True} if flag else {}))
    gen = get_model_class(PWG)(**gp)
    gen.load_state_dict(jax_params_to_state_dict(PWG, SMALL, v))
    gen.remove_weight_norm()
    gen.eval()
    gen.prepare_kernels()
    from parallelwavegan_tpu_torch.utils.model import InferenceModel

    return InferenceModel(gen, "cpu")


@pytest.mark.parametrize("flag", [None, "use_pallas_stack_train"])
def test_padded_forward_matches_jax(flag):
    v = _jax_params()
    rs = np.random.RandomState(5)
    pad_t = 32
    c = rs.randn(pad_t, 10).astype(np.float32)
    z = rs.randn(pad_t * 16).astype(np.float32)
    want = np.asarray(_jax_inference_model(v, flag)._forward_fn()(
        jnp.asarray(c), jnp.asarray(z)))
    with torch.inference_mode():
        got = _port_inference_model(v, flag).forward_padded(
            torch.from_numpy(c), torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (pad_t * 16, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("frames", [1, 20, 33])
def test_inference_lengths_and_padding_equal_jax(frames):
    v = _jax_params()
    mel = np.random.RandomState(frames).randn(frames, 10).astype(np.float32)
    jax_y = _jax_inference_model(v).inference(mel)
    model = _port_inference_model(v)
    seen = {}
    forward = model.forward_padded

    def spy(c, z):
        seen["c"], seen["z"] = c.numpy(), z.numpy()
        return forward(c, z)

    model.forward_padded = spy
    y = model.inference(mel, rng=torch.Generator().manual_seed(0))
    pad_t = -(-frames // 32) * 32
    assert y.shape == jax_y.shape == (frames * 16, 1)
    assert seen["c"].shape == (pad_t, 10) and seen["z"].shape == (pad_t * 16,)
    np.testing.assert_array_equal(seen["c"][frames:], np.repeat(mel[-1:], pad_t - frames, 0))
    # the same z gives the same samples as the padded forward, trimmed
    model.forward_padded = forward
    again = model.inference(mel, rng=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again, y)
    with torch.inference_mode():
        full = forward(torch.from_numpy(seen["c"]), torch.from_numpy(seen["z"]))
    np.testing.assert_array_equal(y, full.numpy()[: frames * 16])


def _write_pwg(tmp_path, **flags):
    exp, dump = tmp_path / "exp", tmp_path / "dump"
    exp.mkdir()
    dump.mkdir()
    gp = dict(SMALL, **flags)
    gen = get_model_class(PWG)(**gp, generator=torch.Generator().manual_seed(0))
    ckpt = str(exp / "checkpoint-1steps.pkl")
    save_checkpoint(ckpt, gen.state_dict(), steps=1)
    rs = np.random.RandomState(1)
    for i, frames in enumerate((20, 37)):
        np.save(dump / f"utt{i}-feats.npy", rs.randn(frames, 10).astype(np.float32))
    config = {"sampling_rate": 16000, "hop_size": 16, "format": "npy",
              "generator_type": PWG, "generator_params": gp}
    cfg = str(exp / "config.json")
    with open(cfg, "w") as f:
        json.dump(config, f)
    return ckpt, cfg, str(dump), config


def test_decode_pwg_checkpoint_on_cpu(tmp_path):
    from scipy.io import wavfile

    ckpt, cfg, dump, config = _write_pwg(tmp_path, use_pallas_stack_train=True)
    out = tmp_path / "wav"
    np.random.seed(0)
    res = decode.main(["--dumpdir", dump, "--outdir", str(out), "--checkpoint",
                       ckpt, "--config", cfg, "--device", "cpu", "--verbose", "0"])
    assert len(res["rtfs"]) == 2
    model = load_model(ckpt, config, device="cpu")
    assert model.generator.use_stack and model.generator._kernel_cache
    np.random.seed(0)
    for i, frames in enumerate((20, 37)):
        fs, data = wavfile.read(out / f"utt{i}-feats_gen.wav")
        assert fs == 16000 and data.shape == (frames * 16,)
        want = model.inference(np.load(f"{dump}/utt{i}-feats.npy"))[:, 0]
        np.testing.assert_allclose(data / 32767.0, np.clip(want, -1, 1),
                                   atol=1.5 / 32767)


def test_decode_flag_routes_pwg_through_the_stack(tmp_path, monkeypatch):
    ckpt, cfg, dump, _ = _write_pwg(tmp_path)
    seen = []
    real = load_model

    def spy(*args, **kwargs):
        model = real(*args, **kwargs)
        seen.append(model.generator.use_stack)
        return model

    monkeypatch.setattr(decode, "load_model", spy)
    for extra in ([], ["--use-pallas-stack"]):
        decode.main(["--dumpdir", dump, "--outdir", str(tmp_path / "o"),
                     "--checkpoint", ckpt, "--config", cfg, "--device", "cpu",
                     "--verbose", "0", *extra])
    assert seen == [False, True]


def test_load_model_defaults_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ckpt, cfg, _, config = _write_pwg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        load_model(ckpt, config)
    assert load_model(ckpt, config, device="cpu").device.type == "cpu"


def test_training_forward_through_a_kernel_raises():
    # the inference-only stack kernel (K3 alone) has no VJP, as in JAX
    port = get_model_class(PWG)(**SMALL, use_pallas_stack=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        port(_ncl(Z), _ncl(C))
    # the plain path, the differentiable cycle (K3 forward, K4 backward) and
    # the block kernel (K5 forward, autograd of the plain block backward,
    # JAX's custom_vjp) train
    for kw in ({}, {"use_pallas_stack_train": True}, {"use_pallas_kernels": True}):
        port = get_model_class(PWG)(**SMALL, **kw)
        port(_ncl(Z), _ncl(C)).sum().backward()
        assert port.first_conv.weight_v.grad is not None
        assert port.conv_layers[0].conv.weight_g.grad is not None


def test_block_kernel_grads_match_jax_fused_gated_resblock():
    """The port's ``fused_gated_resblock`` (its plain forward on the CPU,
    its backward autograd of the plain block) against the JAX
    ``fused_gated_resblock`` in interpret mode, causal and not, within
    2e-4."""
    rs = np.random.RandomState(9)
    arrays = [(rs.randn(2, 60, 8) * 0.5).astype(np.float32),
              (rs.randn(2, 60, 10) * 0.5).astype(np.float32)]
    for shape in ((3, 8, 16), (16,), (10, 16), (8, 8), (8,), (8, 8), (8,)):
        arrays.append((rs.randn(*shape) * 0.3).astype(np.float32))
    cot = [rs.randn(2, 60, 8).astype(np.float32) for _ in range(2)]
    for dilation, causal in ((2, False), (4, True)):
        def f(*args):
            return jax_fused_gated_resblock(*args, dilation=dilation, causal=causal,
                                            t_tile=32, interpret=True)

        _, vjp = jax.vjp(f, *map(jnp.asarray, arrays))
        want = vjp(tuple(map(jnp.asarray, cot)))
        leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
        r, s = fused_gated_resblock(*leaves, dilation=dilation, causal=causal)
        torch.autograd.backward((r, s), tuple(map(torch.from_numpy, cot)))
        for i, (leaf, w) in enumerate(zip(leaves, want)):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=2e-4,
                                       err_msg=f"input {i}, dilation {dilation}")


def test_causal_generator_with_melgan_upsample_net_is_causal():
    """The causal generator with the MelGAN upsample net (refused until the
    causal MelGAN generator was ported) has upstream's causal keys under
    ``upsample_net.melgan`` and keeps the samples before a mel frame as
    they were when that frame and the ones after it change."""
    kw = dict(SMALL, use_causal_conv=True, upsample_net="MelGANGenerator",
              aux_context_window=0,
              upsample_params={"in_channels": 10, "out_channels": 10, "channels": 32,
                               "upsample_scales": [4, 4]})
    gen = get_model_class(PWG)(**kw, generator=torch.Generator().manual_seed(3))
    keys = {k.rsplit(".", 1)[0] for k in gen.state_dict() if k.startswith("upsample_net.")}
    assert {"upsample_net.melgan.0.conv", "upsample_net.melgan.2.deconv",
            "upsample_net.melgan.3.stack.1.conv", "upsample_net.melgan.3.stack.3",
            "upsample_net.melgan.7.deconv", "upsample_net.melgan.12.conv"} <= keys
    rs = np.random.RandomState(4)
    z = torch.from_numpy(rs.randn(1, 1, 12 * 16).astype(np.float32))
    c = torch.from_numpy(rs.randn(1, 10, 12).astype(np.float32))
    c2 = c.clone()
    c2[:, :, 8:] = 0.0
    with torch.no_grad():
        y, y2 = gen(z, c), gen(z, c2)
    assert y.shape == (1, 1, 12 * 16)
    torch.testing.assert_close(y2[..., :8 * 16], y[..., :8 * 16], rtol=0, atol=0)
    assert not torch.equal(y2, y)


def test_random_init_is_seeded_and_kaiming():
    cls = get_model_class(PWG)
    a = cls(generator=torch.Generator().manual_seed(7), use_weight_norm=False)
    b = cls(generator=torch.Generator().manual_seed(7), use_weight_norm=False)
    for k, t in a.state_dict().items():
        torch.testing.assert_close(t, b.state_dict()[k], rtol=0, atol=0)
    conv = a.conv_layers[5].conv
    assert float(conv.bias.detach().abs().max()) == 0.0
    assert abs(float(conv.weight.detach().std()) - (2.0 / (3 * 64)) ** 0.5) < 0.01
    up = a.upsample_net.upsample.up_layers[1].weight
    assert torch.all(up == 1.0 / 9)


def test_kernel_counters_stay_at_zero_on_the_cpu():
    before = (fused_wavenet_stack.launches, fused_gated_resblock.launches)
    for flag in FLAGS:
        port = get_model_class(PWG)(**SMALL, **{flag: True}).eval()
        with torch.inference_mode():
            port(_ncl(Z), _ncl(C))
    assert (fused_wavenet_stack.launches, fused_gated_resblock.launches) == before
