"""Port of Multi-band MelGAN decode held against the JAX package.

The fused residual-stack wrapper (its plain version on the CPU) is fed the
same numpy arrays as the JAX ``fused_melgan_stacks`` (Pallas in interpret
mode); ``ResidualStack`` and ``MelGANGenerator`` take the JAX ``init``
parameters through ``jax_params_to_state_dict``; ``PQMF`` and an MB-MelGAN
``.pkl`` decoded by both packages' ``load_model`` close the slice. Small
widths: channels 64, scales (4, 2), 2 stacks, 2 sub-bands, and one
generator with a 256-channel stage so that the fused gate's both sides run.
Tolerance atol 2e-4 (float32 convolutions summed in another order by XLA
and by PyTorch), 1e-5 for PQMF alone, exact for the numpy filter design.
"""

import functools
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
from parallelwavegan_tpu.layers.residual_stack import (  # noqa: E402
    ResidualStack as JaxResidualStack,
)
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.ops import pqmf as jax_pqmf  # noqa: E402
from parallelwavegan_tpu.ops.pallas_kernels import melgan_stack as jax_ms  # noqa: E402
from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.bin import decode  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.layers.residual_stack import ResidualStack  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.models import melgan as port_melgan  # noqa: E402
from parallelwavegan_tpu_torch.ops import pqmf as port_pqmf  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import melgan_stack as port_ms  # noqa: E402
from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import load_model  # noqa: E402

MELGAN = "MelGANGenerator"
TOL = 2e-4
SMALL = dict(in_channels=10, out_channels=2, kernel_size=7, channels=64,
             upsample_scales=(4, 2), stack_kernel_size=3, stacks=2)
# stage 0 at 256 channels stays plain under the fused gate, stage 1 at 128
WIDE = dict(SMALL, channels=512)
FRAMES = 12
MEL = np.random.RandomState(0).randn(2, FRAMES, 10).astype(np.float32)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V2_YAML = os.path.join(ROOT, "egs", "ljspeech", "voc1", "conf",
                       "multi_band_melgan.v2.yaml")


def _stacks(rs, c, dilations=(1, 3, 9), k=3, bias=True):
    """Folded stack weights as numpy, scaled to keep |y| about 1."""
    def w(*shape):
        return (rs.randn(*shape) * 0.5 / np.sqrt(shape[0] * shape[1])).astype(np.float32)

    def b():
        return (rs.randn(c) * 0.1).astype(np.float32) if bias else None

    return [{"wd": w(k, c, c), "bd": b(), "w1": w(1, c, c), "b1": b(),
             "ws": w(1, c, c), "bs": b(), "dilation": d} for d in dilations]


def _as(stacks, fn):
    return [{k: (v if k == "dilation" or v is None else fn(v)) for k, v in st.items()}
            for st in stacks]


def _both(x, stacks, final, pad_mode):
    """(JAX in interpret mode, port on the CPU) on the same arrays."""
    want = jax_ms.fused_melgan_stacks(
        jnp.asarray(x), _as(stacks, jnp.asarray),
        final=None if final is None else tuple(
            None if v is None else jnp.asarray(v) for v in final),
        pad_mode=pad_mode, t_tile=64, interpret=True)
    calls = port_ms.fused_melgan_stacks.calls
    got = port_ms.fused_melgan_stacks(
        torch.from_numpy(x), _as(stacks, torch.from_numpy),
        final=None if final is None else tuple(
            None if v is None else torch.from_numpy(v) for v in final),
        pad_mode=pad_mode)
    assert port_ms.fused_melgan_stacks.calls == calls  # no kernel on the CPU
    return np.asarray(want), got.numpy()


def _final(rs, c, out_ch, bias=True):
    w = (rs.randn(7, c, out_ch) * 0.5 / np.sqrt(7 * c)).astype(np.float32)
    return w, (rs.randn(out_ch) * 0.1).astype(np.float32) if bias else None


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("pad_mode", ["reflect", "edge", "constant"])
def test_fused_stacks_match_jax(pad_mode, with_final):
    rs = np.random.RandomState(1)
    c = 48  # MB-MelGAN v2's last stage: a width that is not a power of two
    stacks = _stacks(rs, c)
    final = _final(rs, c, 4) if with_final else None
    x = rs.randn(2, 300, c).astype(np.float32)
    want, got = _both(x, stacks, final, pad_mode)
    assert got.shape == (2, 300, 4 if with_final else c)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("pad_mode,with_final", [("reflect", True), ("edge", False)])
def test_fused_stacks_short_input_is_all_edge(pad_mode, with_final):
    """T <= 2R: JAX computes the whole output with its twin."""
    rs = np.random.RandomState(2)
    stacks = _stacks(rs, 32)
    final = _final(rs, 32, 1) if with_final else None
    r = 1 + 3 + 9 + (3 if with_final else 0)
    x = rs.randn(1, 20, 32).astype(np.float32)
    assert x.shape[1] <= 2 * r
    want, got = _both(x, stacks, final, pad_mode)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_fused_stacks_without_biases_match_jax():
    rs = np.random.RandomState(3)
    stacks = _stacks(rs, 64, dilations=(1, 3), bias=False)
    x = rs.randn(1, 200, 64).astype(np.float32)
    want, got = _both(x, stacks, _final(rs, 64, 4, bias=False), "reflect")
    np.testing.assert_allclose(got, want, atol=TOL)


def test_cuda_input_checks_raise_on_what_the_kernel_does_not_take():
    rs = np.random.RandomState(4)
    ok = _as(_stacks(rs, 32, dilations=(1, 27)), torch.from_numpy)
    x = torch.zeros(1, 100, 32)
    port_ms._check_cuda_inputs(x, ok, None, "reflect")  # accepted
    with pytest.raises(ValueError, match="width 24 is not a multiple of 16"):
        port_ms._check_cuda_inputs(
            torch.zeros(1, 100, 24), _as(_stacks(rs, 24), torch.from_numpy),
            None, "reflect")
    with pytest.raises(ValueError, match="reflect padding of 27"):
        port_ms._check_cuda_inputs(torch.zeros(1, 27, 32), ok, None, "reflect")
    port_ms._check_cuda_inputs(torch.zeros(1, 27, 32), ok, None, "edge")
    with pytest.raises(ValueError, match="float32"):
        port_ms._check_cuda_inputs(x.double(), ok, None, "edge")
    with pytest.raises(ValueError, match="pad_mode 'wrap'"):
        port_ms.fused_melgan_stacks(x, ok, pad_mode="wrap")


@pytest.mark.parametrize("use_weight_norm", [True, False])
@pytest.mark.parametrize("pad,pad_params", [
    ("ReflectionPad1d", None), ("ReplicationPad1d", None),
    ("ConstantPad1d", {"value": 0.0})])
def test_residual_stack_matches_jax(pad, pad_params, use_weight_norm):
    kw = dict(kernel_size=3, channels=16, dilation=3, pad=pad,
              pad_params=pad_params)
    jm = JaxResidualStack(**kw, norm="weight" if use_weight_norm else None)
    x = np.random.RandomState(5).randn(2, 40, 16).astype(np.float32)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    port = ResidualStack(**kw, use_weight_norm=use_weight_norm)
    port.load_state_dict(jax_params_to_state_dict("ResidualStack", {}, v),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    assert set(port.state_dict()) >= {"stack.2.bias", "stack.4.bias",
                                      "skip_layer.bias"}


@functools.lru_cache(maxsize=None)
def _jax_init(kind, use_weight_norm=True):
    params = dict(SMALL if kind == "small" else WIDE,
                  use_weight_norm=use_weight_norm)
    g = jax_model_class(MELGAN)(**params)
    v = g.init(jax.random.key(0), jnp.asarray(MEL))
    return params, jax.tree_util.tree_map(np.asarray, v)


def _spy_calls(monkeypatch):
    calls = []
    real = port_melgan.fused_melgan_stacks

    def spy(x, stacks, **kw):
        calls.append((tuple(x.shape), len(stacks), kw["final"] is not None))
        return real(x, stacks, **kw)

    monkeypatch.setattr(port_melgan, "fused_melgan_stacks", spy)
    return calls


@pytest.mark.parametrize("kind,use_pallas_stacks,extra", [
    ("small", False, {}),
    ("small", True, {}),
    ("small", True, {"pad": "ReplicationPad1d"}),
    ("wide", False, {}),
    ("wide", True, {}),
])
def test_generator_matches_jax(kind, use_pallas_stacks, extra, monkeypatch):
    params, v = _jax_init(kind)
    params = dict(params, **extra)
    flags = dict(use_pallas_stacks=use_pallas_stacks)
    want = np.asarray(jax_model_class(MELGAN)(**params, **flags).apply(
        v, jnp.asarray(MEL)))
    port = get_model_class(MELGAN)(**params, **flags).eval()
    port.load_state_dict(jax_params_to_state_dict(MELGAN, params, v), strict=True)
    calls = _spy_calls(monkeypatch)
    with torch.no_grad():
        got = port(torch.from_numpy(MEL).transpose(1, 2)).transpose(1, 2)
    assert got.shape == (2, FRAMES * 8, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # both stages fused at 32/16 channels; only the 128-channel one when wide
    expect = {("small", True): [((2, 48, 32), 2, False), ((2, 96, 16), 2, True)],
              ("wide", True): [((2, 96, 128), 2, True)]}
    assert calls == expect.get((kind, use_pallas_stacks), [])


@pytest.mark.parametrize("use_weight_norm", [True, False])
def test_jax_params_round_trip_exact(use_weight_norm):
    params, v = _jax_init("small", use_weight_norm)
    sd = jax_params_to_state_dict(MELGAN, params, v)
    back, _ = convert_state_dict(MELGAN, params, {k: t.numpy() for k, t in sd.items()})
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert want.keys() == got.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a, err_msg=str(path))


def test_port_state_dict_is_upstream_checkpoint():
    """Port module -> state dict -> the JAX converter -> JAX apply."""
    port = get_model_class(MELGAN)(**SMALL, generator=torch.Generator().manual_seed(3))
    keys = set(port.state_dict())
    for k in ("melgan.1.weight_v", "melgan.3.weight_g", "melgan.4.stack.2.weight_v",
              "melgan.5.skip_layer.bias", "melgan.7.weight_g",
              "melgan.8.stack.4.bias", "melgan.12.weight_v", "melgan.12.bias"):
        assert k in keys, k
    assert port.melgan[3].weight_g.shape == (64, 1, 1)  # deconv: per Cin
    assert isinstance(port.melgan[13], torch.nn.Tanh)
    params, _ = convert_state_dict(
        MELGAN, SMALL, {k: t.detach().numpy() for k, t in port.state_dict().items()})
    want = np.asarray(jax_model_class(MELGAN)(**SMALL).apply(
        {"params": params}, jnp.asarray(MEL)))
    with torch.no_grad():
        got = port(torch.from_numpy(MEL).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("subbands,kw", [
    (4, {}), (4, dict(taps=62, cutoff_ratio=0.15, beta=9.0)), (2, {}),
    (3, dict(taps=48, cutoff_ratio=0.2, beta=8.0))])
def test_pqmf_matches_jax(subbands, kw):
    for a, b in zip(port_pqmf.pqmf_filters(subbands, **kw),
                    jax_pqmf.pqmf_filters(subbands, **kw)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_pqmf.design_prototype_filter(**kw),
                                  jax_pqmf.design_prototype_filter(**kw))
    jp, pp = jax_pqmf.PQMF(subbands, **kw), port_pqmf.PQMF(subbands, **kw)
    rs = np.random.RandomState(6)
    wave = rs.randn(2, 60 * subbands, 1).astype(np.float32)
    np.testing.assert_allclose(pp.analysis(torch.from_numpy(wave)).numpy(),
                               np.asarray(jp.analysis(jnp.asarray(wave))), atol=1e-5)
    bands = rs.randn(2, 60, subbands).astype(np.float32)
    got = pp.synthesis(torch.from_numpy(bands)).numpy()
    assert got.shape == (2, 60 * subbands, 1)
    np.testing.assert_allclose(got, np.asarray(jp.synthesis(jnp.asarray(bands))),
                               atol=1e-5)


def _write_mbmelgan(tmp_path, extra_config=None, **flags):
    exp, dump = tmp_path / "exp", tmp_path / "dump"
    exp.mkdir()
    dump.mkdir()
    gp = dict(SMALL, **flags)
    gen = get_model_class(MELGAN)(**gp, generator=torch.Generator().manual_seed(0))
    ckpt = str(exp / "checkpoint-2steps.pkl")
    save_checkpoint(ckpt, gen.state_dict(), steps=2)
    rs = np.random.RandomState(7)
    mels = {}
    for i, frames in enumerate((20, 37)):
        mels[f"utt{i}-feats"] = rs.randn(frames, 10).astype(np.float32)
        np.save(dump / f"utt{i}-feats.npy", mels[f"utt{i}-feats"])
    config = {"sampling_rate": 16000, "hop_size": 16, "format": "npy",
              "generator_type": MELGAN, "generator_params": gp,
              **(extra_config or {})}
    cfg = str(exp / "config.json")
    with open(cfg, "w") as f:
        json.dump(config, f)
    return ckpt, cfg, str(dump), config, mels


@pytest.mark.parametrize("extra_config,cutoff", [
    ({}, 0.15),                                   # no version: old defaults
    ({"version": "0.4.2"}, 0.15),
    ({"version": "0.5.4"}, 0.142),                # the class default
    ({"pqmf_params": {"taps": 48, "cutoff_ratio": 0.2, "beta": 8.0}}, 0.2),
])
def test_load_model_inference_matches_jax(tmp_path, extra_config, cutoff):
    ckpt, cfg, _, config, mels = _write_mbmelgan(
        tmp_path, extra_config, use_pallas_stacks=True)
    model = load_model(ckpt, config, device="cpu")
    assert model.pqmf.cutoff_ratio == cutoff and model.pqmf.subbands == 2
    assert model.upsample_factor == 16
    assert model.generator.fused_stages == (0, 1)
    assert model.generator._kernel_cache is not None  # gathered once
    jax_model = jax_load_model(ckpt, config)
    for mel in mels.values():
        got = model.inference(mel)
        want = np.asarray(jax_model.inference(mel))
        assert got.shape == want.shape == (mel.shape[0] * 16, 1)
        np.testing.assert_allclose(got, want, atol=TOL)


def test_shipped_v2_config_gets_the_old_pqmf_defaults():
    yaml = pytest.importorskip("yaml")
    with open(V2_YAML) as f:
        cfg = yaml.safe_load(f)
    assert "pqmf_params" not in cfg and "version" not in cfg
    gp = dict(cfg["generator_params"], channels=32, upsample_scales=[2, 2, 2],
              stacks=1)  # narrow, so that the test is cheap
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "checkpoint-1steps.pkl")
        save_checkpoint(ckpt, get_model_class(MELGAN)(**gp).state_dict())
        model = load_model(ckpt, dict(cfg, generator_params=gp), device="cpu")
    assert (model.pqmf.subbands, model.pqmf.taps, model.pqmf.cutoff_ratio,
            model.pqmf.beta) == (4, 62, 0.15, 9.0)


def test_decode_cli_routes_mbmelgan_through_the_stacks(tmp_path, monkeypatch):
    from scipy.io import wavfile

    ckpt, cfg, dump, config, mels = _write_mbmelgan(tmp_path)
    seen = []
    real = load_model

    def spy(*args, **kwargs):
        model = real(*args, **kwargs)
        seen.append(model.generator.fused_stages)
        return model

    monkeypatch.setattr(decode, "load_model", spy)
    for name, extra in (("plain", []), ("stacks", ["--use-pallas-stacks"])):
        decode.main(["--dumpdir", dump, "--outdir", str(tmp_path / name),
                     "--checkpoint", ckpt, "--config", cfg, "--device", "cpu",
                     "--verbose", "0", *extra])
    assert seen == [(), (0, 1)]
    for utt, mel in mels.items():
        wavs = [wavfile.read(tmp_path / name / f"{utt}_gen.wav")[1]
                for name in ("plain", "stacks")]
        assert wavs[0].shape == wavs[1].shape == (mel.shape[0] * 16,)
        assert np.abs(wavs[0].astype(int) - wavs[1].astype(int)).max() <= 1


@pytest.mark.parametrize("cls,kw,keys", [
    (ResidualStack, dict(use_causal_conv=True),
     {"stack.1.conv", "stack.3", "skip_layer"}),
    (get_model_class(MELGAN), dict(SMALL, use_causal_conv=True),
     {"melgan.0.conv", "melgan.2.deconv", "melgan.3.stack.1.conv", "melgan.3.stack.3",
      "melgan.3.skip_layer", "melgan.4.stack.1.conv", "melgan.4.stack.3",
      "melgan.4.skip_layer", "melgan.6.deconv", "melgan.7.stack.1.conv",
      "melgan.7.stack.3", "melgan.7.skip_layer", "melgan.8.stack.1.conv",
      "melgan.8.stack.3", "melgan.8.skip_layer", "melgan.10.conv"}),
])
def test_causal_variant_has_upstream_keys(cls, kw, keys):
    """The causal stack and generator (upstream's CausalConv1d ``.conv`` and
    CausalConvTranspose1d ``.deconv``, the causal stack's Sequential(act,
    CausalConv1d, act, conv)) keep their length and run no kernel."""
    m = cls(**kw)
    assert {k.rsplit(".", 1)[0] for k in m.state_dict()} == keys
    if cls is ResidualStack:
        x = torch.randn(2, 32, 40)
        assert m(x).shape == x.shape
    else:
        assert m.fused_stages == ()
        assert m(torch.from_numpy(MEL).transpose(1, 2)).shape[-1] == MEL.shape[1] * 8


def test_training_forward_through_the_kernel_raises():
    x = torch.from_numpy(MEL).transpose(1, 2)
    # the decode kernel's wrapper (K6 alone) has no VJP, as in JAX
    port = get_model_class(MELGAN)(**SMALL, use_pallas_stacks=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        port(x)
    # the plain path and the differentiable stages (K6 forward, K7
    # backward) train, and the stacks' weight gradients reach weight norm
    for kw in ({}, dict(use_pallas_stacks_train=True, pallas_stacks_train_tile=64)):
        port = get_model_class(MELGAN)(**SMALL, **kw)
        port(x).sum().backward()
        assert port.melgan[1].weight_v.grad is not None
        assert port.melgan[4].stack[2].weight_g.grad.abs().sum() > 0


def test_random_init_is_seeded_normal_002():
    cls = get_model_class(MELGAN)
    kw = dict(SMALL, channels=128, use_weight_norm=False)
    a = cls(**kw, generator=torch.Generator().manual_seed(7))
    b = cls(**kw, generator=torch.Generator().manual_seed(7))
    for k, t in a.state_dict().items():
        torch.testing.assert_close(t, b.state_dict()[k], rtol=0, atol=0)
    for idx in (1, 3, 4):  # input conv, first deconv, a stack's conv
        m = a.melgan[idx]
        w = (m.stack[2] if idx == 4 else m).weight.detach()
        assert abs(float(w.std()) - 0.02) < 0.002, idx
