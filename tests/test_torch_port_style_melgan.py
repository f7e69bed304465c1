"""Port of StyleMelGAN decode held against the JAX package.

``TADEResBlock`` and ``StyleMelGANGenerator`` take the JAX ``init``
parameters through ``jax_params_to_state_dict``; the fused TADE wrapper
(its plain version on the CPU) is fed the same numpy arrays as the JAX
``fused_tade_blocks`` (Pallas in interpret mode, ``t_tile=16``, the sizes
of tests/test_tade_kernel.py); ``InferenceModel.forward_padded`` is held
to the JAX ``_forward_fn()`` with the same injected noise, and a small
checkpoint is decoded through ``bin/decode.main`` on the CPU. Tolerance
2e-4 (float32 convolutions summed in another order by XLA and PyTorch),
the bound tests/test_tade_kernel.py holds the JAX kernel to.
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
from parallelwavegan_tpu.layers.tade import (  # noqa: E402
    TADEResBlock as JaxTADEResBlock,
)
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.ops.pallas_kernels import tade_decode as jax_td  # noqa: E402
from parallelwavegan_tpu.utils.model import load_model as jax_load_model  # noqa: E402
from parallelwavegan_tpu_torch.bin import decode  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.layers.tade import TADEResBlock  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_decode as port_td  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_train as port_tt  # noqa: E402
from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import load_model  # noqa: E402

STYLE = "StyleMelGANGenerator"
TOL = 2e-4
C = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V1_YAML = os.path.join(ROOT, "egs", "ljspeech", "voc1", "conf", "style_melgan.v1.yaml")
# width 64 (the kernels'), noise x10, blocks x2, x2, x1: block 0 at aux 20
SMALL = dict(in_channels=16, aux_channels=20, channels=64, out_channels=1,
             kernel_size=9, dilation=2, noise_upsample_scales=[5, 2],
             upsample_scales=[2, 2, 1])
WEIGHTS = port_td.WEIGHT_KEYS


def _jax_blocks(scales, aux0, seed, gated="softmax", norm=None, t=32):
    """Flax TADEResBlocks and their params, block 0 at aux width aux0."""
    mods, params, ach = [], [], aux0
    for i, s in enumerate(scales):
        m = JaxTADEResBlock(in_channels=C, aux_channels=ach, kernel_size=9,
                            dilation=2, upsample_factor=s, gated_function=gated,
                            norm=norm)
        v = m.init(jax.random.fold_in(jax.random.key(seed), i),
                   jnp.zeros((1, t, C)), jnp.zeros((1, t, ach)))
        mods.append(m)
        params.append(jax.tree_util.tree_map(np.asarray, v))
        ach = C
    return mods, params


def _port_blocks(scales, params, aux0, gated="softmax", use_weight_norm=False):
    """Port TADEResBlocks loaded from the flax params."""
    blocks, ach = [], aux0
    for s, v in zip(scales, params):
        blk = TADEResBlock(in_channels=C, aux_channels=ach, kernel_size=9,
                           dilation=2, upsample_factor=s, gated_function=gated,
                           use_weight_norm=use_weight_norm)
        blk.load_state_dict(jax_params_to_state_dict("TADEResBlock", {}, v),
                            strict=True)
        blocks.append(blk.eval())
        ach = C
    return blocks


def _as_jax(blk):
    return {k: (v if k in ("scale", "dilation") else jnp.asarray(v.numpy()))
            for k, v in blk.items() if k != "module"}


def _rand_block(rs, aux=C, scale=2, dilation=2, bias=True):
    """Folded weights as numpy, scaled to keep activations about 1."""
    out = {"scale": scale, "dilation": dilation}
    for key in WEIGHTS:
        cin = aux if key == "aux1" else C
        cout = C if key.startswith("aux") else 2 * C
        out[f"{key}_w"] = (rs.randn(9, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
        out[f"{key}_b"] = ((rs.randn(cout) * 0.1) if bias else np.zeros(cout)).astype(
            np.float32)
    return out


@pytest.mark.parametrize("gated", ["softmax", "sigmoid"])
@pytest.mark.parametrize("scale", [2, 1])
def test_tade_res_block_matches_jax(gated, scale):
    """Weight-normed module against the flax TADEResBlock, aux width 80."""
    kw = dict(in_channels=16, aux_channels=80, kernel_size=9, dilation=2,
              upsample_factor=scale, gated_function=gated)
    rs = np.random.RandomState(0)
    x = rs.randn(2, 24, 16).astype(np.float32)
    c = rs.randn(2, 24, 80).astype(np.float32)
    jm = JaxTADEResBlock(**kw, norm="weight")
    v = jm.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(c))
    want_x, want_c = jm.apply(v, jnp.asarray(x), jnp.asarray(c))
    port = TADEResBlock(**kw)
    port.load_state_dict(jax_params_to_state_dict("TADEResBlock", {}, v), strict=True)
    with torch.no_grad():
        got_x, got_c = port(torch.from_numpy(x).transpose(1, 2),
                            torch.from_numpy(c).transpose(1, 2))
    assert got_x.shape == (2, 16, 24 * scale)
    np.testing.assert_allclose(got_x.transpose(1, 2).numpy(), np.asarray(want_x), atol=TOL)
    np.testing.assert_allclose(got_c.transpose(1, 2).numpy(), np.asarray(want_c), atol=TOL)


def test_tade_block_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="relu is not supported"):
        TADEResBlock(gated_function="relu")
    with pytest.raises(ValueError, match="nearest"):
        TADEResBlock(upsample_mode="linear")


@pytest.mark.parametrize("gated,scale,dilation,bias", [
    ("softmax", 2, 2, True), ("sigmoid", 1, 2, True), ("softmax", 1, 1, False),
    ("softmax", 2, 3, True)])
def test_tade_block_reference_matches_xla(gated, scale, dilation, bias):
    rs = np.random.RandomState(2)
    blk = _rand_block(rs, scale=scale, dilation=dilation, bias=bias)
    x = rs.randn(2, 37, C).astype(np.float32)
    c = rs.randn(2, 37, C).astype(np.float32)
    want = jax_td.tade_block_xla(jnp.asarray(x), jnp.asarray(c),
                                 {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                  for k, v in blk.items()}, gated_function=gated)
    got = port_td.tade_block_reference(
        torch.from_numpy(x), torch.from_numpy(c),
        {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in blk.items()}, gated_function=gated)
    for g, w in zip(got, want):
        assert g.shape == (2, 37 * scale, C)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def _both_fused(scales, aux0, x, c, gated, min_fused_t, seed):
    """(JAX fused_tade_blocks in interpret mode, the port's on the CPU)."""
    _, params = _jax_blocks(scales, aux0, seed, gated)
    blocks = [b.folded_weights() for b in _port_blocks(scales, params, aux0, gated)]
    want = jax_td.fused_tade_blocks(
        jnp.asarray(x), jnp.asarray(c), [_as_jax(b) for b in blocks],
        gated_function=gated, min_fused_t=min_fused_t, t_tile=16, interpret=True)
    calls = port_td.fused_tade_blocks.calls
    with torch.no_grad():
        got = port_td.fused_tade_blocks(torch.from_numpy(x), torch.from_numpy(c),
                                        blocks, gated_function=gated,
                                        min_fused_t=min_fused_t)
    assert port_td.fused_tade_blocks.calls == calls  # no kernel on the CPU
    return want, got


@pytest.mark.parametrize("gated", ["softmax", "sigmoid"])
@pytest.mark.parametrize("t0", [64, 50])  # even, and not a multiple of the tile
def test_fused_blocks_match_jax(gated, t0):
    rs = np.random.RandomState(3)
    x = rs.randn(2, t0, C).astype(np.float32)
    c = rs.randn(2, t0, C).astype(np.float32)
    want, got = _both_fused((2, 1), C, x, c, gated, 1, seed=1)
    for w, g in zip(want, got):
        assert g.shape == (2, 2 * t0, C)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def test_mixed_path_matches_jax(monkeypatch):
    """Block 0 (aux 80, T=40 < 64) runs its module; block 1 the fused path."""
    seen = []
    real = port_td.tade_block_reference

    def spy(x, c, blk, **kw):
        seen.append(tuple(x.shape))
        return real(x, c, blk, **kw)

    monkeypatch.setattr(port_td, "tade_block_reference", spy)
    rs = np.random.RandomState(4)
    x = rs.randn(1, 40, C).astype(np.float32)
    c = rs.randn(1, 40, 80).astype(np.float32)
    want, got = _both_fused((2, 2), 80, x, c, "softmax", 64, seed=2)
    assert seen == [(1, 80, C)]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def test_gate_decode_and_train():
    rs = np.random.RandomState(5)
    blk, blk80 = _rand_block(rs), _rand_block(rs, aux=80)
    assert port_td.gated(4096, blk, min_fused_t=4096)
    assert not port_td.gated(4095, blk, min_fused_t=4096)
    assert not port_td.gated(8192, blk80, min_fused_t=4096)  # the mel-fed block
    assert port_td.gated(1024, blk, min_fused_t=1024, train=True)
    assert not port_td.gated(1025, blk, min_fused_t=1024, train=True)  # odd T
    blk4 = _rand_block(rs, scale=4)
    assert not port_td.gated(2048, blk4, min_fused_t=1024, train=True)
    assert not port_td.gated(100, blk4, min_fused_t=4096)  # left out: no check
    with pytest.raises(ValueError, match="scale 4"):
        port_td.gated(4096, blk4, min_fused_t=4096)


def test_scale_4_block_raises_under_use_pallas_tade():
    kw = dict(SMALL, upsample_scales=[2, 4])  # block 1: T=20, aux 64, scale 4
    c, z = torch.zeros(1, 20, 10), torch.zeros(1, 16, 1)
    for flag in ("use_pallas_tade", "use_pallas_tade_train"):
        gen = get_model_class(STYLE)(**kw, **{flag: True}, pallas_tade_min_t=1,
                                     pallas_tade_train_min_t=1)
        with torch.inference_mode():
            if flag == "use_pallas_tade":
                with pytest.raises(ValueError, match="scale 4"):
                    gen(c, z)
            else:  # the train gate sends the scale-4 block to its module
                assert gen(c, z).shape == (1, 1, 80)


def test_fused_path_refuses_an_ungated_block_without_module():
    rs = np.random.RandomState(6)
    blk = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in _rand_block(rs).items()}
    with pytest.raises(ValueError, match="no module"):
        port_td.fused_tade_blocks(torch.zeros(1, 8, C), torch.zeros(1, 8, C), [blk],
                                  min_fused_t=64)


def test_cuda_input_checks_raise_on_what_the_kernels_do_not_take():
    rs = np.random.RandomState(7)
    blk = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in _rand_block(rs).items()}
    x = torch.zeros(1, 100, C)
    port_td._check_cuda_inputs(x, x, blk)  # accepted
    with pytest.raises(ValueError, match="width 64 only"):
        port_td._check_cuda_inputs(torch.zeros(1, 100, 32), x, blk)
    with pytest.raises(ValueError, match="float32"):
        port_td._check_cuda_inputs(x.double(), x, blk)
    with pytest.raises(ValueError, match="contiguous"):
        port_td._check_cuda_inputs(torch.zeros(1, C, 100).transpose(1, 2), x, blk)
    with pytest.raises(ValueError, match="scale 1 or 2"):
        port_td._check_cuda_inputs(x, x, dict(blk, scale=3))
    with pytest.raises(ValueError, match="dilation"):
        port_td._check_cuda_inputs(x, x, dict(blk, dilation=5))


@functools.lru_cache(maxsize=None)
def _jax_init(use_weight_norm=True):
    params = dict(SMALL, use_weight_norm=use_weight_norm)
    g = jax_model_class(STYLE)(**params)
    c = jnp.zeros((1, 20, 20))
    z = jnp.zeros((1, 2, 16))
    v = g.init(jax.random.key(0), c, z)
    return params, jax.tree_util.tree_map(np.asarray, v)


def _inputs(seed=8, b=2, tz=4):
    rs = np.random.RandomState(seed)
    c = rs.randn(b, tz * 10, 20).astype(np.float32)
    z = rs.randn(b, tz, 16).astype(np.float32)
    return c, z


@pytest.mark.parametrize("flag", [None, "use_pallas_tade", "use_pallas_tade_train"])
def test_generator_matches_jax(flag, monkeypatch):
    monkeypatch.setenv("PALLAS_INTERPRET_OK", "1")
    params, v = _jax_init()
    # block inputs 40, 80, 160: min_t 64 gates blocks 1 and 2
    flags = {} if flag is None else {flag: True, "pallas_tade_min_t": 64,
                                      "pallas_tade_tile": 16,
                                      "pallas_tade_train_min_t": 64,
                                      "pallas_tade_train_tile": 16}
    c, z = _inputs()
    want = np.asarray(jax_model_class(STYLE)(**params, **flags).apply(
        v, jnp.asarray(c), jnp.asarray(z)))
    port = get_model_class(STYLE)(**params, **flags).eval()
    port.load_state_dict(jax_params_to_state_dict(STYLE, params, v), strict=True)
    # each gated block runs the plain first half once on the CPU: through
    # fused_tade_blocks with the decode flag, tade_block_train with the train one
    mod = port_tt if flag == "use_pallas_tade_train" else port_td
    seen, real = [], mod.tade1_reference

    def spy(x, *args):
        seen.append(x.shape[1])
        return real(x, *args)

    monkeypatch.setattr(mod, "tade1_reference", spy)
    with torch.no_grad():
        got = port(torch.from_numpy(c).transpose(1, 2), torch.from_numpy(z).transpose(1, 2))
    assert got.shape == (2, 1, 40 * 4)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=TOL)
    assert seen == ([] if flag is None else [80, 160])


@pytest.mark.parametrize("use_weight_norm", [True, False])
def test_jax_params_round_trip_exact(use_weight_norm):
    params, v = _jax_init(use_weight_norm)
    sd = jax_params_to_state_dict(STYLE, params, v)
    back, _ = convert_state_dict(STYLE, params, {k: t.numpy() for k, t in sd.items()})
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert want.keys() == got.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a, err_msg=str(path))


def test_port_state_dict_is_upstream_checkpoint():
    """Port module -> state dict -> the JAX converter -> JAX apply."""
    port = get_model_class(STYLE)(**SMALL, generator=torch.Generator().manual_seed(3))
    keys = set(port.state_dict())
    for k in ("noise_upsample.0.weight_v", "noise_upsample.2.weight_g",
              "blocks.0.tade1.aux_conv.0.weight_v", "blocks.0.tade1.gated_conv.0.bias",
              "blocks.1.gated_conv1.weight_g", "blocks.2.tade2.aux_conv.0.bias",
              "blocks.2.gated_conv2.weight_v", "output_conv.0.weight_v"):
        assert k in keys, k
    assert port.noise_upsample[0].weight_g.shape == (16, 1, 1)  # deconv: per Cin
    assert port.blocks[0].tade1.aux_conv[0].weight_v.shape == (64, 20, 9)
    params, _ = convert_state_dict(
        STYLE, SMALL, {k: t.detach().numpy() for k, t in port.state_dict().items()})
    c, z = _inputs(9)
    want = np.asarray(jax_model_class(STYLE)(**SMALL).apply(
        {"params": params}, jnp.asarray(c), jnp.asarray(z)))
    with torch.no_grad():
        got = port(torch.from_numpy(c).transpose(1, 2), torch.from_numpy(z).transpose(1, 2))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=TOL)


def test_random_init_is_seeded_normal_002_and_z_from_the_generator():
    cls = get_model_class(STYLE)
    kw = dict(SMALL, use_weight_norm=False)
    a = cls(**kw, generator=torch.Generator().manual_seed(7))
    b = cls(**kw, generator=torch.Generator().manual_seed(7))
    for k, t in a.state_dict().items():
        torch.testing.assert_close(t, b.state_dict()[k], rtol=0, atol=0)
    for m in (a.noise_upsample[0], a.blocks[1].gated_conv2, a.output_conv[0]):
        assert abs(float(m.weight.detach().std()) - 0.02) < 0.003
    c = torch.randn(1, 20, 10, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y1 = a(c, generator=torch.Generator().manual_seed(2))
        y2 = a(c, generator=torch.Generator().manual_seed(2))
    assert y1.shape == (1, 1, 40)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)


@pytest.mark.parametrize("flag", ["use_pallas_tade", "use_pallas_tade_train", None])
def test_training_forward_through_the_kernel_raises(flag):
    """Under grad the decode flag raises (its wrapper is inference-only, as
    JAX's); the train flag trains its gated blocks (1 and 2) through
    ``fused_tade_blocks_train``, with non-zero gradients reaching their
    weight norm; the plain path trains."""
    c, z = _inputs(10, b=1, tz=2)
    args = (torch.from_numpy(c).transpose(1, 2), torch.from_numpy(z).transpose(1, 2))
    flags = {} if flag is None else {flag: True}
    port = get_model_class(STYLE)(**SMALL, **flags, pallas_tade_min_t=1,
                                  pallas_tade_train_min_t=1)
    if flag == "use_pallas_tade":
        with pytest.raises(RuntimeError, match="inference-only"):
            port(*args)
        return
    port(*args).sum().backward()
    for blk in port.blocks:
        for conv in (blk.tade1.aux_conv[0], blk.gated_conv1, blk.tade2.gated_conv[0],
                     blk.gated_conv2):
            for p in (conv.weight_v, conv.weight_g, conv.bias):
                assert p.grad is not None and float(p.grad.abs().max()) > 0


def _write_style(tmp_path, frames=(25, 41), **flags):
    exp, dump = tmp_path / "exp", tmp_path / "dump"
    exp.mkdir()
    dump.mkdir()
    gp = dict(SMALL, **flags)
    gen = get_model_class(STYLE)(**gp, generator=torch.Generator().manual_seed(0))
    ckpt = str(exp / "checkpoint-2steps.pkl")
    save_checkpoint(ckpt, gen.state_dict(), steps=2)
    rs = np.random.RandomState(11)
    mels = {}
    for i, n in enumerate(frames):
        mels[f"utt{i}-feats"] = rs.randn(n, 20).astype(np.float32)
        np.save(dump / f"utt{i}-feats.npy", mels[f"utt{i}-feats"])
    config = {"sampling_rate": 16000, "hop_size": 4, "format": "npy",
              "generator_type": STYLE, "generator_params": gp}
    cfg = str(exp / "config.json")
    with open(cfg, "w") as f:
        json.dump(config, f)
    return ckpt, cfg, str(dump), config, mels


def test_forward_padded_matches_jax_forward_fn(tmp_path, monkeypatch):
    monkeypatch.setenv("PALLAS_INTERPRET_OK", "1")
    ckpt, _, _, config, mels = _write_style(
        tmp_path, use_pallas_tade=True, pallas_tade_min_t=64, pallas_tade_tile=16)
    model = load_model(ckpt, config, device="cpu")
    assert model.generator._kernel_cache is not None  # folded once
    jax_model = jax_load_model(ckpt, config)
    fn = jax_model._forward_fn()
    rs = np.random.RandomState(12)
    for mel in mels.values():
        noise_len = -(-((mel.shape[0] - 1) // 10 + 1) // 4) * 4
        z = rs.randn(noise_len, 16).astype(np.float32)
        want = np.asarray(fn(jnp.asarray(mel), jnp.asarray(z)))
        with torch.inference_mode():
            got = model.forward_padded(torch.from_numpy(mel), torch.from_numpy(z))
        assert got.shape == want.shape == (noise_len * 10 * 4, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("frames,noise_len", [(25, 4), (41, 8), (80, 8), (81, 12)])
def test_inference_rounds_the_noise_to_a_multiple_of_4(tmp_path, frames, noise_len,
                                                       monkeypatch):
    ckpt, _, _, config, _ = _write_style(tmp_path, frames=())
    model = load_model(ckpt, config, device="cpu")
    seen = []
    real = model.forward_padded

    def spy(c, z):
        seen.append((tuple(c.shape), tuple(z.shape)))
        return real(c, z)

    monkeypatch.setattr(model, "forward_padded", spy)
    mel = np.random.RandomState(13).randn(frames, 20).astype(np.float32)
    y = model.inference(mel, rng=torch.Generator().manual_seed(0))
    assert seen == [((frames, 20), (noise_len, 16))]
    assert y.shape == (frames * 4, 1) and np.isfinite(y).all()
    # the JAX package pads to noise_len * 10 frames too; upstream to ceil(T / 10)
    z = torch.randn(noise_len, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = real(torch.from_numpy(mel), z)[: frames * 4]
    torch.testing.assert_close(torch.from_numpy(y), want, rtol=0, atol=0)


def test_decode_cli_decodes_style_melgan(tmp_path):
    from scipy.io import wavfile

    ckpt, cfg, dump, _, mels = _write_style(tmp_path, use_pallas_tade=True,
                                            pallas_tade_min_t=64)
    outs = {}
    for name in ("a", "b"):
        np.random.seed(0)  # the same noise in both runs
        res = decode.main(["--dumpdir", dump, "--outdir", str(tmp_path / name),
                           "--checkpoint", ckpt, "--config", cfg, "--device", "cpu",
                           "--verbose", "0"])
        assert len(res["rtfs"]) == len(mels)
        outs[name] = {u: wavfile.read(tmp_path / name / f"{u}_gen.wav")[1] for u in mels}
    for utt, mel in mels.items():
        a, b = outs["a"][utt], outs["b"][utt]
        assert a.shape == (mel.shape[0] * 4,) and np.abs(a).max() > 0
        np.testing.assert_array_equal(a, b)


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    return smoke


def test_chip_smoke_style_melgan_v1_parameters_equal_shipped_config():
    yaml = pytest.importorskip("yaml")
    smoke = _chip_smoke()
    with open(V1_YAML) as f:
        cfg = yaml.safe_load(f)
    assert smoke.V1_STYLE_GENERATOR == cfg["generator_params"]
    assert cfg["generator_type"] == STYLE
    for k, v in smoke.V1_FEATURES.items():
        assert cfg[k] == v, k
    gen = get_model_class(STYLE)(**cfg["generator_params"], use_pallas_tade=True)
    assert gen.use_fused and gen.min_fused_t == 4096
    assert (gen.noise_upsample_factor, gen.upsample_factor) == (88, 256)
