"""The discrete-symbol (HuBERT-unit) vocoders of the port held against the
JAX package on the CPU: the duration layers (LayerNorm, DurationPredictor,
length_regulator, repeat_by_durations_np), the three generators through
the converters (speaker embeddings added and concatenated, and with
``use_pallas_tail`` / ``use_pallas_tade``, whose plain versions run here
against JAX's trunk), the duration collater, ``InferenceModel``'s discrete
decode against JAX's ``_inference_discrete``, the TADE gate at the hubert
StyleMelGAN's blocks, and the duration predictor's dropout.

Inputs are made with numpy from seeds and fed to both packages; JAX
matmuls run at ``highest``. Tolerance: 2e-4 absolute (the port's parity
TOL) on outputs of order one, exact for ids, durations and batches.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.convert.torch_checkpoint import (  # noqa: E402
    convert_state_dict,
)
from parallelwavegan_tpu.data.collater import Collater as JaxCollater  # noqa: E402
from parallelwavegan_tpu.layers import duration as jax_duration  # noqa: E402
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.utils.model import InferenceModel as JaxInferenceModel  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.data.collater import Collater  # noqa: E402
from parallelwavegan_tpu_torch.layers import duration  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_decode as k8  # noqa: E402
from parallelwavegan_tpu_torch.utils.model import InferenceModel  # noqa: E402

HIFI, DUR, STYLE = ("DiscreteSymbolHiFiGANGenerator", "DiscreteSymbolDurationGenerator",
                    "DiscreteSymbolStyleMelGANGenerator")
TOL = 2e-4
# the hubert trunk's shape at small widths: four stages, kernels 2s, the
# last two of scale 2 (K1's), 64 samples per id
SMALL_HIFI = dict(in_channels=16, out_channels=1, channels=32, num_embs=7,
                  num_spk_embs=3, spk_emb_dim=16, kernel_size=7,
                  upsample_scales=[4, 4, 2, 2], upsample_kernel_sizes=[8, 8, 4, 4],
                  resblock_kernel_sizes=[3, 5], resblock_dilations=[[1, 3], [1, 2]])
SMALL_DUR = dict(SMALL_HIFI, num_spk_embs=0, duration_layers=2, duration_chans=12,
                 duration_kernel_size=3, duration_dropout_rate=0.5)
# width 64 (the TADE kernels'), noise x8, blocks x5, x2, x1 as hubert's
# first, middle and last; min_t 80 gates blocks 1-2 at 8 ids
SMALL_STYLE = dict(in_channels=16, aux_channels=20, channels=64, out_channels=1,
                   num_embs=9, num_spk_embs=3, spk_emb_dim=20, kernel_size=9,
                   dilation=2, noise_upsample_scales=[4, 2], upsample_scales=[5, 2, 1])


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ids(rs, b, t, vocab, spk=None):
    """Ids (B, T, 1|2) in the JAX layout: units, and a speaker per item."""
    u = rs.randint(0, vocab, (b, t, 1))
    if spk is None:
        return u.astype(np.int32)
    s = np.broadcast_to(rs.randint(0, spk, (b, 1, 1)), (b, t, 1))
    return np.concatenate([u, s], axis=-1).astype(np.int32)


def _ncl(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


# ---------------------------------------------------------------------------
# the duration layers
# ---------------------------------------------------------------------------


def test_layer_norm_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 9, 6).astype(np.float32) * 3 + 1
    scale, bias = rs.randn(6).astype(np.float32), rs.randn(6).astype(np.float32)
    want = jax_duration.LayerNorm(6).apply({"params": {"scale": scale, "bias": bias}},
                                           jnp.asarray(x))
    norm = duration.LayerNorm(6)
    norm.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    got = norm(_ncl(x)).transpose(1, 2).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def test_duration_predictor_matches_jax_in_eval():
    """Log-domain output and the integer durations of ``inference``
    (exact, away from the rounding's ties); the head's bias moved so the
    durations spread over 0-9."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 15, 10).astype(np.float32)
    jp = jax_duration.DurationPredictor(idim=10, n_layers=2, n_chans=12, dropout_rate=0.5)
    params = _np(jax.jit(jp.init)(jax.random.key(0), jnp.asarray(x)))["params"]
    params["linear_bias"] = np.array([1.2], np.float32)
    port = duration.DurationPredictor(10, n_layers=2, n_chans=12, dropout_rate=0.5)
    port.load_state_dict(jax_params_to_state_dict("DurationPredictor", {}, params),
                         strict=True)
    port.eval()
    want = np.asarray(jax.jit(jp.apply)({"params": params}, jnp.asarray(x)))
    got = port(_ncl(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    want_d = np.asarray(jax.jit(partial(jp.apply, method="inference"))(
        {"params": params}, jnp.asarray(x)))
    got_d = port.inference(_ncl(x)).numpy()
    lin = np.exp(want) - 1.0
    away = np.abs(lin - np.floor(lin) - 0.5) > 1e-3
    assert away.mean() > 0.95 and len(np.unique(want_d)) > 4
    np.testing.assert_array_equal(got_d[away], want_d[away])
    masks = np.zeros((2, 15), bool)
    masks[:, -3:] = True
    masked = port(_ncl(x), torch.from_numpy(masks)).detach().numpy()
    np.testing.assert_array_equal(masked[masks], 0.0)


@pytest.mark.parametrize("bias", [True, False])
def test_variance_predictor_matches_jax(bias):
    """FastSpeech2's variance predictor (upstream's keys are the duration
    predictor's, so the converter's ``DurationPredictor`` map serves it),
    masked positions zeroed."""
    rs = np.random.RandomState(12)
    x = rs.randn(2, 11, 6).astype(np.float32)
    masks = np.zeros((2, 11), bool)
    masks[1, -4:] = True
    jp = jax_duration.VariancePredictor(idim=6, n_layers=2, n_chans=8, bias=bias)
    params = _np(jax.jit(jp.init)(jax.random.key(1), jnp.asarray(x)))["params"]
    want = np.asarray(jax.jit(jp.apply)({"params": params}, jnp.asarray(x),
                                        jnp.asarray(masks)))
    port = duration.VariancePredictor(6, n_layers=2, n_chans=8, bias=bias).eval()
    port.load_state_dict(jax_params_to_state_dict("DurationPredictor", {}, params),
                         strict=True)
    with torch.no_grad():
        got = port(_ncl(x), torch.from_numpy(masks)).numpy()
    assert got.shape == want.shape == (2, 11, 1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert (got[masks] == 0).all() and np.abs(got[~masks]).min() > 0


@pytest.mark.parametrize("out_length", [12, 30])
def test_length_regulator_matches_jax_and_the_host_expansion(out_length):
    """The static gather against JAX's on durations with zeros, an output
    shorter and one longer than sum(ds); against ``repeat_by_durations_np``
    where sum(ds) equals out_length."""
    rs = np.random.RandomState(2)
    xs = rs.randn(3, 7, 4).astype(np.float32)
    ds = rs.randint(0, 4, (3, 7)).astype(np.int32)
    ds[1] = 0
    ds[1, 3] = 5
    want = np.asarray(jax_duration.length_regulator(jnp.asarray(xs), jnp.asarray(ds),
                                                    out_length))
    got = duration.length_regulator(_ncl(xs), torch.from_numpy(ds), out_length)
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want)
    ds2 = np.array([[3, 0, 2, 1, 4, 0, 2]] * 2, np.int32)
    full = duration.length_regulator(_ncl(xs[:2]), torch.from_numpy(ds2), 12)
    for i in range(2):
        np.testing.assert_array_equal(full[i].T.numpy(),
                                      duration.repeat_by_durations_np(xs[i], ds2[i]))


@pytest.mark.parametrize("d,alpha", [([2, 0, 3, 1], 1.0), ([0, 0, 0], 1.0),
                                     ([2, -1, 3], 1.0), ([1, 2, 3], 1.5)])
def test_repeat_by_durations_np_matches_jax(d, alpha):
    x = np.arange(len(d) * 2, dtype=np.float32).reshape(len(d), 2)
    d = np.array(d, np.int32)
    np.testing.assert_array_equal(duration.repeat_by_durations_np(x, d, alpha),
                                  jax_duration.repeat_by_durations_np(x, d, alpha))


# ---------------------------------------------------------------------------
# the generators through the converters
# ---------------------------------------------------------------------------


def _pair(model_type, kw, seed, **flags):
    """(the port's generator in eval mode, the JAX generator, its params):
    the port's init from ``seed`` with every weight-norm scale g set to 1.2
    (the outputs then spread with a std near 0.2, where the N(0, 0.01) and
    N(0, 0.02) inits leave them near a constant 0.04 and 2e-4 would hold
    little; from 1.4 up HiFi-GAN's tanh saturates),
    carried to JAX by its ``convert_state_dict``; the port's converter
    gives the state dict back exactly. ``flags`` are the port's alone."""
    port = get_model_class(model_type)(**kw, **flags,
                                       generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith("weight_g"):
                p.fill_(1.2)
    sd = {k: v.detach().numpy().copy() for k, v in port.state_dict().items()}
    params = convert_state_dict(model_type, kw, sd)[0]
    back = jax_params_to_state_dict(model_type, kw, {"params": params})
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    return port.eval(), jax_model_class(model_type)(**kw), params


HIFI_CASES = [
    ("add", dict(SMALL_HIFI), {}),
    ("concat", dict(SMALL_HIFI, concat_spk_emb=True), {}),
    ("no speaker", dict(SMALL_HIFI, num_spk_embs=0), {}),
    ("tail", dict(SMALL_HIFI), {"use_pallas_tail": True}),
]


@pytest.mark.parametrize("name,kw,flags", HIFI_CASES, ids=[c[0] for c in HIFI_CASES])
def test_discrete_hifigan_matches_jax(name, kw, flags):
    """The port's forward against JAX ``apply`` on the same ids (float32, as
    the collater gives them); with ``use_pallas_tail`` the port's tail runs
    K1's plain version (stage 1's MRF folded in, stages 2-3)."""
    c = _ids(np.random.RandomState(3), 2, 9, kw["num_embs"], kw["num_spk_embs"] or None)
    port, jg, params = _pair(HIFI, kw, 1, **flags)
    want = np.asarray(jax.jit(jg.apply)({"params": params}, jnp.asarray(c)))
    assert port.tail_from == (2 if flags else None)
    with torch.inference_mode():
        got = port(_ncl(c.astype(np.float32))).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, 9 * 64, 1)
    assert np.std(want) > 0.05
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_discrete_trunk_pads_as_jax_at_an_odd_kernel():
    """(K - s) // 2 with no output padding, any K: K = 5 at s = 2 gives
    2T + 1 samples (K = 7 at s = 3 gives 3T), and the K1 gate refuses a last
    stage of K != 2s, as JAX's."""
    kw = dict(SMALL_HIFI, num_spk_embs=0, upsample_scales=[3, 2, 2],
              upsample_kernel_sizes=[7, 4, 5], resblock_kernel_sizes=[3],
              resblock_dilations=[[1]])
    c = _ids(np.random.RandomState(4), 1, 6, kw["num_embs"])
    port, jg, params = _pair(HIFI, kw, 2, use_pallas_tail=True)
    want = np.asarray(jax.jit(jg.apply)({"params": params}, jnp.asarray(c)))
    assert port.tail_from is None
    with torch.no_grad():
        got = port(_ncl(c)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (1, (6 * 3 * 2) * 2 + 1, 1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("kw", [SMALL_DUR, dict(SMALL_DUR, num_spk_embs=3,
                                                concat_spk_emb=True)],
                         ids=["no speaker", "concat"])
def test_duration_generator_matches_jax(kw):
    """The teacher-forced forward (wave, log-durations) in eval mode and the
    decode pieces (``predict_durations``, ``embed_tokens``,
    ``decode_expanded``), each against JAX's, the vocabulary's padding
    symbol (id num_embs) included."""
    rs = np.random.RandomState(5)
    c = _ids(rs, 2, 8, kw["num_embs"] + 1, kw["num_spk_embs"] or None)
    ds = rs.randint(0, 4, (2, 8)).astype(np.int32)
    port, jg, params = _pair(DUR, kw, 3)
    v, cj = {"params": params}, jnp.asarray(c)
    wave, d_out = jax.jit(jg.apply, static_argnums=3)(v, cj, jnp.asarray(ds), 16)
    assert port.emb.num_embeddings == kw["num_embs"] + 1
    with torch.no_grad():
        got, got_d = port(_ncl(c), torch.from_numpy(ds), 16)
        emb = port.embed_tokens(_ncl(c))
        pred = port.predict_durations(_ncl(c))
        again = port.decode_expanded(duration.length_regulator(emb, torch.from_numpy(ds), 16))
    assert got.shape == (2, 1, 16 * 64) and np.std(np.asarray(wave)) > 0.05
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(wave), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(d_out), atol=TOL, rtol=0)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    want_emb = jax.jit(partial(jg.apply, method="embed_tokens"))(v, cj)
    np.testing.assert_array_equal(emb.transpose(1, 2).numpy(), np.asarray(want_emb))
    want_d = jax.jit(partial(jg.apply, method="predict_durations"))(v, cj)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(want_d))


STYLE_CASES = [
    ("add", dict(SMALL_STYLE), {}),
    ("concat", dict(SMALL_STYLE, spk_emb_dim=8, concat_spk_emb=True), {}),
    ("tade", dict(SMALL_STYLE), {"use_pallas_tade": True, "pallas_tade_min_t": 80}),
]


@pytest.mark.parametrize("name,kw,flags", STYLE_CASES, ids=[c[0] for c in STYLE_CASES])
def test_discrete_style_melgan_matches_jax(name, kw, flags, monkeypatch):
    """With the same z; with ``use_pallas_tade`` blocks 1-2 (aux 64) run
    ``fused_tade_blocks``' plain version, block 0 (aux 20) its own forward."""
    rs = np.random.RandomState(6)
    c = _ids(rs, 2, 16, kw["num_embs"], kw["num_spk_embs"])
    z = rs.randn(2, 2, kw["in_channels"]).astype(np.float32)
    port, jg, params = _pair(STYLE, kw, 4, **flags)
    want = np.asarray(jax.jit(jg.apply)({"params": params}, jnp.asarray(c), jnp.asarray(z)))
    seen, real = [], k8.tade_block_reference

    def spy(x, *args, **kwargs):
        seen.append(x.shape[1])
        return real(x, *args, **kwargs)

    monkeypatch.setattr(k8, "tade_block_reference", spy)
    with torch.no_grad():
        got = port(_ncl(c), _ncl(z)).transpose(1, 2).numpy()
    assert seen == ([80, 160] if flags else [])
    assert got.shape == want.shape == (2, 16 * 10, 1)
    assert np.std(want) > 0.05
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_hubert_style_melgan_first_block_fails_the_width_test_before_the_scale_test():
    """style_melgan_hubert.v1.yaml's generator: block 0 (scale 5, aux 128)
    is refused by the decode gate at any length instead of raising on its
    scale; at 512 ids (560 frames) decode gates blocks 2-8, and the train
    gate at the 56-frame crop blocks 3-8."""
    gp = dict(in_channels=128, aux_channels=128, channels=64, num_embs=100,
              num_spk_embs=128, spk_emb_dim=128, noise_upsample_scales=[7, 2, 2, 2],
              upsample_scales=[5, 2, 2, 2, 2, 2, 2, 1, 1], use_pallas_tade=True)
    blocks = get_model_class(STYLE)(**gp).block_weights()
    assert not k8.gated(8192, blocks[0], min_fused_t=4096)
    wrong = dict(blocks[0], aux1_w=blocks[1]["aux1_w"])  # the scale test, were it reached
    with pytest.raises(ValueError, match="scale 1 or 2"):
        k8.gated(8192, wrong, min_fused_t=4096)

    def walk(t, **kw):
        out = []
        for i, blk in enumerate(blocks):
            if k8.gated(t, blk, **kw):
                out.append((i, t))
            t *= blk["scale"]
        return out

    decode = walk(560, min_fused_t=4096)
    assert [i for i, _ in decode] == list(range(2, 9))
    assert (decode[0][1], decode[-1][1]) == (5600, 179200)
    assert walk(56, min_fused_t=1024, train=True) == [
        (3, 1120), (4, 2240), (5, 4480), (6, 8960), (7, 17920), (8, 17920)]


def test_duration_predictor_drops_in_training_and_not_in_eval():
    """The predictor's dropout (rate 0.5) zeroes about half its inputs in
    train mode, scaling the rest by 2, with masks from the generator it is
    given (the same seed, the same output), and none in eval; the wave
    does not pass through it."""
    x = torch.randn(4, 12, 500, generator=torch.Generator().manual_seed(1)) + 3.0
    dropped = duration.dropout(x, 0.5, True, torch.Generator().manual_seed(2))
    kept = dropped != 0
    assert 0.48 < float(kept.float().mean()) < 0.52
    torch.testing.assert_close(dropped[kept], 2 * x[kept], rtol=0, atol=0)
    assert duration.dropout(x, 0.5, False) is x
    port = get_model_class(DUR)(**SMALL_DUR, generator=torch.Generator().manual_seed(0))
    c = torch.from_numpy(_ids(np.random.RandomState(7), 4, 64,
                              SMALL_DUR["num_embs"])).transpose(1, 2)
    ds = torch.ones(4, 64, dtype=torch.long)

    def run(train, seed=0):
        with torch.no_grad():
            return port.train(train)(c, ds, 64, torch.Generator().manual_seed(seed))

    (wave_t, d_t), (_, d_again), (_, d_other) = run(True), run(True), run(True, 1)
    wave_e, d_e = run(False)
    torch.testing.assert_close(d_t, d_again, rtol=0, atol=0)
    assert not torch.equal(d_t, d_other) and not torch.equal(d_t, d_e)
    torch.testing.assert_close(d_e, run(False, 1)[1], rtol=0, atol=0)
    torch.testing.assert_close(wave_t, wave_e, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the collater and decode
# ---------------------------------------------------------------------------


def _token_items(rs, n, spk):
    """(audio, ids) items of 20-40 frames, hop 8: runs of 1-4 equal units."""
    items = []
    for _ in range(n):
        units = np.repeat(rs.randint(0, 7, 40), rs.randint(1, 5, 40))[:rs.randint(20, 40)]
        feats = units[:, None].astype(np.float32)
        if spk:
            feats = np.concatenate([feats, np.full_like(feats, rs.randint(0, 3))], axis=1)
        items.append(((0.3 * rs.randn(len(feats) * 8 - 3)).astype(np.float32), feats))
    return items


@pytest.mark.parametrize("use_duration,spk", [(True, False), (True, True), (False, True)])
def test_collater_matches_jax_bit_for_bit(use_duration, spk):
    """Three batches from one seed: the duration branch's collapsed codes
    and durations (int32, padded with pad_value and 0) and the plain
    discrete branch's float32 ids, equal to JAX's."""
    items = _token_items(np.random.RandomState(8), 5, spk)
    kw = dict(batch_max_steps=80, hop_size=8, aux_context_window=0,
              use_duration=use_duration, pad_value=7)
    port = Collater(**kw, rng=np.random.default_rng(3))
    ref = JaxCollater(**kw, rng=np.random.default_rng(3))
    for _ in range(3):
        got, want = port(items), ref(items)
        assert sorted(got) == sorted(want) == sorted(["c", "y"] + ["ds"] * use_duration)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    if use_duration:
        assert (got["ds"].sum(1) == 10).all() and (got["c"][got["ds"] == 0] == 7).all()


def _models(model_type, kw, seed, **flags):
    """(the port's ``InferenceModel``, as ``load_model`` prepares it, and
    the JAX package's) on the weights of ``_pair``."""
    port, jg, params = _pair(model_type, kw, seed, **flags)
    port.remove_weight_norm()
    port.prepare_kernels()
    config = {"generator_type": model_type, "generator_params": kw}
    return InferenceModel(port, "cpu"), JaxInferenceModel(jg, params, config)


@pytest.mark.parametrize("t", [37, 20])
def test_inference_discrete_hifigan_matches_jax(t):
    """Ids edge-padded to the 32-frame bucket (at least one), the output
    trimmed; the port through K1's plain version."""
    c = _ids(np.random.RandomState(9), 1, t, SMALL_HIFI["num_embs"],
             SMALL_HIFI["num_spk_embs"])[0].astype(np.float32)
    pm, jm = _models(HIFI, SMALL_HIFI, 5, use_pallas_tail=True)
    want = np.asarray(jm.inference(c))
    got = pm.inference(c)
    assert got.shape == want.shape == (t * 64, 1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_inference_duration_matches_jax_with_given_and_predicted_durations():
    """Given durations bypass the predictor; predicted ones (the head's bias
    set to 1.3: about 3 frames an id) are the JAX package's, expanded on the
    host and the frames edge-padded to the bucket."""
    rs = np.random.RandomState(10)
    c = _ids(rs, 1, 12, SMALL_DUR["num_embs"])[0]
    port, jg, params = _pair(DUR, SMALL_DUR, 6)
    with torch.no_grad():
        port.duration_predictor.linear.bias.fill_(1.3)
    params["duration_predictor"]["linear_bias"] = np.array([1.3], np.float32)
    port.remove_weight_norm()
    pm = InferenceModel(port, "cpu")
    jm = JaxInferenceModel(jg, params, {"generator_type": DUR,
                                        "generator_params": SMALL_DUR})
    given = rs.randint(0, 5, 12).astype(np.int32)
    predicted = port.predict_durations(_ncl(c[None]))[0].numpy()
    assert predicted.sum() > 24
    for ds, frames in ((given, given.sum()), (None, predicted.sum())):
        want = np.asarray(jm.inference(c, ds=ds))
        got = pm.inference(c, ds=ds)
        assert got.shape == want.shape == (frames * 64, 1)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_inference_discrete_style_melgan_matches_jax_with_the_same_z(monkeypatch):
    """noise_len = (T - 1) // 8 + 1 with no rounding to a multiple of 4, the
    ids edge-padded to noise_len * 8; JAX's z from its key, given the port."""
    kw = SMALL_STYLE
    c = _ids(np.random.RandomState(11), 1, 21, kw["num_embs"], kw["num_spk_embs"])[0]
    pm, jm = _models(STYLE, kw, 7, use_pallas_tade=True, pallas_tade_min_t=80)
    key = jax.random.key(8)
    want = np.asarray(jm.inference(c, rng=key))
    z = np.array(jax.random.normal(key, (1, 3, kw["in_channels"])))  # noise_len 3
    monkeypatch.setattr(pm, "_noise", lambda shape, rng: (
        torch.from_numpy(z).transpose(1, 2) if shape == (1, 16, 3) else None))
    got = pm.inference(c)
    assert got.shape == want.shape == (21 * 10, 1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_inference_batch_refuses_the_discrete_generators():
    for model_type, kw in ((HIFI, SMALL_HIFI), (DUR, SMALL_DUR), (STYLE, SMALL_STYLE)):
        model = InferenceModel(get_model_class(model_type)(**kw), "cpu")
        with pytest.raises(ValueError, match="does not support batched decode"):
            model.inference_batch([np.zeros((5, 1), np.float32)])


def test_registry_refuses_vqvae_and_uhifigan_by_name():
    """Both names resolve since the VQ-VAE and the U-Net HiFi-GAN are
    ported; a name the registry does not have is still refused by name."""
    for name in ("VQVAE", "UHiFiGANGenerator", HIFI, DUR, STYLE):
        assert get_model_class(name).__name__ == name
    with pytest.raises(NotImplementedError, match="CausalHiFiGANGenerator"):
        get_model_class("CausalHiFiGANGenerator")
    for name in (HIFI, DUR, STYLE):
        assert get_model_class(name).__name__ == name
