"""Port of the HiFi-GAN generator held against the JAX package.

Parameters made by the JAX ``G.init`` go into the port through
``jax_params_to_state_dict``; the same numpy mel goes through both
generators. Tolerance atol 1e-4 on the tanh output (float32 convolutions
summed in another order by XLA and by PyTorch).
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
from parallelwavegan_tpu_torch.convert.jax_params import (  # noqa: E402
    jax_params_to_state_dict,
)
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402

# tests/test_hifigan_tail_kernel.py:85-90: channels 32, scales 4.4.2.2, so
# the tail gate is on (entry width 8, a power of two <= 128)
SMALL = dict(
    in_channels=6, out_channels=1, channels=32, kernel_size=7,
    upsample_scales=(4, 4, 2, 2), upsample_kernel_sizes=(8, 8, 4, 4),
    resblock_kernel_sizes=(3, 7, 11),
    resblock_dilations=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
)


C_IN = np.random.RandomState(0).randn(2, 37, 6).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_params(use_weight_norm=True):
    """JAX ``G.init`` parameters (the tail flag does not change the tree)."""
    g = jax_model_class("HiFiGANGenerator")(**SMALL,
                                            use_weight_norm=use_weight_norm)
    v = g.init(jax.random.key(0), jnp.asarray(C_IN))
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.mark.parametrize("use_weight_norm", [True, False])
def test_jax_params_round_trip_exact(use_weight_norm):
    params = dict(SMALL, use_weight_norm=use_weight_norm)
    v = _jax_params(use_weight_norm)
    sd = jax_params_to_state_dict("HiFiGANGenerator", params, v)
    back, _ = convert_state_dict("HiFiGANGenerator", params,
                                 {k: t.numpy() for k, t in sd.items()})
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert want.keys() == got.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a, err_msg=str(path))
    # the keys are the port module's own (strict load)
    port = get_model_class("HiFiGANGenerator")(**params)
    port.load_state_dict(sd, strict=True)


def test_port_state_dict_has_upstream_keys():
    port = get_model_class("HiFiGANGenerator")(**SMALL)
    keys = set(port.state_dict())
    for k in ("input_conv.weight_g", "input_conv.weight_v", "input_conv.bias",
              "upsamples.3.1.weight_g", "upsamples.0.1.weight_v",
              "blocks.11.convs1.2.1.weight_v", "blocks.0.convs2.0.1.bias",
              "output_conv.1.weight_g", "output_conv.1.bias"):
        assert k in keys, k
    assert port.upsamples[0][1].weight_g.shape == (32, 1, 1)  # per Cin
    assert port.input_conv.weight_g.shape == (32, 1, 1)       # per Cout


@pytest.mark.parametrize("use_pallas_tail", [False, True])
def test_generator_matches_jax(use_pallas_tail):
    g = jax_model_class("HiFiGANGenerator")(
        **SMALL, use_pallas_tail=use_pallas_tail, pallas_tail_tile=64)
    v, c = _jax_params(), C_IN
    want = np.asarray(g.apply(v, jnp.asarray(c)))

    port = get_model_class("HiFiGANGenerator")(
        **SMALL, use_pallas_tail=use_pallas_tail)
    assert (port.tail_from is not None) == use_pallas_tail
    port.load_state_dict(jax_params_to_state_dict("HiFiGANGenerator", SMALL, v))
    with torch.no_grad():
        got = port(torch.from_numpy(c.transpose(0, 2, 1))).numpy()
        port.remove_weight_norm()
        port.prepare_kernels()
        folded = port(torch.from_numpy(c.transpose(0, 2, 1))).numpy()
    assert got.shape == (2, 1, 37 * 64)
    np.testing.assert_allclose(got.transpose(0, 2, 1), want, atol=1e-4)
    np.testing.assert_allclose(folded, got, atol=1e-5)


def test_tail_gate_follows_jax_conditions():
    cls = get_model_class("HiFiGANGenerator")
    assert cls(**SMALL, use_pallas_tail=True).tail_from == 2
    # v1 widths: entry width 512 / 4 = 128 -> tail from stage 2, pre-MRF
    assert cls(channels=512, use_pallas_tail=True).tail_from == 2
    # not a power of two at the tail entry
    assert cls(**dict(SMALL, channels=24), use_pallas_tail=True).tail_from is None
    # no additional convs, or other last strides: plain path
    assert cls(**dict(SMALL, use_additional_convs=False),
               use_pallas_tail=True).tail_from is None
    assert cls(**dict(SMALL, upsample_scales=(4, 2, 4, 2),
                      upsample_kernel_sizes=(8, 4, 8, 4)),
               use_pallas_tail=True).tail_from is None
    # two stages only: the tail starts at stage 0 (no pre-MRF)
    assert cls(**dict(SMALL, upsample_scales=(2, 2), upsample_kernel_sizes=(4, 4)),
               use_pallas_tail=True).tail_from == 0


def test_two_stage_tail_matches_plain_path():
    params = dict(SMALL, channels=16, upsample_scales=(2, 2),
                  upsample_kernel_sizes=(4, 4))
    gen = torch.Generator().manual_seed(3)
    cls = get_model_class("HiFiGANGenerator")
    plain = cls(**params, generator=gen)
    tail = cls(**params, use_pallas_tail=True)
    tail.load_state_dict(plain.state_dict())
    c = torch.from_numpy(np.random.RandomState(1).randn(1, 6, 21).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(tail(c), plain(c), atol=1e-5, rtol=0)


def test_tail_refuses_a_training_forward():
    port = get_model_class("HiFiGANGenerator")(**SMALL, use_pallas_tail=True)
    c = torch.zeros(1, 6, 5)
    with pytest.raises(RuntimeError, match="inference-only"):
        port(c)
    with torch.inference_mode():
        assert port(c).shape == (1, 1, 5 * 64)


def test_registry_names_unported_models():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model_class("CausalHiFiGANGenerator")
    # the causal HiFi-GAN is ported, as the JAX package has it: a flag of
    # HiFiGANGenerator, under upstream's causal keys
    keys = get_model_class("HiFiGANGenerator")(**SMALL, use_causal_conv=True).state_dict()
    assert {"input_conv.conv.weight_v", "upsamples.0.1.deconv.weight_v",
            "output_conv.1.conv.weight_v"} <= set(keys)


def test_random_init_is_seeded():
    cls = get_model_class("HiFiGANGenerator")
    a = cls(**SMALL, generator=torch.Generator().manual_seed(7)).state_dict()
    b = cls(**SMALL, generator=torch.Generator().manual_seed(7)).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
