"""The port's CUDA kernels on a CUDA device, against their plain versions:
the fused HiFi-GAN tail, the fused WaveNet layer (K3 stack and K5 block,
split TF32 on the tensor cores, the block's training by autograd of its
plain version) and its backward (K4, split TF32 as well),
the MelGAN stack kernel (K6) and its backward (K7), the MRF stage on the
residual-unit kernel (K2) and the StyleMelGAN TADE kernels (K8a, K8b,
decode and the backward's re-run, split TF32 on the tensor cores) and
their backward (K9a, K9b), K3, K6/K7 and K8/K9 also in their
bf16-resident modes (``-k bf16``: one bf16 product per multiply, against
plain versions that round where JAX rounds). The generator tests also check that no CUDA tensor reaches a plain
version on the main path.

The HiFi-GAN residual units run on the tensor cores in split TF32 at
widths 16-128 and on the CUDA cores below; the tests check which route
each launch took.

These tests need an NVIDIA GPU with sm_90a (Hopper) and nvcc; elsewhere
they skip. They import no JAX, so they run on a machine that has only
torch (``tests/conftest.py`` imports jax, hence ``--noconftest``):
    python -m pytest tests/test_torch_port_cuda.py -m gpu --noconftest
Tolerance 2e-4 (ROADMAP.md's kernel bound); TF32 is off for the plain
version's cuDNN convolutions.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import hifigan_mrf as mrf_mod  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import melgan_stack as stack_mod  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import tade_decode as tade_mod  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (  # noqa: E402
    fused_hifigan_tail,
    hifigan_tail_reference,
)
from parallelwavegan_tpu_torch.ops.kernels.wavenet import (  # noqa: E402
    WEIGHT_KEYS,
    fused_gated_resblock,
    fused_wavenet_cycle,
    fused_wavenet_stack,
    gated_resblock_reference,
    wavenet_stack_reference,
)
from parallelwavegan_tpu_torch.ops.kernels.wavenet_train import (  # noqa: E402
    wavenet_stack_backward,
    wavenet_stack_backward_reference,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernel is built for sm_90a (Hopper)")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = old


def _generator(channels, seed=0):
    gen = get_model_class("HiFiGANGenerator")(
        in_channels=8, channels=channels, upsample_scales=(4, 4, 2, 2),
        upsample_kernel_sizes=(8, 8, 4, 4), use_pallas_tail=True,
        generator=torch.Generator().manual_seed(seed))
    gen.remove_weight_norm()
    return gen.eval()


def _routes():
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import run_mrf

    return run_mrf.tensor_core_launches, run_mrf.cuda_core_launches


# tail widths (pre-MRF, stage 1, stage 2): 128, 64, 32 (tensor cores); 8,
# 4, 2 (CUDA cores); 32, 16, 8 (both)
@pytest.mark.parametrize("channels,b,t0", [(512, 1, 777), (512, 2, 64),
                                           (32, 3, 130), (128, 1, 1)])
def test_kernel_matches_plain_version(cuda, channels, b, t0):
    gen = _generator(channels).to(cuda)
    w = gen.tail_weights()
    c0 = channels // 4
    x = torch.from_numpy(np.random.RandomState(1).randn(b, t0, c0)
                         .astype(np.float32)).to(cuda)
    args = (x, w["stages"], w["final_w"], w["final_b"])
    kw = dict(slope=gen.slope, pre_blocks=w["pre_blocks"])
    before, routes = fused_hifigan_tail.launches, _routes()
    got = fused_hifigan_tail(*args, **kw)
    torch.cuda.synchronize()
    assert fused_hifigan_tail.launches == before + 1
    tc = sum(3 for c in (c0, c0 // 2, c0 // 4) if c >= 16)  # 3 dilation depths
    assert _routes() == (routes[0] + tc, routes[1] + 9 - tc)
    want = hifigan_tail_reference(*args, **kw)
    assert got.shape == want.shape == (b, t0 * 4, 1)
    err = float((got - want).abs().max())
    assert err <= 2e-4 and err <= 1e-4 * float(want.abs().max())


def test_kernel_is_deterministic(cuda):
    """Two runs, and runs on the split that decode keeps, bit for bit."""
    gen = _generator(512, seed=4).to(cuda)
    gen.prepare_kernels()
    w, kept = gen.tail_weights(), gen._tail_cache
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 300, 128)
                         .astype(np.float32)).to(cuda)
    outs = [fused_hifigan_tail(x, v["stages"], v["final_w"], v["final_b"],
                               slope=gen.slope, pre_blocks=v["pre_blocks"])
            for v in (w, w, kept, kept)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    blocks = kept["stages"][0]["blocks"]
    xm = torch.from_numpy(np.random.RandomState(6).randn(1, 1000, 64)
                          .astype(np.float32)).to(cuda)
    with torch.inference_mode():
        a, b = (mrf_mod.fused_hifigan_mrf(xm, blocks) for _ in range(2))
    assert torch.equal(a, b)


def test_kernel_rejects_a_wrong_split(cuda):
    """Fragments of the wrong shape, or on the CPU, raise."""
    gen = _generator(512, seed=4).to(cuda)
    gen.prepare_kernels()
    w = gen._tail_cache
    x = torch.zeros(1, 40, 128, device=cuda)
    pre = w["pre_blocks"]
    for bad, match in ((dict(pre[1], f1=pre[1]["f1"][:, :-1].contiguous()),
                        r"pre_blocks\[1\]\.f1 has shape"),
                       (dict(pre[2], f2=pre[2]["f2"].cpu()), r"pre_blocks\[2\]\.f2 is on cpu")):
        blocks = [bad if blk["w1"].shape == bad["w1"].shape else blk for blk in pre]
        with pytest.raises(ValueError, match=match):
            fused_hifigan_tail(x, w["stages"], w["final_w"], w["final_b"],
                               pre_blocks=blocks)
    with torch.inference_mode(), pytest.raises(ValueError, match=r"blocks\[0\]\.f1 has shape"):
        mrf_mod.fused_hifigan_mrf(torch.zeros(1, 40, 64, device=cuda), [
            dict(w["stages"][0]["blocks"][0], f1=pre[0]["f1"])] + w["stages"][0]["blocks"][1:])


def test_generator_decode_through_kernel(cuda):
    gen = _generator(64, seed=2).to(cuda)
    plain = get_model_class("HiFiGANGenerator")(
        in_channels=8, channels=64, upsample_scales=(4, 4, 2, 2),
        upsample_kernel_sizes=(8, 8, 4, 4))
    plain.remove_weight_norm()
    plain.load_state_dict(gen.state_dict())
    plain.eval().to(cuda)
    gen.prepare_kernels()
    c = torch.randn(2, 8, 45, generator=torch.Generator().manual_seed(3)).to(cuda)
    with torch.inference_mode():
        got, want = gen(c), plain(c)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-4


def test_kernel_rejects_unsupported_input(cuda):
    gen = _generator(32).to(cuda)
    w = gen.tail_weights()
    x = torch.zeros(1, 16, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        fused_hifigan_tail(x, w["stages"], w["final_w"], w["final_b"],
                           pre_blocks=w["pre_blocks"])


def _wavenet_weights(n_layers, ch, ca, k=3, seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"wconv": (n_layers, k, ch, 2 * ch), "bconv": (n_layers, 2 * ch),
              "waux": (n_layers, ca, 2 * ch), "wskip": (n_layers, ch, ch),
              "bskip": (n_layers, ch), "wres": (n_layers, ch, ch),
              "bres": (n_layers, ch)}
    fan = {"wconv": k * ch, "waux": ca, "wskip": ch, "wres": ch}
    return {key: torch.from_numpy((rs.randn(*shape) * (2.0 / fan.get(key, 4)) ** 0.5)
                                  .astype(np.float32))
            for key, shape in shapes.items()}


# v1 widths (64, aux 80), an odd aux width (10), and the narrow width 16
@pytest.mark.parametrize("ch,ca,b,t", [(64, 80, 1, 4099), (64, 10, 2, 1000),
                                       (16, 80, 3, 777), (64, 80, 2, 1)])
def test_wavenet_stack_matches_plain_version(cuda, ch, ca, b, t):
    dil = tuple(2 ** i for i in range(10))
    w = {k: v.to(cuda) for k, v in _wavenet_weights(len(dil), ch, ca).items()}
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(b, t, ch).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rs.randn(b, t, ca).astype(np.float32)).to(cuda)
    before = fused_wavenet_stack.launches
    with torch.inference_mode():
        got = fused_wavenet_cycle(x, c, w, dil, max_layers_per_call=5)
        torch.cuda.synchronize()
        want = wavenet_stack_reference(x, c, w, dil)
    assert fused_wavenet_stack.launches == before + len(dil)
    for g, r in zip(got, want):
        assert g.shape == r.shape == (b, t, ch)
        assert float((g - r).abs().max()) <= 2e-4


@pytest.mark.parametrize("dilation,causal,k", [(1, False, 3), (4, True, 3),
                                               (2, False, 5), (8, True, 2)])
def test_gated_resblock_matches_plain_version(cuda, dilation, causal, k):
    w = _wavenet_weights(1, 64, 80, k=k, seed=2)
    args = [w[key][0].to(cuda) for key in WEIGHT_KEYS]
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 777, 64).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rs.randn(2, 777, 80).astype(np.float32)).to(cuda)
    before = fused_gated_resblock.launches
    with torch.inference_mode():
        got = fused_gated_resblock(x, c, *args, dilation=dilation, causal=causal)
        torch.cuda.synchronize()
        want = gated_resblock_reference(x, c, *args, dilation=dilation,
                                        causal=causal)
    assert fused_gated_resblock.launches == before + 1
    for g, r in zip(got, want):
        assert float((g - r).abs().max()) <= 2e-4


def _within(got, want):
    """max|diff| <= 2e-4 and <= 1e-4 max|plain| (chip_smoke.py phase 4)."""
    err = float((got - want).abs().max())
    return err <= 2e-4 and err <= 1e-4 * float(want.abs().max())


def _v1_cycle(cuda, b, t, seed=1):
    gen = get_model_class("ParallelWaveGANGenerator")(
        layers=30, stacks=3, aux_channels=80, generator=torch.Generator().manual_seed(0))
    gen.remove_weight_norm()
    all_w, all_d = gen.stack_weights()
    w = {k: v[:10].contiguous().to(cuda) for k, v in all_w.items()}
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(b, t, 64).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rs.randn(b, t, 80).astype(np.float32)).to(cuda)
    return x, c, w, tuple(all_d[:10])


def test_wavenet_v1_cycle_within_a_ten_thousandth(cuda):
    """One PWG v1 cycle (the generator's weights from seed 0), split made
    once (``with_fragments``), against the plain version; two runs give the
    same bits."""
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import with_fragments

    x, c, w, dil = _v1_cycle(cuda, 1, 4099)
    wf = with_fragments(w)
    with torch.inference_mode():
        got = fused_wavenet_stack(x, c, wf, dil)
        again = fused_wavenet_stack(x, c, wf, dil)
        split_per_call = fused_wavenet_stack(x, c, w, dil)
        torch.cuda.synchronize()
        want = wavenet_stack_reference(x, c, w, dil)
    for g, a, p, r in zip(got, again, split_per_call, want):
        assert _within(g, r), float((g - r).abs().max())
        assert torch.equal(g, a) and torch.equal(g, p)


def test_wavenet_wide_kernel_past_the_rows(cuda):
    """K = 7 at dilation 512 on 300 rows: every tap but the centre one
    reads rows outside [0, T), for the stack and the causal block."""
    w = {k: v.to(cuda) for k, v in _wavenet_weights(2, 64, 80, k=7, seed=5).items()}
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(2, 300, 64).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rs.randn(2, 300, 80).astype(np.float32)).to(cuda)
    args = [w[key][1] for key in WEIGHT_KEYS]
    with torch.inference_mode():
        got = fused_wavenet_stack(x, c, w, (512, 256))
        blk = fused_gated_resblock(x, c, *args, dilation=512, causal=True)
        torch.cuda.synchronize()
        want = wavenet_stack_reference(x, c, w, (512, 256))
        want_blk = gated_resblock_reference(x, c, *args, dilation=512, causal=True)
    for g, r in zip((*got, *blk), (*want, *want_blk)):
        assert _within(g, r), float((g - r).abs().max())


def test_gated_resblock_causal_narrow(cuda):
    """K5 at C = 16, causal, with an aux width that is not a multiple of 4
    (4-byte copies) and the block's split passed in."""
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import with_fragments

    w = _wavenet_weights(1, 16, 10, k=3, seed=7)
    blk = with_fragments({key: v[0].to(cuda) for key, v in w.items()})
    args = [blk[key] for key in WEIGHT_KEYS]
    rs = np.random.RandomState(8)
    x = torch.from_numpy(rs.randn(3, 777, 16).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rs.randn(3, 777, 10).astype(np.float32)).to(cuda)
    before = fused_gated_resblock.launches
    with torch.inference_mode():
        got = fused_gated_resblock(x, c, *args, dilation=8, causal=True,
                                   fragments=blk["frag"])
        torch.cuda.synchronize()
        want = gated_resblock_reference(x, c, *args, dilation=8, causal=True)
    assert fused_gated_resblock.launches == before + 1
    for g, r in zip(got, want):
        assert _within(g, r), float((g - r).abs().max())


def test_wavenet_fragments_refuse_a_wrong_width(cuda):
    from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import wavenet_fragments

    w = {k: v.to(cuda) for k, v in _wavenet_weights(1, 64, 80).items()}
    with pytest.raises(ValueError, match="wavenet_fragments: wres"):
        wavenet_fragments(dict(w, wres=w["wres"][:, :, :32]))
    x = torch.zeros(1, 16, 64, device=cuda)
    c = torch.zeros(1, 16, 80, device=cuda)
    stale = dict(w, frag=wavenet_fragments(w)[:, :-1])  # one k-step short
    with pytest.raises(ValueError, match="frag has shape"):
        with torch.inference_mode():
            fused_wavenet_stack(x, c, stale, (1,))


def _k3_bf16_layer_ok(got, want):
    """One layer of K3's bf16 mode against its bf16 plain version on the same
    input (chip_smoke.py phase 30): rms|diff| <= 1e-3 rms|plain| and
    max|diff| <= 1e-2 max|plain| on x_out and skip, and x_out bit-equal in
    at least 99 % of its elements (the CPU floor, float32 against float64
    sums: 99.98 %)."""
    for g, r in zip(got, want):
        d, w = g.float() - r.float(), r.float()
        if not (float(d.pow(2).mean().sqrt()) <= 1e-3 * float(w.pow(2).mean().sqrt())
                and float(d.abs().max()) <= 1e-2 * float(w.abs().max())):
            return False
    return float((got[0] == want[0]).float().mean()) >= 0.99


# the bf16-resident mode at v1 widths, an odd aux width (2-byte c loads),
# the narrow width and one row
@pytest.mark.parametrize("ch,ca,b,t", [(64, 80, 1, 4099), (64, 10, 2, 1000),
                                       (16, 80, 3, 777), (16, 8, 2, 1)])
def test_wavenet_stack_bf16_matches_plain_version(cuda, ch, ca, b, t):
    """K3's bf16 mode layer by layer (d = 1..512), each layer fed the plain
    version's input, with the float32 kernel, the weights truncated to bf16
    and g left unrounded rejected at every layer; then the cycle, twice and
    on weights rounded per call, bit for bit."""
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import (
        wavenet_stack_reference_bf16,
        with_tiles_bf16,
    )

    dil = tuple(2 ** i for i in range(10))
    w = {k: v.to(cuda) for k, v in _wavenet_weights(len(dil), ch, ca, seed=ch + ca).items()}
    kept = with_tiles_bf16(w)
    rs = np.random.RandomState(t)
    x = torch.from_numpy(rs.randn(b, t, ch).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rs.randn(b, t, ca).astype(np.float32)).to(cuda)
    bf16 = torch.bfloat16

    def trunc(v):
        return (v.contiguous().view(torch.int32) & ~0xFFFF).view(torch.float32)

    before = (fused_wavenet_stack.launches, fused_wavenet_stack.bf16_launches,
              fused_wavenet_stack.bf16_calls)
    xl = x
    with torch.inference_mode():
        for li, d in enumerate(dil):
            wl = {k: v[li:li + 1] for k, v in kept.items()}
            pl = {k: wl[k] for k in WEIGHT_KEYS}
            want = wavenet_stack_reference_bf16(xl, c, pl, (d,))
            got = fused_wavenet_stack(xl, c, wl, (d,), bf16)
            torch.cuda.synchronize()
            assert _k3_bf16_layer_ok(got, want), (li, d)
            for control in (
                    fused_wavenet_stack(xl, c, pl, (d,)),
                    fused_wavenet_stack(xl, c, {k: trunc(v) if k[0] == "w" else v
                                                for k, v in pl.items()}, (d,), bf16),
                    wavenet_stack_reference_bf16(xl, c, pl, (d,), round_g=False)):
                assert not _k3_bf16_layer_ok(control, want), (li, d)
            xl = want[0]
        got = fused_wavenet_stack(x, c, kept, dil, bf16)
        again = fused_wavenet_stack(x, c, w, dil, bf16)
        xb = fused_wavenet_stack(x.to(bf16), c, kept, dil, bf16)
        torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert xb[0].dtype == bf16 and torch.equal(xb[0].float(), got[0])
    assert got[0].dtype == got[1].dtype == torch.float32
    # one layer of the loop above is two bf16 launches (the kernel and the
    # truncated control), each a host call, and one float32 launch; each
    # cycle is one host call of n launches
    n = len(dil)
    assert (fused_wavenet_stack.launches - before[0],
            fused_wavenet_stack.bf16_launches - before[1],
            fused_wavenet_stack.bf16_calls - before[2]) == (3 * n + 3 * n, 2 * n + 3 * n, 2 * n + 3)


def test_wavenet_stack_bf16_refuses_what_it_does_not_take(cuda):
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import with_tiles_bf16

    w = {k: v.to(cuda) for k, v in _wavenet_weights(1, 64, 80).items()}
    x = torch.zeros(1, 16, 64, device=cuda)
    c = torch.zeros(1, 16, 80, device=cuda)
    stale = dict(w, tiles_bf16=with_tiles_bf16(w)["tiles_bf16"][:, :-8])
    with torch.inference_mode():
        with pytest.raises(ValueError, match="tiles_bf16 has shape"):
            fused_wavenet_stack(x, c, stale, (1,), torch.bfloat16)
        narrow = {k: v.to(cuda) for k, v in _wavenet_weights(1, 8, 80).items()}
        with pytest.raises(ValueError, match="residual width 8"):
            fused_wavenet_stack(torch.zeros(1, 16, 8, device=cuda), c, narrow, (1,),
                                torch.bfloat16)


def test_pwg_generator_bf16_stack_on_the_card(cuda):
    """``use_pallas_stack`` with ``pallas_stack_bf16``: every layer through K3's
    bf16 mode (no float32 launch, no plain version), its output within the
    bf16 chain's noise of the generator with the bf16 plain version."""
    import parallelwavegan_tpu_torch.models.parallel_wavegan as pwg_mod
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import wavenet_stack_reference_bf16

    cls = get_model_class("ParallelWaveGANGenerator")
    small = dict(layers=6, stacks=2, aux_channels=80, use_pallas_stack=True,
                 pallas_stack_bf16=True, upsample_params={"upsample_scales": [4, 4]})
    gen = cls(**small, generator=torch.Generator().manual_seed(4))
    gen.remove_weight_norm()
    gen.eval().to(cuda)
    gen.prepare_kernels()
    assert "tiles_bf16" in gen._kernel_cache["stack"][0]
    z = torch.randn(2, 1, 40 * 16, generator=torch.Generator().manual_seed(5)).to(cuda)
    c = torch.randn(2, 80, 44, generator=torch.Generator().manual_seed(6)).to(cuda)
    before = (fused_wavenet_stack.launches, fused_wavenet_stack.bf16_launches,
              fused_wavenet_stack.bf16_calls)
    with torch.inference_mode():
        got = gen(z, c)
        torch.cuda.synchronize()
        assert (fused_wavenet_stack.launches - before[0],
                fused_wavenet_stack.bf16_launches - before[1],
                fused_wavenet_stack.bf16_calls - before[2]) == (6, 6, 1)
        real = pwg_mod.fused_wavenet_stack
        pwg_mod.fused_wavenet_stack = lambda x, cc, w, d, dt: wavenet_stack_reference_bf16(
            x, cc, {k: w[k] for k in WEIGHT_KEYS}, d)
        try:
            want = gen(z, c)
        finally:
            pwg_mod.fused_wavenet_stack = real
    d = got - want
    assert float(d.pow(2).mean().sqrt()) <= 5e-3 * float(want.pow(2).mean().sqrt())


def test_pwg_generator_through_the_kernels(cuda):
    cls = get_model_class("ParallelWaveGANGenerator")
    small = dict(layers=6, stacks=2, aux_channels=80,
                 upsample_params={"upsample_scales": [4, 4]})
    plain = cls(**small, generator=torch.Generator().manual_seed(4))
    plain.remove_weight_norm()
    z = torch.randn(2, 1, 40 * 16, generator=torch.Generator().manual_seed(5))
    c = torch.randn(2, 80, 44, generator=torch.Generator().manual_seed(6))
    plain.eval().to(cuda)
    with torch.inference_mode():
        want = plain(z.to(cuda), c.to(cuda))
    for flag in ("use_pallas_stack_train", "use_pallas_kernels"):
        gen = cls(**small, **{flag: True})
        gen.remove_weight_norm()
        gen.load_state_dict(plain.state_dict())
        gen.eval().to(cuda)
        gen.prepare_kernels()
        before = fused_wavenet_stack.launches + fused_gated_resblock.launches
        with torch.inference_mode():
            got = gen(z.to(cuda), c.to(cuda))
        torch.cuda.synchronize()
        assert fused_wavenet_stack.launches + fused_gated_resblock.launches == before + 6
        assert float((got - want).abs().max()) <= 2e-4


def test_pwg_stack_without_biases_through_the_kernel(cuda):
    cls = get_model_class("ParallelWaveGANGenerator")
    small = dict(layers=6, stacks=2, aux_channels=80, bias=False,
                 upsample_params={"upsample_scales": [4, 4]})
    plain = cls(**small, generator=torch.Generator().manual_seed(4))
    gen = cls(**small, use_pallas_stack_train=True)
    gen.load_state_dict(plain.state_dict())
    for m in (plain, gen):
        m.remove_weight_norm()
        m.eval().to(cuda)
    gen.prepare_kernels()
    z = torch.randn(1, 1, 40 * 16, generator=torch.Generator().manual_seed(5))
    c = torch.randn(1, 80, 44, generator=torch.Generator().manual_seed(6))
    before = fused_wavenet_stack.launches
    with torch.inference_mode():
        want = plain(z.to(cuda), c.to(cuda))
        got = gen(z.to(cuda), c.to(cuda))
    torch.cuda.synchronize()
    assert fused_wavenet_stack.launches == before + 6
    assert float((got - want).abs().max()) <= 2e-4


def test_wavenet_kernel_rejects_unsupported_input(cuda):
    w = {k: v.to(cuda) for k, v in _wavenet_weights(1, 32, 80).items()}
    x = torch.zeros(1, 16, 32, device=cuda)
    c = torch.zeros(1, 16, 80, device=cuda)
    with pytest.raises(ValueError, match="residual width 32"):
        fused_wavenet_stack(x, c, w, (1,))
    w = {k: v.to(cuda) for k, v in _wavenet_weights(1, 64, 80).items()}
    with pytest.raises(ValueError, match="float32"):
        fused_wavenet_stack(torch.zeros(1, 16, 64, device=cuda, dtype=torch.float64),
                            c, w, (1,))
    with pytest.raises(ValueError, match="contiguous"):
        fused_wavenet_stack(torch.zeros(1, 64, 16, device=cuda).transpose(1, 2),
                            c, w, (1,))


def _grads_miss(g, r, strict) -> bool:
    """True where g misses r: |g - r| > 2e-4 + 1e-3 |r| anywhere, the JAX
    K4 test's tolerance (tests/test_wavenet_stack_train.py:70-72), or, when
    ``strict``, max|g - r| > 1e-4 max|r|."""
    d = (g - r).abs()
    return (g.shape != r.shape or not bool(torch.isfinite(g).all())
            or not bool((d <= 2e-4 + 1e-3 * r.abs()).all())
            or (strict and float(d.max()) > 1e-4 * float(r.abs().max())))


def _assert_grads_close(cases, strict=False):
    """Each (name, got, want) within tolerance. ``strict`` is for gradients
    of order one (a unit cotangent): it adds the 1e-4 max|want| bound, and
    each ``got`` zeroed in turn must be rejected. A gradient that is zero
    up to rounding, such as that of a weight-norm direction of one element,
    has no relative error to hold."""
    for name, g, r in cases:
        assert not _grads_miss(g, r, strict), (name, float((g - r).abs().max()))
        if strict:
            assert _grads_miss(torch.zeros_like(g), r, strict), f"zeroed {name} passed"


def _k4_case(cuda, ch, ca, b, t, bias, n_layers=5, seed=7, k=3):
    w = {key: v.to(cuda)
         for key, v in _wavenet_weights(n_layers, ch, ca, k=k, seed=seed).items()}
    if not bias:
        for key in ("bconv", "bskip", "bres"):
            w[key] = torch.zeros_like(w[key])
    rs = np.random.RandomState(seed + 1)

    def randn(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda)

    return w, randn(b, t, ch), randn(b, t, ca), randn(b, t, ch), randn(b, t, ch)


# v1 widths with the d=512 halo past both ends of a ragged T, an odd aux
# width (4-byte copies), the narrow width, no biases, and T = 1; T at the
# 64-row tile of dz_kernel and dx_kernel and at the 1,024-row block of the
# weight gradients, each +- 1, T below one tile, d >= T, and the narrow
# width with the odd aux width
@pytest.mark.parametrize("ch,ca,b,t,bias,dils", [
    (64, 80, 2, 1000, True, (32, 64, 128, 256, 512)),
    (64, 10, 1, 777, True, (1, 2, 4, 8, 16)),
    (16, 80, 3, 300, True, (1, 2, 4)),
    (64, 80, 1, 1100, False, (1, 8, 64, 512)),
    (64, 80, 2, 1, True, (1, 2)),
    (64, 80, 2, 63, True, (1, 2, 4)),
    (64, 80, 1, 65, True, (8, 64, 128)),
    (64, 80, 2, 1023, True, (1, 16, 256)),
    (64, 80, 1, 1025, True, (2, 32, 512)),
    (64, 80, 3, 40, True, (1, 4, 32, 64)),
    (16, 10, 2, 129, True, (1, 128, 512)),
])
def test_wavenet_backward_matches_plain_version(cuda, ch, ca, b, t, bias, dils):
    w, x, c, dxo, dsk = _k4_case(cuda, ch, ca, b, t, bias, n_layers=len(dils))
    before = wavenet_stack_backward.launches
    dx, dc, dw = wavenet_stack_backward(x, c, w, dils, dxo, dsk)
    torch.cuda.synchronize()
    assert wavenet_stack_backward.launches == before + len(dils)
    rdx, rdc, rdw = wavenet_stack_backward_reference(x, c, w, dils, dxo, dsk)
    _assert_grads_close([("dx", dx, rdx), ("dc", dc, rdc)]
                        + [(k, dw[k], rdw[k]) for k in WEIGHT_KEYS], strict=True)


def test_wavenet_backward_kernel_size_five(cuda):
    """K = 5: the weight gradients take the taps in two jobs per half of
    dz (three taps, then two with the aux input)."""
    dils = (1, 4, 64)
    w, x, c, dxo, dsk = _k4_case(cuda, 64, 80, 2, 700, True, n_layers=3, k=5)
    dx, dc, dw = wavenet_stack_backward(x, c, w, dils, dxo, dsk)
    rdx, rdc, rdw = wavenet_stack_backward_reference(x, c, w, dils, dxo, dsk)
    _assert_grads_close([("dx", dx, rdx), ("dc", dc, rdc)]
                        + [(k, dw[k], rdw[k]) for k in WEIGHT_KEYS], strict=True)


def test_wavenet_backward_unaligned_aux_input(cuda):
    """An aux input 4 bytes off a 16-byte boundary takes the 4-byte copies."""
    dils = (1, 2, 512)
    w, x, c, dxo, dsk = _k4_case(cuda, 64, 80, 2, 300, True, n_layers=3)
    c_off = torch.empty(c.numel() + 1, device=cuda)[1:].view(c.shape)
    c_off.copy_(c)
    assert c_off.data_ptr() % 16 == 4
    dx, dc, dw = wavenet_stack_backward(x, c_off, w, dils, dxo, dsk)
    rdx, rdc, rdw = wavenet_stack_backward_reference(x, c, w, dils, dxo, dsk)
    _assert_grads_close([("dx", dx, rdx), ("dc", dc, rdc)]
                        + [(k, dw[k], rdw[k]) for k in WEIGHT_KEYS], strict=True)


def test_wavenet_backward_is_deterministic(cuda):
    dils = (1, 2, 4, 8, 16)
    w, x, c, dxo, dsk = _k4_case(cuda, 64, 80, 2, 3000, True)
    first = wavenet_stack_backward(x, c, w, dils, dxo, dsk)
    second = wavenet_stack_backward(x, c, w, dils, dxo, dsk)
    torch.cuda.synchronize()
    for a, b in zip(first[:2], second[:2]):
        assert torch.equal(a, b)
    for k in WEIGHT_KEYS:
        assert torch.equal(first[2][k], second[2][k]), k


def test_pwg_generator_trains_through_the_kernels(cuda):
    cls = get_model_class("ParallelWaveGANGenerator")
    small = dict(layers=6, stacks=2, aux_channels=80,
                 upsample_params={"upsample_scales": [4, 4]})
    plain = cls(**small, generator=torch.Generator().manual_seed(4)).to(cuda)
    gen = cls(**small, use_pallas_stack_train=True,
              pallas_stack_train_layers_per_call=2).to(cuda)
    gen.load_state_dict(plain.state_dict())
    z = torch.randn(2, 1, 40 * 16, generator=torch.Generator().manual_seed(5))
    c = torch.randn(2, 80, 44, generator=torch.Generator().manual_seed(6))
    (plain(z.to(cuda), c.to(cuda)) ** 2).mean().backward()
    before = wavenet_stack_backward.launches
    (gen(z.to(cuda), c.to(cuda)) ** 2).mean().backward()
    torch.cuda.synchronize()
    assert wavenet_stack_backward.launches == before + 6  # one per layer
    want = dict(plain.named_parameters())
    assert gen.conv_layers[3].conv.weight_g.grad is not None
    # the last layer's residual output is unused: autograd leaves None on
    # the plain path, the kernel writes zeros (as JAX's VJP does)
    _assert_grads_close([(k, p.grad, torch.zeros_like(p) if want[k].grad is None
                          else want[k].grad) for k, p in gen.named_parameters()])


def test_wavenet_backward_rejects_unsupported_input(cuda):
    w, x, c, dxo, dsk = _k4_case(cuda, 64, 80, 1, 64, True, n_layers=1)
    with pytest.raises(ValueError, match="dxo"):
        wavenet_stack_backward(x, c, w, (1,), dxo[:, :32], dsk)
    c = torch.zeros(1, 64, 130, device=cuda)
    w["waux"] = torch.zeros(1, 130, 128, device=cuda)
    with pytest.raises(ValueError, match="aux width 130"):
        wavenet_stack_backward(x, c, w, (1,), dxo, dsk)


def test_library_entry_points_match_signatures(cuda):
    from parallelwavegan_tpu_torch.ops.kernels import build

    lib = build.load()  # binds every name of _SIGNATURES
    for name in build._SIGNATURES:
        assert getattr(lib._lib, name).argtypes == build._SIGNATURES[name]
    # ctas x (two halves of dz against 3 taps and aux, 272 + 1 rows of 64;
    # g against dS and against dxn, 64 + 1 rows of 64)
    assert lib.query("wavenet_bwd_part_floats", 6, 25600, 64, 80, 3) == (
        150 * (2 * 273 * 64 + 2 * 65 * 64))
    assert lib.query("wavenet_bwd_part_floats", 6, 25600, 32, 80, 3) == -1


def _melgan_stacks(c, dilations, seed, bias=True, gain=0.5):
    rs = np.random.RandomState(seed)

    def t(*shape, scale):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))

    return [{"wd": t(3, c, c, scale=gain / (3 * c) ** 0.5),
             "bd": t(c, scale=0.1) if bias else None,
             "w1": t(1, c, c, scale=gain / c ** 0.5),
             "b1": t(c, scale=0.1) if bias else None,
             "ws": t(1, c, c, scale=gain / c ** 0.5),
             "bs": t(c, scale=0.1) if bias else None,
             "dilation": d} for d in dilations]


def _on(stacks, device):
    return [{k: v.to(device) if torch.is_tensor(v) else v for k, v in st.items()}
            for st in stacks]


def _k6_close(got, want):
    """K6's bound: max|diff| <= 2e-4 and <= 1e-4 max|plain|."""
    err = float((got - want).abs().max())
    return err <= 2e-4 and err <= 1e-4 * float(want.abs().max())


# MB-MelGAN v2's widths (96, 48), MelGAN v1's (128, 64, 32), the narrowest
# (16), every pad mode, short T (all edge), B > 1 and no biases; each on
# weights of gain 0.5 and of gain one (every branch as large as its input)
@pytest.mark.parametrize("c,b,t,mode,out_ch,bias", [
    (96, 1, 4099, "reflect", None, True), (48, 2, 1000, "reflect", 4, True),
    (128, 1, 777, "edge", 1, True), (64, 2, 1000, "constant", None, True),
    (32, 3, 30, "reflect", 4, True), (16, 1, 5, "edge", None, True),
    (80, 2, 333, "constant", 2, False), (112, 1, 200, "reflect", None, True)])
def test_melgan_stacks_match_plain_version(cuda, c, b, t, mode, out_ch, bias):
    rs = np.random.RandomState(1)
    final = None
    if out_ch is not None:
        final = (torch.from_numpy((rs.randn(7, c, out_ch) * 0.5 / (7 * c) ** 0.5)
                                  .astype(np.float32)).to(cuda),
                 torch.from_numpy(rs.randn(out_ch).astype(np.float32)).to(cuda)
                 if bias else None)
    x = torch.from_numpy(rs.randn(b, t, c).astype(np.float32)).to(cuda)
    for gain in (0.5, 1.0):
        stacks = _on(_melgan_stacks(c, (1, 3, 9, 27), seed=c, bias=bias, gain=gain), cuda)
        if mode == "reflect" and t <= 27:
            stacks = stacks[:2]  # reflect padding needs T > the pad
        before = (stack_mod.fused_melgan_stacks.calls, stack_mod.fused_melgan_stacks.launches)
        with torch.inference_mode():
            got = stack_mod.fused_melgan_stacks(x, stacks, final=final, pad_mode=mode)
            torch.cuda.synchronize()
            want = stack_mod.melgan_stacks_reference(x, stacks, final=final,
                                                     pad_mode=mode)
        assert (stack_mod.fused_melgan_stacks.calls,
                stack_mod.fused_melgan_stacks.launches) == (
            before[0] + 1, before[1] + len(stacks) + (final is not None))
        assert got.shape == want.shape == (b, t, out_ch or c)
        assert _k6_close(got, want), (gain, float((got - want).abs().max()))


# paddings too wide for one window beside the ring: the taps' rows staged
# one tap at a time (C = 128, d = 130; C = 96, d = 200), and a kernel size
# of 5 with the window whole (C = 48)
@pytest.mark.parametrize("c,t,k,dils,mode", [
    (128, 600, 3, (1, 130), "reflect"), (96, 900, 3, (200, 2), "edge"),
    (48, 500, 5, (1, 30), "constant")])
def test_melgan_stacks_wide_padding(cuda, c, t, k, dils, mode):
    rs = np.random.RandomState(k)
    stacks = _on(_melgan_stacks(c, dils, seed=c, gain=1.0), cuda)
    for st in stacks:
        st["wd"] = torch.from_numpy(
            (rs.randn(k, c, c) / (k * c) ** 0.5).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rs.randn(2, t, c).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        got = stack_mod.fused_melgan_stacks(x, stacks, pad_mode=mode)
        torch.cuda.synchronize()
        want = stack_mod.melgan_stacks_reference(x, stacks, pad_mode=mode)
    assert _k6_close(got, want), float((got - want).abs().max())


# MB-MelGAN v2's widths, v1's 128 with K = 5, missing biases, and 18
# stacks (two launches of 16 and 2)
@pytest.mark.parametrize("c,k,n,bias", [(96, 3, 4, True), (48, 3, 4, True),
                                        (128, 5, 3, False), (16, 3, 18, True)])
def test_melgan_split_kernel_matches_plain_version(cuda, c, k, n, bias):
    """The split kernel against its plain version (``tf32x3.
    stack_forward_fragments`` and the biases stacked), bit for bit."""
    from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import stack_forward_fragments

    stacks = _on(_melgan_stacks(c, (1,) * n, seed=c + n, bias=bias, gain=1.0), cuda)
    rs = np.random.RandomState(k)
    for st in stacks:
        st["wd"] = torch.from_numpy((rs.randn(k, c, c) / c).astype(np.float32)).to(cuda)
    if bias:
        stacks[1]["b1"] = None
    before = stack_mod.kernel_weights.launches
    frags, biases = stack_mod.kernel_weights(stacks)
    torch.cuda.synchronize()
    assert stack_mod.kernel_weights.launches == before + (n + 15) // 16
    want = stack_forward_fragments(stacks)
    assert len(frags) == len(want) == n
    for got, ref in zip(frags, want):
        assert got.shape == ref.shape and torch.equal(got, ref)
    for st, got in zip(stacks, biases):
        for row, key in enumerate(("bd", "b1", "bs")):
            ref = torch.zeros(c, device=cuda) if st[key] is None else st[key]
            assert torch.equal(got[row], ref), key


def test_melgan_stacks_are_deterministic(cuda):
    """Two runs, and runs on the split that decode keeps, bit for bit."""
    stacks = _on(_melgan_stacks(96, (1, 3, 9, 27), seed=2, gain=1.0), cuda)
    kept = stack_mod.with_fragments(stacks)
    x = torch.randn(1, 5000, 96, generator=torch.Generator().manual_seed(3)).to(cuda)
    with torch.inference_mode():
        first = stack_mod.fused_melgan_stacks(x, stacks)
        second = stack_mod.fused_melgan_stacks(x, stacks)
        third = stack_mod.fused_melgan_stacks(x, kept)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, third)


def _refuse(monkeypatch, module, name):
    def plain(*args, **kwargs):
        raise AssertionError(f"{name} reached with a CUDA tensor")

    monkeypatch.setattr(module, name, plain)


def test_mbmelgan_generator_through_the_kernel(cuda, monkeypatch):
    cls = get_model_class("MelGANGenerator")
    small = dict(in_channels=16, out_channels=4, channels=384,
                 upsample_scales=(8, 4, 2), stacks=4)
    plain = cls(**small, generator=torch.Generator().manual_seed(4))
    gen = cls(**small, use_pallas_stacks=True)
    gen.load_state_dict(plain.state_dict())
    for m in (plain, gen):
        m.remove_weight_norm()
        m.eval().to(cuda)
    gen.prepare_kernels()
    assert gen.fused_stages == (1, 2)  # stage 0 at 192 channels stays on cuDNN
    c = torch.randn(2, 16, 40, generator=torch.Generator().manual_seed(5)).to(cuda)
    with torch.inference_mode():
        want = plain(c)
        _refuse(monkeypatch, stack_mod, "melgan_stacks_reference")
        before = stack_mod.fused_melgan_stacks.calls
        got = gen(c)
    torch.cuda.synchronize()
    assert stack_mod.fused_melgan_stacks.calls == before + 2
    assert got.shape == want.shape == (2, 4, 40 * 64)
    assert float((got - want).abs().max()) <= 2e-4


def test_mbmelgan_decode_makes_no_split(cuda, monkeypatch):
    """After ``prepare_kernels`` every fused stage carries its split: a
    decode forward makes none."""
    gen = get_model_class("MelGANGenerator")(
        in_channels=16, out_channels=4, channels=384, upsample_scales=(8, 4, 2),
        stacks=4, use_pallas_stacks=True, generator=torch.Generator().manual_seed(4))
    gen.remove_weight_norm()
    gen.eval().to(cuda)
    c = torch.randn(1, 16, 40, generator=torch.Generator().manual_seed(5)).to(cuda)
    with torch.inference_mode():
        per_call = gen(c)  # no prepare_kernels: each call splits
        gen.prepare_kernels()
        assert all(st["frag"] is not None for w in gen._kernel_cache.values()
                   for st in w["stacks"])
        _refuse(monkeypatch, stack_mod, "stack_forward_fragments")
        splits = stack_mod.kernel_weights.launches
        got = gen(c)
    torch.cuda.synchronize()
    assert stack_mod.kernel_weights.launches == splits
    assert torch.equal(got, per_call)


def test_melgan_kernel_rejects_unsupported_input(cuda):
    stacks = _on(_melgan_stacks(24, (1,), seed=0), cuda)
    with pytest.raises(ValueError, match="width 24"):
        stack_mod.fused_melgan_stacks(torch.zeros(1, 64, 24, device=cuda), stacks)
    stacks = _on(_melgan_stacks(32, (27,), seed=0), cuda)
    with pytest.raises(ValueError, match="reflect padding"):
        stack_mod.fused_melgan_stacks(torch.zeros(1, 27, 32, device=cuda), stacks)
    kept = stack_mod.with_fragments(stacks)[0]
    stale = [dict(kept, frag=kept["frag"][:-1])]  # one matrix short
    with pytest.raises(ValueError, match="frag has shape"):
        stack_mod.fused_melgan_stacks(torch.zeros(1, 64, 32, device=cuda), stale)
    with pytest.raises(ValueError, match="contiguous"):
        stack_mod.fused_melgan_stacks(
            torch.zeros(1, 32, 64, device=cuda).transpose(1, 2), stacks)


def _off_the_kinks(x, stacks, final, mode, seed):
    """x with its rows moved (0.05 N(0, 1) added) where the plain forward
    puts an input of LeakyReLU (each stack's input and z, the final conv's
    input) within 1e-5 of its rms of the kink at 0, until none is left, as
    chip_smoke.py phase 17 does. There float32 rounding, which differs
    between K6's split-TF32 forward, K7's recomputed z and the plain
    version, can put the two paths on the two sides of the kink, where the
    derivative jumps by 1 - slope: a difference of the function, not of the
    kernels: at C = 128, B = 2, T = 1000 such a z put dx 3.9e-3 off the
    plain version's, while K7 fed the plain forward's stack inputs agreed."""
    import torch.nn.functional as F

    g = torch.Generator(device=x.device).manual_seed(seed)
    for _ in range(50):
        near = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)

        def mark(v):
            near.logical_or_((v.abs() < 1e-5 * v.pow(2).mean().sqrt()).any(1))

        with torch.no_grad():
            c = x.transpose(1, 2)
            for st in stacks:
                mark(c)
                p = (st["wd"].shape[0] - 1) // 2 * st["dilation"]
                z = stack_mod._conv(F.pad(F.leaky_relu(c, 0.2), (p, p),
                                          mode=stack_mod._pad_mode(mode)),
                                    st["wd"], st["bd"], st["dilation"])
                mark(z)
                c = stack_mod._conv(F.leaky_relu(z, 0.2), st["w1"], st["b1"]) + \
                    stack_mod._conv(c, st["ws"], st["bs"])
            if final is not None:
                mark(c)
        rows = near.nonzero()
        if len(rows) == 0:
            return x
        x = x.clone()
        x[rows[:, 0], rows[:, 1]] += 0.05 * torch.randn(
            len(rows), x.shape[2], generator=g, device=x.device)
    raise AssertionError("could not move the input off the kinks of LeakyReLU")


def _k7_case(cuda, c, b, t, out_ch, bias, dils, seed=3, mode="reflect"):
    stacks = _on(_melgan_stacks(c, dils, seed=seed, bias=bias), cuda)
    rs = np.random.RandomState(seed + 1)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to(cuda)

    final = None
    if out_ch is not None:
        final = (randn(7, c, out_ch, scale=0.5 / (7 * c) ** 0.5),
                 randn(out_ch, scale=0.1) if bias else None)
    x, dy = randn(b, t, c), randn(b, t, out_ch or c)
    return stacks, final, _off_the_kinks(x, stacks, final, mode, seed), dy


def _k7_grads(dx, dstacks, dfinal):
    out = [("dx", dx)]
    for i, d in enumerate(dstacks):
        out += [(f"stacks[{i}].{k}", v) for k, v in d.items() if v is not None]
    for name, v in zip(("final w", "final b"), dfinal or ()):
        if v is not None:
            out.append((name, v))
    return out


# MelGAN v1's widths (128, 64 with the final conv to 1, 32 with T just
# above the reflect pad of 9), ragged replicate and zero cases with the
# final conv to 4, a width of two 64-channel pieces without biases, T
# below the pad (replicate), and MB-MelGAN v2's training stages
@pytest.mark.parametrize("c,b,t,mode,out_ch,bias,dils", [
    (128, 2, 1000, "reflect", None, True, (1, 3, 9)),
    (64, 1, 777, "reflect", 1, True, (1, 3, 9)),
    (32, 1, 10, "reflect", 1, True, (1, 3, 9)),
    (48, 2, 1000, "edge", 4, True, (1, 3, 9)),
    (48, 2, 1000, "constant", 4, True, (1, 3, 9)),
    (80, 1, 333, "edge", None, False, (1, 3, 9, 27)),
    (16, 3, 5, "edge", 2, True, (1, 3)),
    # MB-MelGAN v2's training stages: 96 channels, then 48 with the final
    # conv to 4 sub-bands; 4 stacks at d = 1, 3, 9, 27
    (96, 2, 256, "reflect", None, True, (1, 3, 9, 27)),
    (48, 2, 512, "reflect", 4, True, (1, 3, 9, 27)),
])
def test_melgan_stacks_backward_matches_plain_version(cuda, c, b, t, mode, out_ch,
                                                      bias, dils):
    from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as k7

    stacks, final, x, dy = _k7_case(cuda, c, b, t, out_ch, bias, dils, mode=mode)
    before = k7.melgan_stacks_backward.launches
    got = k7.melgan_stacks_backward(x, stacks, final, 0.2, mode, dy)
    torch.cuda.synchronize()
    assert k7.melgan_stacks_backward.launches == before + len(dils) + (final is not None)
    want = k7.melgan_stacks_backward_reference(x, stacks, final, 0.2, mode, dy)
    got, want = _k7_grads(*got), _k7_grads(*want)
    assert [n for n, _ in got] == [n for n, _ in want]
    _assert_grads_close([(n, g, r) for (n, g), (_, r) in zip(got, want)], strict=True)


# kernel sizes 5 and 7: weight-gradient jobs of one to three taps (a
# dilation past a staged step's 64 rows takes one tap a job), a padding
# wider than a row tile (the fold over several tiles) and, in replicate,
# wider than T
@pytest.mark.parametrize("c,t,k,dils,mode,out_ch", [
    (128, 500, 5, (1, 70), "reflect", None),
    (64, 300, 7, (2, 30), "edge", 1),
    (32, 90, 7, (40,), "edge", 4),
])
def test_melgan_stacks_backward_wide_kernels(cuda, c, t, k, dils, mode, out_ch):
    from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as k7

    stacks, final, x, dy = _k7_case(cuda, c, 2, t, out_ch, True, dils, mode=mode)
    rs = np.random.RandomState(k)
    for st in stacks:
        st["wd"] = torch.from_numpy(
            (rs.randn(k, c, c) * 0.5 / (k * c) ** 0.5).astype(np.float32)).to(cuda)
    x = _off_the_kinks(x, stacks, final, mode, k)  # at the new taps' z
    got = k7.melgan_stacks_backward(x, stacks, final, 0.2, mode, dy)
    torch.cuda.synchronize()
    want = k7.melgan_stacks_backward_reference(x, stacks, final, 0.2, mode, dy)
    got, want = _k7_grads(*got), _k7_grads(*want)
    assert [n for n, _ in got] == [n for n, _ in want]
    _assert_grads_close([(n, g, r) for (n, g), (_, r) in zip(got, want)], strict=True)


def test_melgan_stacks_backward_is_deterministic(cuda):
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        melgan_stacks_backward,
    )

    stacks, final, x, dy = _k7_case(cuda, 64, 2, 3000, 1, True, (1, 3, 9))
    first = _k7_grads(*melgan_stacks_backward(x, stacks, final, 0.2, "reflect", dy))
    second = _k7_grads(*melgan_stacks_backward(x, stacks, final, 0.2, "reflect", dy))
    torch.cuda.synchronize()
    for (name, a), (_, b) in zip(first, second):
        assert torch.equal(a, b), name


def test_melgan_generator_trains_through_the_kernels(cuda, monkeypatch):
    from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as k7

    cls = get_model_class("MelGANGenerator")
    small = dict(in_channels=16, out_channels=1, channels=256,
                 upsample_scales=(4, 2, 2), stacks=3)
    plain = cls(**small, generator=torch.Generator().manual_seed(4)).to(cuda)
    # unit-norm filters (every weight-norm scale 1) and a unit cotangent keep
    # every gradient of order one: the N(0, 0.02) init leaves them far
    # under the 2e-4 term
    with torch.no_grad():
        for k, p in plain.named_parameters():
            if k.endswith("weight_g"):
                p.fill_(1.0)
    gen = cls(**small, use_pallas_stacks_train=True).to(cuda)
    gen.load_state_dict(plain.state_dict())
    assert gen.fused_stages == (0, 1, 2)
    c = torch.randn(2, 16, 40, generator=torch.Generator().manual_seed(5)).to(cuda)
    cot = torch.randn(2, 1, 40 * 16, generator=torch.Generator().manual_seed(6)).to(cuda)
    (plain(c) * cot).sum().backward()
    _refuse(monkeypatch, k7, "melgan_stacks_reference")
    _refuse(monkeypatch, k7, "melgan_stacks_backward_reference")
    k7_splits = []

    def counted(stacks):
        k7_splits.append(len(stacks))
        return stack_fragments(stacks)

    # one split per stage for K6 in the forward (its re-run in the backward
    # reads it again) and one for K7 in the backward
    stack_fragments = k7.stack_fragments
    monkeypatch.setattr(k7, "stack_fragments", counted)
    before = k7.melgan_stacks_backward.launches
    k6_splits = stack_mod.kernel_weights.launches
    y = gen(c)
    assert stack_mod.kernel_weights.launches == k6_splits + 3 and k7_splits == []
    (y * cot).sum().backward()
    torch.cuda.synchronize()
    assert stack_mod.kernel_weights.launches == k6_splits + 3 and k7_splits == [3, 3, 3]
    assert k7.melgan_stacks_backward.launches == before + 10  # 9 stacks, final
    with torch.no_grad():
        assert float((y - plain(c)).abs().max()) <= 2e-4
    want = dict(plain.named_parameters())
    _assert_grads_close([(k, p.grad, want[k].grad) for k, p in gen.named_parameters()],
                        strict=True)
    with torch.no_grad():  # the D phase's re-run: K6 alone
        calls = stack_mod.fused_melgan_stacks.calls
        gen(c)
    assert stack_mod.fused_melgan_stacks.calls == calls + 3


def _mel_off_the_kinks(gen, c, seed, stages, rel=1e-5):
    """c with the mel frames moved (0.05 N(0, 1) added) under which the
    plain forward of ``gen`` puts an input of a LeakyReLU that sees one of
    ``stages`` (each stack's input and z, the activation after the stage,
    the final conv's input) within ``rel`` of its rms of the kink at 0,
    until none is left: ``_off_the_kinks`` at the generator's input."""
    scales, hooks, near = gen.upsample_scales, [], []

    def watch(module, factor):
        def hook(mod, inputs):
            v = inputs[0]
            hit = (v.abs() < rel * v.pow(2).mean().sqrt()).any(1).nonzero()
            near.extend((int(b), int(t) // factor) for b, t in hit)
        hooks.append(module.register_forward_pre_hook(hook))

    for i in stages:
        factor = math.prod(scales[:i + 1])
        for j in gen._stages[i][2]:
            watch(gen.melgan[j].stack[0], factor)
            watch(gen.melgan[j].stack[3], factor)
        if i + 1 < len(scales):
            watch(gen.melgan[gen._stages[i + 1][0]], factor)
    watch(gen.melgan[gen._tail], math.prod(scales))
    g = torch.Generator(device=c.device).manual_seed(seed)
    try:
        for _ in range(50):
            near.clear()
            with torch.no_grad():
                gen(c)
            if not near:
                return c
            b, f = map(list, zip(*set(near)))
            c = c.clone()
            c[b, :, f] += 0.05 * torch.randn(len(b), c.shape[1], generator=g,
                                             device=c.device)
    finally:
        for h in hooks:
            h.remove()
    raise AssertionError("could not move the mel off the kinks of LeakyReLU")


def test_mb_melgan_v2_g_step_through_the_kernels(cuda, monkeypatch):
    """One MB-MelGAN G step at v2's fused stage widths (96 and 48, 4 stacks
    each, the final conv to 4 sub-bands and tanh), the kernels' path (K6
    forward, K7 backward) against the plain path: the step's losses (the
    full-band and sub-band STFT losses at v2's sizes and the multi-scale
    discriminator's adversarial loss) to 1e-4 relative, and every gradient
    of G by ``_assert_grads_close(strict=True)`` under two cotangents on
    G's output: a unit random one, and the step's own (the losses'
    gradient at the plain path's output). Each path's own loss gradient
    is not compared: the STFT log-magnitude loss at bins of small
    magnitude turns K6's forward difference (5e-6 of the output here,
    within its bound) into gradient differences 2.9 times the plain path's
    own float32 error against float64 (on the card). Unit-norm filters
    keep the gradients of order one; the mel is moved until no LeakyReLU
    input that a fused stage feeds lies within 1e-5 of its rms of the kink
    in the plain forward, where the two paths' roundings could take
    opposite sides: one such z of stage 0 put a bias gradient 1.4 % off
    the plain one, a function's difference and not the kernels'."""
    from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as k7
    from parallelwavegan_tpu_torch.train.criterion import build_criterion
    from parallelwavegan_tpu_torch.train.step import aux_losses

    cls = get_model_class("MelGANGenerator")
    small = dict(in_channels=16, out_channels=4, channels=192, upsample_scales=(4, 2),
                 stacks=4)
    plain = cls(**small, generator=torch.Generator().manual_seed(4)).to(cuda)
    with torch.no_grad():
        for k, p in plain.named_parameters():
            if k.endswith("weight_g"):
                p.fill_(1.0)
    gen = cls(**small, use_pallas_stacks_train=True).to(cuda)
    gen.load_state_dict(plain.state_dict())
    assert gen.fused_stages == (0, 1)
    assert [gen.melgan[gen._stages[i][2][0]].stack[2].weight_v.shape[0] for i in (0, 1)] \
        == [96, 48]
    dis = get_model_class("MelGANMultiScaleDiscriminator")(
        channels=16, max_downsample_channels=64, downsample_scales=(4, 4, 4),
        generator=torch.Generator().manual_seed(7)).to(cuda)
    config = {"generator_params": small, "use_subband_stft_loss": True,
              "stft_loss_params": {"fft_sizes": [1024, 2048, 512],
                                   "hop_sizes": [120, 240, 50],
                                   "win_lengths": [600, 1200, 240]},
              "subband_stft_loss_params": {"fft_sizes": [384, 683, 171],
                                           "hop_sizes": [30, 60, 10],
                                           "win_lengths": [150, 300, 60]},
              "lambda_adv": 2.5}
    crit = build_criterion(config)
    frames = 64  # sub-bands of 512 samples, past the 683-point FFT's pad
    g = torch.Generator().manual_seed(5)
    c = _mel_off_the_kinks(plain, torch.randn(2, 16, frames, generator=g).to(cuda), 6,
                           gen.fused_stages)
    y = (0.3 * torch.randn(2, 1, frames * 32, generator=g)).to(cuda)

    def losses(out):
        metrics = {}
        aux, y_full = aux_losses(crit, out, y, metrics)
        metrics["adversarial_loss"] = crit.gen_adv(dis(y_full))
        return aux + crit.lambda_adv * metrics["adversarial_loss"], metrics

    out = plain(c).detach().requires_grad_()
    loss, want = losses(out)
    step_cot = torch.autograd.grad(loss, out)[0]
    _refuse(monkeypatch, k7, "melgan_stacks_reference")
    _refuse(monkeypatch, k7, "melgan_stacks_backward_reference")
    with torch.no_grad():
        got = losses(gen(c))[1]
    assert sorted(got) == sorted(want) and "sub_log_stft_magnitude_loss" in got
    for k in want:
        rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
        assert rel <= 1e-4, (k, float(got[k]), float(want[k]))
    ref = dict(plain.named_parameters())
    for cot in (torch.randn(2, 4, frames * 8, generator=g).to(cuda), step_cot):
        for m in (plain, gen):
            m.zero_grad()
        (plain(c) * cot).sum().backward()
        before = (k7.melgan_stacks_backward.launches,
                  dict(stack_mod.fused_melgan_stacks.launches_by_width),
                  dict(k7.melgan_stacks_backward.launches_by_width))
        (gen(c) * cot).sum().backward()
        torch.cuda.synchronize()
        assert k7.melgan_stacks_backward.launches == before[0] + 9  # 8 stacks, final
        for c_, k6_n, k7_n in ((96, 4 + 3, 4), (48, 5 + 5, 5)):  # forward + re-run
            assert stack_mod.fused_melgan_stacks.launches_by_width.get(c_, 0) \
                == before[1].get(c_, 0) + k6_n
            assert k7.melgan_stacks_backward.launches_by_width.get(c_, 0) \
                == before[2].get(c_, 0) + k7_n
        _assert_grads_close([(k, p.grad, ref[k].grad) for k, p in gen.named_parameters()],
                            strict=True)


def test_melgan_backward_rejects_unsupported_input(cuda):
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        melgan_stacks_backward,
    )

    stacks, final, x, dy = _k7_case(cuda, 32, 1, 64, None, True, (1,))
    with pytest.raises(ValueError, match="dy"):
        melgan_stacks_backward(x, stacks, final, 0.2, "reflect", dy[:, :32])
    with pytest.raises(ValueError, match="reflect padding"):
        melgan_stacks_backward(x[:, :9], _on(_melgan_stacks(32, (9,), 0), cuda),
                               None, 0.2, "reflect", dy[:, :9])


# ---------------------------------------------------------------------------
# bf16-resident modes of K6 and K7 (mixed_precision training)
# ---------------------------------------------------------------------------


def _bf16_close(got, want) -> bool:
    """The bf16 modes' bound against their plain versions: rms|diff| <=
    1e-3 rms|plain| and max|diff| <= 1e-2 max|plain|. Both round the same
    operands to bf16 and add exact products in float32, in other orders, so
    they part where a float32 value sits within that difference of a bf16
    rounding point: one bf16 step (2^-8) in one operand, which the chain of
    stacks spreads (measured up to 2.8e-4 rms at C = 128, three stacks of
    gain one, on an H100). A rounding missed, added or truncated moves every
    value coherently: the float32 kernel, or weights cut to bf16 by
    truncation, differ by about 2e-3 to 4e-3 rms."""
    d, w = (got.float() - want.float()), want.float()
    return (float(d.pow(2).mean().sqrt()) <= 1e-3 * float(w.pow(2).mean().sqrt())
            and float(d.abs().max()) <= 1e-2 * float(w.abs().max()))


def _as(stacks, final, dtype):
    sts = [{k: v.to(dtype) if torch.is_tensor(v) else v for k, v in st.items()}
           for st in stacks]
    fin = None if final is None else tuple(None if v is None else v.to(dtype)
                                           for v in final)
    return sts, fin


def _kernel_chain(x, stacks, final, mode):
    """The inputs of stacks 1, 2, .. and of the final conv (or the stage's
    output) as K6's bf16 mode computes them in float32 (K7's re-run)."""
    xs = []
    with torch.no_grad():
        stack_mod._run_cuda_bf16(x, stacks, final, 0.2, mode, outs=xs, keep_f32=True)
    return xs


def _off_the_kinks_bf16(x, stacks, final, mode, seed):
    """x (bf16) with its rows moved (0.05 N(0, 1) added, rounded again)
    where K6's bf16 chain puts an input of LeakyReLU computed in float32 (a
    later stack's input, each z, the final conv's input) within 1e-5 of its
    rms of the kink (``_off_the_kinks``); the stage input, bf16, has an
    exact sign."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    for _ in range(50):
        with torch.no_grad():
            fwd = stack_mod.stacks_forward_bf16(x, stacks, final, 0.2, mode,
                                                _kernel_chain(x, stacks, final, mode))
        vals = fwd["xs"][1:] + fwd["zs"] + ([fwd["xf"]] if final is not None else [])
        near = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
        for v in vals:
            near.logical_or_((v.abs() < 1e-5 * v.pow(2).mean().sqrt()).any(2))
        rows = near.nonzero()
        if len(rows) == 0:
            return x
        x = x.float()
        x[rows[:, 0], rows[:, 1]] += 0.05 * torch.randn(
            len(rows), x.shape[2], generator=g, device=x.device)
        x = x.to(torch.bfloat16)
    raise AssertionError("could not move the input off the kinks of LeakyReLU")


def _truncated(stacks):
    """The stacks' weights cut to bf16 by truncation (a control)."""
    return [{k: (v.view(torch.int32) & -65536).view(torch.float32)
             if k in ("wd", "w1", "ws") else v for k, v in st.items()} for st in stacks]


# MelGAN v1's widths (128; 64 and 32 with the final conv to 1), ragged
# replicate and zero cases, MB-MelGAN v2's 96 without biases, the narrowest
# (16, T below the pad), 80 and 112 (C not a multiple of 32); weights given
# in float32 or bf16. The stage's float32 chain (the output K7's re-run
# keeps) is held to the plain version's; the bf16 output is its rounding.
@pytest.mark.parametrize("c,b,t,mode,out_ch,bias,wdtype", [
    (128, 2, 1000, "reflect", None, True, torch.float32),
    (64, 1, 777, "reflect", 1, True, torch.bfloat16),
    (32, 2, 1000, "reflect", 1, True, torch.bfloat16),
    (48, 2, 1000, "edge", 4, True, torch.float32),
    (96, 1, 500, "constant", None, False, torch.bfloat16),
    (16, 3, 5, "edge", 2, True, torch.float32),
    (80, 1, 333, "edge", None, True, torch.float32),
    (112, 1, 200, "reflect", None, True, torch.bfloat16)])
def test_melgan_stacks_bf16_match_plain_version(cuda, c, b, t, mode, out_ch, bias, wdtype):
    stacks = _on(_melgan_stacks(c, (1, 3, 9), seed=11, bias=bias, gain=1.0), cuda)
    rs = np.random.RandomState(12)
    final = None
    if out_ch is not None:
        final = (torch.from_numpy((rs.randn(7, c, out_ch) / (7 * c) ** 0.5)
                                  .astype(np.float32)).to(cuda),
                 torch.from_numpy(rs.randn(out_ch).astype(np.float32)).to(cuda)
                 if bias else None)
    x = torch.from_numpy(rs.randn(b, t, c).astype(np.float32)).to(cuda).to(torch.bfloat16)
    sts, fin = _as(stacks, final, wdtype)
    before = stack_mod.fused_melgan_stacks.bf16_launches
    with torch.no_grad():
        got = stack_mod.fused_melgan_stacks(x, sts, final=fin, pad_mode=mode)
        chain = stack_mod._run_cuda_bf16(x, sts, fin, 0.2, mode, keep_f32=True)
    torch.cuda.synchronize()
    assert stack_mod.fused_melgan_stacks.bf16_launches == before + 2 * (3 + (final is not None))
    assert got.dtype == torch.bfloat16 and torch.equal(got, chain.to(torch.bfloat16))
    want = stack_mod.stacks_forward_bf16(x, sts, fin, 0.2, mode)["y"]
    assert got.shape == want.shape
    assert torch.equal(stack_mod.melgan_stacks_reference_bf16(x, sts, final=fin, pad_mode=mode),
                       want.to(torch.bfloat16))
    assert _bf16_close(chain, want), float((chain - want).abs().max())
    # controls: the float32 kernel on the same values, and weights cut to
    # bf16 by truncation in place of rounding
    with torch.no_grad():
        f32 = stack_mod.fused_melgan_stacks(x.float(), stacks, final=final, pad_mode=mode)
        trunc = stack_mod._run_cuda_bf16(x, _truncated(stacks), final, 0.2, mode,
                                         keep_f32=True)
    assert not _bf16_close(f32, want) and not _bf16_close(trunc, want)


# K7 is held stack by stack: its plain version takes the stacks' inputs
# from K6's bf16 chain (``inputs``), as rounding flips in the chain would
# otherwise move a z across LeakyReLU's kink
@pytest.mark.parametrize("c,b,t,mode,out_ch,bias,dils", [
    (128, 2, 1000, "reflect", None, True, (1, 3, 9)),
    (64, 1, 777, "reflect", 1, True, (1, 3, 9)),
    (32, 1, 10, "reflect", 1, True, (1, 3, 9)),
    (48, 2, 1000, "edge", 4, True, (1, 3, 9)),
    (48, 2, 1000, "constant", 4, True, (1, 3, 9)),
    (80, 1, 333, "edge", None, False, (1, 3, 9, 27)),
    (16, 3, 5, "edge", 2, True, (1, 3)),
    (64, 2, 300, "reflect", None, True, (9,)),
])
def test_melgan_stacks_backward_bf16_matches_plain_version(cuda, c, b, t, mode, out_ch,
                                                           bias, dils):
    from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as k7

    stacks, final, x, dy = _k7_case(cuda, c, b, t, out_ch, bias, dils, mode=mode)
    stacks = [dict(st, **{k: st[k] * 2 for k in ("wd", "w1", "ws")}) for st in stacks]
    x = _off_the_kinks_bf16(x.to(torch.bfloat16), stacks, final, mode, 5)
    dy = dy.to(torch.bfloat16)
    before = k7.melgan_stacks_backward.bf16_launches
    got = k7.melgan_stacks_backward(x, stacks, final, 0.2, mode, dy)
    torch.cuda.synchronize()
    assert k7.melgan_stacks_backward.bf16_launches == before + len(dils) + (final is not None)
    chain = _kernel_chain(x, stacks, final, mode)
    want = _k7_grads(*k7.melgan_stacks_backward_reference_bf16(x, stacks, final, 0.2, mode,
                                                               dy, chain))
    got = _k7_grads(*got)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, r) in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert _bf16_close(g, r), (name, float((g.float() - r.float()).abs().max()),
                                   float(r.float().abs().max()))
        assert not _bf16_close(torch.zeros_like(g), r), name
    # controls: K7's float32 mode on the same values, and weights cut to
    # bf16 by truncation
    for wrong in (k7.melgan_stacks_backward(x.float(), stacks, final, 0.2, mode, dy.float()),
                  k7.melgan_stacks_backward(x, _truncated(stacks), final, 0.2, mode, dy)):
        assert not all(_bf16_close(g, r) for (_, g), (_, r) in zip(_k7_grads(*wrong), want))


def test_melgan_stacks_backward_bf16_is_deterministic(cuda):
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        melgan_stacks_backward,
    )

    stacks, final, x, dy = _k7_case(cuda, 64, 2, 3000, 1, True, (1, 3, 9))
    x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    first = _k7_grads(*melgan_stacks_backward(x, stacks, final, 0.2, "reflect", dy))
    second = _k7_grads(*melgan_stacks_backward(x, stacks, final, 0.2, "reflect", dy))
    torch.cuda.synchronize()
    for (name, a), (_, b) in zip(first, second):
        assert torch.equal(a, b), name


def test_melgan_stage_bf16_trains_through_the_kernels(cuda, monkeypatch):
    """The autograd Function on bf16 weights and input: K6 and K7 in their
    bf16 modes, never a plain version; dx bf16 and every weight gradient in
    its weight's type."""
    from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as k7

    stacks, final, x, dy = _k7_case(cuda, 32, 2, 2000, 1, True, (1, 3, 9))
    sts, fin = _as(stacks, final, torch.bfloat16)
    x = _off_the_kinks_bf16(x.to(torch.bfloat16), sts, fin, "reflect", 6)
    leaves = [x.clone().requires_grad_()] + [
        st[k].clone().requires_grad_() for st in sts for k in k7.STACK_KEYS] + [
        v.clone().requires_grad_() for v in fin]
    _refuse(monkeypatch, k7, "melgan_stacks_reference_bf16")
    _refuse(monkeypatch, k7, "melgan_stacks_backward_reference_bf16")
    n6, n7 = stack_mod.fused_melgan_stacks.bf16_launches, k7.melgan_stacks_backward.bf16_launches
    args = leaves[1:]
    sts_l = [dict(zip(k7.STACK_KEYS, args[6 * i:6 * i + 6]), dilation=st["dilation"])
             for i, st in enumerate(sts)]
    y = k7.fused_melgan_stacks_train(leaves[0], sts_l, final=tuple(args[18:]))
    grads = torch.autograd.grad(y, leaves, dy.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    assert stack_mod.fused_melgan_stacks.bf16_launches == n6 + 4 + 4  # forward, re-run
    assert k7.melgan_stacks_backward.bf16_launches == n7 + 4
    assert all(g.dtype == torch.bfloat16 for g in grads)


def _stacks_k(c, dils, k, seed, bias=True):
    """``_melgan_stacks`` of kernel size k, the weights of gain one."""
    rs = np.random.RandomState(seed)

    def t(*shape, scale):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))

    return [{"wd": t(k, c, c, scale=(k * c) ** -0.5), "bd": t(c, scale=0.1) if bias else None,
             "w1": t(1, c, c, scale=c ** -0.5), "b1": t(c, scale=0.1) if bias else None,
             "ws": t(1, c, c, scale=c ** -0.5), "bs": t(c, scale=0.1) if bias else None,
             "dilation": d} for d in dils]


# csrc/melgan_stack_bf16.cu and csrc/melgan_stack_bwd_bf16.cu on shapes
# the cases above leave out: MB-MelGAN v2's C = 96 at d = 27 with the final
# conv to 4 and T not a multiple of the 128-row tile at B > 1, C = 112 in
# both directions, K = 7 at d = 9, and a pad past what a window holds at C
# = 128 (K = 7, d = 81: P = 243, the taps one at a time in every kernel)
BF16_NEW_CASES = [
    (96, 2, 1000, "reflect", 4, (1, 3, 9, 27), 3),
    (112, 2, 555, "edge", None, (1, 3), 3),
    (64, 2, 700, "reflect", 1, (9,), 7),
    (48, 3, 333, "constant", 4, (3, 27), 7),
    (128, 1, 600, "edge", None, (81,), 7),
]


def _bf16_new_case(cuda, c, b, t, mode, out_ch, dils, k):
    stacks = _on(_stacks_k(c, dils, k, seed=c + k), cuda)
    rs = np.random.RandomState(c + k + 1)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to(cuda)

    final = None
    if out_ch is not None:
        final = (randn(7, c, out_ch, scale=(7 * c) ** -0.5), randn(out_ch, scale=0.1))
    x = _off_the_kinks_bf16(randn(b, t, c).to(torch.bfloat16), stacks, final, mode, c + k)
    dy = randn(b, t, out_ch or c, scale=(b * t) ** -0.5).to(torch.bfloat16)
    return stacks, final, x, dy


@pytest.mark.parametrize("c,b,t,mode,out_ch,dils,k", BF16_NEW_CASES)
def test_melgan_stacks_bf16_more_shapes_match_plain_version(cuda, c, b, t, mode, out_ch, dils,
                                                           k):
    stacks, final, x, _ = _bf16_new_case(cuda, c, b, t, mode, out_ch, dils, k)
    with torch.no_grad():
        got = stack_mod.fused_melgan_stacks(x, stacks, final=final, pad_mode=mode)
        chain = stack_mod._run_cuda_bf16(x, stacks, final, 0.2, mode, keep_f32=True)
    torch.cuda.synchronize()
    assert torch.equal(got, chain.to(torch.bfloat16))
    want = stack_mod.stacks_forward_bf16(x, stacks, final, 0.2, mode)["y"]
    assert _bf16_close(chain, want), float((chain - want).abs().max())
    with torch.no_grad():
        trunc = stack_mod._run_cuda_bf16(x, _truncated(stacks), final, 0.2, mode, keep_f32=True)
    assert not _bf16_close(trunc, want)


@pytest.mark.parametrize("c,b,t,mode,out_ch,dils,k", BF16_NEW_CASES)
def test_melgan_stacks_backward_bf16_more_shapes_match_plain_version(cuda, c, b, t, mode,
                                                                    out_ch, dils, k):
    from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as k7

    stacks, final, x, dy = _bf16_new_case(cuda, c, b, t, mode, out_ch, dils, k)
    got = _k7_grads(*k7.melgan_stacks_backward(x, stacks, final, 0.2, mode, dy))
    torch.cuda.synchronize()
    want = _k7_grads(*k7.melgan_stacks_backward_reference_bf16(
        x, stacks, final, 0.2, mode, dy, _kernel_chain(x, stacks, final, mode)))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, r) in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert _bf16_close(g, r), (name, float((g.float() - r.float()).abs().max()),
                                   float(r.float().abs().max()))
        assert not _bf16_close(torch.zeros_like(g), r), name
    wrong = k7.melgan_stacks_backward(x, _truncated(stacks), final, 0.2, mode, dy)
    assert not all(_bf16_close(g, r) for (_, g), (_, r) in zip(_k7_grads(*wrong), want))


@pytest.mark.parametrize("c,ks,wdtype,bias", [
    (128, (3, 3, 3), torch.float32, True), (48, (3, 7), torch.bfloat16, False),
    (16, (5,), torch.bfloat16, True)])
def test_melgan_bf16_layout_kernel_matches_plain_version(cuda, c, ks, wdtype, bias):
    """``kernel_weights_bf16`` on the card (csrc/melgan_stack_bf16.cu's
    layout kernel) gives ``mma_bf16.stack_wgmma``'s tiles and the packed
    biases bit for bit."""
    from parallelwavegan_tpu_torch.ops.kernels import mma_bf16

    stacks = []
    for i, k in enumerate(ks):
        st = _stacks_k(c, (1,), k, seed=i, bias=bias)[0]
        stacks.append({key: v.to(cuda).to(wdtype) if torch.is_tensor(v) else v
                       for key, v in st.items()})
    before = stack_mod.kernel_weights_bf16.launches
    tiles, biases = stack_mod.kernel_weights_bf16(stacks)
    torch.cuda.synchronize()
    assert stack_mod.kernel_weights_bf16.launches == before + 1
    for got, want in zip(tiles, mma_bf16.stack_wgmma(stacks)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    for got, want in zip(biases, stack_mod._packed_biases(stacks)):
        assert torch.equal(got, want.float())


def test_melgan_stacks_bf16_is_deterministic(cuda):
    stacks, final, x, _ = _bf16_new_case(cuda, 96, 2, 1000, "reflect", 4, (1, 3, 9, 27), 3)
    with torch.no_grad():
        first = stack_mod._run_cuda_bf16(x, stacks, final, 0.2, "reflect", keep_f32=True)
        second = stack_mod._run_cuda_bf16(x, stacks, final, 0.2, "reflect", keep_f32=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_gated_resblock_trains_on_the_card(cuda):
    """K5 forward, backward by autograd of the plain block (as JAX)."""
    w = _wavenet_weights(1, 64, 80, seed=2)
    rs = np.random.RandomState(3)
    inputs = [torch.from_numpy(rs.randn(2, 777, 64).astype(np.float32)),
              torch.from_numpy(rs.randn(2, 777, 80).astype(np.float32))]
    inputs += [w[key][0] for key in WEIGHT_KEYS]
    grads = []
    for fn in (fused_gated_resblock, gated_resblock_reference):
        leaves = [v.to(cuda).requires_grad_() for v in inputs]
        before = fused_gated_resblock.launches
        r, s = fn(*leaves, dilation=4, causal=True)
        ((r ** 2).sum() + (s ** 2).sum()).backward()
        torch.cuda.synchronize()
        grads.append([v.grad for v in leaves])
        assert fused_gated_resblock.launches == before + (fn is fused_gated_resblock)
    _assert_grads_close([(f"input {i}", g, r) for i, (g, r) in enumerate(zip(*grads))])


@pytest.mark.parametrize("c,b,t", [(64, 1, 4099), (32, 2, 1000), (128, 1, 777),
                                   (16, 3, 7)])
def test_mrf_matches_plain_version(cuda, c, b, t):
    gen = get_model_class("HiFiGANGenerator")(
        in_channels=8, channels=2 * c, upsample_scales=(2,),
        upsample_kernel_sizes=(4,), generator=torch.Generator().manual_seed(c))
    gen.remove_weight_norm()
    gen.to(cuda)
    blocks = gen.mrf_weights(0)
    x = torch.from_numpy(np.random.RandomState(2).randn(b, t, c)
                         .astype(np.float32)).to(cuda)
    before = (mrf_mod.fused_hifigan_mrf.calls, mrf_mod.fused_hifigan_mrf.launches)
    routes = _routes()
    with torch.inference_mode():
        got = mrf_mod.fused_hifigan_mrf(x, blocks)
        torch.cuda.synchronize()
        want = mrf_mod.hifigan_mrf_reference(x, blocks)
    assert (mrf_mod.fused_hifigan_mrf.calls, mrf_mod.fused_hifigan_mrf.launches) == (
        before[0] + 1, before[1] + 4)  # 3 dilation depths and the mean
    assert _routes() == (routes[0] + 3, routes[1])  # on the tensor cores
    assert got.shape == want.shape == (b, t, c)
    err = float((got - want).abs().max())
    assert err <= 2e-4 and err <= 1e-4 * float(want.abs().max())


def test_hifigan_generator_mrf_through_the_kernel(cuda, monkeypatch):
    kw = dict(in_channels=8, channels=256, upsample_scales=(4, 4, 2, 2),
              upsample_kernel_sizes=(8, 8, 4, 4))
    plain = get_model_class("HiFiGANGenerator")(
        **kw, generator=torch.Generator().manual_seed(6))
    gen = get_model_class("HiFiGANGenerator")(**kw, use_pallas_mrf=True)
    gen.load_state_dict(plain.state_dict())
    for m in (plain, gen):
        m.remove_weight_norm()
        m.eval().to(cuda)
    gen.prepare_kernels()
    assert gen.mrf_stages == (1, 2, 3)
    c = torch.randn(1, 8, 33, generator=torch.Generator().manual_seed(7)).to(cuda)
    with torch.inference_mode():
        want = plain(c)
        _refuse(monkeypatch, mrf_mod, "hifigan_mrf_reference")
        before = mrf_mod.fused_hifigan_mrf.calls
        got = gen(c)
    torch.cuda.synchronize()
    assert mrf_mod.fused_hifigan_mrf.calls == before + 3
    assert float((got - want).abs().max()) <= 2e-4


def test_mrf_kernel_rejects_unsupported_width(cuda):
    gen = get_model_class("HiFiGANGenerator")(
        in_channels=8, channels=512, upsample_scales=(2,), upsample_kernel_sizes=(4,))
    gen.remove_weight_norm()
    gen.to(cuda)
    with pytest.raises(ValueError, match="MRF width 256"):
        mrf_mod.fused_hifigan_mrf(torch.zeros(1, 16, 256, device=cuda),
                                  gen.mrf_weights(0))


def _tade_block(seed, scale=2, dilation=2, bias=True, aux=64):
    rs = np.random.RandomState(seed)
    out = {"scale": scale, "dilation": dilation}
    for key in tade_mod.WEIGHT_KEYS:
        cin = aux if key == "aux1" else 64
        cout = 64 if key.startswith("aux") else 128
        out[f"{key}_w"] = torch.from_numpy(
            (rs.randn(9, cin, cout) / (9 * cin) ** 0.5).astype(np.float32))
        out[f"{key}_b"] = torch.from_numpy(
            ((rs.randn(cout) * 0.1) if bias else np.zeros(cout)).astype(np.float32))
    return out


def _tade_on(blk, device):
    return {k: v.to(device) if torch.is_tensor(v) else v for k, v in blk.items()}


def _tade_chain_reference(x, c, blocks, gated):
    for blk in blocks:
        x, c = tade_mod.tade_block_reference(x, c, blk, gated_function=gated)
    return x, c


# the ragged cases of chip_smoke.py: B=2, odd T, scales (2, 1), both gates,
# no biases, T below one halo (12 rows), and dilations 1 to 4; T of a
# whole number of K8a's 112-row tiles (and of K8b's at D = 1, 224 rows),
# one row past a tile, below a halo at D = 3 and 4, and at D = 3 and 4 at
# scale 2 (K8b's tiles of 96 and 88 rows)
@pytest.mark.parametrize("b,t,gated,bias,dilation", [
    (2, 1001, "softmax", True, 2), (2, 1001, "sigmoid", True, 2),
    (1, 333, "softmax", False, 2), (2, 5, "softmax", True, 2),
    (1, 130, "sigmoid", True, 1), (1, 200, "softmax", True, 4),
    (2, 224, "softmax", True, 1), (2, 113, "sigmoid", True, 3),
    (1, 9, "softmax", True, 3), (2, 23, "softmax", True, 4),
    (2, 700, "softmax", False, 3), (1, 1003, "sigmoid", True, 4)])
def test_tade_kernels_match_plain_version(cuda, b, t, gated, bias, dilation):
    blocks = [_tade_on(_tade_block(s, scale=sc, dilation=dilation, bias=bias), cuda)
              for s, sc in ((1, 2), (2, 1))]
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(b, t, 64).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rs.randn(b, t, 64).astype(np.float32)).to(cuda)
    f = tade_mod.fused_tade_blocks
    before = (f.calls, f.launches_k8a, f.launches_k8b)
    with torch.inference_mode():
        got = f(x, c, blocks, gated_function=gated, min_fused_t=1)
        torch.cuda.synchronize()
        want = _tade_chain_reference(x, c, blocks, gated)
    assert (f.calls, f.launches_k8a, f.launches_k8b) == (
        before[0] + 1, before[1] + 2, before[2] + 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (b, 2 * t, 64)
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


def test_tade_halves_match_plain_version(cuda):
    blk = _tade_on(_tade_block(4), cuda)
    rs = np.random.RandomState(5)
    x, c = (torch.from_numpy(rs.randn(2, 777, 64).astype(np.float32)).to(cuda)
            for _ in range(2))
    with torch.inference_mode():
        x2, a = tade_mod.tade1_cuda(x, c, blk)
        x2r, ar = (v.contiguous() for v in tade_mod.tade1_reference(x, c, blk))
        with pytest.raises(ValueError, match="contiguous"):
            tade_mod.tade2_cuda(x, x2r, ar.transpose(1, 2).contiguous().transpose(1, 2),
                                blk)
        out, a2 = tade_mod.tade2_cuda(x, x2r, ar, blk)
        outr, a2r = tade_mod.tade2_reference(x, x2r, ar, blk)
    torch.cuda.synchronize()
    for g, w in ((x2, x2r), (a, ar), (out, outr), (a2, a2r)):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


def _save_reference(x, c_or_a, blk, half):
    """What the Save variant writes, from the plain convs: K8a (a, y, s, t),
    K8b (a2, y, s, t, up(a)) at the kernel's rate."""
    sc = 1 if half == 1 else int(blk["scale"])
    d = 1 if half == 1 else int(blk["dilation"])
    aux, g, gc = tade_mod.WEIGHT_KEYS[:3] if half == 1 else tade_mod.WEIGHT_KEYS[3:]
    src = tade_mod._stretch(c_or_a, sc)
    a = tade_mod._conv(src, blk[f"{aux}_w"], blk[f"{aux}_b"])
    s, h = tade_mod._conv(a, blk[f"{g}_w"], blk[f"{g}_b"]).chunk(2, dim=-1)
    mean, rstd = tade_mod._stats(x)
    y = s * tade_mod._stretch((x - mean[:, None]) * rstd[:, None], sc) + h
    t = tade_mod._conv(y, blk[f"{gc}_w"], blk[f"{gc}_b"], d)
    return (a, y, s, t) if half == 1 else (a, y, s, t, src)


@pytest.mark.parametrize("b,t,scale,dilation", [
    (2, 337, 2, 2), (1, 224, 1, 1), (2, 101, 2, 4), (1, 6, 2, 3)])
def test_tade_save_variant_matches_plain_version(cuda, b, t, scale, dilation):
    """K8a's and K8b's re-run for K9 (the Save variant: a, y, s, t and
    up(a)) against the plain convs, and the kernels with the weights split
    once (``with_fragments``) bit for bit those that split per call."""
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9

    blk = _tade_on(_tade_block(8, scale=scale, dilation=dilation), cuda)
    rs = np.random.RandomState(9)
    x, c = (torch.from_numpy(rs.randn(b, t, 64).astype(np.float32)).to(cuda)
            for _ in range(2))
    with torch.inference_mode():
        x2, a = tade_mod.tade1_cuda(x, c, blk)
        got1 = k9.tade1_rerun_cuda(x, c, blk, "softmax", *tade_mod._stats(x))
        got2 = k9.tade2_rerun_cuda(x, x2, a, blk, "softmax", *tade_mod._stats(x2))
        want1 = _save_reference(x, c, blk, 1)
        want2 = _save_reference(x2, a, blk, 2)
        pre = tade_mod.with_fragments(blk)
        cached = (tade_mod.tade1_cuda(x, c, pre), tade_mod.tade2_cuda(x, x2, a, pre))
        fresh = (tade_mod.tade1_cuda(x, c, blk), tade_mod.tade2_cuda(x, x2, a, blk))
    torch.cuda.synchronize()
    assert (got2[4] is None) == (scale == 1)
    for name, g, w in zip(("a", "y", "s", "t", "a2", "y2", "s2", "t2", "ua"),
                          got1 + got2, want1 + want2):
        if g is None:
            continue
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4, msg=name)
    for p, q in zip(cached, fresh):
        for u, v in zip(p, q):
            assert torch.equal(u, v)


def test_tade_kernels_are_deterministic(cuda):
    """K8a and K8b, the decode and the Save variant, give the same bits in
    two runs (every sum in a fixed order, no atomics)."""
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9

    blk = _tade_on(_tade_block(10, scale=2, dilation=2), cuda)
    rs = np.random.RandomState(11)
    x, c = (torch.from_numpy(rs.randn(2, 3001, 64).astype(np.float32)).to(cuda)
            for _ in range(2))

    def run():
        with torch.inference_mode():
            x2, a = tade_mod.tade1_cuda(x, c, blk)
            out = tade_mod.tade2_cuda(x, x2, a, blk)
            save1 = k9.tade1_rerun_cuda(x, c, blk, "softmax", *tade_mod._stats(x))
            save2 = k9.tade2_rerun_cuda(x, x2, a, blk, "softmax", *tade_mod._stats(x2))
        return [x2, a, *out, *save1, *save2]

    first, second = run(), run()
    torch.cuda.synchronize()
    for i, (p, q) in enumerate(zip(first, second)):
        assert torch.equal(p, q), i


def test_style_melgan_generator_through_the_kernels(cuda, monkeypatch):
    cls = get_model_class("StyleMelGANGenerator")
    small = dict(in_channels=32, aux_channels=80, noise_upsample_scales=(11, 2),
                 upsample_scales=(2, 2, 2, 1))
    plain = cls(**small, generator=torch.Generator().manual_seed(4))
    gen = cls(**small, use_pallas_tade=True, pallas_tade_min_t=100)
    gen.load_state_dict(plain.state_dict())
    for m in (plain, gen):
        m.remove_weight_norm()
        m.eval().to(cuda)
    gen.prepare_kernels()
    c = torch.randn(1, 80, 88, generator=torch.Generator().manual_seed(5)).to(cuda)
    z = torch.randn(1, 32, 4, generator=torch.Generator().manual_seed(6)).to(cuda)
    f = tade_mod.fused_tade_blocks
    with torch.inference_mode():
        want = plain(c, z)
        _refuse(monkeypatch, tade_mod, "tade_block_reference")
        before = (f.launches_k8a, f.launches_k8b)
        got = gen(c, z)  # block inputs 88, 176, 352, 704: blocks 1-3 gated
    torch.cuda.synchronize()
    assert (f.launches_k8a, f.launches_k8b) == (before[0] + 3, before[1] + 3)
    assert got.shape == want.shape == (1, 1, 88 * 8)
    assert float((got - want).abs().max()) <= 2e-4


def test_tade_kernels_reject_unsupported_input(cuda):
    blk = _tade_on(_tade_block(6), cuda)
    x = torch.zeros(1, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        tade_mod.fused_tade_blocks(x.double(), x.double(), [blk], min_fused_t=1)
    with pytest.raises(ValueError, match="width 64 only"):
        tade_mod.fused_tade_blocks(torch.zeros(1, 64, 32, device=cuda), x, [blk],
                                   min_fused_t=1)
    with pytest.raises(ValueError, match="scale 4"):
        tade_mod.fused_tade_blocks(x, x, [dict(blk, scale=4)], min_fused_t=1)
    with pytest.raises(ValueError, match="contiguous"):
        tade_mod.fused_tade_blocks(torch.zeros(1, 64, 64, device=cuda).transpose(1, 2),
                                   x, [blk], min_fused_t=1)
    w = dict(blk, gc1_w=blk["gc1_w"].clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="inference-only"):
        tade_mod.fused_tade_blocks(x, x, [w], min_fused_t=1)


def _k9_case(cuda, b, t, scale, dilation, bias, seed=7):
    """A block of unit-gain convs, its input and the forward's residuals,
    and cotangents of scale 1 / sqrt(B sT): every gradient of order one."""
    blk = _tade_on(_tade_block(seed, scale=scale, dilation=dilation, bias=bias), cuda)
    rs = np.random.RandomState(seed + 1)

    def randn(*shape, s=1.0):
        return torch.from_numpy((rs.randn(*shape) * s).astype(np.float32)).to(cuda)

    x, c = randn(b, t, 64), randn(b, t, 64)
    u = (b * t * scale) ** -0.5
    return blk, x, c, randn(b, scale * t, 64, s=u), randn(b, scale * t, 64, s=u)


def _k9_pairs(got, want):
    (dx, dc, dw), (rx, rc, rw) = got, want
    return [("dx", dx, rx), ("dc", dc, rc)] + [(k, dw[k], rw[k]) for k in rw]


# ragged B and T, scales 1 and 2, both gates, no biases, T of one tile and
# of a few rows, dilations 1 to 4, L not a multiple of the chain's 112-row
# tile, and stage-2 rows just below and above a 1,024-row slab boundary
@pytest.mark.parametrize("b,t,scale,gated,bias,dilation", [
    (2, 1002, 2, "softmax", True, 2), (2, 1002, 1, "sigmoid", True, 2),
    (1, 334, 2, "softmax", False, 2), (2, 6, 2, "softmax", True, 2),
    (1, 130, 1, "softmax", True, 1), (1, 200, 2, "sigmoid", True, 4),
    (1, 500, 2, "softmax", True, 3), (2, 225, 1, "sigmoid", True, 2),
    (1, 511, 2, "softmax", True, 2), (1, 513, 2, "softmax", True, 2)])
def test_tade_backward_matches_plain_version(cuda, b, t, scale, gated, bias, dilation):
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9

    blk, x, c, dxo, dco = _k9_case(cuda, b, t, scale, dilation, bias)
    x2, a = (v.contiguous() for v in tade_mod.tade1_reference(x, c, blk, gated))
    f = k9.tade_block_backward
    before = (f.launches_k9a, f.launches_k9b)
    got = f(x, c, x2, a, blk, gated, dxo, dco)
    torch.cuda.synchronize()
    assert (f.launches_k9a, f.launches_k9b) == (before[0] + 1, before[1] + 1)
    want = k9.tade_block_backward_reference(x, c, blk, gated, dxo, dco)
    _assert_grads_close(_k9_pairs(got, want), strict=True)
    # each kernel alone against its own plain version
    dxr, dx2, da, g2 = k9.tade2_backward_cuda(x, x2, a, blk, gated, dxo, dco)
    w = k9.tade2_backward_reference(x, x2, a, blk, gated, dxo, dco)
    _assert_grads_close([("dx", dxr, w[0]), ("dx2", dx2, w[1]), ("da", da, w[2])]
                        + [(k, g2[k], w[3][k]) for k in w[3]], strict=True)
    dx2, da = w[1].contiguous(), w[2].contiguous()  # autograd's strides vary
    w1 = k9.tade1_backward_reference(x, c, blk, gated, dx2, da)
    _assert_grads_close(_k9_pairs(k9.tade1_backward_cuda(x, c, blk, gated, dx2, da),
                                  w1), strict=True)


def test_tade_backward_is_deterministic(cuda):
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9

    blk, x, c, dxo, dco = _k9_case(cuda, 2, 3000, 2, 2, True)
    x2, a = tade_mod.tade1_cuda(x, c, blk)
    first = k9.tade_block_backward(x, c, x2, a, blk, "softmax", dxo, dco)
    second = k9.tade_block_backward(x, c, x2, a, blk, "softmax", dxo, dco)
    torch.cuda.synchronize()
    for name, p, q in _k9_pairs(first, second):
        assert torch.equal(p, q), name


def test_style_melgan_generator_trains_through_the_kernels(cuda, monkeypatch):
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9

    cls = get_model_class("StyleMelGANGenerator")
    small = dict(in_channels=32, aux_channels=80, noise_upsample_scales=(11, 2),
                 upsample_scales=(2, 2, 2, 1))
    plain = cls(**small, generator=torch.Generator().manual_seed(4)).to(cuda)
    with torch.no_grad():  # unit-norm filters: gradients of order one
        for k, p in plain.named_parameters():
            if k.endswith("weight_g"):
                p.fill_(1.0)
    gen = cls(**small, use_pallas_tade_train=True, pallas_tade_train_min_t=80).to(cuda)
    gen.load_state_dict(plain.state_dict())
    c = torch.randn(2, 80, 22, generator=torch.Generator().manual_seed(5)).to(cuda)
    z = torch.randn(2, 32, 1, generator=torch.Generator().manual_seed(6)).to(cuda)
    cot = torch.randn(2, 1, 22 * 8, generator=torch.Generator().manual_seed(7)).to(cuda)
    (plain(c, z) * cot).sum().backward()
    for name in ("tade_block_backward_reference", "tade1_reference", "tade2_reference"):
        _refuse(monkeypatch, k9, name)
    f, k8 = k9.tade_block_backward, tade_mod.fused_tade_blocks
    before = (f.launches_k9a, f.launches_k9b, k8.launches_k8a, k8.launches_k8b)
    (gen(c, z) * cot).sum().backward()  # block inputs 22, 44, 88, 176: 2, 3 gated
    torch.cuda.synchronize()
    assert (f.launches_k9a, f.launches_k9b, k8.launches_k8a, k8.launches_k8b) == tuple(
        n + 2 for n in before)
    want = dict(plain.named_parameters())
    _assert_grads_close([(k, p.grad, want[k].grad) for k, p in gen.named_parameters()],
                        strict=True)
    with torch.no_grad():  # the D phase's re-run: K8 alone
        gen(c, z)
    assert (k8.launches_k8a, k8.launches_k8b) == (before[2] + 4, before[3] + 4)
    assert (f.launches_k9a, f.launches_k9b) == (before[0] + 2, before[1] + 2)


def test_tade_backward_rejects_unsupported_input(cuda):
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9

    blk, x, c, dxo, dco = _k9_case(cuda, 1, 64, 2, 2, True)
    x2, a = tade_mod.tade1_cuda(x, c, blk)
    f = k9.tade_block_backward
    before = (f.launches_k9a, f.launches_k9b)
    with pytest.raises(ValueError, match="width 64 only"):
        f(x[..., :32].contiguous(), c, x2, a, blk, "softmax", dxo, dco)
    with pytest.raises(ValueError, match="float32"):
        f(x, c, x2, a, blk, "softmax", dxo.double(), dco)
    with pytest.raises(ValueError, match="contiguous"):
        f(x, c, x2, a, blk, "softmax", dxo,
          torch.zeros(1, 64, 128, device=cuda).transpose(1, 2))
    with pytest.raises(ValueError, match="scale 1 or 2"):
        f(x, c, x2, a, dict(blk, scale=4), "softmax", dxo, dco)
    with pytest.raises(ValueError, match="dilation"):
        f(x, c, x2, a, dict(blk, dilation=5), "softmax", dxo, dco)
    with pytest.raises(ValueError, match="dout"):
        f(x, c, x2, a, blk, "softmax", dxo[:, :64].contiguous(), dco)
    assert (f.launches_k9a, f.launches_k9b) == before


# ---------------------------------------------------------------------------
# bf16-resident modes of K8 and K9 (mixed_precision training)
# ---------------------------------------------------------------------------


def _tade_truncated(blk):
    """The block's weights cut to bf16 by truncation (a control)."""
    return {k: (v.float().view(torch.int32) & -65536).view(torch.float32)
            if k.endswith("_w") else v for k, v in blk.items()}


def _tade_bf16_case(cuda, b, t, scale, dilation, bias, wdtype, seed=21):
    """A unit-gain block (weights in wdtype), bf16 x and c, bf16 cotangents
    of scale 1 / sqrt(B sT), and the block's float32 weights truncated to
    bf16 (a control: truncating bf16 weights would change nothing)."""
    blk, x, c, dxo, dco = _k9_case(cuda, b, t, scale, dilation, bias, seed=seed)
    trunc = _tade_truncated(blk)
    blk = {k: v.to(wdtype) if torch.is_tensor(v) else v for k, v in blk.items()}
    return blk, *(v.to(torch.bfloat16) for v in (x, c, dxo, dco)), trunc


# StyleMelGAN v1's block shapes cut in T (blocks 4-8 are scale 2 or 1,
# dilation 2, softmax), a ragged T of no whole tile, the sigmoid gate, no
# biases, dilations 1, 3 and 4, bf16 and float32 weights; then, for
# csrc/tade_bf16.cu's tiles (176 rows for K8a, 184 - 8D for K8b), lengths
# of no whole tile at B > 1 at each dilation and lengths below one tile
TADE_BF16_FORWARD_CASES = [
    (4, 1408, 2, 2, "softmax", True, torch.bfloat16),
    (4, 2816, 1, 2, "softmax", True, torch.bfloat16),
    (2, 1001, 2, 2, "sigmoid", True, torch.float32),
    (1, 333, 2, 1, "softmax", False, torch.bfloat16),
    (2, 130, 1, 3, "sigmoid", True, torch.float32),
    (1, 200, 2, 4, "softmax", True, torch.bfloat16),
    (3, 261, 1, 1, "sigmoid", True, torch.bfloat16),
    (2, 395, 2, 3, "softmax", True, torch.bfloat16),
    (3, 227, 2, 4, "sigmoid", False, torch.float32),
    (2, 50, 2, 2, "softmax", True, torch.bfloat16),
    (3, 80, 1, 3, "softmax", True, torch.bfloat16)]


@pytest.mark.parametrize("b,t,scale,dilation,gated,bias,wdtype", TADE_BF16_FORWARD_CASES)
def test_tade_bf16_kernels_match_plain_version(cuda, b, t, scale, dilation, gated, bias,
                                               wdtype):
    """K8a and K8b in the bf16 mode against ``tade1_reference_bf16`` /
    ``tade2_reference_bf16`` (K8b on K8a's outputs), to ``_bf16_close``;
    the float32 kernels on the same values and truncated weights are
    rejected."""
    blk, x, c, _, _, tb = _tade_bf16_case(cuda, b, t, scale, dilation, bias, wdtype)
    f = tade_mod.fused_tade_blocks
    before = (f.bf16_launches_k8a, f.bf16_launches_k8b)
    with torch.no_grad():
        x2, a = tade_mod.tade1_cuda(x, c, blk, gated)
        out, a2 = tade_mod.tade2_cuda(x, x2, a, blk, gated)
        want = (*tade_mod.tade1_reference_bf16(x, c, blk, gated),
                *tade_mod.tade2_reference_bf16(x, x2, a, blk, gated))
        b32 = {k: v.float() if torch.is_tensor(v) else v for k, v in blk.items()}
        f32 = (*tade_mod.tade1_cuda(x.float(), c.float(), b32, gated),
               *tade_mod.tade2_cuda(x.float(), x2.float(), a.float(), b32, gated))
        trunc = (*tade_mod.tade1_cuda(x, c, tb, gated),
                 *tade_mod.tade2_cuda(x, x2, a, tb, gated))
    torch.cuda.synchronize()
    assert (f.bf16_launches_k8a, f.bf16_launches_k8b) == (before[0] + 2, before[1] + 2)
    for name, g, w in zip(("x2", "a", "out", "a2"), (x2, a, out, a2), want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert _bf16_close(g, w), (name, float((g.float() - w.float()).abs().max()))
    assert not all(_bf16_close(g, w) for g, w in zip(f32, want))
    assert not all(_bf16_close(g, w) for g, w in zip(trunc, want))


@pytest.mark.parametrize("b,t,scale,dilation,gated,bias,wdtype", TADE_BF16_FORWARD_CASES)
def test_tade_bf16_reruns_match_plain_version(cuda, b, t, scale, dilation, gated, bias,
                                              wdtype):
    """K8a's and K8b's bf16 Save re-runs (``tade1_rerun_cuda``,
    ``tade2_rerun_cuda``: a, y, s, t and up(a)) against
    ``tade1_rerun_reference_bf16`` / ``tade2_rerun_reference_bf16`` on the
    same statistics, to ``_bf16_close``, counted as re-runs; two runs give
    the same bits; truncated weights are rejected."""
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9

    blk, x, c, _, _, tb = _tade_bf16_case(cuda, b, t, scale, dilation, bias, wdtype)
    f = tade_mod.fused_tade_blocks
    with torch.no_grad():
        x2, a = tade_mod.tade1_cuda(x, c, blk, gated)
        m1, r1 = tade_mod._stats(x.float())
        m2, r2 = tade_mod._stats(x2.float())
        before = (f.bf16_rerun_launches_k8a, f.bf16_rerun_launches_k8b)
        got1 = k9.tade1_rerun_cuda(x, c, blk, gated, m1, r1)
        got2 = k9.tade2_rerun_cuda(x, x2, a, blk, gated, m2, r2)
        assert (f.bf16_rerun_launches_k8a, f.bf16_rerun_launches_k8b) == (before[0] + 1,
                                                                          before[1] + 1)
        want1 = k9.tade1_rerun_reference_bf16(x, c, blk, gated, m1, r1)
        want2 = k9.tade2_rerun_reference_bf16(x, x2, a, blk, gated, m2, r2)
        again = (*k9.tade1_rerun_cuda(x, c, blk, gated, m1, r1),
                 *k9.tade2_rerun_cuda(x, x2, a, blk, gated, m2, r2))
        trunc = (*k9.tade1_rerun_cuda(x, c, tb, gated, m1, r1),
                 *k9.tade2_rerun_cuda(x, x2, a, tb, gated, m2, r2))
    torch.cuda.synchronize()
    assert (got2[4] is None) == (scale == 1)
    names = ("a", "y", "s", "t", "a2", "y2", "s2", "t2", "ua")
    for name, g, w, g2, tr in zip(names, (*got1, *got2), (*want1, *want2), again, trunc):
        if w is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _bf16_close(g, w), (name, float((g.float() - w.float()).abs().max()))
        assert torch.equal(g, g2), name
    wrong = [(tr, w) for tr, w in zip(trunc, (*want1, *want2)) if w is not None]
    assert not all(_bf16_close(tr, w) for tr, w in wrong)


@pytest.mark.parametrize("b,t,scale,dilation,gated,bias,wdtype", [
    (4, 1408, 2, 2, "softmax", True, torch.bfloat16),
    (4, 2816, 1, 2, "softmax", True, torch.bfloat16),
    (2, 1002, 2, 2, "sigmoid", True, torch.float32),
    (1, 334, 2, 1, "softmax", False, torch.bfloat16),
    (2, 6, 2, 2, "softmax", True, torch.bfloat16),
    (1, 513, 2, 4, "sigmoid", True, torch.float32),
    # lengths of no whole 112-row chain tile or 448-row weight-gradient
    # chunk of csrc/tade_bwd_bf16.cu, at each dilation
    (2, 507, 1, 1, "softmax", True, torch.bfloat16),
    (1, 285, 2, 2, "sigmoid", False, torch.bfloat16),
    (2, 999, 1, 3, "softmax", True, torch.float32),
    (1, 777, 2, 4, "sigmoid", True, torch.bfloat16)])
def test_tade_bf16_backward_matches_plain_version(cuda, b, t, scale, dilation, gated, bias,
                                                  wdtype):
    """K9b and K9a in the bf16 mode, stage by stage, against their plain
    versions fed the kernels' own re-run (``tade2_backward_reference_bf16``
    / ``tade1_backward_reference_bf16`` with ``rerun``: the bf16 chain of a
    second forward would move values by its own roundings), to
    ``_bf16_close``; the float32 kernels and truncated weights rejected."""
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9

    blk, x, c, dxo, dco, tb = _tade_bf16_case(cuda, b, t, scale, dilation, bias, wdtype)
    with torch.no_grad():
        x2, a = tade_mod.tade1_cuda(x, c, blk, gated)
    f = k9.tade_block_backward
    before = (f.bf16_launches_k9a, f.bf16_launches_k9b)
    got2 = k9.tade2_backward_cuda(x, x2, a, blk, gated, dxo, dco)
    got1 = k9.tade1_backward_cuda(x, c, blk, gated, got2[1], got2[2])
    m2, r2 = tade_mod._stats(x2.float())
    m1, r1 = tade_mod._stats(x.float())
    with torch.no_grad():
        rerun2 = k9.tade2_rerun_cuda(x, x2, a, blk, gated, m2, r2)
        rerun1 = k9.tade1_rerun_cuda(x, c, blk, gated, m1, r1)
    want2 = k9.tade2_backward_reference_bf16(x, x2, a, blk, gated, dxo, dco, rerun2)
    want1 = k9.tade1_backward_reference_bf16(x, c, blk, gated, got2[1], got2[2], rerun1)
    torch.cuda.synchronize()
    assert (f.bf16_launches_k9a, f.bf16_launches_k9b) == (before[0] + 1, before[1] + 1)

    def pairs(g1, g2, w1, w2):
        return ([("dx", g1[0], w1[0]), ("dc", g1[1], w1[1]), ("dx res", g2[0], w2[0]),
                 ("dx2", g2[1], w2[1]), ("da", g2[2], w2[2])]
                + [(k, g1[2][k], w1[2][k]) for k in w1[2]]
                + [(k, g2[3][k], w2[3][k]) for k in w2[3]])

    for name, g, w in pairs(got1, got2, want1, want2):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.dtype == (torch.bfloat16 if name in ("dx", "dc", "dx res", "dx2", "da")
                           else torch.float32), name
        assert _bf16_close(g, w), (name, float((g.float() - w.float()).abs().max()),
                                   float(w.float().abs().max()))
        assert not _bf16_close(torch.zeros_like(g), w), name
    # controls: the float32 kernels on the same values, truncated weights
    b32 = {k: v.float() if torch.is_tensor(v) else v for k, v in blk.items()}
    xf, cf, x2f, af = x.float(), c.float(), x2.float(), a.float()
    g2 = k9.tade2_backward_cuda(xf, x2f, af, b32, gated, dxo.float(), dco.float())
    g1 = k9.tade1_backward_cuda(xf, cf, b32, gated, got2[1].float(), got2[2].float())
    assert not all(_bf16_close(g, w) for _, g, w in pairs(g1, g2, want1, want2))
    g2 = k9.tade2_backward_cuda(x, x2, a, tb, gated, dxo, dco)
    g1 = k9.tade1_backward_cuda(x, c, tb, gated, got2[1], got2[2])
    assert not all(_bf16_close(g, w) for _, g, w in pairs(g1, g2, want1, want2))


@pytest.mark.parametrize("b,t", [(32, 22528), (3, 1001), (2, 50), (5, 1537)])
def test_tade_bf16_statistics_match_torch(cuda, b, t):
    """``stats_cuda`` of a bf16 x (csrc/tade_bf16.cu's statistics, no float32
    copy) against ``_stats`` in float64, within float32 rounding, on rows
    far from zero mean; two runs bit-equal."""
    g = torch.Generator().manual_seed(t)
    x = (torch.randn(b, t, 64, generator=g) * 0.3 + 4.0).to(torch.bfloat16).to(cuda)
    mean, rstd = tade_mod.stats_cuda(x)
    again = tade_mod.stats_cuda(x)
    want_mean, want_rstd = tade_mod._stats(x.double())
    torch.cuda.synchronize()
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == (b, 64)
    assert torch.allclose(mean.double(), want_mean, rtol=2e-6, atol=0)
    assert torch.allclose(rstd.double(), want_rstd, rtol=2e-5, atol=0)
    assert torch.equal(mean, again[0]) and torch.equal(rstd, again[1])


def test_tade_bf16_kernels_are_deterministic(cuda):
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9

    blk, x, c, dxo, dco, _ = _tade_bf16_case(cuda, 2, 3000, 2, 2, True, torch.bfloat16)

    def run():
        with torch.no_grad():
            x2, a = tade_mod.tade1_cuda(x, c, blk)
            out = tade_mod.tade2_cuda(x, x2, a, blk)
        dx, dc, dw = k9.tade_block_backward(x, c, x2, a, blk, "softmax", dxo, dco)
        return [x2, a, *out, dx, dc, *dw.values()]

    first, second = run(), run()
    torch.cuda.synchronize()
    for i, (p, q) in enumerate(zip(first, second)):
        assert torch.equal(p, q), i


def test_style_melgan_generator_trains_bf16_through_the_kernels(cuda, monkeypatch):
    """``mixed_precision``'s bf16 parameters and input through the fused
    train path: K8 and K9 in their bf16 modes, never a plain version; the
    output bf16 and every master gradient float32 and finite."""
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as k9
    from parallelwavegan_tpu_torch.train import precision

    cls = get_model_class("StyleMelGANGenerator")
    small = dict(in_channels=32, aux_channels=80, noise_upsample_scales=(11, 2),
                 upsample_scales=(2, 2, 2, 1))
    gen = cls(**small, use_pallas_tade_train=True, pallas_tade_train_min_t=80,
              generator=torch.Generator().manual_seed(4)).to(cuda)
    c = torch.randn(2, 80, 22, generator=torch.Generator().manual_seed(5)).to(cuda)
    z = torch.randn(2, 32, 1, generator=torch.Generator().manual_seed(6)).to(cuda)
    for name in ("tade_block_backward_reference", "tade1_reference_bf16",
                 "tade2_reference_bf16", "tade1_reference", "tade2_reference"):
        _refuse(monkeypatch, k9, name)
    f, k8 = k9.tade_block_backward, tade_mod.fused_tade_blocks
    before = (f.bf16_launches_k9a, f.bf16_launches_k9b, k8.bf16_launches_k8a,
              k8.bf16_launches_k8b)
    y = precision.call(gen, precision.bf16_params(gen), c.to(torch.bfloat16),
                       z.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 1, 22 * 8)
    y.float().pow(2).mean().backward()  # block inputs 22, 44, 88, 176: 2, 3 gated
    torch.cuda.synchronize()
    assert (f.bf16_launches_k9a, f.bf16_launches_k9b, k8.bf16_launches_k8a,
            k8.bf16_launches_k8b) == tuple(n + 2 for n in before)
    for k, p in gen.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k


def test_tade_bf16_rejects_mixed_input(cuda):
    blk, x, c, dxo, dco, _ = _tade_bf16_case(cuda, 1, 64, 2, 2, True, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        tade_mod.tade1_cuda(x, c.float(), blk)
    with pytest.raises(ValueError, match="float32"):
        tade_mod.fused_tade_blocks(x, c, [blk], min_fused_t=1)


def test_hifigan_train_step_on_the_card_matches_the_cpu(cuda):
    """A small HiFi-GAN generator against the multi-scale multi-period
    discriminator (spectral norm on scale 0, hifigan.v1.yaml's losses):
    two G+D ``TrainStep`` calls on the card and on the CPU from the same
    weights and batches, TF32 off: every loss within 1e-4 relative, the
    spectral (u, v) within 1e-5. No kernel runs on this path."""
    from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config
    from parallelwavegan_tpu_torch.train.criterion import build_criterion
    from parallelwavegan_tpu_torch.train.step import TrainStep

    scale = dict(channels=8, max_downsample_channels=16, max_groups=4,
                 downsample_scales=[2, 2, 1], kernel_sizes=[5, 7, 3, 3])
    period = dict(channels=4, max_downsample_channels=16, downsample_scales=[3, 3, 1])
    adam = {"lr": 2e-4, "betas": [0.5, 0.9], "eps": 1e-6, "weight_decay": 0.0}
    config = {
        "generator_type": "HiFiGANGenerator",
        "generator_params": dict(in_channels=8, channels=32, upsample_scales=[4, 4],
                                 upsample_kernel_sizes=[8, 8]),
        "discriminator_type": "HiFiGANMultiScaleMultiPeriodDiscriminator",
        "discriminator_params": dict(scales=2, scale_discriminator_params=scale,
                                     periods=[2, 3], period_discriminator_params=period),
        "use_stft_loss": False, "use_mel_loss": True,
        "mel_loss_params": dict(fs=8000, fft_size=64, hop_size=16, num_mels=8, fmin=0,
                                fmax=4000, log_base=None),
        "generator_adv_loss_params": {"average_by_discriminators": False},
        "discriminator_adv_loss_params": {"average_by_discriminators": False},
        "use_feat_match_loss": True,
        "feat_match_loss_params": {"average_by_discriminators": False,
                                   "average_by_layers": False},
        "lambda_aux": 45.0, "lambda_feat_match": 2.0,
        "generator_optimizer_type": "Adam", "generator_optimizer_params": adam,
        "discriminator_optimizer_type": "Adam", "discriminator_optimizer_params": adam,
    }
    g = torch.Generator().manual_seed(3)
    batches = [{"y": 0.3 * torch.randn(2, 1, 320, generator=g),
                "c": torch.randn(2, 8, 20, generator=g)} for _ in range(2)]
    got, dis = {}, {}
    for device in ("cuda", "cpu"):
        gen = get_model_class(config["generator_type"])(
            **config["generator_params"], generator=torch.Generator().manual_seed(0))
        dis[device] = get_model_class(config["discriminator_type"])(
            **config["discriminator_params"],
            generator=torch.Generator().manual_seed(1)).to(device)
        gen.to(device)
        step = TrainStep(config, gen, dis[device], build_criterion(config),
                         build_optimizer_from_config(config, "generator", gen.parameters()),
                         build_optimizer_from_config(config, "discriminator",
                                                     dis[device].parameters()))
        got[device] = [{k: float(v) for k, v in step(
            {k: v.to(device) for k, v in b.items()}, True, True, i).items()}
            for i, b in enumerate(batches)]
    for i, (a, b) in enumerate(zip(got["cuda"], got["cpu"])):
        assert sorted(a) == sorted(b) and "feature_matching_loss" in a
        for k in b:
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (i, k, a[k], b[k])
    uv = {k: t for k, t in dis["cpu"].state_dict().items() if k.endswith("weight_u")}
    assert len(uv) == 6
    card = dis["cuda"].state_dict()
    for k in uv:
        for vec in ("u", "v"):
            key = k[:-1] + vec
            torch.testing.assert_close(card[key].cpu(), dis["cpu"].state_dict()[key],
                                       rtol=0, atol=1e-5)
