"""The fused HiFi-GAN tail kernel on a CUDA device, against its plain version.

These tests need an NVIDIA GPU with sm_90a (Hopper) and nvcc; elsewhere
they skip. They import no JAX, so they run on a machine that has only
torch (``tests/conftest.py`` imports jax, hence ``--noconftest``):
    python -m pytest tests/test_torch_port_cuda.py -m gpu --noconftest
Tolerance 2e-4 (ROADMAP.md's kernel bound); TF32 is off for the plain
version's cuDNN convolutions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (  # noqa: E402
    fused_hifigan_tail,
    hifigan_tail_reference,
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
    before = fused_hifigan_tail.launches
    got = fused_hifigan_tail(*args, **kw)
    torch.cuda.synchronize()
    assert fused_hifigan_tail.launches == before + 1
    want = hifigan_tail_reference(*args, **kw)
    assert got.shape == want.shape == (b, t0 * 4, 1)
    assert float((got - want).abs().max()) <= 2e-4


def test_generator_decode_through_kernel(cuda):
    gen = _generator(64, seed=2).to(cuda)
    plain = get_model_class("HiFiGANGenerator")(
        in_channels=8, channels=64, upsample_scales=(4, 4, 2, 2),
        upsample_kernel_sizes=(8, 8, 4, 4))
    plain.remove_weight_norm()
    plain.load_state_dict(gen.state_dict())
    plain.eval().to(cuda)
    gen.prepare_tail()
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
