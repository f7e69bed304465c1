"""Port of the fused HiFi-GAN tail (parallelwavegan_tpu_torch/ops/kernels/
hifigan_tail.py) held against the JAX package.

The same numpy arrays go through the port's plain version and through JAX's
``fused_hifigan_tail`` (the Pallas kernel in interpret mode, as the JAX
package's own tests run it) and ``hifigan_tail_xla``. Tolerance atol 2e-5,
rtol 1e-4: the JAX tail tests' own bound for float32 sums taken in another
order. The dispatch tests check that a CUDA tensor never reaches the plain
version.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.ops.pallas_kernels.hifigan_tail import (  # noqa: E402
    fused_hifigan_tail as jax_fused_tail,
    hifigan_tail_xla,
)
from parallelwavegan_tpu_torch.ops.kernels import hifigan_tail as port  # noqa: E402


def _make_blocks(rs, c, kernel_sizes=(3, 7, 11)):
    return [{
        "w1": (rs.randn(3, k, c, c) * 0.05).astype(np.float32),
        "b1": (rs.randn(3, c) * 0.01).astype(np.float32),
        "w2": (rs.randn(3, k, c, c) * 0.05).astype(np.float32),
        "b2": (rs.randn(3, c) * 0.01).astype(np.float32),
        "dilations": (1, 3, 5),
    } for k in kernel_sizes]


def _make_tail(seed, b, t0, c0, pre_kernel_sizes=None):
    """Numpy inputs in the shapes of tests/test_hifigan_tail_kernel.py."""
    rs = np.random.RandomState(seed)
    pre = (_make_blocks(rs, c0, pre_kernel_sizes)
           if pre_kernel_sizes is not None else None)
    stages, cin = [], c0
    for _ in range(2):
        cout = cin // 2
        stages.append({
            "deconv_w": (rs.randn(4, cin, cout) * 0.05).astype(np.float32),
            "deconv_b": (rs.randn(cout) * 0.01).astype(np.float32),
            "stride": 2, "padding": 1, "blocks": _make_blocks(rs, cout),
        })
        cin = cout
    final_w = (rs.randn(7, cin, 1) * 0.05).astype(np.float32)
    final_b = (rs.randn(1) * 0.01).astype(np.float32)
    x = (rs.randn(b, t0, c0) * 0.1).astype(np.float32)
    return x, stages, final_w, final_b, pre


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: (v if k in ("stride", "padding", "dilations")
                    else _tree(v, fn)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    if tree is None:
        return None
    return fn(tree)


@pytest.mark.parametrize("c0,t0,pre", [
    (128, 300, None), (64, 128, None), (32, 96, None), (64, 120, (3, 7)),
])
def test_reference_matches_jax_tail(c0, t0, pre):
    b = 1 if pre else 2
    x, stages, fw, fb, pre_blocks = _make_tail(0, b, t0, c0, pre)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    jx = (j(x), _tree(stages, j), j(fw), j(fb))
    want_pallas = np.asarray(jax_fused_tail(
        *jx, pre_blocks=_tree(pre_blocks, j), t_tile=64, interpret=True))
    want_xla = np.asarray(hifigan_tail_xla(*jx, pre_blocks=_tree(pre_blocks, j)))

    t = torch.from_numpy
    got = port.hifigan_tail_reference(
        t(x), _tree(stages, t), t(fw), t(fb), pre_blocks=_tree(pre_blocks, t))
    assert got.shape == (b, t0 * 4, 1)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=2e-5, rtol=1e-4)


def test_wrapper_takes_plain_version_on_cpu():
    x, stages, fw, fb, pre = _make_tail(1, 2, 50, 16, (3,))
    t = torch.from_numpy
    args = (t(x), _tree(stages, t), t(fw), t(fb))
    before = port.fused_hifigan_tail.launches
    got = port.fused_hifigan_tail(*args, pre_blocks=_tree(pre, t))
    want = port.hifigan_tail_reference(*args, pre_blocks=_tree(pre, t))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert port.fused_hifigan_tail.launches == before


def _cuda_like(shape=(1, 8, 16)):
    x = mock.MagicMock(name="cuda_tensor")
    x.device = torch.device("cuda", 0)
    x.shape = shape
    return x


def test_cuda_tensor_never_takes_plain_version():
    x = _cuda_like()
    before = port.fused_hifigan_tail.launches
    with mock.patch.object(port, "hifigan_tail_reference") as ref, \
            mock.patch.object(port, "_run_cuda", return_value="out") as run:
        assert port.fused_hifigan_tail(x, [], None, None) == "out"
    ref.assert_not_called()
    run.assert_called_once()
    assert port.fused_hifigan_tail.launches == before + 1
    port.fused_hifigan_tail.launches = before


def test_cuda_failure_raises_instead_of_falling_back():
    """A build that fails (no nvcc) raises; nothing falls back."""
    from parallelwavegan_tpu_torch.ops.kernels import build

    x, stages, fw, fb, _ = _make_tail(2, 1, 40, 16)
    t = torch.from_numpy
    before = port.fused_hifigan_tail.launches
    with mock.patch.object(port, "hifigan_tail_reference") as ref, \
            mock.patch.object(port, "_check_cuda_inputs"), \
            mock.patch.object(build, "load",
                              side_effect=RuntimeError("nvcc not found")):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            port._run_cuda(t(x), _tree(stages, t), t(fw), t(fb), 0.1, None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            port.fused_hifigan_tail(_cuda_like(), _tree(stages, t), t(fw), t(fb))
    ref.assert_not_called()
    assert port.fused_hifigan_tail.launches == before


@pytest.mark.parametrize("bad,match", [
    ("dtype", "float32"), ("width", "power of two"), ("block", "w2"),
    ("deconv", "shape"),
])
def test_cuda_input_checks(bad, match):
    """The CUDA path refuses what the kernel does not take (checked on CPU
    tensors: the checks look at dtype, shape and contiguity only)."""
    x, stages, fw, fb, _ = _make_tail(3, 1, 20, 16)
    t = torch.from_numpy
    x, stages, fw, fb = t(x), _tree(stages, t), t(fw), t(fb)
    if bad == "dtype":
        x = x.double()
    elif bad == "width":
        x = torch.zeros(1, 20, 12)
    elif bad == "block":
        del stages[0]["blocks"][1]["w2"]
    else:
        stages[1]["deconv_w"] = stages[1]["deconv_w"][:, :, :2].contiguous()
    with pytest.raises(ValueError, match=match):
        port._check_cuda_inputs(x, stages, fw, fb, None)


def test_cuda_input_checks_accept_valid_bundle():
    x, stages, fw, fb, pre = _make_tail(4, 2, 20, 32, (3, 7))
    t = torch.from_numpy
    port._check_cuda_inputs(t(x), _tree(stages, t), t(fw), t(fb), _tree(pre, t))
