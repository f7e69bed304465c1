"""Fused HiFi-GAN MRF stage: the mean over resblocks of one upsample stage
(K2a and K2b).

Counterpart of parallelwavegan_tpu/ops/pallas_kernels/hifigan_mrf.py
(``hifigan_mrf_xla`` :52, ``fused_hifigan_mrf`` :178,
``fused_hifigan_mrf_packed`` :399). The TPU package splits the stage into
a packed kernel for C <= 64 and an unpacked one above, a choice of how to
fill the MXU's 128 lanes; here one wrapper serves both. The public
functions keep the JAX layout and block form, so a test can feed the same
arrays to both packages: x is (B, T, C) and ``blocks`` is a list of
{w1 (n_dil, K, C, C), b1 (n_dil, C), w2, b2, dilations}.

For a CUDA tensor ``fused_hifigan_mrf`` runs the port's residual-unit
kernel (csrc/hifigan_tail.cu, ``hifigan_resunits`` and ``hifigan_mean``,
the kernels that run the MRFs inside the decode tail): one launch per
dilation depth across the stage's resblocks, then one for the mean. At
widths 16-128 the units run on the tensor cores in split TF32, on the
weights' split that the blocks carry as ``f1``/``f2``
(``hifigan_tail.with_fragments``, which decode's ``prepare_kernels``
calls once) or that each call makes. For a CPU tensor it runs the plain
PyTorch version ``hifigan_mrf_reference``, which ignores the split. A
CUDA tensor never takes the plain path. The kernel has no backward, so a
forward that would need gradients raises.
"""

from __future__ import annotations

from parallelwavegan_tpu_torch.ops.kernels import build
from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
    _WIDTHS,
    _check_blocks,
    _mrf,
    run_mrf,
)
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import MRF_WIDTHS


def hifigan_mrf_reference(x, blocks, *, slope: float = 0.1):
    """Plain MRF stage: x (B, T, C) -> mean of the resblocks, (B, T, C)."""
    return _mrf(x.transpose(1, 2), blocks, slope).transpose(1, 2)


def _check_cuda_inputs(x, blocks) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    b, t, c = x.shape
    # the tensor-core residual units read x in 16-byte pieces
    build.check_tensor("x", x, x.device, (b, t, c), align=16 if c in MRF_WIDTHS else 0)
    if c not in _WIDTHS:
        raise ValueError(f"MRF width {c} is not a power of two <= 128, the "
                         "widths the residual-unit kernel is built for")
    _check_blocks("blocks", blocks, x.device, c)


def fused_hifigan_mrf(x, blocks, *, slope: float = 0.1):
    """One MRF stage: x (B, T, C) -> (B, T, C).

    A CUDA tensor goes through the residual-unit kernel (C a power of two
    <= 128, 1 to 8 resblocks with w2/b2, odd kernel sizes; float32,
    contiguous; each block's split ``f1``/``f2`` of ``with_fragments``
    used where it has one) and raises on anything it does not take; a CPU
    tensor goes through ``hifigan_mrf_reference``.
    ``fused_hifigan_mrf.calls`` counts the calls that ran the kernel,
    ``.launches`` its launches (``run_mrf``'s counters split the
    residual-unit launches by route). ``build.check_grid`` refuses, on any
    device, a batch or a length that the kernel's grid cannot take.
    """
    build.refuse_training("the fused MRF kernel (K2)", [x] + [
        blk[k] for blk in blocks for k in ("w1", "b1", "w2", "b2") if k in blk])
    if x.dim() == 3:
        build.check_grid("fused_hifigan_mrf", x.shape[0], x.shape[1])
    if x.device.type == "cpu":
        return hifigan_mrf_reference(x, blocks, slope=slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_hifigan_mrf: unsupported device {x.device}")
    _check_cuda_inputs(x, blocks)
    lib = build.load()
    dev, stream = build.launch_target(x)
    out, launches = run_mrf(lib, x, blocks, slope, dev, stream)
    fused_hifigan_mrf.launches += launches
    fused_hifigan_mrf.calls += 1
    return out


fused_hifigan_mrf.calls = 0
fused_hifigan_mrf.launches = 0
