"""Fused HiFi-GAN decode tail: pre-MRF -> (deconv -> MRF) x n -> out conv.

Counterpart of parallelwavegan_tpu/ops/pallas_kernels/hifigan_tail.py. The
public function keeps the JAX layout and weight form, so a test can feed
the same arrays to both packages: x is (B, T, C) and every weight is in
gather form (K, Cin, Cout), in the dicts of ``hifigan_tail_xla``
(:86-90): ``stages`` is a list of {deconv_w, deconv_b, stride, padding,
blocks}, each MRF block {w1 (n_dil, K, C, C), b1 (n_dil, C), w2, b2,
dilations}.

``fused_hifigan_tail`` runs the hand-written CUDA kernel
(csrc/hifigan_tail.cu) for a CUDA tensor and the plain PyTorch version
``hifigan_tail_reference`` for a CPU tensor; a CUDA tensor never takes the
plain path. The TPU kernel's block-matrix lane packing is not carried
over. At widths 16-128 the residual units run on the tensor cores in split
TF32 and read each conv's weights split into TF32 hi and lo in the mma
fragments' order (``tf32x3.mrf_fragments``): a block dict may carry that
split as ``f1``/``f2`` (``with_fragments``, which decode's
``prepare_kernels`` calls once), else each call makes it. Below 16 they
run on the CUDA cores from the gather-form weights; the plain version
ignores the split.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from parallelwavegan_tpu_torch.ops.kernels import build
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import MRF_WIDTHS, mrf_fragments

# ---------------------------------------------------------------------------
# plain version (port of hifigan_tail_xla / hifigan_mrf_xla)
# ---------------------------------------------------------------------------


def _conv(x, w, b, dilation: int = 1):
    """'same' conv of (B, C, T) with a gather-form (K, Cin, Cout) kernel."""
    k = w.shape[0]
    return F.conv1d(x, w.permute(2, 1, 0), b, padding=(k - 1) // 2 * dilation,
                    dilation=dilation)


def _mrf(x, blocks, slope: float):
    acc = None
    for blk in blocks:
        xb = x
        for di, d in enumerate(blk["dilations"]):
            z = _conv(F.leaky_relu(xb, slope), blk["w1"][di], blk["b1"][di], d)
            z = _conv(F.leaky_relu(z, slope), blk["w2"][di], blk["b2"][di])
            xb = xb + z
        acc = xb if acc is None else acc + xb
    return acc / len(blocks)


def hifigan_tail_reference(x, stages, final_w, final_b, *, slope: float = 0.1,
                           pre_blocks=None):
    """Plain PyTorch version: x (B, T0, C0) -> (B, T0 * prod(strides), out)."""
    c = x.transpose(1, 2)
    if pre_blocks is not None:
        c = _mrf(c, pre_blocks, slope)
    for st in stages:
        c = F.leaky_relu(c, slope)
        # gather form (K, Cin, Cout) -> torch's scatter (Cin, Cout, K)
        w = st["deconv_w"].flip(0).permute(1, 2, 0)
        c = F.conv_transpose1d(c, w, st["deconv_b"], stride=st["stride"],
                               padding=st["padding"])
        c = _mrf(c, st["blocks"], slope)
    c = _conv(F.leaky_relu(c, 0.01), final_w, final_b)
    return torch.tanh(c).transpose(1, 2)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128)
_MAX_CHAINS = 8  # resblocks per MRF that one launch takes (kMaxChains)


def _check_blocks(name, blocks, device, c):
    if not 1 <= len(blocks) <= _MAX_CHAINS:
        raise ValueError(f"{name}: 1 to {_MAX_CHAINS} resblocks per MRF, "
                         f"got {len(blocks)}")
    tc = c in MRF_WIDTHS
    for bi, blk in enumerate(blocks):
        if "w2" not in blk:
            raise ValueError(f"{name}[{bi}]: the kernel needs w2/b2 "
                             "(use_additional_convs)")
        n, k = len(blk["dilations"]), blk["w1"].shape[1]
        if k % 2 == 0 or any(int(d) < 1 for d in blk["dilations"]):
            raise ValueError(f"{name}[{bi}]: odd kernel size and positive "
                             "dilations required")
        shapes = {"w1": ((n, k, c, c), 16), "b1": ((n, c), 8 if tc else 0),
                  "w2": ((n, k, c, c), 16), "b2": ((n, c), 8 if tc else 0)}
        if tc:  # the split, where the block carries it, copied in 16-byte pieces
            shapes.update({key: ((n, k * c // 8, c // 8, 32, 4), 16)
                           for key in ("f1", "f2") if blk.get(key) is not None})
        for key, (shape, align) in shapes.items():
            # biases are read in 8-byte pieces on the tensor cores
            build.check_tensor(f"{name}[{bi}].{key}", blk[key], device, shape,
                               align=align)


def _check_cuda_inputs(x, stages, final_w, final_b, pre_blocks):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    b, t, c = x.shape
    # the tensor-core residual units read x in 16-byte pieces
    build.check_tensor("x", x, x.device, (b, t, c), align=16 if c in MRF_WIDTHS else 0)
    if c not in _WIDTHS:
        raise ValueError(f"x width {c} is not a power of two <= 128")
    if pre_blocks is not None:
        _check_blocks("pre_blocks", pre_blocks, x.device, c)
    for si, st in enumerate(stages):
        k = st["deconv_w"].shape[0]
        build.check_tensor(f"stages[{si}].deconv_w", st["deconv_w"], x.device,
                           (k, c, c // 2))
        build.check_tensor(f"stages[{si}].deconv_b", st["deconv_b"], x.device,
                           (c // 2,))
        c //= 2
        _check_blocks(f"stages[{si}].blocks", st["blocks"], x.device, c)
    kf, _, out_ch = final_w.shape
    if kf % 2 == 0:
        raise ValueError("final_w needs an odd kernel size")
    build.check_tensor("final_w", final_w, x.device, (kf, c, out_ch))
    build.check_tensor("final_b", final_b, x.device, (out_ch,))


def _ptrs(tensors):
    """A C array of the tensors' data pointers (null for None)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def with_fragments(blocks):
    """An MRF's ``blocks`` with the split that the tensor-core residual
    units read (``f1``, ``f2``; ``tf32x3.mrf_fragments``, one pass for all
    blocks), for a decode that runs the same weights many times; as they
    are at a width that runs on the CUDA cores. The split is as stale as
    the weights it was made from: make it again after they change."""
    if not blocks or blocks[0]["w1"].shape[-1] not in MRF_WIDTHS:
        return blocks
    return [dict(blk, f1=f1, f2=f2) for blk, (f1, f2) in
            zip(blocks, mrf_fragments(blocks))]


def run_mrf(lib, inp, blocks, slope: float, dev: int, stream) -> tuple:
    """One MRF on the current stream: the mean over resblocks, each a chain
    of residual units; the units of one dilation depth of all chains share
    a ``hifigan_resunits`` launch, then ``hifigan_mean`` averages them. At
    the tensor-core widths the blocks' split is used where they carry it,
    else made here (and held until the launches are queued).
    ``run_mrf.tensor_core_launches`` and ``.cuda_core_launches`` count the
    residual-unit launches of each route. Returns (output, number of
    launches)."""
    b, t, c = inp.shape
    tc = c in MRF_WIDTHS
    if tc and any(blk.get(k) is None for blk in blocks for k in ("f1", "f2")):
        blocks = with_fragments(blocks)
    outs = [torch.empty_like(inp) for _ in blocks]
    tmps = [(torch.empty_like(inp), torch.empty_like(inp)) for _ in blocks]
    src = [inp] * len(blocks)
    # heaviest resblock first: its tiles are handed out first
    order = sorted(range(len(blocks)), key=lambda j: -blocks[j]["w1"].shape[1])
    depth = max(len(blk["dilations"]) for blk in blocks)
    for di in range(depth):
        units = []
        for j in order:
            blk, n = blocks[j], len(blocks[j]["dilations"])
            if di < n:
                dst = outs[j] if di == n - 1 else tmps[j][di % 2]
                units.append((src[j], dst, blk["w1"][di], blk["b1"][di],
                              blk["w2"][di], blk["b2"][di],
                              *((blk["f1"][di], blk["f2"][di]) if tc else (None, None)),
                              blk["w1"].shape[1], int(blk["dilations"][di])))
                src[j] = dst
        cols = list(zip(*units))
        lib.call("hifigan_resunits", len(units), *(_ptrs(col) for col in cols[:8]),
                 _ints(cols[8]), _ints(cols[9]), b, t, c, slope, dev, stream)
        if tc:
            run_mrf.tensor_core_launches += 1
        else:
            run_mrf.cuda_core_launches += 1
    acc = torch.empty_like(inp)
    lib.call("hifigan_mean", len(outs), _ptrs(outs), acc.data_ptr(),
             acc.numel(), dev, stream)
    return acc, depth + 1


run_mrf.tensor_core_launches = 0
run_mrf.cuda_core_launches = 0


def _run_cuda(x, stages, final_w, final_b, slope, pre_blocks):
    _check_cuda_inputs(x, stages, final_w, final_b, pre_blocks)
    lib = build.load()
    dev, stream = build.launch_target(x)
    b = x.shape[0]

    def mrf(inp, blocks):
        return run_mrf(lib, inp, blocks, slope, dev, stream)[0]

    c = x
    if pre_blocks is not None:
        c = mrf(c, pre_blocks)
    for st in stages:
        t, cin = c.shape[1], c.shape[2]
        k, s, pad = st["deconv_w"].shape[0], int(st["stride"]), int(st["padding"])
        t_out = (t - 1) * s - 2 * pad + k
        y = torch.empty((b, t_out, cin // 2), device=x.device, dtype=torch.float32)
        lib.call("hifigan_deconv", c.data_ptr(), y.data_ptr(),
                 st["deconv_w"].data_ptr(), st["deconv_b"].data_ptr(),
                 b, t, t_out, cin, cin // 2, k, s, pad, slope, dev, stream)
        c = mrf(y, st["blocks"])
    kf, cin, out_ch = final_w.shape
    out = torch.empty((b, c.shape[1], out_ch), device=x.device, dtype=torch.float32)
    lib.call("hifigan_outconv", c.data_ptr(), out.data_ptr(), final_w.data_ptr(),
             final_b.data_ptr(), b, c.shape[1], cin, out_ch, kf, 0.01, dev, stream)
    return out


def fused_hifigan_tail(x, stages, final_w, final_b, *, slope: float = 0.1,
                       pre_blocks=None):
    """x (B, T0, C0) -> (B, T0 * prod(strides), final_out_channels).

    A CUDA tensor goes through the hand-written kernel (C0 a power of two
    <= 128, each stage halving the width; float32, contiguous) and raises
    on anything it does not take; a CPU tensor goes through
    ``hifigan_tail_reference``. ``fused_hifigan_tail.launches`` counts the
    calls that ran the kernel. ``build.check_grid`` refuses, on any device,
    a batch or an output length that the kernel's grid cannot take.
    """
    if x.dim() == 3:
        rows = x.shape[1]
        for st in stages:
            k, s, pad = st["deconv_w"].shape[0], int(st["stride"]), int(st["padding"])
            rows = max(rows, (rows - 1) * s - 2 * pad + k)
        build.check_grid("fused_hifigan_tail", x.shape[0], rows)
    if x.device.type == "cpu":
        return hifigan_tail_reference(x, stages, final_w, final_b,
                                      slope=slope, pre_blocks=pre_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_hifigan_tail: unsupported device {x.device}")
    out = _run_cuda(x, stages, final_w, final_b, slope, pre_blocks)
    fused_hifigan_tail.launches += 1
    return out


fused_hifigan_tail.launches = 0
