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
over: the CUDA kernel reads the gather-form weights as they are.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from parallelwavegan_tpu_torch.ops.kernels import build

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
    for bi, blk in enumerate(blocks):
        if "w2" not in blk:
            raise ValueError(f"{name}[{bi}]: the kernel needs w2/b2 "
                             "(use_additional_convs)")
        n, k = len(blk["dilations"]), blk["w1"].shape[1]
        if k % 2 == 0 or any(int(d) < 1 for d in blk["dilations"]):
            raise ValueError(f"{name}[{bi}]: odd kernel size and positive "
                             "dilations required")
        for key, shape in (("w1", (n, k, c, c)), ("b1", (n, c)),
                           ("w2", (n, k, c, c)), ("b2", (n, c))):
            # w1/w2 are copied in 16-byte pieces (cp.async)
            build.check_tensor(f"{name}[{bi}].{key}", blk[key], device, shape,
                               align=16 if key in ("w1", "w2") else 0)


def _check_cuda_inputs(x, stages, final_w, final_b, pre_blocks):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    b, t, c = x.shape
    build.check_tensor("x", x, x.device, (b, t, c))
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
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def run_mrf(lib, inp, blocks, slope: float, dev: int, stream) -> tuple:
    """One MRF on the current stream: the mean over resblocks, each a chain
    of residual units; the units of one dilation depth of all chains share
    a ``hifigan_resunits`` launch, then ``hifigan_mean`` averages them.
    Returns (output, number of launches)."""
    b, t, c = inp.shape
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
                              blk["w1"].shape[1], int(blk["dilations"][di])))
                src[j] = dst
        cols = list(zip(*units))
        lib.call("hifigan_resunits", len(units), *(_ptrs(col) for col in cols[:6]),
                 _ints(cols[6]), _ints(cols[7]), b, t, c, slope, dev, stream)
    acc = torch.empty_like(inp)
    lib.call("hifigan_mean", len(outs), _ptrs(outs), acc.data_ptr(),
             acc.numel(), dev, stream)
    return acc, depth + 1


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
    calls that ran the kernel.
    """
    if x.device.type == "cpu":
        return hifigan_tail_reference(x, stages, final_w, final_b,
                                      slope=slope, pre_blocks=pre_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_hifigan_tail: unsupported device {x.device}")
    out = _run_cuda(x, stages, final_w, final_b, slope, pre_blocks)
    fused_hifigan_tail.launches += 1
    return out


fused_hifigan_tail.launches = 0
