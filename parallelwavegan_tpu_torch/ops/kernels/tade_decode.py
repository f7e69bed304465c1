"""Fused StyleMelGAN TADEResBlock decode (K8a, K8b).

Counterpart of parallelwavegan_tpu/ops/pallas_kernels/tade_decode.py
(``tade_block_xla`` :82-107, ``_run_tade1`` :366, ``_run_tade2`` :437,
``fused_tade_blocks`` :514). The public functions keep the JAX layout and
weight form, so a test can feed the same arrays to both packages: x is
(B, T, 64), c (B, T, Ca); a block is a dict of folded weights in gather
form (K, Cin, Cout), ``aux1_w`` (9, Ca, 64), ``g1_w``, ``gc1_w``, ``g2_w``,
``gc2_w`` (9, 64, 128), ``aux2_w`` (9, 64, 64), their biases, ``scale``
and ``dilation``, as ``TADEResBlock.folded_weights`` returns it (which
adds the block itself under ``module``).

A block is two halves, split where the JAX package splits it, because
each half's instance norm is a reduction over the whole time axis of an
activation the block produces:

  K8a  a  = aux1(c); [s | h] = g1(a); y = s * norm(x) + h;
       x2 = gate(gc1(y))                                     (rate T)
  K8b  a2 = aux2(up(a)); [s | h] = g2(a2); y2 = s * up(norm(x2)) + h;
       out = up(x) + gate(gc2_d(y2))                         (rate sT)

with ``up`` the nearest x``scale`` stretch, every conv zero-padded "same"
(d = ``dilation`` for gc2), and ``gate`` softmax over channels (or
sigmoid) of the first half times tanh of the second. The norms'
per-(batch, channel) mean and 1/std are two-pass torch reductions
(``torch.var_mean``) between the launches.

For a CUDA tensor each gated block runs the hand-written kernels of
csrc/tade.cu, one launch of each, every conv product split TF32 on the
tensor cores; each half's three convs go to its kernel split once into
TF32 hi and lo in the mma fragments' order (``tf32x3.forward_fragments``),
per call or, for decode, once in ``with_fragments`` (the blocks'
``frag1`` and ``frag2``). For a CPU tensor it runs the plain PyTorch
version ``tade_block_reference``. A CUDA tensor never takes the
plain path. The TPU lane packing and tiling (``t_tile``) do not carry
over. This wrapper is inference-only, as JAX's, so a forward that would
need gradients raises; the differentiable block, whose backward is
K9a/K9b, is ``ops/kernels/tade_train.py``.

The kernels' bf16-resident mode (JAX's ``mxu_bf16``, which
``fused_tade_blocks_train`` turns on for a bf16 x, tade_train.py:776;
JAX's decode wrapper has none) is ``tade1_cuda``/``tade2_cuda`` on a bf16
x and c, the hand-written kernels of csrc/tade_bf16.cu on Hopper's
warpgroup products: x, c, x2, a, out and a2 bf16 in memory, the
statistics float32, each conv's operands rounded to bf16 (the weights
once per call, by ``mma_bf16.tade_forward_wgmma``), the products summed in
float32, the biases, modulation and gate in float32. Its plain versions are
``tade1_reference_bf16`` and ``tade2_reference_bf16``, differentiable,
their backward rounding where JAX's reverse kernels round (``_ConvBF16``,
``_NormBF16``, ``_StretchBF16``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from parallelwavegan_tpu_torch.layers.tade import GATES, gate, instance_norm_1d
from parallelwavegan_tpu_torch.ops.kernels import build, mma_bf16
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import forward_fragments

C = 64  # the kernels' width, the JAX C0P
KERNEL_SIZE = 9
DILATIONS = (1, 2, 3, 4)  # instantiated in tade.cu
EPS = 1e-5
WEIGHT_KEYS = ("aux1", "g1", "gc1", "aux2", "g2", "gc2")
# a half's three convs split for its kernel (tf32x3.forward_fragments)
FRAGMENTS_SHAPE = (5, KERNEL_SIZE * C // 8, 8, 32, 4)

# ---------------------------------------------------------------------------
# plain version (port of tade_block_xla)
# ---------------------------------------------------------------------------


def _conv(x, w, b, d: int = 1):
    """'Same' zero-padded conv of (B, T, Cin) with a (K, Cin, Cout) kernel."""
    pad = (w.shape[0] - 1) // 2 * d
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, padding=pad, dilation=d)
    return y.transpose(1, 2)


def _stretch(x, s: int):
    return x if s == 1 else x.repeat_interleave(s, dim=1)


def _gate(t, gated_function):
    return gate(*t.chunk(2, dim=-1), gated_function, dim=-1)


def tade1_reference(x, c, blk, gated_function: str = "softmax"):
    """The first half of a block (K8a's function): (x2, a), both (B, T, 64)."""
    a = _conv(c, blk["aux1_w"], blk["aux1_b"])
    s, h = _conv(a, blk["g1_w"], blk["g1_b"]).chunk(2, dim=-1)
    y = s * instance_norm_1d(x, dim=1) + h
    return _gate(_conv(y, blk["gc1_w"], blk["gc1_b"]), gated_function), a


def tade2_reference(x, x2, a, blk, gated_function: str = "softmax"):
    """The second half (K8b's function): (out, a2), both (B, sT, 64)."""
    sc, d = int(blk["scale"]), int(blk["dilation"])
    a2 = _conv(_stretch(a, sc), blk["aux2_w"], blk["aux2_b"])
    s, h = _conv(a2, blk["g2_w"], blk["g2_b"]).chunk(2, dim=-1)
    y2 = s * _stretch(instance_norm_1d(x2, dim=1), sc) + h
    t2 = _conv(y2, blk["gc2_w"], blk["gc2_b"], d)
    return _stretch(x, sc) + _gate(t2, gated_function), a2


def tade_block_reference(x, c, blk, *, gated_function: str = "softmax"):
    """One TADEResBlock on folded weights: x (B, T, 64), c (B, T, Ca) ->
    (x_out, c_out), both (B, T * scale, 64). A bf16 x runs the bf16 plain
    versions (``tade1_reference_bf16``, c then bf16 too)."""
    if x.dtype == torch.bfloat16:
        x2, a = tade1_reference_bf16(x, c, blk, gated_function)
        return tade2_reference_bf16(x, x2, a, blk, gated_function)
    x2, a = tade1_reference(x, c, blk, gated_function)
    return tade2_reference(x, x2, a, blk, gated_function)


# ---------------------------------------------------------------------------
# plain versions of the bf16-resident mode (JAX's mxu_bf16)
# ---------------------------------------------------------------------------


def _rb(v):
    """v rounded to bf16 (to nearest even, as astype(bfloat16)), as float32."""
    return v.detach().to(torch.bfloat16).float()


def instance_norm_backward(dxn, x, mean, rstd):
    """dL/dx of xn = (x - mean) * rstd over time (dim 1) for dL/dxn = dxn:
    rstd * (dxn - E[dxn] - xn * E[dxn * xn]) (JAX tade_train.py:90-105)."""
    mean, rstd = mean[:, None], rstd[:, None]
    xn = (x - mean) * rstd
    e1 = dxn.mean(dim=1, keepdim=True)
    e2 = (dxn * xn).mean(dim=1, keepdim=True)
    return rstd * (dxn - e1 - xn * e2)


class _ConvBF16(torch.autograd.Function):
    """A "same" 9-tap conv in JAX's bf16 mode: z = conv(bf16(x), bf16(w)) +
    b, products of the rounded operands summed in float32, the bias added
    in float32 (``_apply_conv``, tade_decode.py:173-190). Its backward is
    JAX's reverse kernels' (tade_train.py:173-208): dx = conv^T(bf16(dz),
    bf16(w)), dw from bf16(x) and bf16(dz), db = sum of dz, all float32
    (autograd casts each to its input's dtype)."""

    @staticmethod
    def forward(ctx, x, w, b, d):
        xr, wr = _rb(x), _rb(w)
        ctx.save_for_backward(xr, wr)
        ctx.d = d
        return _conv(xr, wr, b.detach().float(), d)

    @staticmethod
    def backward(ctx, dz):
        xr, wr = ctx.saved_tensors
        dx, dw = conv_vjp_bf16(xr, wr, dz, ctx.d)
        return dx, dw, dz.float().sum(dim=(0, 1)), None


def conv_vjp_bf16(x, w, dz, d: int = 1):
    """(dx, dw) of ``_ConvBF16`` for the cotangent dz: the transposed conv
    of bf16(dz) with bf16(w), and the weight gradient of bf16(x) against
    bf16(dz), both summed in float32 (JAX's ``_apply_conv_t`` and
    ``_conv_wgrads``)."""
    with torch.enable_grad():
        xl, wl = _rb(x).requires_grad_(), _rb(w).requires_grad_()
        return torch.autograd.grad(_conv(xl, wl, None, d), (xl, wl), _rb(dz))


class _NormBF16(torch.autograd.Function):
    """The instance norm of a bf16 activation x (B, T, 64): xn = (x -
    mean) * rstd in float32, the statistics float32 from the bf16 values
    (``_packed_stats``, tade_decode.py:127-140). Backward: its cotangent
    rounded to bf16 (the reverse kernels store dxn in bf16), the norm's
    backward in float32, dx rounded to bf16 (``_in_bwd_packed``,
    tade_train.py:130-145)."""

    @staticmethod
    def forward(ctx, x):
        xf = x.float()
        mean, rstd = _stats(xf)
        ctx.save_for_backward(xf, mean, rstd)
        return (xf - mean[:, None]) * rstd[:, None]

    @staticmethod
    def backward(ctx, dxn):
        xf, mean, rstd = ctx.saved_tensors
        return instance_norm_backward(_rb(dxn), xf, mean, rstd).to(torch.bfloat16)


class _StretchBF16(torch.autograd.Function):
    """The nearest x``scale`` stretch along time of a value whose cotangent
    JAX's stage-2 kernel stores in bf16: backward rounds the cotangent to
    bf16 and sums each group of ``scale`` rows in bf16 (``_stretch_t_packed``
    on bf16 arrays, tade_train.py:148-160); at scale 1 it only rounds."""

    @staticmethod
    def forward(ctx, v, scale):
        ctx.scale = scale
        return _stretch(v, scale)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.bfloat16)
        if ctx.scale > 1:
            b, rows, c = g.shape
            g = g.view(b, rows // ctx.scale, ctx.scale, c).sum(dim=2)
        return g, None


def tade1_reference_bf16(x, c, blk, gated_function: str = "softmax"):
    """K8a's function in the bf16-resident mode (JAX ``_kernel_tade1`` with
    ``mxu_bf16``): x, c (B, T, 64) bf16 -> (x2, a) bf16. Each conv's
    operands rounded to bf16 and the products summed in float32
    (``_ConvBF16``); a, the modulation and the gate float32 until the
    outputs are rounded on store. Differentiable: its autograd rounds
    where JAX's reverse kernel does (``_ConvBF16``, ``_NormBF16``); the
    weights may be float32 or bf16 (rounded either way)."""
    a = _ConvBF16.apply(c, blk["aux1_w"], blk["aux1_b"], 1)
    s, h = _ConvBF16.apply(a, blk["g1_w"], blk["g1_b"], 1).chunk(2, dim=-1)
    y = s * _NormBF16.apply(x) + h
    x2 = _gate(_ConvBF16.apply(y, blk["gc1_w"], blk["gc1_b"], 1), gated_function)
    return x2.to(torch.bfloat16), a.to(torch.bfloat16)


def tade2_reference_bf16(x, x2, a, blk, gated_function: str = "softmax"):
    """K8b's function in the bf16-resident mode (JAX ``_kernel_tade2`` with
    ``mxu_bf16``): x, x2, a (B, T, 64) bf16 -> (out, a2) (B, sT, 64) bf16,
    out = bf16(up(x) + gate(...)) with the sum in float32. Differentiable
    as ``tade1_reference_bf16``; the stretches' adjoints sum in bf16
    (``_StretchBF16``)."""
    sc, d = int(blk["scale"]), int(blk["dilation"])
    a2 = _ConvBF16.apply(_StretchBF16.apply(a, sc), blk["aux2_w"], blk["aux2_b"], 1)
    s, h = _ConvBF16.apply(a2, blk["g2_w"], blk["g2_b"], 1).chunk(2, dim=-1)
    y2 = s * _StretchBF16.apply(_NormBF16.apply(x2), sc) + h
    t2 = _ConvBF16.apply(y2, blk["gc2_w"], blk["gc2_b"], d)
    out = _StretchBF16.apply(x, sc).float() + _gate(t2, gated_function)
    return out.to(torch.bfloat16), a2.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _stats(x):
    """Per (batch, channel) mean and 1/std over time of x (B, T, C)."""
    var, mean = torch.var_mean(x, dim=1, unbiased=False)
    return mean.contiguous(), torch.rsqrt(var.clamp_min(0.0) + EPS).contiguous()


def stats_cuda(x):
    """The kernels' statistics of x on the card: for a bf16 x (B, T, 64)
    csrc/tade_bf16.cu's tade_stats_bf16, the float32 mean and 1/std over
    time from the bf16 rows without a float32 copy (chunks of rows by two
    passes, merged in order; ``_stats`` of the float32 values within
    float32 rounding); else ``_stats``."""
    if x.dtype != torch.bfloat16:
        return _stats(x.float())
    lib = build.load()
    dev, stream = build.launch_target(x)
    b, t, _ = x.shape
    n_part = lib.query("tade_stats_bf16_part_floats", b, t)
    if n_part < 0:
        raise ValueError(f"(B, T) = ({b}, {t}) needs too large a partial buffer")
    part = torch.empty(n_part, device=x.device)
    mean, rstd = (torch.empty(b, C, device=x.device) for _ in range(2))
    lib.call("tade_stats_bf16", x.data_ptr(), part.data_ptr(), mean.data_ptr(),
             rstd.data_ptr(), b, t, dev, stream)
    return mean, rstd


def _check_cuda_inputs(x, c, blk) -> None:
    """Raise unless the kernels take x, c and the block: float32 x and c
    (or, for the bf16 mode, both bf16, the weights then float32 or bf16)."""
    if x.dim() != 3 or c.dim() != 3:
        raise ValueError(f"x and c must be (B, T, C), got {tuple(x.shape)}, "
                         f"{tuple(c.shape)}")
    b, t, width = x.shape
    if width != C or c.shape[2] != C:
        raise ValueError(f"the TADE kernels take width {C} only, got x width "
                         f"{width} and c width {c.shape[2]}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's 65535")
    bf16 = x.dtype == torch.bfloat16
    io = build.BF16 if bf16 else (torch.float32,)
    # rows are read in 16-byte pieces
    build.check_tensor("x", x, x.device, (b, t, C), align=16, dtypes=io)
    build.check_tensor("c", c, x.device, (b, t, C), align=16, dtypes=io)
    if int(blk["scale"]) not in (1, 2):
        raise ValueError(f"the TADE kernels take scale 1 or 2, got {blk['scale']}")
    if int(blk["dilation"]) not in DILATIONS:
        raise ValueError(f"the TADE kernels take dilation in {DILATIONS}, "
                         f"got {blk['dilation']}")
    for key in WEIGHT_KEYS:
        cout = C if key.startswith("aux") else 2 * C
        # the kernels read the weights' split (forward_fragments), and the
        # biases in 8-byte pairs (the bf16 mode's widened by the wrapper)
        kinds = build.EITHER if bf16 else (torch.float32,)
        build.check_tensor(f"{key}_w", blk[f"{key}_w"], x.device,
                           (KERNEL_SIZE, C, cout), dtypes=kinds)
        build.check_tensor(f"{key}_b", blk[f"{key}_b"], x.device, (cout,),
                           align=0 if bf16 else 8, dtypes=kinds)
    for half in (1, 2):
        if f"frag{half}" in blk and not bf16:
            build.check_tensor(f"frag{half}", blk[f"frag{half}"], x.device,
                               FRAGMENTS_SHAPE, align=16)


def _keys(half: int):
    return WEIGHT_KEYS[:3] if half == 1 else WEIGHT_KEYS[3:]


def _split(blk, half: int):
    """Half ``half``'s three convs split for its kernel."""
    return forward_fragments(*(blk[f"{k}_w"] for k in _keys(half)))


def _fragments(blk, half: int, bf16: bool = False):
    """The block's ``frag1``/``frag2`` where ``with_fragments`` made them,
    else the split made now; with ``bf16`` the half's convs rounded to
    bf16 now in csrc/tade_bf16.cu's tiles (``mma_bf16.tade_forward_wgmma``)."""
    if bf16:
        return mma_bf16.tade_forward_wgmma(*(blk[f"{k}_w"] for k in _keys(half)))
    cached = blk.get(f"frag{half}")
    return cached if cached is not None else _split(blk, half)


def with_fragments(blk):
    """``blk`` with each half's three convs split once for the kernels
    (``frag1``, ``frag2``), for a decode that runs the same weights many
    times; unchanged where the kernels do not take the block (an aux width
    other than 64). The split is as stale as the weights it was made from:
    make it again after they change."""
    if blk["aux1_w"].shape[1] != C:
        return blk
    return dict(blk, frag1=_split(blk, 1), frag2=_split(blk, 2))


def _biases(blk, half: int):
    """The half's three biases as float32 (the bf16 mode's widened): hold
    them until the launch is queued."""
    return [blk[f"{k}_b"].float().contiguous() for k in _keys(half)]


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def _entry(name: str, x) -> str:
    return f"{name}_bf16" if x.dtype == torch.bfloat16 else name


def tade1_cuda(x, c, blk, gated_function: str = "softmax"):
    """K8a on the card: the stats of x (``stats_cuda``), then one launch.
    (x2, a), in x's dtype (a bf16 x runs the bf16-resident mode)."""
    _check_cuda_inputs(x, c, blk)
    bf16 = x.dtype == torch.bfloat16
    lib = build.load()
    dev, stream = build.launch_target(x)
    b, t, _ = x.shape
    mean, rstd = stats_cuda(x)
    x2, a = torch.empty_like(x), torch.empty_like(x)
    wf, bias = _fragments(blk, 1, bf16), _biases(blk, 1)  # held until the launch is queued
    lib.call(_entry("tade1", x), x.data_ptr(), c.data_ptr(), mean.data_ptr(),
             rstd.data_ptr(), x2.data_ptr(), a.data_ptr(), wf.data_ptr(), *_ptrs(bias),
             None, None, None, b, t, GATES.index(gated_function), dev, stream)
    fused_tade_blocks.launches_k8a += 1
    fused_tade_blocks.bf16_launches_k8a += int(bf16)
    return x2, a


def tade2_cuda(x, x2, a, blk, gated_function: str = "softmax"):
    """K8b on the card: the stats of x2 (``stats_cuda``), then one launch.
    (out, a2), in x's dtype (a bf16 x runs the bf16-resident mode)."""
    _check_cuda_inputs(x, a, blk)
    bf16 = x.dtype == torch.bfloat16
    build.check_tensor("x2", x2, x.device, x.shape, align=16, dtypes=(x.dtype,))
    lib = build.load()
    dev, stream = build.launch_target(x)
    b, t, _ = x.shape
    sc = int(blk["scale"])
    mean, rstd = stats_cuda(x2)
    out = torch.empty((b, sc * t, C), device=x.device, dtype=x.dtype)
    a2 = torch.empty_like(out)
    wf, bias = _fragments(blk, 2, bf16), _biases(blk, 2)
    lib.call(_entry("tade2", x), x.data_ptr(), x2.data_ptr(), a.data_ptr(),
             mean.data_ptr(), rstd.data_ptr(), out.data_ptr(), a2.data_ptr(), wf.data_ptr(),
             *_ptrs(bias), None, None, None, None, b, t, sc, int(blk["dilation"]),
             GATES.index(gated_function), dev, stream)
    fused_tade_blocks.launches_k8b += 1
    fused_tade_blocks.bf16_launches_k8b += int(bf16)
    return out, a2


# ---------------------------------------------------------------------------
# the block walk (port of fused_tade_blocks)
# ---------------------------------------------------------------------------


def gated(t: int, blk, *, min_fused_t: int, train: bool = False) -> bool:
    """Whether a block of input length t runs the fused path: the JAX
    decode gate (tade_decode.py:531: t >= min_fused_t, aux width 64), or
    with ``train`` the train wrapper's (tade_train.py:725-730: also t even
    and scale 1 or 2). The decode gate does not look at the scale, and a
    gated block of another scale raises."""
    ok = t >= min_fused_t and blk["aux1_w"].shape[1] == C
    if train:
        return ok and t % 2 == 0 and int(blk["scale"]) in (1, 2)
    if ok and int(blk["scale"]) not in (1, 2):
        raise ValueError(f"the fused TADE decode takes scale 1 or 2, got a gated "
                         f"block of scale {blk['scale']} at T={t}")
    return ok


def run_module(i: int, blk, x, c):
    """Block ``i`` of a walk through its module's forward, for a block the
    gate leaves out: (B, T, C) in and out."""
    if blk.get("module") is None:
        raise ValueError(f"blocks[{i}] is left out by the gate and has no module to run")
    y, cy = blk["module"](x.transpose(1, 2), c.transpose(1, 2))
    return y.transpose(1, 2).contiguous(), cy.transpose(1, 2).contiguous()


def fused_tade_blocks(x, c, blocks, *, gated_function: str = "softmax",
                      min_fused_t: int = 4096):
    """Run a stack of TADEResBlocks: x (B, T0, 64), c (B, T0, Ca) ->
    (x, c) at T0 times the product of the scales.

    Blocks the gate passes (``gated``) run K8a then K8b on a CUDA tensor
    (float32, contiguous, width 64, scale 1 or 2; anything else raises) or
    ``tade_block_reference`` on a CPU tensor; the others run their
    module's own forward (``blk["module"]``). ``fused_tade_blocks.calls``
    counts the calls that launched a kernel, ``.launches_k8a`` and
    ``.launches_k8b`` the launches of each kernel (``.bf16_launches_k8a``
    and ``.bf16_launches_k8b`` those in the bf16 mode, which the training
    wrapper's bf16 x runs; ``.bf16_rerun_launches_k8a`` and
    ``.bf16_rerun_launches_k8b`` the bf16 mode's Save re-runs inside K9,
    ``tade_train.tade1_rerun_cuda`` / ``tade2_rerun_cuda``).
    """
    if gated_function not in GATES:
        raise ValueError(f"{gated_function} is not supported.")
    tensors = [x, c] + [blk[f"{k}{s}"] for blk in blocks for k in WEIGHT_KEYS
                        for s in ("_w", "_b")]
    build.refuse_training("the fused TADE kernels (K8; train through "
                          "fused_tade_blocks_train, K9)", tensors)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_tade_blocks: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"fused_tade_blocks takes float32 x, got {x.dtype}: JAX's decode "
                         "wrapper has no bf16 mode (train through fused_tade_blocks_train)")
    launched = False
    for i, blk in enumerate(blocks):
        if not gated(x.shape[1], blk, min_fused_t=min_fused_t):
            x, c = run_module(i, blk, x, c)
            continue
        if x.device.type == "cpu":
            x, c = tade_block_reference(x, c, blk, gated_function=gated_function)
            continue
        x2, a = tade1_cuda(x, c, blk, gated_function)
        x, c = tade2_cuda(x, x2, a, blk, gated_function)
        launched = True
    if launched:
        fused_tade_blocks.calls += 1
    return x, c


fused_tade_blocks.calls = 0
fused_tade_blocks.launches_k8a = 0
fused_tade_blocks.launches_k8b = 0
fused_tade_blocks.bf16_launches_k8a = 0
fused_tade_blocks.bf16_launches_k8b = 0
fused_tade_blocks.bf16_rerun_launches_k8a = 0
fused_tade_blocks.bf16_rerun_launches_k8b = 0
