"""Fused MelGAN residual stacks of one upsample stage (K6).

Counterpart of parallelwavegan_tpu/ops/pallas_kernels/melgan_stack.py
(``melgan_stacks_xla`` :83, ``fused_melgan_stacks`` :250,
``substitute_biases`` :194). The public functions keep the JAX layout and
weight form, so a test can feed the same arrays to both packages: x is
(B, T, C); each stack is a dict of folded weights in gather form, ``wd``
(K, C, C), ``w1`` and ``ws`` (1, C, C), biases ``bd``, ``b1``, ``bs`` (or
None, read as zeros) and ``dilation``; ``final`` is ``(w (K, C, out),
b)`` for the generator's trailing act -> conv -> tanh. ``pad_mode`` is the
JAX package's jnp.pad name: "reflect", "edge" or "constant" (zeros).

For a CUDA tensor ``fused_melgan_stacks`` runs the hand-written kernel
(csrc/melgan_stack.cu), one launch per stack and one for ``final``, with
the padding applied inside the kernel; for a CPU tensor it runs the plain
PyTorch version ``melgan_stacks_reference``. A CUDA tensor never takes
the plain path: the JAX wrapper's edge stitching, which recomputes the
first and last outputs with the XLA twin, is not carried over. The TPU
tiling (``t_tile``) and lane packing do not carry over either. The
stacks' products run on the tensor cores in split TF32 and read each
stack's weights split into TF32 hi and lo in the mma fragments' order
(``tf32x3.stack_forward_fragments``) and its three biases packed into
one (3, C) tensor: a stack dict may carry both as ``frag`` and ``biases``
(``with_fragments``, which decode's ``prepare_kernels`` calls once), else
each call makes them for all its stacks at once; the plain version
ignores them. This wrapper is inference-only, as the JAX
``fused_melgan_stacks`` has no VJP, so a forward that would need
gradients raises; the differentiable stage is
``ops/kernels/melgan_stack_train.py`` (K6 forward, K7 backward).

A bf16 x runs the JAX kernel's bf16-resident mode (``mxu_bf16``,
melgan_stack.py:302-326): every product's operands rounded to bf16 (the
padded leaky(x), leaky(z), x; the weights), float32 sums, z and the chain
between stacks in float32, the stage's output bf16. Its plain version is
``melgan_stacks_reference_bf16``; on the card the hand-written bf16 kernel
(csrc/melgan_stack_bf16.cu, on Hopper's warpgroup products, the weights
rounded once into its tiles by ``mma_bf16.stack_wgmma``). A bf16 x on the
card never reaches the float32 kernel or a plain version. The weights may
be float32 or bf16 (rounded either way); the biases are added in float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from parallelwavegan_tpu_torch.ops.kernels import build, mma_bf16
from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import stack_forward_fragments

# JAX pad mode -> (torch F.pad mode, the kernel's mode number)
_MODES = {"reflect": ("reflect", 0), "edge": ("replicate", 1),
             "constant": ("constant", 2)}
WIDTHS = tuple(range(16, 129, 16))  # instantiated in melgan_stack.cu

# ---------------------------------------------------------------------------
# plain version (port of melgan_stacks_xla)
# ---------------------------------------------------------------------------


def _conv(x, w, b, dilation: int = 1):
    """Valid conv of (B, C, T) with a gather-form (K, Cin, Cout) kernel."""
    return F.conv1d(x, w.permute(2, 1, 0), b, dilation=dilation)


def _pad_mode(pad_mode: str) -> str:
    if pad_mode not in _MODES:
        raise ValueError(f"pad_mode {pad_mode!r} is not one of {sorted(_MODES)}")
    return _MODES[pad_mode][0]


def melgan_stacks_reference(x, stacks, *, final=None, slope: float = 0.2,
                            pad_mode: str = "reflect"):
    """Plain sequential ResidualStacks: x (B, T, C) -> (B, T, C), or (B, T,
    out) with ``final``."""
    mode = _pad_mode(pad_mode)
    c = x.transpose(1, 2)
    for st in stacks:
        k, d = st["wd"].shape[0], int(st["dilation"])
        p = (k - 1) // 2 * d
        t = F.pad(F.leaky_relu(c, slope), (p, p), mode=mode)
        z = _conv(t, st["wd"], st["bd"], d)
        z = _conv(F.leaky_relu(z, slope), st["w1"], st["b1"])
        c = z + _conv(c, st["ws"], st["bs"])
    if final is not None:
        fw, fb = final
        p = (fw.shape[0] - 1) // 2
        t = F.pad(F.leaky_relu(c, slope), (p, p), mode=mode)
        c = torch.tanh(_conv(t, fw, fb))
    return c.transpose(1, 2)


_bf = mma_bf16.rounded


def _f32(v):
    return None if v is None else v.float()


def _pad_cl(v, p: int, mode: str):
    """(B, T, C) padded by p rows at both ends."""
    return F.pad(v.transpose(1, 2), (p, p), mode=mode).transpose(1, 2)


def _conv_cl(vp, w, b, dilation: int, t: int):
    """sum_k vp[:, k d : k d + t] . w[k] (+ b): the valid conv of a padded
    (B, t + (K - 1) d, Cin) by a gather-form (K, Cin, Cout) kernel, one
    float32 product per tap."""
    out = None
    for k in range(w.shape[0]):
        term = vp[:, k * dilation:k * dilation + t] @ w[k]
        out = term if out is None else out + term
    return out if b is None else out + b


def stacks_forward_bf16(x, stacks, final, slope: float, pad_mode: str,
                        inputs=None) -> dict:
    """The bf16-resident forward of one stage, every value it keeps: "xs"
    (each stack's input, float32; the first the bf16 x widened), "zs" (each
    stack's z + bd), "ts" (each stack's padded leaky input rounded to bf16,
    (B, T + 2P, C)), then with ``final`` "xf" (the final conv's input), "tf"
    (its rounded padded input) and "y" (its tanh, float32), else "y" the
    last stack's output (float32). ``inputs`` (float32, one per stack) are
    the inputs of stacks 1, 2, .. and of the final conv to take in place of
    the chain's own: values that another forward rounded at other points,
    so that a backward can be held to that forward stack by stack."""
    mode = _pad_mode(pad_mode)
    t = x.shape[1]
    c = x.float()
    out = {"xs": [], "zs": [], "ts": []}
    for i, st in enumerate(stacks):
        if i > 0 and inputs is not None:
            c = inputs[i - 1]
        k, d = st["wd"].shape[0], int(st["dilation"])
        # on the bf16 stage input LeakyReLU multiplies in bf16 (JAX _leaky)
        s = mma_bf16.slope_of(slope) if i == 0 else slope
        tp = _bf(_pad_cl(F.leaky_relu(c, s), (k - 1) // 2 * d, mode))
        z = _conv_cl(tp, _bf(st["wd"]), _f32(st["bd"]), d, t)
        h = _conv_cl(_bf(F.leaky_relu(z, slope)), _bf(st["w1"]), _f32(st["b1"]), 1, t)
        out["xs"].append(c)
        out["zs"].append(z)
        out["ts"].append(tp)
        c = h + _conv_cl(_bf(c), _bf(st["ws"]), _f32(st["bs"]), 1, t)
    if final is None:
        out["y"] = c
        return out
    fw, fb = final
    s = mma_bf16.slope_of(slope) if not stacks else slope
    if stacks and inputs is not None:
        c = inputs[len(stacks) - 1]
    out["xf"] = c
    out["tf"] = _bf(_pad_cl(F.leaky_relu(c, s), (fw.shape[0] - 1) // 2, mode))
    out["y"] = torch.tanh(_conv_cl(out["tf"], _bf(fw), _f32(fb), 1, t))
    return out


def melgan_stacks_reference_bf16(x, stacks, *, final=None, slope: float = 0.2,
                                 pad_mode: str = "reflect"):
    """Plain version of K6's bf16-resident mode (the JAX ``_kernel_stacks``
    with ``mxu_bf16``, whose casts it copies: each product's operands
    rounded to bf16, the products summed in float32, z, the stack's sum and
    the chain between stacks float32): x (B, T, C) bf16 -> bf16 (B, T, C),
    or (B, T, out) with ``final``. Exact products of bf16 values, so only
    the order of the sums differs from the kernel."""
    return stacks_forward_bf16(x, stacks, final, slope, pad_mode)["y"].to(torch.bfloat16)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _bias(b, n: int, like):
    return torch.zeros(n, device=like.device, dtype=like.dtype) if b is None else b


def _kept(st) -> bool:
    """Whether a stack carries what the kernel reads (``with_fragments``)."""
    return st.get("frag") is not None and st.get("biases") is not None


def _check_cuda_inputs(x, stacks, final, pad_mode) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    b, t, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    if bf16 and final is not None and not stacks:
        raise ValueError("the bf16 mode runs the final conv after one stack at least")
    # x is read, and the output written, in 16-byte pieces
    build.check_tensor("x", x, x.device, (b, t, c), align=16,
                       dtypes=build.BF16 if bf16 else (torch.float32,))
    if c not in WIDTHS:
        raise ValueError(f"x width {c} is not a multiple of 16 up to 128")
    reflect = pad_mode == "reflect"
    for i, st in enumerate(stacks):
        k, d = st["wd"].shape[0], int(st["dilation"])
        if k % 2 == 0 or d < 1:
            raise ValueError(f"stacks[{i}]: odd kernel size and positive "
                             "dilation required")
        if reflect and (k - 1) // 2 * d >= t:
            raise ValueError(f"stacks[{i}]: reflect padding of {(k - 1) // 2 * d} "
                             f"needs more than that many samples, got T={t}")
        if _kept(st) and not bf16:  # the kernel reads these alone; the split in 16-byte pieces
            build.check_tensor(f"stacks[{i}].frag", st["frag"], x.device,
                               (k + 2, c // 8, c // 8, 32, 4), align=16)
            build.check_tensor(f"stacks[{i}].biases", st["biases"], x.device, (3, c))
        else:
            _check_weights(i, st, x.device, c, bf16)
    if final is not None:
        fw, fb = final
        kf, out_ch = fw.shape[0], fw.shape[-1]
        kinds = build.EITHER if bf16 else (torch.float32,)
        if kf % 2 == 0:
            raise ValueError("final needs an odd kernel size")
        if reflect and (kf - 1) // 2 >= t:
            raise ValueError(f"final: reflect padding needs T > {(kf - 1) // 2}")
        build.check_tensor("final w", fw, x.device, (kf, c, out_ch), dtypes=kinds)
        if fb is not None:
            build.check_tensor("final b", fb, x.device, (out_ch,), dtypes=kinds)


def _check_weights(i: int, st, device, c: int, bf16: bool = False) -> None:
    """Stack i's gather-form weights as the split kernel reads them (in the
    bf16 mode float32 or bf16, as the layout rounds them)."""
    k = st["wd"].shape[0]
    kinds = build.EITHER if bf16 else (torch.float32,)
    for key, shape in (("wd", (k, c, c)), ("w1", (1, c, c)), ("ws", (1, c, c))):
        build.check_tensor(f"stacks[{i}].{key}", st[key], device, shape, dtypes=kinds)
    for key in ("bd", "b1", "bs"):
        if st[key] is not None:
            build.check_tensor(f"stacks[{i}].{key}", st[key], device, (c,), dtypes=kinds)


def _packed_biases(stacks):
    """Each stack's bd, b1, bs as one (3, C) tensor, zeros for a missing
    one: views of one tensor, made in one op."""
    if not stacks:
        return []
    like = stacks[0]["wd"]
    zero = torch.zeros(like.shape[-1], device=like.device)
    parts = [zero if st[k] is None else st[k].detach().float()
             for st in stacks for k in ("bd", "b1", "bs")]
    return list(torch.stack(parts).view(len(stacks), 3, -1))


def _split_cuda(stacks) -> tuple:
    """``kernel_weights`` on the card: one ``melgan_stack_split`` call (a
    launch per 16 stacks) writes every stack's split, then every stack's
    biases, into one tensor; the stacks' views of it. The weights are
    checked by the caller."""
    wd0 = stacks[0]["wd"]
    c, n = wd0.shape[-1], len(stacks)
    ks = [st["wd"].shape[0] for st in stacks]
    sizes = [(k + 2) * c * c * 2 for k in ks]
    out = torch.empty(sum(sizes) + n * 3 * c, device=wd0.device)
    lib = build.load()
    dev, stream = build.launch_target(wd0)
    ptrs = [0 if st[key] is None else st[key].data_ptr() for st in stacks
            for key in ("wd", "w1", "ws", "bd", "b1", "bs")]
    lib.call("melgan_stack_split", n, (ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_int * n)(*ks), out.data_ptr(), c, dev, stream)
    kernel_weights.launches += (n + 15) // 16
    *parts, biases = out.split(sizes + [n * 3 * c])
    frags = [f.view(k + 2, c // 8, c // 8, 32, 4) for f, k in zip(parts, ks)]
    return frags, list(biases.view(n, 3, c))


def kernel_weights(stacks) -> tuple:
    """(splits, biases): what the kernel reads of each stack, its weights'
    split into TF32 hi and lo in the mma fragments' order (K + 2, C / 8, C
    / 8, 32, 4) and its biases bd, b1, bs as one (3, C) tensor, zeros for a
    missing one. Those that ``with_fragments`` put in the stacks where
    every stack has them, else made here once for all the stacks: on the
    card by the split kernel (``.launches`` counts its launches), on the
    CPU by its plain version (``tf32x3.stack_forward_fragments`` and a
    stack of the biases)."""
    if stacks and all(_kept(st) for st in stacks):
        return [st["frag"] for st in stacks], [st["biases"] for st in stacks]
    if not stacks or stacks[0]["wd"].device.type == "cpu":
        return stack_forward_fragments(stacks), _packed_biases(stacks)
    return _split_cuda(stacks)


kernel_weights.launches = 0


def with_fragments(stacks):
    """``stacks`` with what the kernel reads (``frag`` and ``biases``, as
    ``kernel_weights`` makes them, one pass for all of them), for a decode
    that runs the same weights many times. They are as stale as the
    weights they were made from: make them again after those change."""
    stacks = [{k: v for k, v in st.items() if k not in ("frag", "biases")}
              for st in stacks]
    if stacks and stacks[0]["wd"].device.type == "cuda":
        c = stacks[0]["wd"].shape[-1]
        if c not in WIDTHS:
            raise ValueError(f"stack width {c} is not a multiple of 16 up to 128")
        for i, st in enumerate(stacks):
            _check_weights(i, st, stacks[0]["wd"].device, c)
    frags, biases = kernel_weights(stacks)
    return [dict(st, frag=f, biases=bb) for st, f, bb in zip(stacks, frags, biases)]


def _tiles_cuda(stacks) -> tuple:
    """``kernel_weights_bf16`` on the card: one ``melgan_stack_tiles_bf16``
    call (a launch per 16 stacks) writes every stack's tiles into one
    tensor and its biases into another; the stacks' views of them. The
    weights are checked by the caller; all of them are read in the first
    one's type, the biases in the first bias's (a value of another type is
    cast first, which rounds it as the tiles would). A training forward
    calls this once per stage: its host time is kept to a few tensor ops."""
    wd0 = stacks[0]["wd"]
    c, n, device = wd0.shape[-1], len(stacks), wd0.device
    mats = [st[k] for st in stacks for k in ("wd", "w1", "ws")]
    if not all(m.dtype == wd0.dtype and m.is_contiguous() for m in mats):
        mats = [m.detach().to(wd0.dtype).contiguous() for m in mats]
    vecs = [st[k] for st in stacks for k in ("bd", "b1", "bs")]
    given = [v for v in vecs if v is not None]
    b_dtype = given[0].dtype if given else torch.float32
    if not all(v.dtype == b_dtype and v.is_contiguous() for v in given):
        vecs = [None if v is None else v.detach().to(b_dtype).contiguous() for v in vecs]
    ptrs = [t.data_ptr() if t is not None else 0
            for i in range(n) for t in (*mats[3 * i:3 * i + 3], *vecs[3 * i:3 * i + 3])]
    ks = [st["wd"].shape[0] for st in stacks]
    if len(set(ks)) == 1:
        tiles = torch.empty((n, ks[0] + 2, c * c), dtype=torch.bfloat16, device=device)
        views = tiles.unbind()
    else:
        tiles = torch.empty(sum(k + 2 for k in ks) * c * c, dtype=torch.bfloat16, device=device)
        views = [v.view(k + 2, c * c) for v, k in zip(tiles.split([(k + 2) * c * c for k in ks]),
                                                      ks)]
    biases = torch.empty((n, 3, c), device=device)
    lib = build.load()
    dev, stream = build.launch_target(wd0)
    lib.call("melgan_stack_tiles_bf16", n, (ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_int * n)(*ks), tiles.data_ptr(), biases.data_ptr(), c,
             int(wd0.dtype == torch.bfloat16), int(b_dtype == torch.bfloat16), dev, stream)
    kernel_weights_bf16.launches += (n + 15) // 16
    return list(views), list(biases.unbind())


def kernel_weights_bf16(stacks) -> tuple:
    """(tiles, biases): what the bf16 mode reads of each stack, its weights
    rounded to bf16 in the kernels' tiles ((K + 2, C * C), which K7 reads
    too) and its biases as one float32 (3, C) tensor, zeros for a missing
    one; made once for all the stacks: on the card by the layout kernel
    (``.launches`` counts its launches), on the CPU by its plain version
    (``mma_bf16.stack_wgmma`` and a stack of the biases)."""
    if not stacks or stacks[0]["wd"].device.type == "cpu":
        return mma_bf16.stack_wgmma(stacks), _packed_biases(stacks)
    return _tiles_cuda(stacks)


kernel_weights_bf16.launches = 0


def _run_cuda_bf16(x, stacks, final, slope: float, pad_mode: str, outs=None,
                   split=None, keep_f32: bool = False):
    """``_run_cuda``'s bf16-resident mode (csrc/melgan_stack_bf16.cu): x
    bf16; the chain between the launches float32 (as the JAX kernel keeps
    it); the stage's output bf16, or float32 with ``keep_f32`` (K7's
    re-run, whose backward reads the unrounded values). ``split`` is
    ``kernel_weights_bf16(stacks)``, made here when not given."""
    lib = build.load()
    dev, stream = build.launch_target(x)
    mode = _MODES[pad_mode][1]
    b, t, c = x.shape
    tiles, biases = kernel_weights_bf16(stacks) if split is None else split
    last = len(stacks) - 1
    n_bufs = len(stacks) if outs is not None else min(2, len(stacks))
    bufs = [torch.empty(x.shape, device=x.device) for _ in range(n_bufs)]
    src, slope_x = x, mma_bf16.slope_of(slope)
    for i, st in enumerate(stacks):
        out_bf16 = i == last and final is None and not keep_f32
        dst = torch.empty_like(x) if out_bf16 else bufs[i % n_bufs]
        lib.call("melgan_stack_bf16", src.data_ptr(), dst.data_ptr(), tiles[i].data_ptr(),
                 biases[i].data_ptr(), b, t, c, st["wd"].shape[0], int(st["dilation"]),
                 mode, slope, slope_x if i == 0 else slope, int(i == 0), int(out_bf16),
                 dev, stream)
        _count(c, True)
        src = dst
    if outs is not None:
        outs.extend(bufs)
    if final is None:
        return src
    fw, fb = final
    out_ch = fw.shape[-1]
    y = torch.empty((b, t, out_ch), device=x.device,
                    dtype=torch.float32 if keep_f32 else torch.bfloat16)
    # held until the launch is queued: a freed block would be reused at once
    w = _bf(fw.detach()).contiguous()
    bias = _bias(_f32(fb), out_ch, src).detach().contiguous()
    lib.call("melgan_outconv_bf16", src.data_ptr(), y.data_ptr(), w.data_ptr(),
             bias.data_ptr(), b, t, c, out_ch, fw.shape[0], mode, slope,
             int(not keep_f32), dev, stream)
    _count(c, True)
    return y


def _run_cuda(x, stacks, final, slope: float, pad_mode: str, outs=None, split=None):
    """One launch per stack (ping-pong between two buffers), then one for
    ``final``, on the current stream. ``split`` is ``kernel_weights(stacks)``,
    made here when not given (and held until the launches are queued).
    Given a list ``outs``, each stack writes a buffer of its own and
    appends it to ``outs``."""
    lib = build.load()
    dev, stream = build.launch_target(x)
    mode = _MODES[pad_mode][1]
    b, t, c = x.shape
    frags, biases = kernel_weights(stacks) if split is None else split
    n_bufs = len(stacks) if outs is not None else min(2, len(stacks))
    bufs = [torch.empty_like(x) for _ in range(n_bufs)]
    src = x
    for i, st in enumerate(stacks):
        dst = bufs[i % n_bufs]
        lib.call("melgan_stack", src.data_ptr(), dst.data_ptr(), frags[i].data_ptr(),
                 biases[i].data_ptr(), b, t, c, st["wd"].shape[0],
                 int(st["dilation"]), mode, slope, dev, stream)
        _count(c, False)
        src = dst
    if outs is not None:
        outs.extend(bufs)
    if final is None:
        return src
    fw, fb = final
    out = torch.empty((b, t, fw.shape[-1]), device=x.device, dtype=torch.float32)
    lib.call("melgan_outconv", src.data_ptr(), out.data_ptr(), fw.data_ptr(),
             _bias(fb, fw.shape[-1], x).data_ptr(), b, t, c, fw.shape[-1],
             fw.shape[0], mode, slope, dev, stream)
    _count(c, False)
    return out


def _count(c: int, bf16: bool) -> None:
    """One launch of K6 at stage width c (``launches_by_width``)."""
    fused_melgan_stacks.launches += 1
    fused_melgan_stacks.bf16_launches += int(bf16)
    by_width = fused_melgan_stacks.launches_by_width
    by_width[c] = by_width.get(c, 0) + 1


def fused_melgan_stacks(x, stacks, *, final=None, slope: float = 0.2,
                        pad_mode: str = "reflect"):
    """A stage's ResidualStacks in sequence, then optionally the trailing
    act -> conv -> tanh: x (B, T, C) -> (B, T, C), or (B, T, out).

    A CUDA tensor goes through the hand-written kernel (C a multiple of 16
    up to 128, odd kernel sizes, float32 or bf16, contiguous, reflect
    padding shorter than T; the split and biases of ``with_fragments`` used
    where every stack has them and x is float32) and raises on anything it
    does not take; a CPU tensor goes through ``melgan_stacks_reference``
    (``melgan_stacks_reference_bf16`` for a bf16 x).
    ``fused_melgan_stacks.calls`` counts the calls that ran the kernel,
    ``.launches`` its launches, ``.bf16_launches`` those in the bf16 mode,
    ``.launches_by_width`` the launches at each stage width C.
    ``build.check_grid`` refuses, on any device, a batch or a length that
    the kernel's grid cannot take.
    """
    if torch.is_grad_enabled():  # decode runs without: skip gathering the tensors
        build.refuse_training(
            "the fused MelGAN stack kernel (K6; train through fused_melgan_stacks_train)",
            [x] + [st[k] for st in stacks for k in ("wd", "bd", "w1", "b1", "ws", "bs")]
            + (list(final) if final is not None else []))
    _pad_mode(pad_mode)
    if x.dim() == 3:
        build.check_grid("fused_melgan_stacks", x.shape[0], x.shape[1])
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        fn = melgan_stacks_reference_bf16 if bf16 else melgan_stacks_reference
        return fn(x, stacks, final=final, slope=slope, pad_mode=pad_mode)
    if x.device.type != "cuda":
        raise ValueError(f"fused_melgan_stacks: unsupported device {x.device}")
    _check_cuda_inputs(x, stacks, final, pad_mode)
    run = _run_cuda_bf16 if bf16 else _run_cuda
    out = run(x, stacks, final, slope, pad_mode)
    fused_melgan_stacks.calls += 1
    return out


fused_melgan_stacks.calls = 0
fused_melgan_stacks.launches = 0
fused_melgan_stacks.bf16_launches = 0
fused_melgan_stacks.launches_by_width = {}
