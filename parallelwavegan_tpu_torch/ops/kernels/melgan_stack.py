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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from parallelwavegan_tpu_torch.ops.kernels import build
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
    # x is read, and the output written, in 16-byte pieces
    build.check_tensor("x", x, x.device, (b, t, c), align=16)
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
        if _kept(st):  # the kernel reads these alone; the split in 16-byte pieces
            build.check_tensor(f"stacks[{i}].frag", st["frag"], x.device,
                               (k + 2, c // 8, c // 8, 32, 4), align=16)
            build.check_tensor(f"stacks[{i}].biases", st["biases"], x.device, (3, c))
        else:
            _check_weights(i, st, x.device, c)
    if final is not None:
        fw, fb = final
        kf, out_ch = fw.shape[0], fw.shape[-1]
        if kf % 2 == 0:
            raise ValueError("final needs an odd kernel size")
        if reflect and (kf - 1) // 2 >= t:
            raise ValueError(f"final: reflect padding needs T > {(kf - 1) // 2}")
        build.check_tensor("final w", fw, x.device, (kf, c, out_ch))
        if fb is not None:
            build.check_tensor("final b", fb, x.device, (out_ch,))


def _check_weights(i: int, st, device, c: int) -> None:
    """Stack i's gather-form weights as the split kernel reads them."""
    k = st["wd"].shape[0]
    for key, shape in (("wd", (k, c, c)), ("w1", (1, c, c)), ("ws", (1, c, c))):
        build.check_tensor(f"stacks[{i}].{key}", st[key], device, shape)
    for key in ("bd", "b1", "bs"):
        if st[key] is not None:
            build.check_tensor(f"stacks[{i}].{key}", st[key], device, (c,))


def _packed_biases(stacks):
    """Each stack's bd, b1, bs as one (3, C) tensor, zeros for a missing
    one: views of one tensor, made in one op."""
    if not stacks:
        return []
    like = stacks[0]["wd"]
    zero = torch.zeros(like.shape[-1], device=like.device, dtype=like.dtype)
    parts = [zero if st[k] is None else st[k].detach()
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
        fused_melgan_stacks.launches += 1
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
    fused_melgan_stacks.launches += 1
    return out


def fused_melgan_stacks(x, stacks, *, final=None, slope: float = 0.2,
                        pad_mode: str = "reflect"):
    """A stage's ResidualStacks in sequence, then optionally the trailing
    act -> conv -> tanh: x (B, T, C) -> (B, T, C), or (B, T, out).

    A CUDA tensor goes through the hand-written kernel (C a multiple of 16
    up to 128, odd kernel sizes, float32, contiguous, reflect padding
    shorter than T; the split and biases of ``with_fragments`` used where
    every stack has them) and raises on anything it does not take; a
    CPU tensor goes through ``melgan_stacks_reference``.
    ``fused_melgan_stacks.calls`` counts the calls that ran the kernel,
    ``.launches`` its launches.
    """
    if torch.is_grad_enabled():  # decode runs without: skip gathering the tensors
        build.refuse_training(
            "the fused MelGAN stack kernel (K6; train through fused_melgan_stacks_train)",
            [x] + [st[k] for st in stacks for k in ("wd", "bd", "w1", "b1", "ws", "bs")]
            + (list(final) if final is not None else []))
    _pad_mode(pad_mode)
    if x.device.type == "cpu":
        return melgan_stacks_reference(x, stacks, final=final, slope=slope,
                                       pad_mode=pad_mode)
    if x.device.type != "cuda":
        raise ValueError(f"fused_melgan_stacks: unsupported device {x.device}")
    _check_cuda_inputs(x, stacks, final, pad_mode)
    out = _run_cuda(x, stacks, final, slope, pad_mode)
    fused_melgan_stacks.calls += 1
    return out


fused_melgan_stacks.calls = 0
fused_melgan_stacks.launches = 0
