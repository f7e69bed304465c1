"""bf16 mixed precision as the JAX package computes it
(parallelwavegan_tpu/train/step.py:182-205, ``mixed_precision: true``).

The model forwards and backwards run in bf16: each phase casts the
module's trainable float32 parameters to bf16 at use and runs the module
on those copies (``call``, through ``torch.func.functional_call``), and
casts the batch to bf16 (``to_bf16``). The casts are differentiable, so
the gradients come back float32 to the float32 master parameters. The
model outputs go back to float32 (``to_f32``) before any loss. Buffers
are not cast: a spectral norm's (u, v) stay the module's own float32
buffers, which its power iteration updates. The optimizer state, the
clipping and the losses stay float32; there is no loss scaling (bf16 has
float32's exponent range).

This is JAX's form and not ``torch.autocast``: autocast would keep the
elementwise ops and weight norm in float32 and hand the kernel wrappers
float32 activations, where JAX runs them, and its kernels, in bf16.
"""

from __future__ import annotations

import torch
from torch.func import functional_call


def bf16_params(module: torch.nn.Module) -> dict:
    """{name: parameter cast to bf16} for every trainable float32
    parameter of ``module`` (differentiable casts; buffers left out)."""
    return {name: p.to(torch.bfloat16) for name, p in module.named_parameters()
            if p.requires_grad and p.dtype == torch.float32}


def _map(tree, fn):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def to_bf16(tree):
    """Every float32 tensor of a tensor, dict, list or tuple (nested) cast
    to bf16; other tensors (integer window starts) and values as they are."""
    return _map(tree, lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t)


def to_f32(tree):
    """Every bf16 tensor of a tensor, dict, list or tuple (nested; D's list
    of lists of features) cast to float32."""
    return _map(tree, lambda t: t.float() if t.dtype == torch.bfloat16 else t)


def call(module: torch.nn.Module, params: dict | None, *args, **kwargs):
    """``module(*args, **kwargs)``, on ``params`` in place of the module's
    own parameters where given (``bf16_params``); the forward pre-hooks of
    weight and spectral norm read the substituted parameters."""
    if params is None:
        return module(*args, **kwargs)
    return functional_call(module, params, args, kwargs, strict=False)
