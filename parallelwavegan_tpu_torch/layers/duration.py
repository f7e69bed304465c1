"""FastSpeech-style duration layers (PyTorch, (B, C, T) layout).

Counterpart of parallelwavegan_tpu/layers/duration.py:32-160:

* ``LayerNorm``: torch's LayerNorm (eps 1e-12) over the channel axis of
  (B, C, T), as upstream's ``LayerNorm(dim=1)``.
* ``DurationPredictor``: per layer conv -> ReLU -> LayerNorm -> Dropout,
  then a linear head, in the log domain; ``inference`` gives integer
  durations clamp(round(exp(out) - offset), 0). torch's ``round`` and
  JAX's both round half to even. The dropout (``dropout``) is active in
  train mode and draws its masks from the ``torch.Generator`` the forward
  is given (torch's global one without), so a training step can seed it
  by (seed, step) as JAX keys it by its step key, and a resumed run draws
  the masks the uninterrupted one drew.
* ``VariancePredictor``: the same stack, a (B, T, 1) output.
* ``length_regulator``: tokens (B, C, Tin) repeated by integer durations
  (B, Tin) into a fixed ``out_length``, the static gather form of JAX's
  :132-144: output position t takes input ``searchsorted(cumsum(ds), t,
  right=True)``, clipped to Tin - 1, so positions past sum(ds) repeat the
  last frame. Its output size does not depend on the durations, so a
  training step needs no sync of the card with the host.
* ``repeat_by_durations_np``: the host-side numpy expansion of decode,
  one frame kept where every duration is zero.

The keys are upstream's: ``conv.{i}.0`` is the conv, ``conv.{i}.2`` the
norm and ``linear`` the head (JAX convert/torch_checkpoint.py:353-363).
Convs, the head and their biases start from torch's default U(-1/sqrt(fan_in),
1/sqrt(fan_in)), drawn from the explicit ``torch.Generator`` passed in.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from parallelwavegan_tpu_torch.layers.convs import Conv1d


class LayerNorm(nn.LayerNorm):
    """Layer norm of (B, C, T) over C (eps 1e-12)."""

    def __init__(self, channels: int, eps: float = 1e-12):
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, -1)).transpose(1, -1)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout: in training each element zeroed with probability
    ``rate``, the rest scaled by 1 / (1 - rate), the mask drawn from
    ``generator`` (on x's device); the identity otherwise."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep / (1.0 - rate)


class _ConvStack(nn.Module):
    """conv -> ReLU -> LayerNorm per layer (``conv.{i}.{0,2}``; upstream's
    Dropout at ``conv.{i}.3`` holds no weights), each followed by
    ``dropout``, then a linear head from ``n_chans`` to one value per
    frame."""

    def __init__(self, idim: int, n_layers: int, n_chans: int, kernel_size: int,
                 bias: bool, dropout_rate: float, generator):
        super().__init__()
        self.conv = nn.ModuleList(
            nn.Sequential(
                Conv1d(idim if i == 0 else n_chans, n_chans, kernel_size,
                       padding=(kernel_size - 1) // 2, bias=bias,
                       use_weight_norm=False, generator=generator),
                nn.ReLU(), LayerNorm(n_chans))
            for i in range(n_layers))
        self.dropout_rate = dropout_rate
        self.linear = nn.Linear(n_chans, 1)
        bound = 1.0 / math.sqrt(n_chans)
        with torch.no_grad():
            self.linear.weight.uniform_(-bound, bound, generator=generator)
            self.linear.bias.uniform_(-bound, bound, generator=generator)

    def _net(self, xs: torch.Tensor, training: bool,
             generator: torch.Generator | None) -> torch.Tensor:
        """(B, idim, T) -> (B, T, 1), the dropout on where ``training``."""
        for f in self.conv:
            xs = dropout(f(xs), self.dropout_rate, training, generator)
        return self.linear(xs.transpose(1, 2))


class DurationPredictor(_ConvStack):
    """Log-domain durations (B, T) of embeddings (B, idim, T)."""

    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 384,
                 kernel_size: int = 3, dropout_rate: float = 0.1,
                 offset: float = 1.0, generator: torch.Generator | None = None):
        super().__init__(idim, n_layers, n_chans, kernel_size, True, dropout_rate,
                         generator)
        self.offset = offset

    def forward(self, xs: torch.Tensor, x_masks: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Masked positions (``x_masks`` true) are zeroed; the dropout's
        masks come from ``generator`` in train mode."""
        out = self._net(xs, self.training, generator)[..., 0]
        return out if x_masks is None else out.masked_fill(x_masks, 0.0)

    def inference(self, xs: torch.Tensor,
                  x_masks: torch.Tensor | None = None) -> torch.Tensor:
        """Integer durations (B, T): clamp(round(exp(out) - offset), 0), the
        dropout off whatever the module's mode."""
        out = self._net(xs, False, None)[..., 0]
        out = torch.clamp(torch.round(torch.exp(out) - self.offset), min=0).long()
        return out if x_masks is None else out.masked_fill(x_masks, 0)


class VariancePredictor(_ConvStack):
    """FastSpeech2's variance predictor: (B, idim, T) -> (B, T, 1)."""

    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 384,
                 kernel_size: int = 3, bias: bool = True, dropout_rate: float = 0.5,
                 generator: torch.Generator | None = None):
        super().__init__(idim, n_layers, n_chans, kernel_size, bias, dropout_rate,
                         generator)

    def forward(self, xs: torch.Tensor, x_masks: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        out = self._net(xs, self.training, generator)
        return out if x_masks is None else out.masked_fill(x_masks[..., None], 0.0)


def length_regulator(xs: torch.Tensor, ds: torch.Tensor, out_length: int) -> torch.Tensor:
    """(B, C, Tin) expanded by integer durations (B, Tin) to (B, C,
    out_length); positions past sum(ds) repeat the last frame, for the
    caller to crop or mask."""
    cum = torch.cumsum(ds.long(), dim=1).contiguous()
    t = torch.arange(out_length, device=xs.device).expand(ds.shape[0], out_length)
    idx = torch.searchsorted(cum, t.contiguous(), right=True).clamp_(max=xs.shape[2] - 1)
    return xs.gather(2, idx[:, None, :].expand(-1, xs.shape[1], -1))


def repeat_by_durations_np(x: np.ndarray, d: np.ndarray, alpha: float = 1.0) -> np.ndarray:
    """Rows of x (T, ...) repeated by durations d (T,) on the host; durations
    scaled by ``alpha`` and rounded first, negatives as 0, and the first row
    kept once where every duration is 0 (JAX :146-160)."""
    if alpha != 1.0:
        if alpha <= 0:
            raise ValueError(f"alpha must be positive, got {alpha}")
        d = np.round(d.astype(np.float64) * alpha).astype(np.int64)
    d = np.maximum(d.astype(np.int64), 0)
    if d.sum() == 0:
        d = d.copy()
        d[0] = 1
    return np.repeat(x, d, axis=0)
