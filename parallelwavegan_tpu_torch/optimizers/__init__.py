"""Optimizers and learning-rate schedules of the port (counterpart of
parallelwavegan_tpu/optimizers/__init__.py).

The port is held against the JAX package, which builds optax chains, so
these optimizers compute optax's functions and not ``torch.optim``'s:

* ``RAdam`` is ``optax.radam``: the adaptive step is m_hat / (sqrt(v_hat)
  + eps) with both moments bias-corrected, and the rectified step is taken
  when rho_t >= 5. ``torch.optim.RAdam`` divides by sqrt(v) + eps after
  multiplying by sqrt(1 - beta2^t) and rectifies when rho_t > 5; with
  PWG v1's eps of 1e-6 the two differ from step 6 on.
* ``Adam`` is ``optax.adam``.
* ``AdamW`` is ``optax.adamw`` with the config's own ``weight_decay``,
  0 when not given (torch's AdamW defaults to 0.01; the JAX package
  applies only what the config asks for, :138-151): the update is
  m_hat / (sqrt(v_hat) + eps) + weight_decay * p, decoupled from the
  moments, times -lr. ``AdamW`` with ``amsgrad: true`` is
  ``optax.amsgrad`` and its ``weight_decay`` has no effect, as in JAX.
* ``AMSGrad`` (``Adam`` with ``amsgrad: true``) is ``optax.amsgrad``: the
  running maximum ``nu_max`` is taken of the bias-corrected second moment
  and the step is m_hat / (sqrt(nu_max) + eps). ``torch.optim.Adam(amsgrad=
  True)`` takes the maximum of the raw second moment and divides it by the
  current step's correction; the two differ from step 2 on. ``amsgrad``
  beside ``RAdam`` has no effect, as in the JAX package (:136-140).
* Gradient clipping is ``optax.clip_by_global_norm``: gradients are scaled
  by max_norm / ||g|| when ||g|| >= max_norm, where
  ``torch.nn.utils.clip_grad_norm_`` scales by max_norm / (||g|| + 1e-6).
* Weight decay is L2 added to the gradient after clipping (the JAX
  chain's ``add_decayed_weights``, :203-215).
* The learning rate of update n (0 first) is ``schedule(n)``: StepLR
  gives ``lr * gamma ** (n // step_size)``, the JAX unit, and
  ExponentialLR ``lr * gamma ** n`` (:46-52), computed in float32 as
  optax computes it on its int32 count.

Each optimizer is a ``torch.optim.Optimizer``: ``step()`` reads ``.grad``,
and ``state_dict()`` holds the moments (``exp_avg``, ``exp_avg_sq``, and
AMSGrad's ``nu_max``) and, in each parameter group, the update count
``step_count``. The other
optimizer and scheduler types of the JAX package raise
``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

_NOT_PORTED_OPTIMIZERS = ("SGD", "NAdam", "NAdamW", "Adamax",
                          "RMSprop", "Adagrad", "Adadelta", "Lamb", "Lion")
_NOT_PORTED_SCHEDULERS = ("CosineAnnealingLR",
                          "CosineAnnealingWarmRestarts", "LinearLR",
                          "PolynomialLR")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to parallelwavegan_tpu_torch yet; see ROADMAP.md")


def build_lr_schedule(base_lr: float, scheduler_type: str | None,
                      params: dict | None) -> Callable[[int], float]:
    """A torch lr_scheduler config as a function: update count -> lr."""
    params = params or {}
    if scheduler_type in (None, "", "ConstantLR"):
        return lambda step: base_lr
    if scheduler_type == "StepLR":
        if "step_size" not in params:
            raise ValueError(
                "StepLR scheduler requires 'step_size' in scheduler_params "
                f"(got {params!r})")
        step_size, gamma = params["step_size"], params.get("gamma", 0.1)
        return lambda step: base_lr * gamma ** (step // step_size)
    if scheduler_type == "MultiStepLR":
        # optax.piecewise_constant_schedule: scaled at each boundary reached
        milestones = sorted({int(m) for m in params["milestones"]})
        gamma = params.get("gamma", 0.1)
        return lambda step: base_lr * gamma ** sum(step >= m for m in milestones)
    if scheduler_type == "ExponentialLR":
        gamma = np.float32(params["gamma"])
        return lambda step: float(np.float32(base_lr) * gamma ** np.float32(step))
    if scheduler_type in _NOT_PORTED_SCHEDULERS:
        raise _not_ported(f"scheduler {scheduler_type}")
    if scheduler_type == "LambdaLR":
        raise ValueError(
            "LambdaLR takes a python callable and cannot be expressed in "
            "YAML; use MultiStepLR instead")
    raise ValueError(f"scheduler {scheduler_type!r} is not supported")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax ``global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _correction(b: float, count: int, dtype: torch.dtype) -> float:
    """optax's bias correction 1 - b ** count, computed in the moments'
    type as optax computes it: in float32 b = 0.999 is 0.99900001, and the
    correction of step 1 is 1.3e-5 below the exact one."""
    if dtype == torch.float64:
        return 1.0 - b ** count
    one = np.float32(1.0)
    return float(one - np.float32(b) ** np.float32(count))


class _OptaxChain(torch.optim.Optimizer):
    """clip_by_global_norm -> add_decayed_weights -> the scaling of the
    subclass -> scale by -lr(update count), applied to ``.grad``. Each
    stage is a ``torch._foreach_*`` call over a group's tensors, in place
    where it can be (a new tensor per parameter costs the host more than
    the update costs the card), so a step is a few dozen launches whatever
    the parameter count."""

    STATE_KEYS = ("exp_avg", "exp_avg_sq")
    DECOUPLED_DECAY = False  # weight decay added to the update, after scaling

    def __init__(self, params, lr_schedule: Callable[[int], float],
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_norm: float = -1):
        super().__init__(params, dict(betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, step_count=0))
        self.lr_schedule = lr_schedule
        self.grad_norm = grad_norm

    @property
    def step_count(self) -> int:
        """Updates applied so far (the schedule's count)."""
        return self.param_groups[0]["step_count"]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("closures are not supported")
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        for p, g in zip(params, grads):  # mixed precision's casts give float32 back
            if g.dtype != p.dtype or p.dtype == torch.bfloat16:
                raise TypeError(f"a {g.dtype} gradient of a {p.dtype} parameter: the "
                                "master parameters, their gradients and the optimizer "
                                "state are float32")
        if self.grad_norm and self.grad_norm > 0:
            norm = global_norm(grads)
            if not bool(norm < self.grad_norm):
                grads = torch._foreach_div(grads, norm)
                torch._foreach_mul_(grads, self.grad_norm)
        by_param = dict(zip(params, grads))
        for group in self.param_groups:
            count = group["step_count"]
            group["step_count"] = count + 1
            ps = [p for p in group["params"] if p in by_param]
            if not ps:
                continue
            gs = [by_param[p] for p in ps]
            decay = group["weight_decay"]
            if decay > 0 and not self.DECOUPLED_DECAY:
                gs = torch._foreach_add(gs, ps, alpha=decay)
            for p in ps:
                if not self.state[p]:
                    for key in self.STATE_KEYS:
                        self.state[p][key] = torch.zeros_like(p)
            updates = self._scale(gs, [self.state[p] for p in ps], group, count + 1)
            if decay > 0 and self.DECOUPLED_DECAY:
                torch._foreach_add_(updates, ps, alpha=decay)
            torch._foreach_mul_(updates, -self.lr_schedule(count))
            torch._foreach_add_(ps, updates)

    @staticmethod
    def _moments(gs, states, group, count, root: bool = True):
        """The moments updated in place, b m + (1 - b) g, and new tensors
        m_hat and sqrt(v_hat) + eps (v_hat itself unless ``root``)."""
        b1, b2 = group["betas"]
        mu = [s["exp_avg"] for s in states]
        nu = [s["exp_avg_sq"] for s in states]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, gs, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1 - b2)
        mu_hat = torch._foreach_div(mu, _correction(b1, count, mu[0].dtype))
        denom = torch._foreach_div(nu, _correction(b2, count, nu[0].dtype))
        if root:
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
        return mu_hat, denom


class Adam(_OptaxChain):
    """``optax.adam``: m_hat / (sqrt(v_hat) + eps)."""

    def _scale(self, gs, states, group, count):
        mu_hat, denom = self._moments(gs, states, group, count)
        torch._foreach_div_(mu_hat, denom)
        return mu_hat


class AdamW(Adam):
    """``optax.adamw``: m_hat / (sqrt(v_hat) + eps) + weight_decay * p."""

    DECOUPLED_DECAY = True


class AMSGrad(_OptaxChain):
    """``optax.amsgrad``: nu_max = max(nu_max, v_hat), then m_hat /
    (sqrt(nu_max) + eps)."""

    STATE_KEYS = ("exp_avg", "exp_avg_sq", "nu_max")

    def _scale(self, gs, states, group, count):
        mu_hat, nu_hat = self._moments(gs, states, group, count, root=False)
        nu_max = [s["nu_max"] for s in states]
        torch._foreach_maximum_(nu_max, nu_hat)
        denom = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(mu_hat, denom)
        return mu_hat


class RAdam(_OptaxChain):
    """``optax.radam`` (threshold 5): the rectified adaptive step where
    rho_t >= 5, else the bias-corrected momentum."""

    def _scale(self, gs, states, group, count):
        mu_hat, denom = self._moments(gs, states, group, count)
        b2 = group["betas"][1]
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2 ** count
        rho = rho_inf - 2 * count * b2t / (1 - b2t)
        if rho < 5.0:
            return mu_hat
        r = math.sqrt((rho - 4.0) * (rho - 2.0) * rho_inf
                      / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho))
        torch._foreach_mul_(mu_hat, r)
        torch._foreach_div_(mu_hat, denom)
        return mu_hat


def build_optimizer(params, optimizer_type: str,
                    optimizer_params: dict | None,
                    scheduler_type: str | None = None,
                    scheduler_params: dict | None = None,
                    grad_norm: float = -1) -> _OptaxChain:
    """The optimizer of a torch-style config over ``params``; ``grad_norm
    > 0`` clips by global norm first (upstream's clip_grad_norm_ before
    optimizer.step())."""
    p = dict(optimizer_params or {})
    lr = p.pop("lr", 1e-3)
    schedule = build_lr_schedule(lr, scheduler_type, scheduler_params)
    betas = p.pop("betas", (0.9, 0.999))
    eps = p.pop("eps", None)
    eps = 1e-8 if eps is None else eps
    weight_decay = p.pop("weight_decay", 0.0)
    amsgrad = p.pop("amsgrad", False)
    if optimizer_type == "AdamW" and amsgrad:
        weight_decay = 0.0  # optax.amsgrad without decay, as the JAX package builds it
    cls = {"Adam": AMSGrad if amsgrad else Adam, "AdamW": AMSGrad if amsgrad else AdamW,
           "RAdam": RAdam}.get(optimizer_type)
    if cls is None:
        if optimizer_type in _NOT_PORTED_OPTIMIZERS:
            raise _not_ported(f"optimizer {optimizer_type}")
        raise ValueError(f"optimizer {optimizer_type!r} is not supported")
    return cls(params, schedule, betas=betas, eps=eps,
               weight_decay=weight_decay, grad_norm=grad_norm)


def build_optimizer_from_config(config: dict, prefix: str, params) -> _OptaxChain:
    """The '{prefix}' (generator/discriminator) optimizer of a YAML config
    (upstream's defaults RAdam + StepLR; a config with no scheduler keys at
    all keeps a constant lr, as the JAX package does)."""
    sched_type = config.get(f"{prefix}_scheduler_type", "StepLR")
    sched_params = config.get(f"{prefix}_scheduler_params")
    if sched_params is None and f"{prefix}_scheduler_type" not in config:
        sched_type = None
    return build_optimizer(
        params,
        config.get(f"{prefix}_optimizer_type", "RAdam"),
        config.get(f"{prefix}_optimizer_params", {}),
        sched_type,
        sched_params or {},
        config.get(f"{prefix}_grad_norm", -1),
    )
