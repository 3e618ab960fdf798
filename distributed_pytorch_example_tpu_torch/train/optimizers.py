"""Optimizer + LR-schedule factory (the JAX package's train/optimizers.py).

The reference trains with bare Adam at a fixed lr (reference
train.py:249); that stays the default. The factory composes, as the JAX
package does from optax, global-norm gradient clipping -> adam | adamw |
sgd (momentum) under a constant, cosine or linear schedule with linear
warmup. Here the optimizer is ``torch.optim``'s and the schedule a
``LambdaLR`` whose factor reproduces the optax schedule step for step:
optimizer update ``t`` (from 0) runs at ``schedule(t)``, as optax's
update count does.

lamb, adafactor and ``every_k > 1`` are not in this slice and raise.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional

import torch

from distributed_pytorch_example_tpu_torch.models.transformer import (
    _not_in_slice,
)
from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda count: init
    return lambda count: init + (end - init) * min(max(count, 0), steps) / steps


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    def fn(count: int) -> float:
        frac = min(max(count, 0), decay_steps) / decay_steps
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)
    return fn


def make_schedule(
    name: str,
    lr: float,
    *,
    warmup_steps: int = 0,
    total_steps: Optional[int] = None,
    final_scale: float = 0.0,
) -> Callable[[int], float]:
    """update count -> learning rate: 'constant' | 'cosine' | 'linear'."""
    name = name.lower()
    if name == "constant":
        if warmup_steps:
            return _linear(0.0, lr, warmup_steps)
        return lambda count: lr
    if total_steps is None:
        raise ValueError(f"schedule {name!r} requires total_steps")
    decay_steps = max(total_steps - warmup_steps, 1)
    if name == "cosine":
        sched = _cosine(lr, decay_steps, final_scale)
    elif name == "linear":
        sched = _linear(lr, lr * final_scale, decay_steps)
    else:
        raise ValueError(f"Unknown schedule {name!r}")
    if warmup_steps:
        warm = _linear(0.0, lr, warmup_steps)
        # optax.join_schedules: the second schedule restarts its count
        return lambda count: (warm(count) if count < warmup_steps
                              else sched(count - warmup_steps))
    return sched


class Optimizer:
    """One optax-style update: global-norm clip -> torch optimizer step ->
    schedule advance. ``grad_clip_norm`` follows ``optax.clip_by_global_norm``
    (scale by max_norm / norm when norm >= max_norm, no epsilon)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], lr: float,
                 grad_clip_norm: Optional[float] = None):
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        factor = ((lambda count: schedule(count) / lr) if lr
                  else (lambda count: 0.0))
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """Apply one update. ``grad_norm`` (a device scalar) is the global
        gradient norm when the caller already has it."""
        if self.grad_clip_norm:
            grads = [p.grad for p in self.params if p.grad is not None]
            if grad_norm is None:
                grad_norm = global_norm(grads)
            scale = torch.where(grad_norm < self.grad_clip_norm, 1.0,
                                self.grad_clip_norm / grad_norm)
            torch._foreach_mul_(grads, scale)
        self.optimizer.step()
        self.scheduler.step()

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every gradient, as a float32 device
    scalar (NaN or Inf when any element is)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def make_optimizer(
    params: Iterable[torch.Tensor],
    name: str = "adam",
    lr: float = 1e-3,
    *,
    schedule: str = "constant",
    warmup_steps: int = 0,
    total_steps: Optional[int] = None,
    weight_decay: float = 0.0,
    grad_clip_norm: Optional[float] = None,
    momentum: float = 0.9,
    every_k: int = 1,
) -> Optimizer:
    """Compose clip -> optimizer(schedule) over ``params``."""
    sched = make_schedule(schedule, lr, warmup_steps=warmup_steps,
                          total_steps=total_steps)
    name = name.lower()
    params = list(params)
    if name == "adam":
        # optax.adam defaults: b1 0.9, b2 0.999, eps 1e-8
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum)
    elif name in ("lamb", "adafactor"):
        raise _not_in_slice(f"optimizer {name!r}")
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    if every_k > 1:
        raise _not_in_slice("optimizer-level accumulation (every_k > 1)")
    if weight_decay and name in ("adam", "sgd"):
        logger.warning(
            "weight_decay=%s is ignored by optimizer %r — use 'adamw' for "
            "decoupled weight decay", weight_decay, name,
        )
    if momentum != 0.9 and name != "sgd":
        logger.warning("momentum=%s only applies to optimizer 'sgd' (got %r)",
                       momentum, name)
    return Optimizer(opt, sched, lr, grad_clip_norm)
