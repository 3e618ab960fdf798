"""Optimizer + LR-schedule factory (the JAX package's train/optimizers.py).

The reference trains with bare Adam at a fixed lr (reference
train.py:249); that stays the default. The factory composes, as the JAX
package does from optax, global-norm gradient clipping -> adam | adamw |
sgd (momentum) under a constant, cosine or linear schedule with linear
warmup. Here the optimizer is ``torch.optim``'s and the schedule a
``LambdaLR`` whose factor reproduces the optax schedule step for step:
optimizer update ``t`` (from 0) runs at ``schedule(t)``, as optax's
update count does.

``every_k > 1`` is ``optax.MultiSteps`` (the JAX CLI's ``--grad-accum``):
every step accumulates the running mean of the gradients, and every k-th
applies the update with it (clipped by its own global norm) and advances
the schedule; the other steps leave the parameters, the moments and the
schedule as they were. lamb and adafactor are not in this slice and raise.

:class:`ShardedUpdate` is the ZeRO-1 update (the JAX step's sharded optax
update plus its re-replication gather): the optimizer keeps state only for
this rank's tile of every leaf the partitioner shards, and full state for
the rest.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Sequence

import torch

from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models.transformer import (
    _not_in_slice,
)
from distributed_pytorch_example_tpu_torch.parallel import wire as wirelib
from distributed_pytorch_example_tpu_torch.runtime import distributed
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
                 grad_clip_norm: Optional[float] = None, every_k: int = 1):
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.every_k = every_k
        # the global norm of the current ``.grad``s (ZeRO-1 swaps in the
        # cross-rank one); optax.MultiSteps' running mean and its count
        self.norm_fn: Callable[[], torch.Tensor] = lambda: global_norm(
            [p.grad for p in self.params if p.grad is not None])
        self._acc: Optional[List[torch.Tensor]] = None
        self._mini_step = 0
        self._factor = ((lambda count: schedule(count) / lr) if lr
                        else (lambda count: 0.0))
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                           self._factor)

    def rebind(self, params: Iterable[torch.Tensor]) -> None:
        """Optimize ``params`` instead, with the same settings; only
        before the first step (the new optimizer starts with no state)."""
        if self.scheduler.last_epoch:
            raise RuntimeError("rebind after an optimizer step")
        opt = self.optimizer
        self.optimizer = type(opt)(list(params), **opt.defaults)
        self._acc, self._mini_step = None, 0
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer,
                                                           self._factor)

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> bool:
        """Apply one update; returns whether the parameters changed (with
        ``every_k > 1``, only every k-th call). ``grad_norm`` (a device
        scalar) is the global norm of the current gradients when the
        caller already has it."""
        if self.every_k > 1:
            if not self._accumulate():
                return False
            grad_norm = None  # the accumulated mean's, not this step's
        if self.grad_clip_norm:
            grads = [p.grad for p in self.params if p.grad is not None]
            if grad_norm is None:
                grad_norm = self.norm_fn()
            scale = torch.where(grad_norm < self.grad_clip_norm, 1.0,
                                self.grad_clip_norm / grad_norm)
            torch._foreach_mul_(grads, scale)
        self.optimizer.step()
        self.scheduler.step()
        return True

    @torch.no_grad()
    def _accumulate(self) -> bool:
        """optax.MultiSteps: fold this step's gradients into the running
        mean (Welford: acc + (g - acc) / (n + 1)); on the k-th, hand the
        mean over as the gradients and reset. True when it is the k-th."""
        params = self.params
        if self._acc is None:
            self._acc = [torch.zeros_like(p, dtype=torch.float32)
                         for p in params]
        n = self._mini_step
        for p, acc in zip(params, self._acc):
            if p.grad is not None:
                acc.add_((p.grad.float() - acc) / (n + 1))
            else:
                acc.mul_(n / (n + 1))
        self._mini_step = (n + 1) % self.every_k
        if self._mini_step:
            return False
        for p, acc in zip(params, self._acc):
            p.grad = acc.to(p.dtype)
        self._acc = None
        return True

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every gradient, as a float32 device
    scalar (NaN or Inf when any element is)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def nonfinite_count(grads: List[torch.Tensor]) -> torch.Tensor:
    """Number of NaN or Inf elements over every gradient, as a float32
    device scalar (the JAX package's ``telemetry.sentinels.nonfinite_count``,
    the train step's skip predicate)."""
    if not grads:
        return torch.zeros(())
    finite = torch.stack([torch.isfinite(g).sum() for g in grads]).sum()
    return (sum(g.numel() for g in grads) - finite).float()


class ShardedUpdate:
    """The ZeRO-1 / wire update of one model (the JAX step's manual data
    path): the leaves in the JAX order and layout, their ZeRO-1 dims, and
    this rank's float32 tiles of the sharded leaves.

    Built before the first step, it rebinds ``optimizer`` to the tiles
    (state for this rank's ``1/world`` of each sharded leaf) plus the
    replicated parameters (full state). Each step: :meth:`local_grads`
    -> ``wire.sync_grads`` -> :meth:`set_grads` -> :meth:`global_norm`
    -> ``optimizer.step`` -> :meth:`replicate`, which gathers the updated
    tiles back into the model's parameters.
    """

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 partitioner, rank: int, world: int):
        self.leaves = interop.flax_leaves(model)
        named = dict(model.named_parameters())
        self.params = [named[leaf.name] for leaf in self.leaves]
        shapes = {leaf.key: tuple(leaf.to_jax(p).shape)
                  for leaf, p in zip(self.leaves, self.params)}
        if partitioner.dp_shard_opt_state:
            by_path = partitioner.zero1_dims(shapes)
        else:
            by_path = dict.fromkeys(shapes)
        self.dims = [by_path[leaf.key] for leaf in self.leaves]
        self.rank, self.world = rank, world
        self.tiles: List[Optional[torch.Tensor]] = []
        self.chunk_shapes: List[Optional[tuple]] = []
        with torch.no_grad():
            for leaf, p, dim in zip(self.leaves, self.params, self.dims):
                if dim is None:
                    self.tiles.append(None)
                    self.chunk_shapes.append(None)
                    continue
                rows, cs = wirelib._scatter_parts(leaf.to_jax(p), dim, world)
                self.tiles.append(rows[rank].reshape(cs).float().clone())
                self.chunk_shapes.append(cs)
        optimizer.rebind(t if t is not None else p
                         for t, p in zip(self.tiles, self.params))
        optimizer.norm_fn = self.global_norm
        self.optimizer = optimizer

    def local_grads(self) -> List[torch.Tensor]:
        """This rank's float32 gradients, JAX layout and order (zeros for
        a parameter the loss did not reach)."""
        return [leaf.to_jax(p.grad).float() if p.grad is not None
                else torch.zeros(leaf.to_jax(p).shape, device=p.device)
                for leaf, p in zip(self.leaves, self.params)]

    def set_grads(self, synced: Sequence[torch.Tensor]) -> None:
        """Synced gradients (tiles for sharded leaves, full otherwise) as
        the ``.grad`` of what the optimizer updates."""
        for leaf, p, tile, g in zip(self.leaves, self.params, self.tiles,
                                    synced):
            if tile is not None:
                tile.grad = g.reshape(tile.shape)
            else:
                p.grad = leaf.from_jax(g).to(p.dtype).contiguous()

    def global_norm(self) -> torch.Tensor:
        """The gradient norm over the whole model: the tiles' squares
        summed across ranks, the replicated leaves counted once (NaN or
        Inf when any element is)."""
        tiles = [t.grad for t in self.tiles if t is not None]
        rest = [p.grad for p, t in zip(self.params, self.tiles) if t is None]
        device = self.params[0].device
        sq = torch.zeros((), device=device)
        if tiles:
            sq = torch.stack(torch._foreach_norm(tiles)).square().sum()
            sq = distributed.all_reduce_sum_(sq.reshape(1))[0]
        if rest:
            sq = sq + torch.stack(
                torch._foreach_norm([g.float() for g in rest])).square().sum()
        return sq.sqrt()

    def nonfinite_count(self) -> torch.Tensor:
        """NaN or Inf elements of the synced gradients over the whole
        model: the tiles' counts summed across ranks (a collective), the
        replicated leaves counted once; the same on every rank."""
        tiles = [t.grad for t in self.tiles if t is not None]
        rest = [p.grad for p, t in zip(self.params, self.tiles) if t is None]
        count = torch.zeros((), device=self.params[0].device)
        if tiles:
            count = distributed.all_reduce_sum_(
                nonfinite_count(tiles).reshape(1))[0]
        if rest:
            count = count + nonfinite_count(rest)
        return count

    @torch.no_grad()
    def replicate(self, config: "wirelib.WireConfig") -> None:
        """Gather every updated tile back into its full parameter: one
        exact library all-gather of all tiles for ``param_gather=
        "float32"`` (the JAX step's sharding-constraint gather), else
        ``wire.replicate_params`` (bf16 or int8 blocks, K3a where
        eligible)."""
        idx = [i for i, t in enumerate(self.tiles) if t is not None]
        if not idx:
            return
        if config.param_gather == "float32":
            flat = torch.cat([self.tiles[i].reshape(-1) for i in idx])
            rows = distributed.all_gather_tiled(flat[None])  # (world, n)
            offset, fulls = 0, []
            for i in idx:
                n = self.tiles[i].numel()
                fulls.append(wirelib._unscatter(
                    rows[:, offset:offset + n], self.dims[i],
                    self.chunk_shapes[i]))
                offset += n
        else:
            fulls = wirelib.replicate_params(
                [self.tiles[i] for i in idx], [self.dims[i] for i in idx],
                config)
        for i, full in zip(idx, fulls):
            self.params[i].copy_(self.leaves[i].from_jax(full))
            if config.param_gather != "float32":
                # as in JAX, the gathered parameters are the next step's
                # master weights: this rank's tile takes the rounding too
                rows, _ = wirelib._scatter_parts(full, self.dims[i],
                                                 self.world)
                self.tiles[i].copy_(rows[self.rank].reshape(
                    self.tiles[i].shape))


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
        logger.warning(
            "every_k=%d is optax.MultiSteps: the gradient collective fires "
            "on EVERY micro-step; Trainer(grad_accum_steps=%d) accumulates "
            "inside the step and syncs once", every_k, every_k,
        )
    if weight_decay and name in ("adam", "sgd"):
        logger.warning(
            "weight_decay=%s is ignored by optimizer %r — use 'adamw' for "
            "decoupled weight decay", weight_decay, name,
        )
    if momentum != 0.9 and name != "sgd":
        logger.warning("momentum=%s only applies to optimizer 'sgd' (got %r)",
                       momentum, name)
    return Optimizer(opt, sched, lr, grad_clip_norm, every_k)
