"""Optimizer + LR-schedule factory (the JAX package's train/optimizers.py).

The reference trains with bare Adam at a fixed lr (reference
train.py:249); that stays the default. The factory composes, as the JAX
package does from optax, global-norm gradient clipping -> adam | adamw |
sgd (momentum) | lamb | adafactor under a constant, cosine or linear
schedule with linear warmup. Here the optimizer is ``torch.optim``'s (lamb
is :class:`Lamb`, ``optax.lamb`` as a ``torch.optim.Optimizer``, and
adafactor :class:`Adafactor`, ``optax.adafactor``) and the schedule a
``LambdaLR`` whose factor reproduces the optax schedule step for step:
optimizer update ``t`` (from 0) runs at ``schedule(t)``, as optax's
update count does.

``every_k > 1`` is ``optax.MultiSteps`` (the JAX CLI's ``--grad-accum``):
every step accumulates the running mean of the gradients, and every k-th
applies the update with it (clipped by its own global norm) and advances
the schedule; the other steps leave the parameters, the moments and the
schedule as they were.

:class:`ShardedUpdate` is the ZeRO-1 update (the JAX step's sharded optax
update plus its re-replication gather): the optimizer keeps state only for
this rank's tile of every leaf the partitioner shards, and full state for
the rest. Lamb's trust ratio there takes whole-leaf norms (one all-reduce
a step); adafactor's statistics are the whole leaf's too: a tile's row
and column sums and its sums of squares are summed across ranks (two
all-reduces a step, :class:`Adafactor`), and an unfactored ``v`` is tiled
like its parameter.

Checkpoints carry the optimizer as the optax state tree of the same
configuration (:meth:`Optimizer.state_tree`, :meth:`Optimizer.
load_state_tree`): adam ``{'0': {count, mu, nu}, '1': {}}``, adamw one
more ``{}`` (decayed weights), lamb two more (decayed weights, trust
ratio), sgd ``{'0': {trace}, '1': {}}``; a schedule's state is
``{count}`` in place of the last ``{}``; adafactor ``{'0': {count,
v_row, v_col, v}, '1': {}, '2': <lr>, '3': {}, ['4': {}], <last>: {}}``
(block clipping, the learning rate, which holds the schedule's
``{count}``, the parameter scale, decayed weights when ``weight_decay`` is
set, the sign flip); clipping wraps the chain as ``{'0': {}, '1':
chain}``; ``every_k > 1`` wraps it in ``optax.MultiSteps``
(``mini_step``, ``gradient_step``, ``inner_opt_state``, ``acc_grads``,
``skip_state``). Every count is the number of applied updates (the
``LambdaLR``'s ``last_epoch``; torch keeps Adam's as a float per
parameter, optax one int32), and neither package advances it on a skipped
step. A :class:`StateLayout` says where each leaf's state lives (the
parameter, or under ZeRO-1 this rank's tile) and maps it to the full leaf
in the JAX layout: a ``Dense`` kernel's moments transpose like the kernel,
and a tile's gather from every rank on save (one library all-gather) and
are sliced back out on load. The sharded checkpoint format gathers
nothing: :meth:`StateLayout.chunks` gives what this rank owns of each
leaf, a :class:`Chunk` for a tile.

Under tensor parallelism the model's layers hold slices of their leaves,
and the torch optimizer keeps the moments of those slices:
:class:`TensorLayout` (:func:`layout_of` picks it for such a model)
gathers them whole over the tensor group, cuts whole leaves back to the
rank's slice, and names each slice a :class:`Chunk` of JAX's TP layout;
:class:`TensorUpdate` is the step's side (the gradient mean over the
data axes and the norms that count a slice once per tensor group).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from types import SimpleNamespace
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Union)

import numpy as np

import torch

from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.parallel import (
    tensor_parallel as tplib,
)
from distributed_pytorch_example_tpu_torch.parallel import wire as wirelib
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.runtime import mesh as mesh_lib
from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger
from distributed_pytorch_example_tpu_torch.telemetry.sentinels import (
    global_norm,
    nonfinite_count,
)

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


class Lamb(torch.optim.Optimizer):
    """``optax.lamb(lr, weight_decay=wd)`` as a torch optimizer, leaf by
    leaf: ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-6, bias-corrected
    moments), then ``+ wd * p`` (every leaf, optax's default mask), then
    the trust ratio ``||p|| / ||u||`` (1 where either norm is 0), then
    ``-lr``. The moments are ``exp_avg`` / ``exp_avg_sq`` and the update
    count ``step`` (a float on the CPU), as torch's Adam keeps them. The
    norms stay on the device: no host sync.

    Per-leaf norms need whole leaves: under ZeRO-1 (tiles of a leaf on
    several ranks) :class:`ShardedUpdate` sets ``leaf_norms``, which maps
    the tiles' norms to their whole leaves' (one all-reduce a step)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        # (params, ||p|| per param, ||u|| per param) -> whole-leaf norms
        self.leaf_norms: Optional[Callable] = None

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Lamb.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads, mus, nus = [], [], []
            for p in params:
                st = self.state[p]
                if "step" not in st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                grads.append(p.grad)
                mus.append(st["exp_avg"])
                nus.append(st["exp_avg_sq"])
            # every leaf of a group shares its count (optax keeps one)
            count = float(self.state[params[0]]["step"])
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            denom = torch._foreach_div(nus, 1 - b2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mus, 1 - b1 ** count)
            torch._foreach_div_(updates, denom)
            if group["weight_decay"]:
                torch._foreach_add_(updates, params,
                                    alpha=group["weight_decay"])
            p_norm = torch.stack(torch._foreach_norm(params))
            u_norm = torch.stack(torch._foreach_norm(updates))
            if self.leaf_norms is not None:
                p_norm, u_norm = self.leaf_norms(params, p_norm, u_norm)
            ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0,
                                p_norm / u_norm)
            for p, u, r in zip(params, updates, ratio.unbind()):
                p.add_(u * r, alpha=-group["lr"])
        return None


# optax.adafactor's defaults
_DECAY_RATE = 0.8
_MIN_DIM_TO_FACTOR = 128
_CLIPPING_THRESHOLD = 1.0
_MIN_SCALE = 1e-3
_EPS = 1e-30


def _factored_dims(shape):
    """optax's ``_factored_dims``: the (second largest, largest) axes of a
    leaf whose two largest dims are both >= 128, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


@dataclasses.dataclass(frozen=True)
class Tile:
    """Where a ZeRO-1 tile sits in its whole leaf (JAX layout): the leaf
    of ``shape`` is cut along ``dim`` into ``count`` equal chunks, and the
    tile is chunk ``index``."""

    shape: tuple
    dim: int
    index: int
    count: int

    def _axis(self, reduced: int) -> int:
        """``dim``'s axis in a tensor of the leaf's shape without axis
        ``reduced``."""
        return self.dim - (self.dim > reduced)

    def place(self, partial: torch.Tensor, reduced: int) -> torch.Tensor:
        """The tile's sums over axis ``reduced`` as the whole leaf's
        partial sums (zeros where other ranks' tiles lie): summed across
        ranks, they are the whole leaf's sums over that axis."""
        if self.dim == reduced:
            return partial
        full = list(np.delete(self.shape, reduced))
        out = partial.new_zeros(full)
        chunk = self.shape[self.dim] // self.count
        out.narrow(self._axis(reduced), self.index * chunk, chunk).copy_(
            partial)
        return out

    def cut(self, factor: torch.Tensor, reduced: int) -> torch.Tensor:
        """A whole leaf's factor over the axes other than ``reduced`` cut
        to the tile's part (all of it when the tile is cut along
        ``reduced``)."""
        if self.dim == reduced:
            return factor
        chunk = self.shape[self.dim] // self.count
        return factor.narrow(self._axis(reduced), self.index * chunk, chunk)


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr, weight_decay_rate=wd or None)`` at optax's
    defaults, as a torch optimizer, leaf by leaf in the leaf's JAX layout:

    - ``scale_by_factored_rms``: with decay ``1 - (t + 1)^-0.8`` at update
      t (from 0) and ``g² + 1e-30``, a leaf whose two largest dims are both
      >= 128 keeps the row and column means of that (``v_row`` without the
      largest axis d0, ``v_col`` without the second largest d1) and scales
      g by ``(v_row / mean(v_row))^-1/2`` along d0 and ``v_col^-1/2``
      along d1; any other leaf keeps the full ``v`` and scales by
      ``v^-1/2``;
    - block clipping: u / max(1, rms(u));
    - ``* lr``, then ``* max(rms(p), 1e-3)`` (the parameter scale);
    - ``+ wd * p`` when ``weight_decay`` is set (after the lr: optax's
      order), then ``p -= u``. No momentum.

    The statistics are kept in the JAX layout (``v_row`` / ``v_col`` /
    ``v``, optax's placeholders of shape (1,) where a leaf does not use
    them) and the update count as ``step`` (a float on the CPU).
    ``perms`` maps a parameter to the dimension order of its JAX leaf (a
    ``Linear`` weight (out, in) is a ``Dense`` kernel (in, out): (1, 0));
    :func:`make_optimizer` fills it from the model, and a parameter
    without an entry is its own layout.

    Under ZeRO-1 (:class:`ShardedUpdate` fills ``tiles`` and
    ``all_reduce``) a parameter may be a :class:`Tile` of its leaf, and
    every statistic is still the whole leaf's: each rank adds its tile's
    row and column sums of g² + 1e-30 into zero-filled whole-leaf buffers
    (and the tile's sum of p²), one all-reduce sums every leaf's, and each
    rank keeps the same whole ``v_row`` and ``v_col``; a second all-reduce
    sums the tiles' sums of u² for the block clip's rms(u). An unfactored
    ``v`` is tiled like its parameter."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.perms: Dict[torch.Tensor, Optional[tuple]] = {}
        self.tiles: Dict[torch.Tensor, Tile] = {}
        self.all_reduce: Optional[Callable[[torch.Tensor],
                                           torch.Tensor]] = None

    def jax_view(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``t`` (shaped like ``p``) in ``p``'s JAX layout: a view."""
        perm = self.perms.get(p)
        return t if perm is None else t.permute(perm)

    @staticmethod
    def init_state(shape) -> Dict[str, tuple]:
        """optax's initial shapes of ``v_row``, ``v_col`` and ``v`` for a
        leaf of JAX shape ``shape``."""
        dims = _factored_dims(tuple(shape))
        if dims is None:
            return {"v_row": (1,), "v_col": (1,), "v": tuple(shape)}
        d1, d0 = dims
        return {"v_row": tuple(np.delete(shape, d0)),
                "v_col": tuple(np.delete(shape, d1)), "v": (1,)}

    def _sum_across_ranks(self, sums: List[torch.Tensor]) -> None:
        """Sum the tiles' partial sums across ranks in one collective, in
        place."""
        if not sums or self.all_reduce is None:
            return
        flat = self.all_reduce(torch.cat([t.reshape(-1) for t in sums]))
        offset = 0
        for t in sums:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adafactor.step takes no closure")
        for group in self.param_groups:
            leaves = []
            for p in group["params"]:
                if p.grad is None:
                    continue
                w = self.jax_view(p, p)
                tile = self.tiles.get(p)
                shape = tile.shape if tile is not None else tuple(w.shape)
                st = self.state[p]
                if "step" not in st:
                    st["step"] = torch.tensor(0.0)
                    for key, init in self.init_state(shape).items():
                        if key == "v" and init == shape:
                            init = tuple(w.shape)  # tiled like its param
                        st[key] = torch.zeros(init, device=p.device)
                # optax's decay schedule, in float32
                decay = 1.0 - (st["step"] + 1).float().pow(-_DECAY_RATE)
                leaves.append(SimpleNamespace(
                    w=w, g=self.jax_view(p, p.grad).float(), st=st,
                    tile=tile, shape=shape, dims=_factored_dims(shape),
                    rate=float(decay), keep=float(1.0 - decay)))
            self._update(leaves, group["lr"], group["weight_decay"])
        return None

    def _update(self, leaves, lr: float, wd: float) -> None:
        # the statistics: a tile's as partial sums, reduced in one
        # collective with the tiles' sums of p²
        sums = []
        for f in leaves:
            sq = f.g.square() + _EPS
            if f.dims is None:
                f.v = f.st["v"].mul_(f.rate).add_(sq * f.keep)
            elif f.tile is None:
                d1, d0 = f.dims
                f.row, f.col = sq.mean(dim=d0), sq.mean(dim=d1)
            else:
                d1, d0 = f.dims
                f.row = f.tile.place(sq.sum(dim=d0), d0)
                f.col = f.tile.place(sq.sum(dim=d1), d1)
                sums += [f.row, f.col]
            if f.tile is not None:
                f.p_sq = f.w.float().square().sum().reshape(1)
                sums.append(f.p_sq)
        self._sum_across_ranks(sums)
        sums = []
        for f in leaves:
            if f.dims is None:
                f.u = f.g * f.v.pow(-0.5)
            else:
                d1, d0 = f.dims
                row, col = f.row, f.col
                if f.tile is not None:  # sums -> means over the whole leaf
                    row, col = row / f.shape[d0], col / f.shape[d1]
                v_row = f.st["v_row"].mul_(f.rate).add_(row * f.keep)
                v_col = f.st["v_col"].mul_(f.rate).add_(col * f.keep)
                reduced = d1 - 1 if d1 > d0 else d1
                row = (v_row / v_row.mean(dim=reduced, keepdim=True)
                       ).pow(-0.5)
                col = v_col.pow(-0.5)
                if f.tile is not None:
                    row, col = f.tile.cut(row, d0), f.tile.cut(col, d1)
                f.u = f.g * row.unsqueeze(d0) * col.unsqueeze(d1)
            if f.tile is not None:
                f.u_sq = f.u.square().sum().reshape(1)
                sums.append(f.u_sq)
        self._sum_across_ranks(sums)
        for f in leaves:
            if f.tile is None:
                rms_u = f.u.square().mean().sqrt()
                rms_p = f.w.float().square().mean().sqrt()
            else:
                n = math.prod(f.shape)
                rms_u, rms_p = (f.u_sq[0] / n).sqrt(), (f.p_sq[0] / n).sqrt()
            u = f.u / torch.clamp(rms_u / _CLIPPING_THRESHOLD, min=1.0)
            u = u * lr
            u = u * torch.where(rms_p <= _MIN_SCALE, _MIN_SCALE, rms_p)
            if wd:
                u = u + wd * f.w
            f.w.sub_(u.to(f.w.dtype))
            f.st["step"] += 1


class Optimizer:
    """One optax-style update: global-norm clip -> torch optimizer step ->
    schedule advance. ``grad_clip_norm`` follows ``optax.clip_by_global_norm``
    (scale by max_norm / norm when norm >= max_norm, no epsilon)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], lr: float,
                 grad_clip_norm: Optional[float] = None, every_k: int = 1,
                 scheduled: bool = False):
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.every_k = every_k
        # optax holds a schedule's count (ScaleByScheduleState) unless the
        # learning rate is a constant (JAX make_schedule returns a float)
        self.scheduled = scheduled
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
        if isinstance(opt, Adafactor):
            self.optimizer.perms = opt.perms
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

    # -- the optax state tree (checkpoints) ---------------------------------

    @property
    def updates(self) -> int:
        """Updates applied so far (optax's ``count``)."""
        return self.scheduler.last_epoch

    def _slots(self) -> Dict[str, str]:
        """optax moment name -> torch state key (of moments shaped like
        the parameter; adafactor's statistics are not)."""
        if isinstance(self.optimizer, torch.optim.SGD):
            return {"trace": "momentum_buffer"}
        if isinstance(self.optimizer, Adafactor):
            return {}
        return {"mu": "exp_avg", "nu": "exp_avg_sq"}

    def _chain(self, first: dict, count: int) -> dict:
        parts = [first]
        sched = {"count": _i32(count)} if self.scheduled else {}
        if isinstance(self.optimizer, Adafactor):
            # block clip, learning rate, parameter scale, [decayed weights],
            # sign flip
            parts += [{}, sched, {}]
            if self.optimizer.defaults["weight_decay"]:
                parts.append({})
            sched = {}
        elif isinstance(self.optimizer, torch.optim.AdamW):
            parts.append({})  # add_decayed_weights
        elif isinstance(self.optimizer, Lamb):
            parts += [{}, {}]  # add_decayed_weights, scale_by_trust_ratio
        parts.append(sched)
        inner = {str(i): part for i, part in enumerate(parts)}
        if self.grad_clip_norm:
            inner = {"0": {}, "1": inner}  # clip_by_global_norm: no state
        return inner

    def state_tree(self, layout: "StateLayout", gather: bool = True) -> dict:
        """The optimizer state as the optax tree (``to_state_dict`` form),
        every moment a full leaf in the JAX layout (a torch tensor where
        the state lives; under ZeRO-1 a collective: every rank calls it).
        ``gather=False``: a sharded leaf is this rank's :class:`Chunk`
        instead, and nothing is exchanged."""
        to_full = layout.to_full if gather else layout.chunks
        count = self.updates
        state = self.optimizer.state
        first: dict = {}
        if not isinstance(self.optimizer, torch.optim.SGD):
            first["count"] = _i32(count)
        if isinstance(self.optimizer, Adafactor):
            # the statistics live in the JAX layout already
            inits = [Adafactor.init_state(shape) for shape
                     in layout.full_shapes()]
            for name in ("v_row", "v_col", "v"):
                first[name] = layout.tree(layout.stats(name, [
                    state[t][name] if name in state.get(t, {})
                    else layout.stat_init(i, name, init[name], t.device)
                    for i, (t, init) in enumerate(zip(layout.targets,
                                                      inits))], gather))
        for name, key in self._slots().items():
            moments = [state.get(t, {}).get(key) for t in layout.targets]
            moments = [m if m is not None
                       else torch.zeros_like(t, dtype=torch.float32)
                       for m, t in zip(moments, layout.targets)]
            first[name] = layout.tree(to_full(moments))
        inner = self._chain(first, count)
        if self.every_k == 1:
            return inner
        if self._acc is None:
            acc = [torch.zeros_like(t, dtype=torch.float32)
                   for t in layout.targets]
        else:  # the running mean is kept in the optimizer's param order
            by_param = {id(p): a for p, a in zip(self.params, self._acc)}
            acc = [by_param[id(t)] for t in layout.targets]
        return {"mini_step": _i32(self._mini_step),
                "gradient_step": _i32(count),
                "inner_opt_state": inner,
                "acc_grads": layout.tree(to_full(acc)),
                "skip_state": {}}

    @torch.no_grad()
    def load_state_tree(self, tree: dict, layout: "StateLayout",
                        check_only: bool = False) -> None:
        """Restore :meth:`state_tree`'s form (written by either package);
        raises, before changing anything, on a tree of another optimizer
        configuration or model. ``check_only``: only that check."""
        mini, acc = 0, None
        if self.every_k > 1:
            _expect_keys(tree, ("mini_step", "gradient_step",
                                "inner_opt_state", "acc_grads",
                                "skip_state"), "opt_state")
            mini = int(tree["mini_step"])
            acc = layout.flat(tree["acc_grads"])
            tree = tree["inner_opt_state"]
        want = self._chain({}, 0)
        if self.grad_clip_norm:
            _expect_keys(tree, want.keys(), "opt_state (clipped)")
            tree, want = tree["1"], want["1"]
        _expect_keys(tree, want.keys(), "opt_state chain")
        adafactor = isinstance(self.optimizer, Adafactor)
        first = tree["0"]
        # where the schedule's count sits: adafactor's learning-rate part
        # ('2'), the chain's last part otherwise
        last = tree["2" if adafactor else str(len(want) - 1)]
        names = list(self._slots())
        stats = ["v_row", "v_col", "v"] if adafactor else []
        _expect_keys(first, names if isinstance(self.optimizer,
                                                torch.optim.SGD)
                     else ["count"] + names + stats, "opt_state/0")
        _expect_keys(last, ["count"] if self.scheduled else [],
                     "the schedule's state")
        count = None
        if "count" in first:
            count = int(first["count"])
        elif "count" in last:
            count = int(last["count"])
        moments = {name: layout.flat(first[name]) for name in names}
        factored = {}
        if adafactor:
            inits = [Adafactor.init_state(shape) for shape
                     in layout.full_shapes()]
            for name in stats:
                values = [_lookup(first[name], leaf.path)
                          for leaf in layout.leaves]
                for leaf, value, init in zip(layout.leaves, values, inits):
                    if tuple(value.shape) != init[name]:
                        raise ValueError(
                            f"checkpoint {name} {leaf.key}: shape "
                            f"{tuple(value.shape)}, want {init[name]}")
                factored[name] = values
        if check_only:
            return
        moments = {name: layout.from_full(m) for name, m in moments.items()}
        sgd = isinstance(self.optimizer, torch.optim.SGD)
        for i, target in enumerate(layout.targets):
            st = self.optimizer.state[target]
            for name, key in self._slots().items():
                st[key] = moments[name][i].to(target.device, target.dtype)
            for name, values in factored.items():
                st[name] = layout.stat_from_full(name, i, values[i]).to(
                    target.device, torch.float32).clone()
            if not sgd:
                group = next(g for g in self.optimizer.param_groups
                             if any(p is target for p in g["params"]))
                device = (target.device if group.get("capturable")
                          or group.get("fused") else "cpu")
                st["step"] = torch.tensor(float(count or 0),
                                          dtype=torch.float32, device=device)
        self._mini_step = mini
        self._acc = None
        if acc is not None and mini:
            by_param = {id(t): a.to(t.device, torch.float32)
                        for t, a in zip(layout.targets, layout.from_full(acc))}
            self._acc = [by_param[id(p)] for p in self.params]
        if count is not None:
            sched = self.scheduler
            sched.last_epoch = count
            for group, base in zip(self.optimizer.param_groups,
                                   sched.base_lrs):
                group["lr"] = base * self._factor(count)
            sched._last_lr = [g["lr"] for g in self.optimizer.param_groups]


def _i32(n: int) -> np.ndarray:
    """A 0-d int32 array: how optax and the JAX train state hold a
    count."""
    return np.asarray(n, dtype=np.int32)


def _expect_keys(tree, keys, what: str) -> None:
    got = set(tree) if isinstance(tree, dict) else None
    if got != set(keys):
        raise ValueError(
            f"checkpoint {what}: keys {sorted(got) if got is not None else tree!r}"
            f", this optimizer's are {sorted(keys)} (another optimizer, "
            "clipping, schedule or every_k?)")


def _nest(paths: Sequence[tuple], values: Sequence) -> dict:
    tree: dict = {}
    for path, value in zip(paths, values):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _lookup(tree, path: tuple, what: str = "leaf"):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            raise ValueError(f"checkpoint has no {what} {'/'.join(path)}")
        node = node[key]
    return node


@dataclasses.dataclass
class Chunk:
    """This rank's part of a leaf that a layout shards: ``data`` (the
    tile, in the JAX layout) sits at index ``start`` of the full leaf of
    ``shape``, which is cut into ``count`` such chunks over the ranks."""

    shape: tuple
    start: List[int]
    data: torch.Tensor
    count: int
    # the rank keeps the whole leaf: the chunk is only where the sharded
    # format writes it (an adafactor statistic JAX shards, kept whole here)
    whole: bool = False
    # this rank writes the chunk in the sharded format; another rank that
    # holds the same chunk (a replica over ``data`` under FSDP) does not
    primary: bool = True


class StateLayout:
    """Where the optimizer keeps each flax leaf's state (``targets``, in
    the JAX leaf order) and how it maps to the full leaf in the JAX
    layout: here, the parameter itself, a ``Dense`` kernel transposed.
    :class:`ShardedUpdate` gives the ZeRO-1 layout. ``partitioner`` stamps
    the checkpoint's mesh manifest (None: replicated)."""

    partitioner = None

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.leaves = interop.flax_leaves(model)
        named = dict(model.named_parameters())
        self.targets: List[torch.Tensor] = [named[leaf.name]
                                            for leaf in self.leaves]

    @property
    def paths(self) -> List[tuple]:
        return [leaf.path for leaf in self.leaves]

    def tree(self, fulls: Sequence) -> dict:
        """Full leaves in the JAX order -> the nested flax tree."""
        return _nest(self.paths, fulls)

    def flat(self, tree: dict) -> list:
        """The nested flax tree -> its leaves in the JAX order, each
        checked against the leaf's JAX shape."""
        out = []
        for leaf, full in zip(self.leaves, self.full_shapes()):
            value = _lookup(tree, leaf.path)
            if tuple(value.shape) != full:
                raise ValueError(f"checkpoint leaf {leaf.key}: shape "
                                 f"{tuple(value.shape)}, want {full}")
            out.append(value)
        return out

    def full_shapes(self) -> List[tuple]:
        return [tuple(leaf.to_jax(t).shape)
                for leaf, t in zip(self.leaves, self.targets)]

    def to_full(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """State tensors shaped like the targets -> full JAX-layout
        leaves."""
        return [leaf.to_jax(t) for leaf, t in zip(self.leaves, tensors)]

    def from_full(self, fulls: Sequence) -> List[torch.Tensor]:
        """Full JAX-layout leaves (arrays or tensors) -> tensors shaped
        like the targets."""
        return [leaf.from_jax(interop.as_tensor(f)).contiguous()
                for leaf, f in zip(self.leaves, fulls)]

    def chunks(self, tensors: Sequence[torch.Tensor]) -> list:
        """What this rank owns of each leaf, with no collective: a
        :class:`Chunk` of a leaf the layout shards, else the full leaf
        (every rank holds it; the sharded format has rank 0 write it).
        Nothing is sharded here."""
        return self.to_full(tensors)

    def params(self, gather: bool = True) -> dict:
        """The model's parameters as the flax param tree (views in the
        JAX layout: here the parameters are whole on every rank)."""
        return interop.params_to_flax(self.model)

    def load_params(self, tree: dict) -> None:
        """Copy a flax param tree into the parameters; raises, before
        copying anything, on a missing, extra or misshapen leaf."""
        interop.params_from_flax(self.model, tree)

    # adafactor's statistics live in the JAX layout, shaped by the whole
    # leaf (``Adafactor.init_state``), not like the targets

    def stat_init(self, i: int, name: str, shape: tuple,
                  device) -> torch.Tensor:
        """Leaf ``i``'s statistic ``name`` before the first update."""
        return torch.zeros(shape, device=device)

    def stats(self, name: str, values: Sequence[torch.Tensor],
              gather: bool = True) -> list:
        """Statistic ``name`` of every leaf as :meth:`to_full` /
        :meth:`chunks` give the moments: whole leaves here."""
        return list(values)

    def stat_from_full(self, name: str, i: int, full) -> torch.Tensor:
        """Leaf ``i``'s statistic ``name`` as the optimizer keeps it, from
        the whole statistic (or its chunk)."""
        return interop.as_tensor(full)

    def refresh(self) -> None:
        """Re-derive whatever the layout keeps beside the parameters
        after they were loaded (nothing here)."""


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

    # the process group the tiles are cut over (None: every process), and
    # whether this rank writes its chunks in the sharded format (a tile
    # held by several ranks is written by one)
    group = None
    primary = True

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 partitioner, rank: int, world: int):
        self.model = model
        self.leaves = interop.flax_leaves(model)
        named = dict(model.named_parameters())
        self.params = [named[leaf.name] for leaf in self.leaves]
        shapes = {leaf.key: leaf.jax_shape(p.shape)
                  for leaf, p in zip(self.leaves, self.params)}
        by_path = partitioner.sync_dims(shapes)
        self.dims = [by_path[leaf.key] for leaf in self.leaves]
        self.partitioner = partitioner
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
        if isinstance(optimizer.optimizer, Lamb):
            optimizer.optimizer.leaf_norms = self.whole_leaf_norms
        if isinstance(optimizer.optimizer, Adafactor):
            optimizer.optimizer.tiles = {
                t: Tile(shapes[leaf.key], dim, rank, world)
                for leaf, t, dim in zip(self.leaves, self.tiles, self.dims)
                if t is not None}
            optimizer.optimizer.all_reduce = lambda t: (
                distributed.all_reduce_sum_(t, self.group))
        self.optimizer = optimizer

    def whole_leaf_norms(self, params, p_norm: torch.Tensor,
                         u_norm: torch.Tensor):
        """Lamb's per-parameter norms of ``params`` (tiles and replicated
        parameters) as the norms of their whole leaves: the tiles' squared
        parameter and update norms, packed in one float32 tensor, are
        summed across ranks in one all-reduce; a replicated leaf's norms
        are already whole and count once."""
        tiles = {id(t) for t in self.tiles if t is not None}
        idx = [i for i, p in enumerate(params) if id(p) in tiles]
        if not idx or self.world == 1:
            return p_norm, u_norm
        sel = torch.tensor(idx, device=p_norm.device)
        sq = torch.cat([p_norm[sel], u_norm[sel]]).float().square()
        sq = distributed.all_reduce_sum_(sq, self.group).sqrt()
        p_norm, u_norm = p_norm.clone(), u_norm.clone()
        p_norm[sel] = sq[:len(idx)].to(p_norm.dtype)
        u_norm[sel] = sq[len(idx):].to(u_norm.dtype)
        return p_norm, u_norm

    def local_grads(self) -> List[torch.Tensor]:
        """This rank's float32 gradients, JAX layout and order (zeros for
        a parameter the loss did not reach)."""
        return [leaf.to_jax(p.grad).float() if p.grad is not None
                else torch.zeros(leaf.jax_shape(p.shape), device=p.device)
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
            sq = distributed.all_reduce_sum_(sq.reshape(1), self.group)[0]
        if rest:
            sq = sq + torch.stack(
                torch._foreach_norm([g.float() for g in rest])).square().sum()
        return sq.sqrt()

    def norm_and_count(self):
        """:meth:`global_norm` and :meth:`nonfinite_count` with the tiles'
        partial sums reduced in one collective."""
        tiles = [t.grad for t in self.tiles if t is not None]
        rest = [p.grad for p, t in zip(self.params, self.tiles) if t is None]
        device = self.params[0].device
        sums = torch.zeros(2, device=device)
        if tiles:
            sums = torch.stack([global_norm(tiles).square(),
                                nonfinite_count(tiles)])
            sums = distributed.all_reduce_sum_(sums, self.group)
        if rest:
            sums = sums + torch.stack([global_norm(rest).square(),
                                       nonfinite_count(rest)])
        return sums[0].sqrt(), sums[1]

    def nonfinite_count(self) -> torch.Tensor:
        """NaN or Inf elements of the synced gradients over the whole
        model: the tiles' counts summed across ranks (a collective), the
        replicated leaves counted once; the same on every rank."""
        tiles = [t.grad for t in self.tiles if t is not None]
        rest = [p.grad for p, t in zip(self.params, self.tiles) if t is None]
        count = torch.zeros((), device=self.params[0].device)
        if tiles:
            count = distributed.all_reduce_sum_(
                nonfinite_count(tiles).reshape(1), self.group)[0]
        if rest:
            count = count + nonfinite_count(rest)
        return count

    def layout(self) -> "ShardedLayout":
        """The checkpoint layout of this update: tiles gathered on save,
        sliced on load."""
        return ShardedLayout(self)

    def end_step(self) -> None:
        """What the step does last, applied or skipped (nothing here: the
        parameters stay whole between steps)."""

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
            rows = distributed.all_gather_tiled(  # (world, n)
                flat[None], group=self.group)
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


class ShardedLayout(StateLayout):
    """The ZeRO-1 layout: a sharded leaf's state lives on this rank's
    tile. The gathered format gathers every rank's tiles in one library
    all-gather (the JAX package's ``process_allgather``; a collective, so
    every rank saves); the sharded format writes each rank's tile as it is
    (:meth:`chunks`); loading slices this rank's tile out of the full
    leaf."""

    def __init__(self, update: ShardedUpdate):
        self.update = update
        self.model = update.model
        self.leaves = update.leaves
        self.partitioner = update.partitioner
        self.targets = [t if t is not None else p
                        for t, p in zip(update.tiles, update.params)]

    def full_shapes(self) -> List[tuple]:
        return [leaf.jax_shape(p.shape)
                for leaf, p in zip(self.leaves, self.update.params)]

    @torch.no_grad()
    def to_full(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        u = self.update
        out = [None if d is not None else leaf.to_jax(t)
               for leaf, t, d in zip(self.leaves, tensors, u.dims)]
        self._gather_into(out, tensors,
                          [i for i, d in enumerate(u.dims) if d is not None])
        return out

    def _gather_into(self, out: list, tensors, idx: List[int]) -> None:
        """``out[i]`` = the whole leaf of the tiles ``tensors[i]`` for each
        ``i`` of ``idx``: one library all-gather for all of them."""
        u = self.update
        if idx:
            flat = torch.cat([tensors[i].reshape(-1).float() for i in idx])
            rows = distributed.all_gather_tiled(  # (world, n)
                flat[None], group=u.group)
            offset = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = wirelib._unscatter(rows[:, offset:offset + n],
                                            u.dims[i], u.chunk_shapes[i])
                offset += n

    def _tiled(self, name: str, i: int) -> bool:
        """Whether leaf ``i``'s statistic ``name`` is a tile: the ``v`` of
        an unfactored leaf ZeRO-1 shards (tiled like its parameter)."""
        return (name == "v" and self.update.dims[i] is not None
                and _factored_dims(self.full_shapes()[i]) is None)

    def stat_init(self, i: int, name: str, shape: tuple,
                  device) -> torch.Tensor:
        if self._tiled(name, i):
            shape = self.update.chunk_shapes[i]
        return torch.zeros(shape, device=device)

    @torch.no_grad()
    def stats(self, name: str, values: Sequence[torch.Tensor],
              gather: bool = True) -> list:
        """A tiled ``v`` gathers (one all-gather) or is this rank's
        :class:`Chunk`; the other statistics are whole on every rank. In
        the sharded format each of those is placed as JAX places an
        optimizer-state leaf: by ``zero1_dim`` of its own shape (at GPT-2's
        widths every ``v_row`` and ``v_col`` is below the floor or odd, so
        rank 0 writes it whole; at LLaMA's, the embedding's and the head's
        ``v_col`` of 32000 is cut), as a :class:`Chunk` the rank still
        keeps whole."""
        u = self.update
        full = self.full_shapes()
        tiled = [i for i in range(len(values)) if self._tiled(name, i)]
        out = list(values)
        if gather:
            self._gather_into(out, values, tiled)
            return out
        for i, v in enumerate(values):
            if i in tiled:
                start = [0] * len(full[i])
                start[u.dims[i]] = u.rank * u.chunk_shapes[i][u.dims[i]]
                out[i] = Chunk(full[i], start, v, u.world,
                               primary=u.primary)
                continue
            dim = self.partitioner.zero1_dim(tuple(v.shape))
            if dim is not None:
                rows, cs = wirelib._scatter_parts(v, dim, u.world)
                start = [0] * v.dim()
                start[dim] = u.rank * cs[dim]
                out[i] = Chunk(tuple(v.shape), start,
                               rows[u.rank].reshape(cs), u.world, whole=True)
        return out

    def stat_from_full(self, name: str, i: int, full) -> torch.Tensor:
        if not self._tiled(name, i):
            return interop.as_tensor(full)
        u = self.update
        if isinstance(full, Chunk):
            return interop.as_tensor(full.data).reshape(u.chunk_shapes[i])
        rows, _ = wirelib._scatter_parts(interop.as_tensor(full), u.dims[i],
                                         u.world)
        return rows[u.rank].reshape(u.chunk_shapes[i])

    def chunks(self, tensors: Sequence[torch.Tensor]) -> list:
        """A sharded leaf's tile as this rank's :class:`Chunk`: rows
        ``rank * chunk`` on of ``dims[i]`` in the JAX layout, the place
        JAX's ``psum_scatter`` gives it."""
        u = self.update
        out = []
        for leaf, t, d, cs, full in zip(self.leaves, tensors, u.dims,
                                        u.chunk_shapes, self.full_shapes()):
            if d is None:
                out.append(leaf.to_jax(t))
                continue
            start = [0] * len(full)
            start[d] = u.rank * cs[d]
            out.append(Chunk(full, start, t.reshape(cs), u.world,
                             primary=u.primary))
        return out

    def from_full(self, fulls: Sequence) -> List[torch.Tensor]:
        """As :meth:`StateLayout.from_full`; a sharded leaf may also come
        as this rank's :class:`Chunk` (a sharded load keeps only that)."""
        u = self.update
        out = []
        for leaf, f, d, cs in zip(self.leaves, fulls, u.dims, u.chunk_shapes):
            if isinstance(f, Chunk):
                out.append(interop.as_tensor(f.data).reshape(cs).clone())
                continue
            f = interop.as_tensor(f)
            if d is None:
                out.append(leaf.from_jax(f).contiguous())
            else:
                rows, _ = wirelib._scatter_parts(f, d, u.world)
                out.append(rows[u.rank].reshape(cs).clone())
        return out

    @torch.no_grad()
    def refresh(self) -> None:
        """Slice each tile again out of its (just loaded) parameter."""
        u = self.update
        for leaf, p, tile, d in zip(u.leaves, u.params, u.tiles, u.dims):
            if tile is not None:
                rows, _ = wirelib._scatter_parts(leaf.to_jax(p), d, u.world)
                tile.copy_(rows[u.rank].reshape(tile.shape))


class FSDPUpdate(ShardedUpdate):
    """The FSDP update (``PlanSpec(family="fsdp")``; in JAX, GSPMD's
    program for the ``fsdp`` rules): every parameter leaf with a dim that
    the FSDP axis divides lives between steps only as this rank's float32
    tile, cut on the dim :func:`parallel.api.shard_largest_axis` picks on
    the leaf's JAX layout (a ``Linear`` weight is the transpose of a flax
    kernel), tile ``index`` of ``fsdp`` at rows ``index * chunk``; its
    moments live on the tile. A leaf no dim of which divides stays whole.

    The step (``train/step.py``):

    1. :meth:`materialize` all-gathers each tile over the ``fsdp`` group
       into its parameter's storage, leaf by leaf through
       ``wire.wire_all_gather`` (K3a on the card where it takes the
       payload, the library gather otherwise);
    2. forward and backward on the whole parameters;
    3. ``wire.sync_grads`` reduce-scatters each gradient to its tile over
       ``fsdp``, in fused buckets (K3b on the card where it takes the
       bucket), scaled to the global mean over ``data x fsdp``; at
       ``data > 1`` the tiles' gradients then all-reduce over ``data``;
    4. the optimizer updates the tiles only;
    5. :meth:`end_step` frees each sharded parameter's storage (its shape
       stays; its bytes are 0) and drops the gradients.

    What a rank holds: between steps the tiles and their moments, 1 /
    fsdp of the sharded leaves' bytes each (plus the leaves kept whole);
    during the step also every parameter whole and its gradient, as the
    replicated step holds them, since the gather covers the whole model
    before the forward. A gathered parameter is not freed after its
    layer's use (FSDP's per-layer reshard is left to ROADMAP.md item 11),
    so the step's peak is the replicated step's minus the moments' and
    the tiles' saving. Validation and a gathered checkpoint gather too
    (:meth:`gathered`, :class:`FSDPLayout`).

    Lamb and adafactor keep whole-leaf statistics and are refused here
    (ROADMAP.md queue 1, item 11)."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 partitioner):
        if isinstance(optimizer.optimizer, (Lamb, Adafactor)):
            raise NotImplementedError(
                f"{type(optimizer.optimizer).__name__} under FSDP is not "
                "ported to the PyTorch package yet; see ROADMAP.md queue 1, "
                "item 11")
        wire = partitioner.wire or wirelib.WireConfig()
        if wire.compress != "none" or wire.param_gather != "float32":
            raise NotImplementedError(
                "a compressed wire under FSDP is not ported to the PyTorch "
                "package yet; see ROADMAP.md queue 1, item 11")
        mesh, axis = partitioner.mesh, partitioner.fsdp_axis
        super().__init__(model, optimizer, partitioner,
                         mesh.axis_index(axis), mesh.shape[axis])
        self.group = mesh.group(axis)
        self.data_group = mesh.group("data")
        self.data_size = mesh.shape["data"]
        self.primary = mesh.axis_index("data") == 0
        # the scatters go in fused buckets (FSDP's flat units), each one
        # collective: K3b on the card
        self.config = dataclasses.replace(
            wire, bucket_bytes=wire.bucket_bytes
            or wirelib.DEFAULT_BUCKET_BYTES)
        for p, t in zip(self.params, self.tiles):
            if t is not None and (p.storage_offset() or not p.is_contiguous()
                                  or p.untyped_storage().nbytes()
                                  != p.numel() * p.element_size()):
                raise ValueError("FSDP frees each sharded parameter's "
                                 "storage: a parameter must own its storage")
        self.materialized = True
        self.end_step()

    @torch.no_grad()
    def materialize(self) -> None:
        """Gather every tile into its parameter (a collective over the
        ``fsdp`` group, one gather a leaf)."""
        if self.materialized:
            return
        for leaf, p, tile, dim, cs in zip(self.leaves, self.params,
                                          self.tiles, self.dims,
                                          self.chunk_shapes):
            if tile is None:
                continue
            p.untyped_storage().resize_(p.numel() * p.element_size())
            rows = wirelib.wire_all_gather(tile.reshape(1, -1),
                                           config=self.config,
                                           group=self.group)
            p.copy_(leaf.from_jax(wirelib._unscatter(rows, dim, cs)))
        self.materialized = True

    def end_step(self) -> None:
        """Free each sharded parameter's storage and its gradient."""
        for p, tile in zip(self.params, self.tiles):
            if tile is not None:
                p.grad = None
                p.untyped_storage().resize_(0)
        self.materialized = False

    @contextlib.contextmanager
    def gathered(self):
        """The parameters whole inside the block (gathered if they are
        not), freed again after it."""
        was = self.materialized
        self.materialize()
        try:
            yield
        finally:
            if not was:
                self.end_step()

    def sync(self, scale: float) -> None:
        """The gradients' reduce-scatter to the tiles (and all-reduce of
        the leaves kept whole) over ``fsdp``, then over ``data``; each
        scaled by ``scale``; set as what the optimizer updates."""
        synced = wirelib.sync_grads(self.local_grads(), self.dims,
                                    config=self.config, scale=scale,
                                    group=self.group)
        if self.data_size > 1:
            flat = torch.cat([g.reshape(-1) for g in synced])
            distributed.all_reduce_sum_(flat, self.data_group)
            offset = 0
            for i, g in enumerate(synced):
                synced[i] = flat[offset:offset + g.numel()].view_as(g)
                offset += g.numel()
        self.set_grads(synced)

    def replicate(self, config: "wirelib.WireConfig") -> None:
        """Nothing: the next step's :meth:`materialize` gathers the
        updated tiles."""

    def param_norm(self) -> torch.Tensor:
        """The parameters' global norm from the tiles (their squares
        summed over ``fsdp``) and the leaves kept whole."""
        tiles = [t for t in self.tiles if t is not None]
        rest = [p for p, t in zip(self.params, self.tiles) if t is None]
        sq = torch.zeros((), device=self.params[0].device)
        if tiles:
            sq = distributed.all_reduce_sum_(
                global_norm(tiles).square().reshape(1), self.group)[0]
        if rest:
            sq = sq + global_norm(rest).square()
        return sq.sqrt()

    def layout(self) -> "FSDPLayout":
        return FSDPLayout(self)


class FSDPLayout(ShardedLayout):
    """The FSDP layout: as :class:`ShardedLayout` for the optimizer
    state, and the sharded parameters too live on this rank's tiles. The
    gathered format gathers them (a collective over ``fsdp``), so its file
    equals the replicated run's byte for byte; the sharded format writes
    each tile as a :class:`Chunk` (from the ranks of data index 0); a load
    keeps this rank's tile of each leaf, whatever layout wrote it."""

    @torch.no_grad()
    def params(self, gather: bool = True) -> dict:
        u = self.update
        full = self.full_shapes()
        out = [None if t is not None else leaf.to_jax(p.detach())
               for leaf, p, t in zip(self.leaves, u.params, u.tiles)]
        idx = [i for i, t in enumerate(u.tiles) if t is not None]
        if gather:
            self._gather_into(out, u.tiles, idx)
        else:
            for i in idx:
                start = [0] * len(full[i])
                start[u.dims[i]] = u.rank * u.chunk_shapes[i][u.dims[i]]
                out[i] = Chunk(full[i], start, u.tiles[i], u.world,
                               primary=u.primary)
        return self.tree(out)

    @torch.no_grad()
    def load_params(self, tree: dict) -> None:
        u = self.update
        values = []
        for leaf, full in zip(self.leaves, self.full_shapes()):
            value = _lookup(tree, leaf.path, "params leaf")
            shape = value.shape if isinstance(value, Chunk) else tuple(
                value.shape)
            if tuple(shape) != full:
                raise ValueError(f"checkpoint params {leaf.key}: shape "
                                 f"{tuple(shape)}, this model's {full}")
            values.append(value)
        extra = {"/".join(p) for p in _leaf_paths(tree)} - {
            leaf.key for leaf in self.leaves}
        if extra:
            raise ValueError("checkpoint params hold leaves this model "
                             "lacks: " + ", ".join(sorted(extra)))
        tiles = self.from_full(values)
        for leaf, p, tile, value, own in zip(self.leaves, u.params, u.tiles,
                                             values, tiles):
            if tile is not None:
                tile.copy_(own)
            else:
                p.copy_(leaf.from_jax(interop.as_tensor(value)))

    def refresh(self) -> None:
        """Nothing: :meth:`load_params` wrote the tiles themselves."""


class TensorLayout(StateLayout):
    """The tensor-parallel layout: a leaf the model's tensor axis cuts
    lives on this rank as its slice (the parameter, its moments), part
    ``index`` of ``size`` along its ``dims`` entry in the JAX layout, the
    place JAX's TP spec gives it. The gathered format gathers the slices
    (one float32 all-gather over the tensor group, a collective), so its
    file equals the replicated run's; the sharded format writes each
    slice as a :class:`Chunk` (from the ranks of data index 0, every
    whole leaf from rank 0); a load keeps this rank's slice of each cut
    leaf, whatever layout wrote it. ``partitioner`` stamps the mesh
    manifest (None: the model alone)."""

    def __init__(self, model: torch.nn.Module, partitioner=None):
        super().__init__(model)
        self.partitioner = partitioner
        self.tp = tplib.tensor_parallel_of(model)
        self.dims = interop.tensor_dims(model, self.leaves)
        self.primary = partitioner is None or all(
            partitioner.mesh.axis_index(a) == 0
            for a in mesh_lib.data_axes(partitioner.mesh))

    def full_shapes(self) -> List[tuple]:
        out = []
        for leaf, t, d in zip(self.leaves, self.targets, self.dims):
            shape = list(leaf.jax_shape(t.shape))
            if d is not None:
                shape[d] *= self.tp.size
            out.append(tuple(shape))
        return out

    def to_full(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return tplib.gather_leaves(
            [leaf.to_jax(t) for leaf, t in zip(self.leaves, tensors)],
            self.dims, self.tp)

    def chunks(self, tensors: Sequence[torch.Tensor]) -> list:
        """A cut leaf's slice as this rank's :class:`Chunk` (at
        ``index * width`` of its dim); a whole leaf as it is."""
        out = []
        for leaf, t, d, full in zip(self.leaves, tensors, self.dims,
                                    self.full_shapes()):
            if d is None:
                out.append(leaf.to_jax(t))
                continue
            start = [0] * len(full)
            start[d] = self.tp.index * (full[d] // self.tp.size)
            out.append(Chunk(full, start, leaf.to_jax(t), self.tp.size,
                             primary=self.primary))
        return out

    def from_full(self, fulls: Sequence) -> List[torch.Tensor]:
        """Whole leaves (or this rank's :class:`Chunk` of a cut one) ->
        tensors shaped like the targets."""
        out = []
        for leaf, f, d in zip(self.leaves, fulls, self.dims):
            if isinstance(f, Chunk):
                f = f.data
            elif d is not None:
                f = tplib.take(interop.as_tensor(f), d, self.tp)
            out.append(leaf.from_jax(interop.as_tensor(f)).contiguous())
        return out

    @torch.no_grad()
    def params(self, gather: bool = True) -> dict:
        targets = [t.detach() for t in self.targets]
        return self.tree(self.to_full(targets) if gather
                         else self.chunks(targets))

    @torch.no_grad()
    def load_params(self, tree: dict) -> None:
        values = []
        for leaf, full in zip(self.leaves, self.full_shapes()):
            value = _lookup(tree, leaf.path, "params leaf")
            if tuple(value.shape) != full:
                raise ValueError(f"checkpoint params {leaf.key}: shape "
                                 f"{tuple(value.shape)}, this model's {full}")
            values.append(value)
        extra = {"/".join(p) for p in _leaf_paths(tree)} - {
            leaf.key for leaf in self.leaves}
        if extra:
            raise ValueError("checkpoint params hold leaves this model "
                             "lacks: " + ", ".join(sorted(extra)))
        for p, own in zip(self.targets, self.from_full(values)):
            p.copy_(own)


def layout_of(model: torch.nn.Module) -> StateLayout:
    """The layout of a model's own state: :class:`TensorLayout` for a
    model built over more than one tensor rank, else
    :class:`StateLayout`."""
    if tplib.tensor_parallel_of(model) is not None:
        return TensorLayout(model)
    return StateLayout(model)


class TensorUpdate:
    """The step's side of tensor parallelism (``PlanSpec(family=
    "transformer")``; in JAX, GSPMD's program for the TP rules). The model
    holds its slices, and the torch optimizer updates them in place, so
    nothing is rebound; each step the gradients, whole for a replicated
    leaf (the same on every rank of a tensor group) and a slice for a cut
    one, are averaged over the data axes (:meth:`sync`), and the norms
    sum a slice's squares over the tensor group once and count a whole
    leaf once (:meth:`global_norm`, :meth:`norm_and_count`,
    :meth:`nonfinite_count`, :meth:`param_norm`), as JAX's sentinels do
    over the global arrays.

    Built only where the model's cuts are the partitioner's: every leaf's
    dim must be ``partitioner.tensor_dim`` of its whole shape. Lamb and
    adafactor (whole-leaf statistics), a compressed wire and bucketing are
    refused (ROADMAP.md queue 1, item 11)."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 partitioner):
        if isinstance(optimizer.optimizer, (Lamb, Adafactor)):
            raise NotImplementedError(
                f"{type(optimizer.optimizer).__name__} under tensor "
                "parallelism is not ported to the PyTorch package yet; see "
                "ROADMAP.md queue 1, item 11")
        wire = partitioner.wire or wirelib.WireConfig()
        if (wire.compress != "none" or wire.param_gather != "float32"
                or wire.bucketed):
            raise NotImplementedError(
                "a compressed or bucketed wire under tensor parallelism is "
                "not ported to the PyTorch package yet; see ROADMAP.md "
                "queue 1, item 11")
        mesh = partitioner.mesh
        tp = tplib.TensorParallel.from_mesh(mesh, partitioner.tensor_axis)
        have = tplib.tensor_parallel_of(model) or tplib.TensorParallel()
        if (have.size, have.index) != (tp.size, tp.index):
            raise ValueError(
                f"the model is built for tensor rank {have.index} of "
                f"{have.size}, the mesh puts this process at {tp.index} of "
                f"{tp.size}: build it with tensor_parallel="
                "TensorParallel.from_mesh(mesh)")
        self.model, self.partitioner, self.tp = model, partitioner, tp
        self.layout_ = TensorLayout(model, partitioner)
        for leaf, d, full in zip(self.layout_.leaves, self.layout_.dims,
                                 self.layout_.full_shapes()):
            want = partitioner.tensor_dim(leaf.key, full)
            if want != d:
                raise ValueError(
                    f"{leaf.key} {full}: the model cuts dim {d} over the "
                    f"tensor axis, the partitioner's rules dim {want}")
        self.params = list(self.layout_.targets)
        self.cut = [d is not None for d in self.layout_.dims]
        self.data_group, self.data_size = mesh_lib.data_group(mesh)
        optimizer.norm_fn = self.global_norm

    def _split(self, tensors):
        """(cut leaves' tensors, whole leaves' tensors), Nones dropped."""
        cut = [t for t, c in zip(tensors, self.cut) if c and t is not None]
        whole = [t for t, c in zip(tensors, self.cut)
                 if not c and t is not None]
        return cut, whole

    def _sums(self, tensors, count: bool) -> torch.Tensor:
        """[sum of squares, non-finite elements] over the whole model:
        the cut leaves' partial sums added over the tensor group (one
        all-reduce), the whole leaves' counted once."""
        cut, whole = self._split(tensors)
        device = self.params[0].device
        sums = torch.zeros(2, device=device)
        if cut:
            part = torch.stack([global_norm(cut).square(),
                                nonfinite_count(cut) if count
                                else torch.zeros((), device=device)])
            sums = distributed.all_reduce_sum_(part, self.tp.group)
        if whole:
            sums = sums + torch.stack([global_norm(whole).square(),
                                       nonfinite_count(whole) if count
                                       else torch.zeros((), device=device)])
        return sums

    def _grads(self):
        return [p.grad for p in self.params]

    @torch.no_grad()
    def sync(self, accum: int = 1) -> None:
        """Every gradient's mean over the data axes (one flat all-reduce
        over their group), then / ``accum``, in place."""
        grads = [g for g in self._grads() if g is not None]
        if self.data_size > 1 and grads:
            flat = torch.cat([g.reshape(-1) for g in grads])
            distributed.all_reduce_sum_(flat, self.data_group)
            flat.div_(self.data_size)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        if accum > 1:
            torch._foreach_div_(grads, float(accum))

    def global_norm(self) -> torch.Tensor:
        return self._sums(self._grads(), count=False)[0].sqrt()

    def norm_and_count(self):
        sums = self._sums(self._grads(), count=True)
        return sums[0].sqrt(), sums[1]

    def nonfinite_count(self) -> torch.Tensor:
        return self._sums(self._grads(), count=True)[1]

    def param_norm(self) -> torch.Tensor:
        return self._sums([p.detach() for p in self.params],
                          count=False)[0].sqrt()

    def layout(self) -> TensorLayout:
        return self.layout_


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaf_paths(value, prefix + (key,))
    else:
        yield prefix


def make_optimizer(
    params: Union[Iterable[torch.Tensor], torch.nn.Module],
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
    """Compose clip -> optimizer(schedule) over ``params``: tensors, or a
    model (its parameters). adafactor takes only a model: it keeps its
    statistics in each leaf's JAX layout, as its checkpoints and optax
    do."""
    sched = make_schedule(schedule, lr, warmup_steps=warmup_steps,
                          total_steps=total_steps)
    name = name.lower()
    model = params if isinstance(params, torch.nn.Module) else None
    params = list(params.parameters() if model is not None else params)
    if name == "adam":
        # optax.adam defaults: b1 0.9, b2 0.999, eps 1e-8
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum)
    elif name == "lamb":
        # optax.lamb defaults: b1 0.9, b2 0.999, eps 1e-6
        opt = Lamb(params, lr=lr, betas=(0.9, 0.999), eps=1e-6,
                   weight_decay=weight_decay)
    elif name == "adafactor":
        # optax.adafactor(lr, weight_decay_rate=wd or None) at its defaults
        if model is None:
            raise ValueError("adafactor needs the model, not its parameters: "
                             "make_optimizer(model, 'adafactor', ...) keeps "
                             "its statistics in each leaf's JAX layout")
        opt = Adafactor(params, lr=lr, weight_decay=weight_decay)
        named = dict(model.named_parameters())
        opt.perms = {named[leaf.name]: leaf.perm
                     for leaf in interop.flax_leaves(model)}
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
            "weight_decay=%s is ignored by optimizer %r — use 'adamw' or "
            "'lamb' for decoupled weight decay", weight_decay, name,
        )
    if momentum != 0.9 and name != "sgd":
        logger.warning("momentum=%s only applies to optimizer 'sgd' (got %r)",
                       momentum, name)
    return Optimizer(opt, sched, lr, grad_clip_norm, every_k,
                     scheduled=schedule.lower() != "constant"
                     or bool(warmup_steps))
