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
a step); adafactor, whose factored statistics are row and column means
of the whole leaf, is refused under ZeRO-1 (ROADMAP.md item 7).

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
are sliced back out on load.
"""

from __future__ import annotations

import math
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Union)

import numpy as np

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
    without an entry is its own layout."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.perms: Dict[torch.Tensor, Optional[tuple]] = {}

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

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adafactor.step takes no closure")
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                w = self.jax_view(p, p)
                g = self.jax_view(p, p.grad).float()
                st = self.state[p]
                if "step" not in st:
                    st["step"] = torch.tensor(0.0)
                    for key, shape in self.init_state(w.shape).items():
                        st[key] = torch.zeros(shape, device=p.device)
                # optax's decay schedule, in float32
                t = (st["step"] + 1).float()
                decay = 1.0 - t.pow(-_DECAY_RATE)
                rate, keep = float(decay), float(1.0 - decay)
                sq = g.square() + _EPS
                dims = _factored_dims(tuple(w.shape))
                if dims is not None:
                    d1, d0 = dims
                    v_row = st["v_row"].mul_(rate).add_(
                        sq.mean(dim=d0) * keep)
                    v_col = st["v_col"].mul_(rate).add_(
                        sq.mean(dim=d1) * keep)
                    reduced = d1 - 1 if d1 > d0 else d1
                    row = (v_row / v_row.mean(dim=reduced, keepdim=True)
                           ).pow(-0.5)
                    u = g * row.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
                else:
                    v = st["v"].mul_(rate).add_(sq * keep)
                    u = g * v.pow(-0.5)
                rms_u = u.square().mean().sqrt()
                u = u / torch.clamp(rms_u / _CLIPPING_THRESHOLD, min=1.0)
                u = u * lr
                rms_p = w.float().square().mean().sqrt()
                u = u * torch.where(rms_p <= _MIN_SCALE, _MIN_SCALE, rms_p)
                if wd:
                    u = u + wd * w
                w.sub_(u.to(w.dtype))
                st["step"] += 1
        return None


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

    def state_tree(self, layout: "StateLayout") -> dict:
        """The optimizer state as the optax tree (``to_state_dict`` form),
        every moment a full leaf in the JAX layout (a torch tensor where
        the state lives; under ZeRO-1 a collective: every rank calls it)."""
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
                first[name] = layout.tree([
                    state[t][name] if name in state.get(t, {})
                    else torch.zeros(init[name], device=t.device)
                    for t, init in zip(layout.targets, inits)])
        for name, key in self._slots().items():
            moments = [state.get(t, {}).get(key) for t in layout.targets]
            moments = [m if m is not None
                       else torch.zeros_like(t, dtype=torch.float32)
                       for m, t in zip(moments, layout.targets)]
            first[name] = layout.tree(layout.to_full(moments))
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
                "acc_grads": layout.tree(layout.to_full(acc)),
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
                st[name] = interop.as_tensor(values[i]).to(
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


class StateLayout:
    """Where the optimizer keeps each flax leaf's state (``targets``, in
    the JAX leaf order) and how it maps to the full leaf in the JAX
    layout: here, the parameter itself, a ``Dense`` kernel transposed.
    :class:`ShardedUpdate` gives the ZeRO-1 layout. ``partitioner`` stamps
    the checkpoint's mesh manifest (None: replicated)."""

    partitioner = None

    def __init__(self, model: torch.nn.Module):
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

    def refresh(self) -> None:
        """Re-derive whatever the layout keeps beside the parameters
        after they were loaded (nothing here)."""


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
        if isinstance(optimizer.optimizer, Adafactor) and any(
                d is not None for d in self.dims):
            raise _not_in_slice(
                "adafactor under ZeRO-1 (its factored statistics are row "
                "and column means of the whole leaf, item 7)")
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
        sq = distributed.all_reduce_sum_(sq).sqrt()
        p_norm, u_norm = p_norm.clone(), u_norm.clone()
        p_norm[sel] = sq[:len(idx)].to(p_norm.dtype)
        u_norm[sel] = sq[len(idx):].to(u_norm.dtype)
        return p_norm, u_norm

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

    def layout(self) -> "ShardedLayout":
        """The checkpoint layout of this update: tiles gathered on save,
        sliced on load."""
        return ShardedLayout(self)

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


class ShardedLayout(StateLayout):
    """The ZeRO-1 layout: a sharded leaf's state lives on this rank's
    tile. Saving gathers every rank's tiles in one library all-gather
    (the JAX package's ``process_allgather``; a collective, so every rank
    saves); loading slices this rank's tile out of the full leaf."""

    def __init__(self, update: ShardedUpdate):
        self.update = update
        self.leaves = update.leaves
        self.partitioner = update.partitioner
        self.targets = [t if t is not None else p
                        for t, p in zip(update.tiles, update.params)]

    def full_shapes(self) -> List[tuple]:
        return [tuple(leaf.to_jax(p).shape)
                for leaf, p in zip(self.leaves, self.update.params)]

    @torch.no_grad()
    def to_full(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        u = self.update
        out = [None if d is not None else leaf.to_jax(t)
               for leaf, t, d in zip(self.leaves, tensors, u.dims)]
        idx = [i for i, d in enumerate(u.dims) if d is not None]
        if idx:
            flat = torch.cat([tensors[i].reshape(-1).float() for i in idx])
            rows = distributed.all_gather_tiled(flat[None])  # (world, n)
            offset = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = wirelib._unscatter(rows[:, offset:offset + n],
                                            u.dims[i], u.chunk_shapes[i])
                offset += n
        return out

    def from_full(self, fulls: Sequence) -> List[torch.Tensor]:
        u = self.update
        out = []
        for leaf, f, d, cs in zip(self.leaves, fulls, u.dims, u.chunk_shapes):
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
