"""The train and eval steps (the JAX package's train/step.py).

A train step is forward, loss, backward, then the gradient sync, then the
optimizer update. Local gradients are d(local loss); their cross-process
mean is the gradient of the mean of the processes' losses. For a task
whose loss is a mean over a fixed number of rows or positions per process
(SimpleNet, GPT-2, the vision models: the sampler's equal shards), that
is the global mean loss, the reference's DDP semantics (train.py:233,138)
and the loss JAX's replicated step differentiates on the global batch.
A task that scores a data-dependent subset (the masked LM:
``compute_sums`` returns its loss sum, its metric sums and its count)
would weigh a position on rank r by 1 / (world * count_r) that way; the
replicated step instead all-reduces the count before the backward pass
and scales the local sums by world / (global count), so the mean over
processes is sum / global count, as in JAX. Its metrics and the eval
step's follow the same rule.

Two sync paths, chosen as the JAX step chooses between its automatic and
manual data modes:

- **replicated** (no partitioner, or one with nothing to do by hand): one
  flat all-reduce mean of every gradient;
- **manual** (a partitioner with ZeRO-1, ``grad_accum_steps > 1``, int8
  wire compression or bucketing): every gradient collective goes through
  one ``parallel/wire.py`` ``sync_grads`` call, on the leaves in the JAX
  layout and order, scaled by ``1 / (world * grad_accum_steps)``. With
  ZeRO-1 the large leaves reduce-scatter to this rank's tile, the
  optimizer updates the tiles (``train/optimizers.py`` ``ShardedUpdate``)
  and the updated tiles gather back into the parameters;
- **FSDP** (a partitioner of the ``fsdp`` family): the parameters live as
  tiles between steps (``train/optimizers.py`` ``FSDPUpdate``); the step
  gathers them, runs forward and backward with the replicated step's
  semantics (global-batch BatchNorm statistics, a masked LM's global
  count: JAX runs FSDP as the automatic program on the global batch),
  reduce-scatters the gradients to the tiles in one ``sync_grads`` call
  over ``fsdp`` (then an all-reduce over ``data``), scaled by
  ``1 / (world * grad_accum_steps)``, updates the tiles and frees the
  gathered parameters. ``param_norm`` comes from the tiles;
- **tensor** (a partitioner of the ``transformer`` family): the model's
  layers hold their slices and run the tensor group's collectives
  themselves (``parallel/tensor_parallel.py``); the step is the
  replicated one over the data axes (``train/optimizers.py``
  ``TensorUpdate``): one all-reduce mean of the gradients over the data
  group, and norms that count a slice's squares once per tensor group.

"World" below is the data-parallel world, the ranks over the mesh's data
axes: every process, but under tensor parallelism one rank of each
tensor group. Every mean of the step and the eval step runs over its
group; a tensor group's ranks hold the same rows and the same metrics.

``grad_accum_steps = N`` runs N microbatches (contiguous slices of the
local batch) before the one sync, accumulating float32 gradients (the
parameters are float32, so their ``.grad`` is); metrics are the mean over
microbatches. The manual path is JAX's manual path: per-shard means, so
a masked LM's loss there is the mean of the processes' per-shard means.

BatchNorm state (``models/batchnorm.py``), as JAX computes it: the
replicated path at world > 1 runs the forward under
``global_batch_stats``, so the statistics are the global batch's and the
running statistics agree on every process; the manual path takes
per-shard statistics (threaded from microbatch to microbatch) and, after
the backward, the cross-process mean of the running statistics (JAX's
``_pmean_inexact``).

The non-finite skip (JAX's graft-armor predication): when any element
of the synced gradients is NaN or Inf (their non-finite count, summed
across ranks under the manual path, is above 0), the update is skipped,
so parameters, moments, the schedule position and the BatchNorm running
statistics stay as they were (the statistics are copied before the
forward, which updates them in place, and copied back on a skip: JAX's
``skip_update`` returns the old model state), and ``bad_step`` reports
1.0. A finite gradient whose norm overflows float32
is applied, as in JAX. A finite global norm means no element is NaN or
Inf, so the count is taken only when the norm is not finite (every rank
sees the same norm, so every rank takes the same branch). JAX takes that
branch inside the compiled step; here the decision reads the norm on the
host once per step, the step's only sync in the common case, and the
ring collectives' error words are read right after it, so a ring wait
that timed out raises before any update.

Randomness: a task that draws (``uses_generator``) gets a
``torch.Generator`` on the batch's device, seeded from (seed, step,
process) for a train step and from (seed, batch index, process) for an
eval batch: the JAX step's
``fold_in(rng, step)`` and shard fold, and its eval step's
``fold_in(rng, batch_idx)``. So masks differ across steps, processes and
validation batches, and a resumed run draws what the uninterrupted run
drew. The bits are torch's, not ``jax.random``'s.

The sentinels (``sentinels=True``, the default, as in JAX; the training
half of ``telemetry/sentinels.py``): ``grad_norm`` is the norm of the
synced gradients (the mean's under accumulation), the one the skip
predicate reads; ``nonfinite_grads`` is the predicate's own count (0 when
that norm is finite, else counted; without the skip, counted in the
norm's own reduction); ``param_norm`` is the norm of the parameters after
the update (a skipped step reports the old ones). Under ZeRO-1 every rank
holds the whole parameters again after the gather, so no collective is
added; the gradient norm's and the count's partial sums ride the
collective the step already runs. They stay on the device until a
boundary fetch: the step adds no host sync.

Pipelines are not in this slice and raise.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from distributed_pytorch_example_tpu_torch.models.batchnorm import (
    global_batch_stats,
    running_stats,
)
from distributed_pytorch_example_tpu_torch.ops import collectives
from distributed_pytorch_example_tpu_torch.parallel import wire as wirelib
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.runtime import mesh as mesh_lib
from distributed_pytorch_example_tpu_torch.train.optimizers import (
    FSDPUpdate,
    ShardedUpdate,
    TensorUpdate,
    global_norm,
    nonfinite_count,
)
from distributed_pytorch_example_tpu_torch.train.state import TrainState


_TRAIN, _EVAL = 0, 1  # keeps train and eval draws apart


def _task_kwargs(task, seed: int, kind: int, index: int, batch) -> dict:
    """``{"generator": ...}`` for a task that draws (``uses_generator``):
    the generator of train step (or eval batch) ``index`` on this
    process, on the batch's device; ``{}`` for any other task."""
    if not getattr(task, "uses_generator", False):
        return {}
    device = next(iter(batch.values())).device
    mixed = np.random.SeedSequence(
        [seed, kind, index, distributed.process_index()]
    ).generate_state(1, np.uint64)[0]
    return {"generator":
            torch.Generator(device=device).manual_seed(int(mixed) >> 1)}


def _flat(tensors):
    """The tensors' elements in one new 1-D tensor, in order."""
    return torch.cat([t.reshape(-1) for t in tensors])


@torch.no_grad()
def _unflat(flat: torch.Tensor, tensors) -> None:
    """Copy :func:`_flat`'s layout back into the tensors, in place."""
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _all_reduce_mean_grads(grads) -> None:
    """One flat all-reduce over every gradient, then / world, in place."""
    world = distributed.process_count()
    if world == 1 or not grads:
        return
    flat = _flat(grads)
    distributed.all_reduce_sum_(flat)
    flat.div_(world)
    _unflat(flat, grads)


def _data_world(partitioner):
    """``(group, size)`` of the data-parallel world: the processes, or the
    partitioner's mesh's data axes (``runtime.mesh.data_group``)."""
    if partitioner is None:
        return None, distributed.process_count()
    return mesh_lib.data_group(partitioner.mesh)


def _mean_metrics(metrics: Dict[str, torch.Tensor],
                  data) -> Dict[str, torch.Tensor]:
    """Mean of the scalar metrics over the data-parallel world ``data`` =
    (group, size), in one collective."""
    group, size = data
    if size == 1:
        return metrics
    names = sorted(metrics)
    packed = torch.stack([metrics[k].float() for k in names])
    distributed.all_reduce_sum_(packed, group)
    packed.div_(size)
    return dict(zip(names, packed.unbind()))


def _microbatches(batch, n: int):
    """Split every batch leaf (B, ...) into n contiguous (B/n, ...)."""
    for key, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(
                f"grad_accum_steps={n} must divide the per-process batch "
                f"size {x.shape[0]} (batch leaf {key!r} of shape "
                f"{tuple(x.shape)})"
            )
    return [{k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]
             for k, x in batch.items()} for i in range(n)]


def _task_loss(task, model, batch, *, train: bool, task_kw: dict,
               global_count: bool, data):
    """``(loss, metrics)`` of one (micro)batch. With ``global_count``, a
    task with ``compute_sums`` is normalised by the count over the
    data-parallel world ``data`` = (group, size) (one all-reduce of the
    count, before the backward pass): the local loss is sum * world /
    global count, so the world's mean of losses, metrics and gradients is
    sum / global count."""
    if not (global_count and hasattr(task, "compute_sums")):
        return task.compute_loss(model, batch, train=train, **task_kw)
    loss_sum, sums, count = task.compute_sums(model, batch, train=train,
                                              **task_kw)
    group, size = data
    total = count.float().reshape(1)
    if size > 1:
        distributed.all_reduce_sum_(total, group)
    denom = total[0].clamp_min(1) / size
    loss = loss_sum / denom
    return loss, {"loss": loss.detach(),
                  **{k: v / denom for k, v in sums.items() if k != "loss"}}


def _backward(task, model, batch, n: int, task_kw: dict,
              global_count: bool, data) -> Dict[str, torch.Tensor]:
    """Forward + backward over ``n`` microbatches; the gradients sum into
    ``.grad``, the metrics are their mean."""
    per = []
    for mb in (batch,) if n == 1 else _microbatches(batch, n):
        loss, metrics = _task_loss(task, model, mb, train=True,
                                   task_kw=task_kw, global_count=global_count,
                                   data=data)
        loss.backward()
        per.append(metrics)
    if n == 1:
        return per[0]
    return {k: torch.stack([m[k].float() for m in per]).mean()
            for k in per[0]}


def build_train_step(
    task,
    *,
    partitioner=None,
    grad_accum_steps: int = 1,
    sentinels: bool = True,
    skip_nonfinite: bool = True,
    wire: Optional[wirelib.WireConfig] = None,
    seed: int = 0,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """One optimization step: ``step(state, batch) -> metrics``; updates
    ``state`` in place. ``wire`` defaults to the partitioner's, else
    float32 payloads; ``seed`` seeds the task's draws and the wire
    quantizer's stochastic rounding (one generator per step and rank);
    ``sentinels`` adds ``grad_norm``, ``param_norm`` and
    ``nonfinite_grads`` to the metrics."""
    if grad_accum_steps < 1:
        raise ValueError(
            f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    if wire is None:
        wire = getattr(partitioner, "wire", None) or wirelib.WireConfig()
    fsdp = getattr(partitioner, "fsdp_axis", None) is not None
    tensor = getattr(partitioner, "tensor_axis", None) is not None
    manual = partitioner is not None and not tensor and (
        fsdp or partitioner.dp_shard_opt_state or grad_accum_steps > 1
        or wire.compress != "none" or wire.bucketed
    )
    data = _data_world(partitioner)
    updates: Dict[int, ShardedUpdate] = {}

    def sharded(state: TrainState) -> ShardedUpdate:
        key = id(state.optimizer)
        if key not in updates:
            if tensor:
                updates[key] = TensorUpdate(state.model, state.optimizer,
                                            partitioner)
            elif fsdp:
                updates[key] = FSDPUpdate(state.model, state.optimizer,
                                          partitioner)
            else:
                updates[key] = ShardedUpdate(
                    state.model, state.optimizer, partitioner,
                    distributed.process_index(),
                    distributed.process_count())
        return updates[key]

    def manual_sync(state: TrainState):
        """ONE sync_grads call for every gradient collective; returns the
        global gradient norm and, when the skip will not count them, the
        non-finite elements (None otherwise), reduced together."""
        update = sharded(state)
        world = distributed.process_count()
        if fsdp:
            update.sync(1.0 / (world * grad_accum_steps))
            if sentinels and not skip_nonfinite:
                return update.norm_and_count()
            return update.global_norm(), None
        generator = None
        if wire.stochastic_rounding and wire.compress != "none":
            device = update.params[0].device
            generator = torch.Generator(device=device).manual_seed(
                (seed * 1_000_003 + state.step) * 4099
                + distributed.process_index())
        synced = wirelib.sync_grads(
            update.local_grads(), update.dims, config=wire,
            generator=generator, scale=1.0 / (world * grad_accum_steps))
        update.set_grads(synced)
        if sentinels and not skip_nonfinite:
            return update.norm_and_count()
        return update.global_norm(), None

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model, optimizer = state.model, state.optimizer
        model.train()
        fold_in = getattr(model, "fold_in", None)
        if fold_in is not None:  # dropout draws from (seed, step) alone
            fold_in(state.step)
        if manual or tensor:
            update = sharded(state)  # rebinds the optimizer before its use
            if fsdp:
                update.materialize()  # the parameters' gathers
        # the model's own grads too: under ZeRO-1 the optimizer holds the
        # tiles, not the sharded parameters
        model.zero_grad(set_to_none=True)
        optimizer.zero_grad()
        task_kw = _task_kwargs(task, seed, _TRAIN, state.step, batch)
        world = data[1]
        stats = running_stats(model)
        # the running statistics update in place in the forward: a copy to
        # put back if the step is skipped
        saved = _flat(stats) if stats and skip_nonfinite else None
        # the replicated step's semantics (FSDP's too: JAX runs it as the
        # automatic program on the global batch)
        global_batch = world > 1 and (fsdp or not manual)
        with global_batch_stats(global_batch):
            metrics = _mean_metrics(_backward(
                task, model, batch, grad_accum_steps, task_kw,
                global_count=global_batch, data=data), data)
        if manual and not fsdp and stats and world > 1:
            flat = distributed.all_reduce_mean_(_flat(stats))
            _unflat(flat, stats)
        if manual:
            norm, count = manual_sync(state)
        elif tensor:
            update = sharded(state)
            update.sync(grad_accum_steps)
            if sentinels and not skip_nonfinite:
                norm, count = update.norm_and_count()
            else:
                norm, count = update.global_norm(), None
        else:
            grads = [p.grad for p in optimizer.params if p.grad is not None]
            _all_reduce_mean_grads(grads)
            if grad_accum_steps > 1:
                torch._foreach_div_(grads, float(grad_accum_steps))
            norm = global_norm(grads)
            count = (nonfinite_count(grads)
                     if sentinels and not skip_nonfinite else None)
        bad, apply = torch.zeros((), device=norm.device), True
        if skip_nonfinite and not bool(torch.isfinite(norm)):
            bad = (sharded(state).nonfinite_count() if manual or tensor
                   else nonfinite_count(grads))
            apply = not bool(bad > 0)
            if not apply and saved is not None:
                _unflat(saved, stats)
        collectives.check_rings()  # a ring wait that timed out raises here
        if apply and optimizer.step(grad_norm=norm) and manual:
            sharded(state).replicate(wire)
        if sentinels:
            # a finite norm means no element is NaN or Inf: the skip's
            # count (0 then) is the sentinel's
            metrics = {**metrics, "grad_norm": norm,
                       "param_norm": (sharded(state).param_norm()
                                      if fsdp or tensor
                                      else global_norm(model.parameters())),
                       "nonfinite_grads": bad if count is None else count}
        if manual:
            sharded(state).end_step()
        if skip_nonfinite:
            metrics = {**metrics, "bad_step": (bad > 0).float()}
        state.step += 1
        return metrics

    def layout(state: TrainState):
        """Where the optimizer keeps its state, for checkpoints: the
        ZeRO-1 / wire update's tiles or the tensor-parallel slices (built
        here if no step has run yet), or None for the replicated
        parameters."""
        return sharded(state).layout() if manual or tensor else None

    def gathered(state: TrainState):
        """A block in which the parameters are whole (FSDP gathers them
        and frees them after it; nothing to do otherwise)."""
        if not fsdp:
            return contextlib.nullcontext()
        return sharded(state).gathered()

    train_step.sharded = sharded  # the ZeRO-1 / wire update, for checks
    train_step.layout = layout
    train_step.gathered = gathered
    return train_step


def build_eval_step(task, *, seed: int = 0, partitioner=None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """One eval step: ``step(state, batch, batch_idx=0) -> metrics``, the
    mean over the data-parallel world (the processes, or the
    partitioner's data axes; a masked LM's over the global count of
    scored positions, as JAX's eval on the global batch); ``batch_idx``
    picks the batch's draws, so validation masks do not repeat across
    batches. BatchNorm uses its running statistics. Reference parity:
    ``validate`` under ``model.eval()`` + ``no_grad``
    (train.py:154-175)."""
    data = _data_world(partitioner)

    @torch.no_grad()
    def eval_step(state: TrainState, batch,
                  batch_idx: int = 0) -> Dict[str, torch.Tensor]:
        state.model.eval()
        _, metrics = _task_loss(
            task, state.model, batch, train=False,
            task_kw=_task_kwargs(task, seed, _EVAL, batch_idx, batch),
            global_count=data[1] > 1, data=data)
        return _mean_metrics(metrics, data)

    return eval_step
