"""The train and eval steps (the JAX package's train/step.py), replicated
data parallelism only.

A train step is forward, loss, backward, then — with more than one process
— an explicit all-reduce mean of the gradients (the reference's DDP
semantics, train.py:233,138: each process holds a full replica and its
shard of the global batch; local gradients are d(local mean loss), so
their cross-process mean is the gradient of the global mean loss), then
the optimizer update.

The non-finite skip (JAX's graft-armor predication): when any synced
gradient is NaN or Inf, the update is skipped, so parameters, moments and
the schedule position stay exactly as they were, and ``bad_step`` reports
1.0. JAX takes that branch inside the compiled step; here the decision
reads one device scalar on the host per step, the step's only sync (the
metrics stay on the device).

ZeRO-1, wire compression, in-step gradient accumulation, pipelines and
the sentinel metrics are not in this slice and raise.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from distributed_pytorch_example_tpu_torch.models.transformer import (
    _not_in_slice,
)
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.train.optimizers import global_norm
from distributed_pytorch_example_tpu_torch.train.state import TrainState


def _all_reduce_mean_grads(grads) -> None:
    """One flat all-reduce over every gradient, then / world, in place."""
    world = distributed.process_count()
    if world == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat.div_(world)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def _mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Cross-process mean of the scalar metrics, in one collective."""
    if distributed.process_count() == 1:
        return metrics
    names = sorted(metrics)
    packed = torch.stack([metrics[k].float() for k in names])
    distributed.all_reduce_mean_(packed)
    return dict(zip(names, packed.unbind()))


def build_train_step(
    task,
    *,
    partitioner=None,
    grad_accum_steps: int = 1,
    sentinels: bool = False,
    skip_nonfinite: bool = True,
    wire=None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """One optimization step: ``step(state, batch) -> metrics``; updates
    ``state`` in place."""
    if partitioner is not None:
        raise _not_in_slice("partitioners (ZeRO-1, FSDP, TP)")
    if wire is not None:
        raise _not_in_slice("wire compression")
    if grad_accum_steps != 1:
        raise _not_in_slice("in-step gradient accumulation")
    if sentinels:
        raise _not_in_slice("the sentinel metrics")

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model, optimizer = state.model, state.optimizer
        model.train()
        optimizer.zero_grad()
        loss, metrics = task.compute_loss(model, batch, train=True)
        loss.backward()
        grads = [p.grad for p in optimizer.params if p.grad is not None]
        _all_reduce_mean_grads(grads)
        metrics = _mean_metrics(metrics)
        if skip_nonfinite:
            norm = global_norm(grads)
            ok = torch.isfinite(norm)
            if bool(ok):
                optimizer.step(grad_norm=norm)
            metrics = {**metrics, "bad_step": 1.0 - ok.float()}
        else:
            optimizer.step()
        state.step += 1
        return metrics

    return train_step


def build_eval_step(task) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                      Dict[str, torch.Tensor]]:
    """One eval step: ``step(state, batch) -> metrics``, the cross-process
    mean. Reference parity: ``validate`` under ``model.eval()`` +
    ``no_grad`` (train.py:154-175)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        state.model.eval()
        _, metrics = task.compute_loss(state.model, batch, train=False)
        return _mean_metrics(metrics)

    return eval_step
