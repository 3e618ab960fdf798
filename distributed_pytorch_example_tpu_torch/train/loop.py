"""The epoch loop: train -> validate -> reduce -> barrier (the JAX
package's train/loop.py).

Behavioural parity with the reference's ``main()`` orchestration
(train.py:212-318):

- per-epoch reshuffle via ``loader.set_epoch`` (train.py:267);
- a rank-0 progress log every ``log_every`` batches, fetching only that
  step's loss (the steps between stay asynchronous);
- validation on each process's shard with cross-process mean metrics
  (train.py:154-175, 275-277);
- the best validation accuracy, and epoch / total wall-time logs with the
  JAX package's wording ("Epoch %d completed", "Throughput: %.1f
  samples/sec", "Train Loss", "Best validation accuracy");
- a cross-process barrier per epoch (train.py:310);
- ZeRO-1 and the wire layer through ``partitioner`` (``parallel/``), and
  in-step gradient accumulation (``grad_accum_steps``), both in the step;
- graft-armor's bad-step budget: non-finite steps are skipped in the step
  (train/step.py) and counted at log boundaries; more than
  ``max_bad_steps`` raises :class:`BadStepBudgetExceeded` (there is no
  checkpoint to roll back to in this slice).

Not in this slice: checkpoints and resume (refused when asked for; the
gathered ``DPX-CRC1`` format comes next, ROADMAP.md queue 1), the
telemetry scope, the profiler, chaos injection, publishing and the
preemption save.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch

from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models.transformer import (
    _not_in_slice,
)
from distributed_pytorch_example_tpu_torch.parallel import wire as wirelib
from distributed_pytorch_example_tpu_torch.robustness import (
    BadStepBudgetExceeded,
)
from distributed_pytorch_example_tpu_torch.runtime import distributed as dist
from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger
from distributed_pytorch_example_tpu_torch.train.metrics import (
    MetricAccumulator,
)
from distributed_pytorch_example_tpu_torch.train.optimizers import Optimizer
from distributed_pytorch_example_tpu_torch.train.state import TrainState
from distributed_pytorch_example_tpu_torch.train.step import (
    build_eval_step,
    build_train_step,
)

logger = get_logger(__name__)


class Trainer:
    """Binds (model, task, optimizer) into a runnable data-parallel job."""

    def __init__(
        self,
        model: torch.nn.Module,
        task,
        optimizer: Optimizer,
        *,
        partitioner=None,
        checkpoint_dir: Optional[str] = None,
        log_every: int = 10,
        seed: int = 0,
        max_bad_steps: int = 8,
        skip_nonfinite: bool = True,
        grad_accum_steps: int = 1,
    ):
        if checkpoint_dir:
            raise _not_in_slice("checkpoints")
        if grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps must be >= 1, got {grad_accum_steps}"
            )
        self.model = model
        self.task = task
        self.optimizer = optimizer
        self.partitioner = partitioner
        self.log_every = log_every
        self.max_bad_steps = max_bad_steps
        self.grad_accum_steps = grad_accum_steps
        self.train_step = build_train_step(
            task, partitioner=partitioner, grad_accum_steps=grad_accum_steps,
            skip_nonfinite=skip_nonfinite, seed=seed,
        )
        self.eval_step = build_eval_step(task)
        self.state = TrainState(step=0, model=model, optimizer=optimizer)
        self.recovery: Dict[str, int] = {"bad_steps": 0}
        self._pending_bad: List[torch.Tensor] = []

    def init(self) -> TrainState:
        """Log the parameter count and, under a partitioner, the analytic
        gradient-sync wire bytes and the bucket plan (the JAX loop's
        graft-wire lines); the model is built with its weights."""
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("Model parameters: %s", f"{n_params:,}")
        self.wire_report = None
        if self.partitioner is None:
            return self.state
        wire = self.partitioner.wire or wirelib.WireConfig()
        named = dict(self.model.named_parameters())
        shapes = {leaf.key: tuple(leaf.to_jax(named[leaf.name]).shape)
                  for leaf in interop.flax_leaves(self.model)}
        self.wire_report = wirelib.grad_wire_report(shapes, self.partitioner,
                                                    wire)
        if wire.compress != "none":
            logger.info(
                "graft-wire: %s block=%d — grad sync %s B/step/device "
                "(fp32 %s, ratio %.2fx)", wire.compress, wire.block_size,
                f"{self.wire_report['grad_wire_bytes_per_step']:,}",
                f"{self.wire_report['grad_wire_bytes_per_step_fp32']:,}",
                self.wire_report["wire_compression_ratio"],
            )
        if wire.bucketed:
            if self.partitioner.dp_shard_opt_state:
                dims = self.partitioner.zero1_dims(shapes)
            else:
                dims = dict.fromkeys(shapes)
            plan = wirelib.plan_buckets(list(dims.values()),
                                        list(shapes.values()), wire,
                                        self.partitioner.world)
            logger.info("graft-wire: %d buckets (%s B target)",
                        len(plan.buckets), f"{wire.bucket_bytes:,}")
        return self.state

    # -- epochs -----------------------------------------------------------

    def train_epoch(self, loader, epoch: int) -> Dict[str, float]:
        loader.set_epoch(epoch)
        acc = MetricAccumulator()
        num_batches = len(loader)
        for batch_idx, batch in enumerate(loader):
            metrics = self.train_step(self.state, batch)
            acc.append(metrics)
            if "bad_step" in metrics:
                self._pending_bad.append(metrics["bad_step"])
            if batch_idx % self.log_every == 0:
                if dist.is_coordinator():
                    logger.info("Epoch %d, Batch %d/%d, Loss: %.4f", epoch,
                                batch_idx, num_batches,
                                float(metrics["loss"]))
                # every process, same cadence: budget decisions must be
                # taken identically on all of them
                self._drain_bad_steps()
        self._drain_bad_steps()
        return acc.result()

    def _drain_bad_steps(self) -> None:
        """Sum the bad-step flags since the last boundary (one host fetch)
        and enforce ``max_bad_steps`` (0 = unlimited)."""
        if not self._pending_bad:
            return
        new = int(round(torch.stack(self._pending_bad).sum().item()))
        self._pending_bad = []
        if new == 0:
            return
        self.recovery["bad_steps"] += new
        logger.warning(
            "graft-armor: %d nonfinite step(s) skipped (%d in all, budget "
            "%s)", new, self.recovery["bad_steps"],
            self.max_bad_steps or "unlimited",
        )
        if self.max_bad_steps and self.recovery["bad_steps"] > self.max_bad_steps:
            raise BadStepBudgetExceeded(
                f"{self.recovery['bad_steps']} nonfinite step(s) skipped; "
                f"budget max_bad_steps={self.max_bad_steps} exhausted with no "
                "checkpoint to roll back to — persistent fault (diverged "
                "optimization, bad data, or a real numerics bug)"
            )

    def validate(self, loader) -> Dict[str, float]:
        acc = MetricAccumulator()
        for batch in loader:
            acc.append(self.eval_step(self.state, batch))
        return acc.result()

    # -- full fit ---------------------------------------------------------

    def fit(self, train_loader, val_loader=None, epochs: int = 10,
            resume: Optional[str] = None) -> List[Dict[str, float]]:
        if resume and os.path.exists(resume):
            raise _not_in_slice("resume from a checkpoint")
        # a missing resume path trains from scratch (reference parity)
        self.init()
        self.recovery = {"bad_steps": 0}
        self._pending_bad = []
        dist.barrier()
        history: List[Dict[str, float]] = []
        best_accuracy = 0.0
        start_time = time.time()
        for epoch in range(epochs):
            epoch_start = time.time()
            train_metrics = self.train_epoch(train_loader, epoch)
            train_time = time.time() - epoch_start
            val_metrics = (self.validate(val_loader)
                           if val_loader is not None else {})
            epoch_time = time.time() - epoch_start
            record = {
                "epoch": epoch,
                "epoch_time": epoch_time,
                "train_time": train_time,
                "train_loss": train_metrics.get("loss", float("nan")),
                "val_loss": val_metrics.get("loss", float("nan")),
                "val_accuracy": val_metrics.get("accuracy", float("nan")),
            }
            global_batch = getattr(train_loader, "global_batch_size", None)
            if global_batch:
                # training throughput only: validation time excluded
                record["samples_per_sec"] = (
                    len(train_loader) * global_batch / train_time
                )
            history.append(record)
            if dist.is_coordinator():
                logger.info("Epoch %d completed in %.2fs", epoch, epoch_time)
                if "samples_per_sec" in record:
                    logger.info("  Throughput: %.1f samples/sec",
                                record["samples_per_sec"])
                logger.info("  Train Loss: %.4f", record["train_loss"])
                if val_loader is not None:
                    logger.info("  Val Loss: %.4f, Val Accuracy: %.2f%%",
                                record["val_loss"], record["val_accuracy"])
            if val_loader is not None and record["val_accuracy"] > best_accuracy:
                best_accuracy = record["val_accuracy"]
            dist.barrier()
        total_time = time.time() - start_time
        if dist.is_coordinator():
            logger.info("Training completed in %.2fs", total_time)
            if val_loader is not None:
                logger.info("Best validation accuracy: %.2f%%", best_accuracy)
        return history
