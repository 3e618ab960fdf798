"""The epoch loop: train -> validate -> reduce -> checkpoint -> barrier (the
JAX package's train/loop.py).

Behavioural parity with the reference's ``main()`` orchestration
(train.py:212-318), and with the JAX package's loop where it goes further:

- per-epoch reshuffle via ``loader.set_epoch`` (train.py:267);
- a rank-0 progress log every ``log_every`` batches, fetching only that
  step's loss (the steps between stay asynchronous);
- validation on each process's shard with cross-process mean metrics
  (train.py:154-175, 275-277);
- rank-0 best/latest checkpoints at each epoch's end, keyed on validation
  accuracy and stamped ``epoch + 1`` with ``extra = {best_accuracy,
  loader_manifest}`` (train.py:292-308; ``train/checkpoint.py``), and
  ``metrics.jsonl`` beside them (a fresh run truncates it, a resumed one
  appends);
- resume from a checkpoint of either package: at the epoch after the
  finished one, or, from a ``save_every_steps`` mid-epoch save, at the
  saved batch (``loader.iter_from``), with ``best_accuracy`` carried over;
  a missing ``resume`` path trains from scratch (reference parity);
- SIGTERM / SIGINT: the in-flight step finishes, a one-process job saves
  ``latest`` with its cursor (a multi-process job skips that save with a
  warning: the signal does not reach the ranks at the same step), and
  :class:`PreemptionInterrupt` unwinds (the CLI exits 143 / 130);
- graft-armor's bad-step budget: non-finite steps are skipped in the step
  (train/step.py) and counted at log boundaries; more than
  ``max_bad_steps`` since the last recovery rolls back once to ``latest``,
  and the next exhaustion raises :class:`BadStepBudgetExceeded`;
- the ``recovery`` counters (``bad_steps``, ``rollbacks``,
  ``checkpoint_fallbacks``), the chaos hooks (``robustness/chaos.py``), a
  check of the async saver after every step and its drain at the end;
- a cross-process barrier per epoch (train.py:310);
- ZeRO-1, FSDP, tensor parallelism and the wire layer through
  ``partitioner`` (``parallel/``: ``data_parallel``, ``fsdp`` or
  ``transformer_partitioner``, lowered from a ``PlanSpec``), and in-step
  gradient accumulation (``grad_accum_steps``), both in the step. Under
  FSDP each rank holds its tiles between steps; validation gathers the
  parameters for its pass, a gathered checkpoint gathers them too, and
  the cost record's ``hbm_peak_bytes`` is this rank's. Under tensor
  parallelism a rank holds its slices throughout: the cost record's
  FLOPs and ``hbm_peak_bytes`` are its share, and the step's and
  validation's means run over the data axes (a tensor group's ranks read
  the same rows).

``checkpoint_format`` is ``auto`` (the sharded format for a multi-process
job, whose saves gather nothing and write on the saver's thread; one
gathered file otherwise), ``gathered`` or ``sharded``. Resume takes
either format at any process count: the loader cursor counts global
batches, so at the same global batch size a resume at another world
repeats no sample and skips none.

graft-scope (``telemetry/``, on by default as in JAX): the first train
and eval step of a run are measured into the cost registry (FLOPs, peak
memory, collectives), every step ticks the rate-limited clock with a
fence on the loss, and each log boundary (or every ``telemetry_every``
steps, which also writes a per-N-step record) fetches the loss and the
sentinels in one host read; ``data_load``, ``h2d``, ``step``, ``eval``
and ``checkpoint`` spans and the bucket plan's issue schedule go to
``trace_events.json`` beside ``metrics.jsonl``; recovery events
(``bad_step_skip``, ``rollback``, ``checkpoint_fallback``) are records of
``metrics.jsonl``; ``telemetry_summary`` holds the scope's summary after
``fit``, with ``wire`` and ``overlap_scheduled`` under a partitioner.
``profile_dir`` traces the global steps of ``profile_window`` (run-relative,
rebased on resume) with ``torch.profiler`` (``runtime/profiler.py``).

Not in this slice: publishing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Union

import torch

from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.data import intake
from distributed_pytorch_example_tpu_torch.parallel import wire as wirelib
from distributed_pytorch_example_tpu_torch.robustness import (
    BadStepBudgetExceeded,
    chaos,
    elastic,
)
from distributed_pytorch_example_tpu_torch.runtime import distributed as dist
from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger
from distributed_pytorch_example_tpu_torch.runtime.profiler import StepProfiler
from distributed_pytorch_example_tpu_torch.telemetry import (
    Telemetry,
    TelemetryConfig,
    scheduled_overlap,
)
from distributed_pytorch_example_tpu_torch.telemetry.cost import (
    resident_bytes,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt_lib
from distributed_pytorch_example_tpu_torch.train.metrics import (
    MetricAccumulator,
)
from distributed_pytorch_example_tpu_torch.train.metrics_writer import (
    MetricsWriter,
)
from distributed_pytorch_example_tpu_torch.train.optimizers import Optimizer
from distributed_pytorch_example_tpu_torch.train.state import (
    TrainState,
    seed_key,
)
from distributed_pytorch_example_tpu_torch.train.step import (
    build_eval_step,
    build_train_step,
)

logger = get_logger(__name__)


def _span(scope: Optional[Telemetry], name: str):
    """A graft-scope trace span, or a no-op when telemetry is off."""
    if scope is None:
        return contextlib.nullcontext()
    return scope.span(name)


def _spanned_batches(iterator, scope: Optional[Telemetry]):
    """Wrap an iterator so each ``next()`` is timed as a "data_load" span
    (the consumer-side wait on the loader)."""
    while True:
        with _span(scope, "data_load"):
            try:
                item = next(iterator)
            except StopIteration:
                return
        yield item


class PreemptionInterrupt(BaseException):
    """Raised inside ``fit`` after a signal-triggered checkpoint landed.

    ``exit_code`` is the conventional rc: 143 for SIGTERM (orchestrator
    teardown, which the launcher does not restart) and 130 for SIGINT. A
    BaseException, so a blanket ``except Exception`` cannot swallow it.
    """

    def __init__(self, exit_code: int = 143):
        super().__init__(exit_code)
        self.exit_code = exit_code


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
        metrics_file: Optional[str] = None,
        checkpoint_format: str = "auto",
        save_every_steps: int = 0,
        max_bad_steps: int = 8,
        skip_nonfinite: bool = True,
        grad_accum_steps: int = 1,
        checkpoint_retain: int = ckpt_lib.DEFAULT_RETAIN,
        profile_dir: Optional[str] = None,
        profile_window: tuple = (10, 13),
        telemetry: Union[bool, TelemetryConfig] = True,
        telemetry_every: int = 0,
    ):
        if grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps must be >= 1, got {grad_accum_steps}"
            )
        if checkpoint_format not in ("auto", "gathered", "sharded"):
            raise ValueError(
                f"checkpoint_format must be auto|gathered|sharded, got "
                f"{checkpoint_format!r}"
            )
        self.model = model
        self.task = task
        self.optimizer = optimizer
        self.partitioner = partitioner
        self.checkpoint_dir = checkpoint_dir
        self.log_every = log_every
        self.max_bad_steps = max_bad_steps
        self.grad_accum_steps = grad_accum_steps
        self.checkpoint_retain = checkpoint_retain
        self.save_every_steps = save_every_steps
        self._checkpoint_format = checkpoint_format
        # the step as built; ``train_step`` may be wrapped (timing, tests)
        self._step = build_train_step(
            task, partitioner=partitioner, grad_accum_steps=grad_accum_steps,
            skip_nonfinite=skip_nonfinite, seed=seed,
        )
        self.train_step = self._step
        self.eval_step = build_eval_step(task, seed=seed,
                                         partitioner=partitioner)
        self.state = TrainState(step=0, model=model, optimizer=optimizer,
                                rng=seed_key(seed))
        if metrics_file is None and checkpoint_dir:
            metrics_file = os.path.join(checkpoint_dir, "metrics.jsonl")
        self._metrics_file = metrics_file
        self._saver = ckpt_lib.AsyncSaver()
        self._best_accuracy = 0.0
        self._preempt_requested = False
        self._preempt_rc = 143
        self.recovery: Dict[str, int] = {
            "bad_steps": 0, "rollbacks": 0, "checkpoint_fallbacks": 0,
        }
        self._pending_bad: List[torch.Tensor] = []
        self._bad_since_recovery = 0
        self._rolled_back = False
        self._global_step = 0
        self._profile_dir = profile_dir
        self._profile_window = profile_window
        self._profiler: Optional[StepProfiler] = None  # made in fit()
        # graft-scope: True takes the defaults (epoch records only),
        # telemetry_every > 0 adds a record every N steps, a
        # TelemetryConfig wins over both, False turns the scope off
        if isinstance(telemetry, TelemetryConfig):
            self._telemetry_cfg: Optional[TelemetryConfig] = telemetry
        elif telemetry:
            self._telemetry_cfg = TelemetryConfig(every=telemetry_every)
        else:
            self._telemetry_cfg = None
        self.scope: Optional[Telemetry] = None
        self.telemetry_summary: Dict[str, Any] = {}
        self.wire_report: Optional[Dict[str, Any]] = None  # set in init()
        self.overlap_report: Optional[Dict[str, Any]] = None
        self._bucket_plan = None
        # the second train step re-takes the cost record's memory
        self._memory_pending = False
        # events fired before fit's scope exists, flushed into it on
        # creation (see _record_event)
        self._pending_events: List[Any] = []

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def init(self) -> TrainState:
        """Log the parameter count and, under a partitioner, the analytic
        gradient-sync wire bytes and the bucket plan (the JAX loop's
        graft-wire lines); the model is built with its weights."""
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("Model parameters: %s", f"{n_params:,}")
        self.wire_report = self.overlap_report = self._bucket_plan = None
        if self.partitioner is None:
            return self.state
        wire = self.partitioner.wire or wirelib.WireConfig()
        named = dict(self.model.named_parameters())
        shapes = {leaf.key: leaf.jax_shape(named[leaf.name].shape)
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
            dims = self.partitioner.sync_dims(shapes)
            # the plan sync_grads executes (grad shapes are the params')
            self._bucket_plan = wirelib.plan_buckets(
                list(dims.values()), list(shapes.values()), wire,
                self.partitioner.mesh.shape[
                    self.partitioner.grad_sync_axis()])
            self.overlap_report = scheduled_overlap(
                self._bucket_plan, grad_accum_steps=self.grad_accum_steps)
            logger.info(
                "graft-wire: %d overlap buckets (%s B target) — scheduled "
                "overlap_frac %.3f (%s of %s wire bytes hideable)",
                self.overlap_report["num_buckets"], f"{wire.bucket_bytes:,}",
                self.overlap_report["overlap_frac_scheduled"],
                f"{self.overlap_report['hideable_wire_bytes']:,}",
                f"{self.overlap_report['total_wire_bytes']:,}",
            )
        return self.state

    # -- checkpoints --------------------------------------------------------

    def layout(self):
        """Where the optimizer keeps its state (the ZeRO-1 tiles, or None
        for the replicated parameters), for ``save/load_checkpoint``."""
        return self._step.layout(self.state)

    def _sharded_ckpt(self) -> bool:
        """``auto``: the sharded format in a multi-process job (no gather,
        saves on the saver's thread), one gathered file otherwise (the
        reference's single file, train.py:185-192)."""
        if self._checkpoint_format == "auto":
            return dist.process_count() > 1
        return self._checkpoint_format == "sharded"

    def _save(self, name: str, epoch: int, loss: float, extra: dict) -> None:
        ckpt_lib.save_checkpoint(
            os.path.join(self.checkpoint_dir, name), self.state, epoch, loss,
            extra, saver=self._saver, sharded=self._sharded_ckpt(),
            retain=self.checkpoint_retain, layout=self.layout(),
        )

    def load(self, path: str):
        """Restore ``path`` (with the fallback walk) into the live state;
        returns ``(epoch, extra)``. This rank's pending save lands first,
        and every rank's (a sharded save's pointer flips on rank 0 after
        the others have written) before any rank reads."""
        self._saver.wait()
        dist.barrier()
        _, epoch, extra = ckpt_lib.load_checkpoint(
            path, self.state, self.layout(), on_event=self._record_event)
        return epoch, extra

    def _save_mid_epoch(self, loader, epoch: int, batch_idx: int,
                        metrics) -> None:
        """Write `latest` stamped with the current epoch and the loader
        cursor (an epoch-end save stamps epoch + 1, cursor 0)."""
        extra = {
            "best_accuracy": self._best_accuracy,
            "batch_in_epoch": batch_idx + 1,
        }
        man = intake.loader_manifest(loader, epoch, batch_idx + 1)
        if man is not None:
            extra[intake.LOADER_MANIFEST_KEY] = man
        with _span(self.scope, "checkpoint"):
            self._save(ckpt_lib.LATEST_NAME, epoch, float(metrics["loss"]),
                       extra)

    # -- epochs -----------------------------------------------------------

    def train_epoch(self, loader, epoch: int,
                    start_batch: int = 0) -> Dict[str, float]:
        loader.set_epoch(epoch)
        acc = MetricAccumulator()
        num_batches = len(loader)
        if start_batch:
            # the permutation is a pure function of (seed, epoch): skipping
            # gives exactly the uninterrupted run's remaining batches; this
            # epoch's train metrics cover the batches after the resume
            logger.info("Resuming epoch %d at batch %d/%d", epoch,
                        start_batch, num_batches)
            batches = loader.iter_from(start_batch)
        else:
            batches = iter(loader)
        scope = self.scope
        for batch_idx, batch in enumerate(_spanned_batches(batches, scope),
                                          start=start_batch):
            if self._profiler is not None:
                self._profiler.step(self._global_step)
            # deterministic fault injection (no-op without a chaos plan);
            # the global step counts on through a rollback, as JAX's does
            batch = chaos.corrupt_batch(batch, self._global_step)
            with self._measured("train_step", batch), _span(scope, "step"):
                metrics = self.train_step(self.state, batch)
            self._global_step += 1
            acc.append(metrics)
            if "bad_step" in metrics:
                self._pending_bad.append(metrics["bad_step"])
            # a failed background save surfaces within a step of the fault
            self._saver.check()
            chaos.crash_point("step")
            if scope is not None:
                # the clock's tick (a fence on the loss every sample_every
                # steps) and, at boundaries, the one-fetch health check,
                # the straggler exchange and the per-N-step record
                scope.on_step(self._global_step, metrics,
                              fence=lambda m=metrics: float(m["loss"]))
            if batch_idx % self.log_every == 0:
                if dist.is_coordinator():
                    logger.info("Epoch %d, Batch %d/%d, Loss: %.4f", epoch,
                                batch_idx, num_batches,
                                float(metrics["loss"]))
                # every process, same cadence: budget decisions (rollback,
                # hard failure) must be taken identically on all of them
                self._drain_bad_steps()
            if (self.save_every_steps and self.checkpoint_dir
                    and (batch_idx + 1) % self.save_every_steps == 0
                    and batch_idx + 1 < num_batches):  # epoch end follows
                self._save_mid_epoch(loader, epoch, batch_idx, metrics)
            if self._preempt_requested:
                self._preempt(loader, epoch, batch_idx, metrics)
        self._drain_bad_steps()  # the epoch's tail shorter than log_every
        return acc.result()

    def _preempt(self, loader, epoch: int, batch_idx: int, metrics) -> None:
        """The in-flight step has finished: save `latest` with the cursor
        (one process only), drain the saver, unwind."""
        if self.checkpoint_dir and dist.process_count() == 1:
            self._save_mid_epoch(loader, epoch, batch_idx, metrics)
            self._saver.wait()
            logger.info("Preemption checkpoint complete (epoch %d, batch %d)",
                        epoch, batch_idx + 1)
        elif self.checkpoint_dir:
            # ranks see the signal at different steps: a save here would mix
            # their states; --save-every-steps saves are the resume point
            logger.warning(
                "SIGTERM on a multi-process job: skipping the uncoordinated "
                "preemption save; latest periodic checkpoint "
                "(--save-every-steps) is the resume point"
            )
        raise PreemptionInterrupt(self._preempt_rc)

    # -- bad-step budget (graft-armor) ------------------------------------

    def _measured(self, tag: str, batch=None):
        """The cost measurement of the run's first ``tag`` step (telemetry
        on, not yet measured); on the second train step, its memory again
        (the first whose optimizer state exists); else a no-op."""
        if self.scope is None:
            return contextlib.nullcontext()

        def resident() -> int:
            return self._resident_bytes(batch)

        if self.scope.costs.get(tag) is None:
            if tag == "train_step":
                self._memory_pending = True
            return self.scope.measure(tag, self._device(), resident)
        if tag == "train_step" and self._memory_pending:
            self._memory_pending = False
            return self.scope.measure_memory(tag, self._device(), resident)
        return contextlib.nullcontext()

    def _resident_bytes(self, batch) -> int:
        """Bytes on the device of the train state (parameters, buffers,
        the optimizer's parameters and state, the accumulated gradients,
        the gradients a step left) and of ``batch``: the resident part of
        ``hbm_peak_bytes``."""
        opt = self.state.optimizer
        params = list(self.model.parameters()) + opt.params
        tensors = params + [p.grad for p in params if p.grad is not None]
        tensors += list(self.model.buffers()) + list(opt._acc or [])
        for st in opt.optimizer.state.values():
            tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
        if isinstance(batch, dict):
            tensors += [v for v in batch.values()
                        if isinstance(v, torch.Tensor)]
        return resident_bytes(tensors, self._device())

    def _record_event(self, kind: str, **fields) -> None:
        """Recovery-event sink: counts the checkpoint fallbacks and
        forwards every event to graft-scope as a record of
        ``metrics.jsonl``; events before fit's scope exists buffer until
        it does."""
        if kind == "checkpoint_fallback":
            self.recovery["checkpoint_fallbacks"] += 1
        if self.scope is not None:
            self.scope.record_event(kind, **fields)
        elif len(self._pending_events) < 256:  # the scope may never come
            self._pending_events.append((kind, fields))

    def _drain_bad_steps(self) -> None:
        """Sum the bad-step flags since the last boundary (one host fetch)
        and enforce ``max_bad_steps`` (0 = unlimited) since the last
        recovery: exceeded -> one rollback, exceeded again -> fail."""
        if not self._pending_bad:
            return
        new = int(round(torch.stack(self._pending_bad).sum().item()))
        self._pending_bad = []
        if new == 0:
            return
        self.recovery["bad_steps"] += new
        self._bad_since_recovery += new
        logger.warning(
            "graft-armor: %d nonfinite step(s) skipped (%d since last "
            "recovery, budget %s)", new, self._bad_since_recovery,
            self.max_bad_steps or "unlimited",
        )
        self._record_event(
            "bad_step_skip", step=self._global_step, new_skips=new,
            since_recovery=self._bad_since_recovery,
            budget=self.max_bad_steps,
        )
        if self.max_bad_steps and self._bad_since_recovery > self.max_bad_steps:
            self._rollback_or_fail()

    def _rollback_or_fail(self) -> None:
        """One rollback to `latest`, then a hard failure on the next
        exhaustion (or at once when there is no checkpoint). The skipped
        updates never touched the state, so the rollback discards only the
        good updates since the checkpoint."""
        latest = (os.path.join(self.checkpoint_dir, ckpt_lib.LATEST_NAME)
                  if self.checkpoint_dir else None)
        if latest and not self._rolled_back:
            # every rank decides on the same files: a sharded save's
            # pointer appears on rank 0's saver thread at its own moment
            self._saver.wait()
            dist.barrier()
        if self._rolled_back or not latest or not os.path.exists(latest):
            raise BadStepBudgetExceeded(
                f"{self.recovery['bad_steps']} nonfinite step(s) skipped; "
                f"budget max_bad_steps={self.max_bad_steps} exhausted "
                + ("again after a rollback" if self._rolled_back
                   else "with no checkpoint to roll back to")
                + " — persistent fault (diverged optimization, bad data, "
                "or a real numerics bug)"
            )
        epoch, _ = self.load(latest)  # an in-flight save lands first
        self._rolled_back = True
        self._bad_since_recovery = 0
        self.recovery["rollbacks"] += 1
        logger.warning(
            "graft-armor: bad-step budget exceeded — rolled back to %s "
            "(epoch %d); the next budget exhaustion hard-fails",
            latest, epoch,
        )
        self._record_event("rollback", step=self._global_step,
                           checkpoint=latest, epoch=epoch)

    def validate(self, loader) -> Dict[str, float]:
        acc = MetricAccumulator()
        # under FSDP the parameters are gathered once for the pass
        with self._step.gathered(self.state):
            for batch_idx, batch in enumerate(loader):
                with self._measured("eval_step"), _span(self.scope, "eval"):
                    acc.append(self.eval_step(self.state, batch, batch_idx))
        return acc.result()

    # -- full fit ---------------------------------------------------------

    def fit(self, train_loader, val_loader=None, epochs: int = 10,
            resume: Optional[str] = None) -> List[Dict[str, float]]:
        self._pending_events = []
        self.init()
        if self.checkpoint_dir and dist.is_coordinator():
            os.makedirs(self.checkpoint_dir, exist_ok=True)
        self._profiler = (
            StepProfiler(self._profile_dir, self._profile_window,
                         dist.process_index(), device=self._device())
            if self._profile_dir else None)
        self._saver.wait()  # a prior fit's pending write must land first
        resuming = bool(resume and os.path.exists(resume))
        writer = MetricsWriter(self._metrics_file,
                               enabled=dist.is_coordinator(),
                               append=resuming)
        self._open_scope(writer, train_loader, val_loader)
        start_epoch = start_batch = 0
        best_accuracy = 0.0
        self.recovery = {"bad_steps": 0, "rollbacks": 0,
                         "checkpoint_fallbacks": 0}
        self._pending_bad = []
        self._bad_since_recovery = 0
        self._rolled_back = False
        try:
            if resuming:
                # fallback-enabled: a torn or corrupt `latest` walks back to
                # the newest intact ancestor, counted in `recovery`
                start_epoch, extra = self.load(resume)
                gap = elastic.resume_gap_steps(resume, start_epoch, extra)
                if gap and dist.is_coordinator():
                    logger.warning(
                        "Resumed %d step(s) behind the newest save attempt "
                        "(a torn or corrupt newer checkpoint was skipped)",
                        gap)
                best_accuracy = float(extra.get("best_accuracy", 0.0))
                man = extra.get(intake.LOADER_MANIFEST_KEY)
                if isinstance(man, dict):
                    start_batch = intake.restore_loader_state(train_loader,
                                                              man)
                else:
                    start_batch = int(extra.get("batch_in_epoch", 0))
                if start_batch >= len(train_loader):
                    start_epoch, start_batch = start_epoch + 1, 0
            dist.barrier()
        except BaseException:
            self._close_scope(train_loader, val_loader)
            writer.close()
            raise
        # telemetry records carry the true step across a resume; the
        # profile window is run-relative, re-anchored at the resumed step
        self._global_step = self.state.step
        if self._profiler is not None:
            self._profiler.rebase(self._global_step)
        history = self._fit_epochs(train_loader, val_loader, start_epoch,
                                   epochs, best_accuracy, writer, start_batch)
        return history

    def _open_scope(self, writer, train_loader, val_loader) -> None:
        """The run's graft-scope (telemetry on): its trace beside
        ``metrics.jsonl``, the loaders' h2d spans, the events buffered
        before it existed, and the bucket plan's issue schedule."""
        if self._telemetry_cfg is None:
            return
        cfg = self._telemetry_cfg
        if cfg.trace_file is None and self._metrics_file:
            cfg = dataclasses.replace(cfg, trace_file=os.path.join(
                os.path.dirname(self._metrics_file) or ".",
                "trace_events.json"))
        self.scope = Telemetry(cfg, writer=writer, profiler=self._profiler,
                               process_index=dist.process_index(),
                               fallback_every=self.log_every)
        for loader in (train_loader, val_loader):
            if loader is not None and hasattr(loader, "telemetry"):
                loader.telemetry = self.scope
        for kind, fields in self._pending_events:
            self.scope.record_event(kind, **fields)
        self._pending_events = []
        if self._bucket_plan is not None and self.scope.trace is not None:
            scheduled_overlap(self._bucket_plan,
                              grad_accum_steps=self.grad_accum_steps,
                              trace=self.scope.trace)

    def _close_scope(self, train_loader, val_loader) -> None:
        """Close the scope into ``telemetry_summary`` (with the wire
        report and the scheduled overlap) and the profiler."""
        if self.scope is not None:
            self.telemetry_summary = self.scope.close()
            if self.wire_report is not None:
                self.telemetry_summary["wire"] = dict(self.wire_report)
            if self.overlap_report is not None:
                self.telemetry_summary["overlap_scheduled"] = dict(
                    self.overlap_report)
            for loader in (train_loader, val_loader):
                if loader is not None and hasattr(loader, "telemetry"):
                    loader.telemetry = None
            self.scope = None
        if self._profiler is not None:
            self._profiler.close()

    def _fit_epochs(self, train_loader, val_loader, start_epoch, epochs,
                    best_accuracy, writer, start_batch):
        """The epochs under the preemption handlers; drains the saver and
        closes the writer however they end."""
        start_time = time.time()
        self._preempt_requested = False
        self._preempt_rc = 143
        prev_term = prev_int = None
        if threading.current_thread() is threading.main_thread():
            def on_signal(signum, frame):
                self._preempt_requested = True
                self._preempt_rc = 130 if signum == signal.SIGINT else 143
                if signum == signal.SIGINT:
                    # a second Ctrl-C must still kill a wedged run
                    signal.signal(signal.SIGINT, prev_int)
                logger.info(
                    "%s received: checkpointing after the in-flight step, "
                    "then exiting %d", signal.Signals(signum).name,
                    self._preempt_rc,
                )

            prev_term = signal.signal(signal.SIGTERM, on_signal)
            prev_int = signal.signal(signal.SIGINT, on_signal)
        try:
            history, best_accuracy = self._epoch_loop(
                train_loader, val_loader, start_epoch, epochs,
                best_accuracy, writer, start_batch,
            )
        finally:
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
            if prev_int is not None:
                signal.signal(signal.SIGINT, prev_int)
            # an exception mid-window must not leave an open trace, an
            # unflushed metrics file or a half-queued save
            self._close_scope(train_loader, val_loader)
            writer.close()
            if sys.exc_info()[1] is not None:
                # already unwinding: a save failure must not replace the
                # training error as the one reported
                try:
                    self._saver.wait()
                except Exception:
                    logger.exception(
                        "async checkpoint save failed while handling a "
                        "training exception (training error follows)")
            else:
                self._saver.wait()
                # rank 0 flips a sharded pointer only after every rank's
                # file has landed: no rank leaves fit before that
                dist.barrier()
        total_time = time.time() - start_time
        if dist.is_coordinator():
            logger.info("Training completed in %.2fs", total_time)
            if val_loader is not None:
                # best_accuracy carries across resume (checkpoint extra)
                logger.info("Best validation accuracy: %.2f%%", best_accuracy)
        return history

    def _epoch_loop(self, train_loader, val_loader, start_epoch, epochs,
                    best_accuracy, writer, start_batch=0):
        """Runs the epochs; returns (history, best accuracy including the
        resumed run's). ``self._best_accuracy`` is the live copy that
        mid-epoch saves read."""
        history: List[Dict[str, float]] = []
        self._best_accuracy = best_accuracy
        for epoch in range(start_epoch, epochs):
            first = start_batch if epoch == start_epoch else 0
            epoch_start = time.time()
            train_metrics = self.train_epoch(train_loader, epoch,
                                             start_batch=first)
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
            record.update({f"train_{k}": v for k, v in train_metrics.items()
                           if k not in ("loss", "accuracy")})
            global_batch = getattr(train_loader, "global_batch_size", None)
            if global_batch:
                # training throughput only: validation time excluded; a
                # mid-epoch-resumed first epoch ran fewer batches
                record["samples_per_sec"] = (
                    (len(train_loader) - first) * global_batch / train_time
                )
            history.append(record)
            writer.write(record)
            if dist.is_coordinator():
                logger.info("Epoch %d completed in %.2fs", epoch, epoch_time)
                if "samples_per_sec" in record:
                    logger.info("  Throughput: %.1f samples/sec",
                                record["samples_per_sec"])
                logger.info("  Train Loss: %.4f", record["train_loss"])
                if val_loader is not None:
                    logger.info("  Val Loss: %.4f, Val Accuracy: %.2f%%",
                                record["val_loss"], record["val_accuracy"])
            is_best = (val_loader is not None
                       and record["val_accuracy"] > self._best_accuracy)
            if is_best:
                self._best_accuracy = record["val_accuracy"]
            if self.checkpoint_dir:
                extra = {"best_accuracy": self._best_accuracy}
                # the cursor at the next epoch's start
                man = intake.loader_manifest(train_loader, epoch + 1, 0)
                if man is not None:
                    extra[intake.LOADER_MANIFEST_KEY] = man
                # epoch + 1: resume continues after the finished epoch
                with _span(self.scope, "checkpoint"):
                    if is_best:
                        self._save(ckpt_lib.BEST_NAME, epoch + 1,
                                   record["train_loss"], extra)
                    self._save(ckpt_lib.LATEST_NAME, epoch + 1,
                               record["train_loss"], extra)
            dist.barrier()
        return history, self._best_accuracy
