"""The graft-scope facade the Trainer drives (the JAX package's
telemetry/scope.py).

One :class:`Telemetry` per ``fit()``: it owns the cost registry, the
rate-limited step clock, the trace-event writer and the boundary logic:
fetch the loss and the sentinel scalars in one host read, exchange the
per-process step times, write an optional per-N-step record to
``metrics.jsonl``, and arm the profiler (``runtime/profiler.py``) when a
health trigger fires (non-finite gradients, or cross-process skew above
the threshold). Everything is a no-op when unconfigured; per step, the
hot path is a counter compare plus, every ``sample_every`` steps, one
fenced clock sample.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Optional

from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger
from distributed_pytorch_example_tpu_torch.telemetry.cost import CostRegistry
from distributed_pytorch_example_tpu_torch.telemetry.steptime import (
    StepClock,
    exchange_step_times,
)
from distributed_pytorch_example_tpu_torch.telemetry.trace import TraceWriter

logger = get_logger(__name__)

_NULL_CTX = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """graft-scope knobs (Trainer kwarg ``telemetry=TelemetryConfig(...)``).

    ``every``: write a metrics.jsonl record every N steps (0 = epoch
    records only, the default). Health checks and the straggler exchange
    still run at the fallback (log) boundary when 0.
    ``sample_every``: the step clock's fence cadence.
    ``trace_file``: Chrome trace-event JSON path (default: next to
    ``metrics.jsonl``; None disables span tracing).
    ``skew_threshold``: max / median per-process step-time ratio that
    flags slow processes and (with ``auto_arm_profiler``) arms a trace
    window.
    """

    every: int = 0
    sample_every: int = 8
    trace_file: Optional[str] = None
    skew_threshold: float = 1.5
    auto_arm_profiler: bool = True
    profile_arm_offset: int = 2
    profile_arm_span: int = 2


class Telemetry:
    """Per-run telemetry scope; created by ``Trainer.fit``."""

    def __init__(
        self,
        config: TelemetryConfig,
        writer=None,
        profiler=None,
        process_index: int = 0,
        fallback_every: int = 10,
    ):
        self.config = config
        self.writer = writer
        self.profiler = profiler
        self.costs = CostRegistry()
        self.clock = StepClock(config.sample_every)
        self.trace = (
            TraceWriter(config.trace_file, process_index)
            if config.trace_file and process_index == 0
            else None
        )
        # health checks and the straggler exchange: the per-N-step record
        # cadence when on, the Trainer's log boundary otherwise (a pure
        # function of the step index: it paces a collective on every
        # process alike)
        self.boundary_every = config.every if config.every > 0 else max(
            int(fallback_every), 1
        )
        self.last_record: Dict[str, object] = {}
        self.last_straggler: Dict[str, object] = {}
        self.overhead_s = 0.0
        self.events: list = []  # recovery / fault events
        # consumer-side waits on the input plane's prefetch queue since the
        # last boundary (reset per record)
        self._data_wait_ms = 0.0
        self._data_waits = 0
        self._data_stalls = 0
        self._closed = False

    # -- spans ------------------------------------------------------------

    def span(self, name: str):
        """Context manager recording one trace-event span (no-op without a
        trace file)."""
        if self.trace is None:
            return _NULL_CTX
        return self.trace.span(name)

    # -- step costs -------------------------------------------------------

    @contextlib.contextmanager
    def measure(self, tag: str, device, resident=None):
        """Measure the step run inside the block and register its cost
        record (:meth:`record_cost`): the port's counterpart of JAX's
        ahead-of-time compile of each step program. ``resident``: see
        ``CostRegistry.measure``."""
        with self.costs.measure(tag, device, resident):
            yield
        self.record_cost(tag)

    @contextlib.contextmanager
    def measure_memory(self, tag: str, device, resident=None):
        """Take ``tag``'s ``hbm_peak_bytes`` anew on the step run inside
        the block (``CostRegistry.measure_memory``) and log it."""
        with self.costs.measure_memory(tag, device, resident):
            yield
        logger.info("graft-scope memory[%s]: hbm_peak=%s bytes", tag,
                    self.costs.get(tag).get("hbm_peak_bytes"))

    def record_cost(self, tag: str) -> Dict[str, object]:
        """Log (and with per-N-step records on, write) the cost record of
        ``tag``: JAX's ``record_compile`` line."""
        rec = self.costs.get(tag)
        flops = rec.get("flops_per_step_per_device")
        logger.info(
            "graft-scope compile[%s]: flops/device=%s, hbm_peak=%s bytes, "
            "collectives=%s",
            tag,
            f"{flops:.3e}" if flops else "n/a",
            rec.get("hbm_peak_bytes"),
            sorted((rec.get("collectives") or {}).keys()) or "none",
        )
        if self.writer is not None and self.config.every > 0:
            self.writer.write({
                "event": "compile",
                "tag": tag,
                "flops_per_step_per_device": flops,
                "hbm_peak_bytes": rec.get("hbm_peak_bytes"),
                "bytes_accessed": rec.get("bytes_accessed"),
                "collectives": rec.get("collectives"),
            })
        return rec

    # -- recovery events --------------------------------------------------

    def record_event(self, kind: str, **fields) -> Dict[str, object]:
        """A recovery record (bad-step skips, rollbacks, checkpoint
        fallbacks): written to the metrics JSONL whatever ``every`` is
        (they are rare and operationally load-bearing) and kept on
        ``self.events`` for the close() summary."""
        record: Dict[str, object] = {"event": kind, **fields}
        self.events.append(record)
        if self.writer is not None:
            self.writer.write(record)
        return record

    # -- input plane ------------------------------------------------------

    def record_data_wait(self, waited_ms: float, stalled: bool) -> None:
        """One consumer-side wait on the input plane's prefetch queue
        (called from the training thread). ``stalled``: the queue was
        empty when the consumer came, so this boundary waited on data."""
        self._data_waits += 1
        if stalled:
            self._data_wait_ms += waited_ms
            self._data_stalls += 1

    # -- per-step ---------------------------------------------------------

    def on_step(
        self,
        step: int,
        metrics: Dict[str, object],
        fence: Optional[Callable[[], object]] = None,
    ) -> None:
        """Once per train step, after dispatch. ``step`` is the 1-based
        global step; ``fence`` blocks until the step's result is on the
        host (the clock calls it only every ``sample_every`` steps)."""
        t0 = time.perf_counter()
        self.clock.tick(step, fence or (lambda: None))
        if step % self.boundary_every == 0:
            self._boundary(step, metrics)
        self.overhead_s += time.perf_counter() - t0

    def _boundary(self, step: int, metrics: Dict[str, object]) -> None:
        # ONE host fetch for every boundary scalar (loss + sentinels)
        from distributed_pytorch_example_tpu_torch.train.metrics import (
            fetch_scalars,
        )

        scalars = fetch_scalars(metrics, keys=(
            "loss", "grad_norm", "param_norm", "nonfinite_grads",
        ))
        straggler = exchange_step_times(
            self.clock.step_time_ms, self.config.skew_threshold
        )
        if straggler:
            self.last_straggler = straggler
        nonfinite = scalars.get("nonfinite_grads")
        if nonfinite:
            logger.warning(
                "graft-scope: %d nonfinite gradient elements at step %d "
                "(grad_norm=%s)",
                int(nonfinite), step, scalars.get("grad_norm"),
            )
        self._maybe_arm_profiler(step, nonfinite, straggler)

        cost = self.costs.get("train_step") or {}
        record: Dict[str, object] = {
            "step": step,
            "step_time_ms": (
                round(self.clock.step_time_ms, 3)
                if self.clock.step_time_ms is not None else None
            ),
            "mfu_analytic": self.costs.mfu_analytic(
                "train_step", self.clock.step_time_ms
            ),
            "flops_per_step_per_device": cost.get(
                "flops_per_step_per_device"
            ),
            "hbm_peak_bytes": cost.get("hbm_peak_bytes"),
            **scalars,
            **straggler,
        }
        if self._data_waits:
            # the window's input-plane health: ms the consumer sat on an
            # empty prefetch queue, and the share of fetches that stalled
            record["data_stall_ms"] = round(self._data_wait_ms, 3)
            record["input_stall_frac"] = round(
                self._data_stalls / self._data_waits, 4
            )
            self._data_wait_ms = 0.0
            self._data_waits = 0
            self._data_stalls = 0
        self.last_record = record
        if self.writer is not None and self.config.every > 0:
            self.writer.write(record)

    def _maybe_arm_profiler(self, step, nonfinite, straggler) -> None:
        if (
            self.profiler is None
            or not self.config.auto_arm_profiler
            or not hasattr(self.profiler, "arm")
        ):
            return
        skew = straggler.get("step_time_skew")
        reason = None
        if nonfinite:
            reason = f"nonfinite grads ({int(nonfinite)} elements)"
        elif skew is not None and skew > self.config.skew_threshold:
            reason = f"cross-host step-time skew {skew:.2f}x"
        if reason:
            self.profiler.arm(
                step + self.config.profile_arm_offset,
                step + self.config.profile_arm_offset
                + self.config.profile_arm_span,
                reason=reason,
            )

    # -- teardown ---------------------------------------------------------

    def close(self) -> Dict[str, object]:
        """Flush the trace and return the run's telemetry summary."""
        if self._closed:
            return {}
        self._closed = True
        if self.trace is not None:
            self.trace.close()
        return {
            "last_record": dict(self.last_record),
            "straggler": dict(self.last_straggler),
            "overhead_s": round(self.overhead_s, 6),
            "events": list(self.events),
            "compiles": {
                tag: {
                    "flops_per_step_per_device": rec.get(
                        "flops_per_step_per_device"
                    ),
                    "hbm_peak_bytes": rec.get("hbm_peak_bytes"),
                }
                for tag, rec in self.costs.records.items()
            },
        }
