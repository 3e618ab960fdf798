"""graft-scope: always-on, low-overhead training telemetry (the JAX
package's telemetry/).

- a step cost registry (:mod:`~.cost`): the first train and eval step of a
  run are measured (FLOPs, peak device memory, the collective mix), so
  ``mfu_analytic`` and memory headroom are per-run telemetry;
- device-side health sentinels (:mod:`~.sentinels`): the global gradient
  norm, the parameter norm and the non-finite gradient count, computed in
  the train step and fetched once per log boundary, with no host sync of
  their own;
- step time and stragglers (:mod:`~.steptime`): a rate-limited host clock
  (a real fence every K steps) and per-process step times exchanged at
  log boundaries, with max / median skew and the slow processes (absent
  with one process);
- spans (:mod:`~.trace`): ``telemetry.span("data_load")`` and the like,
  streamed as Chrome trace-event JSON next to ``metrics.jsonl``;
- overlap accounting (:mod:`~.overlap`): a short ``torch.profiler``
  trace split into collective and compute device time, and the bucket
  plan's scheduled estimate.

:class:`~.scope.Telemetry` is the facade the Trainer drives; everything
here is a no-op when unconfigured. The serving half of the JAX package's
telemetry (``LatencyBook``, ``RollingStats``, ``ServeSentinels``) waits
for the fleet (ROADMAP.md, D).
"""

from distributed_pytorch_example_tpu_torch.telemetry.cost import (
    CostRegistry,
    peak_bf16_flops,
)
from distributed_pytorch_example_tpu_torch.telemetry.overlap import (
    measure_overlap,
    overlap_frac_from_times,
    scheduled_overlap,
    split_trace_times,
)
from distributed_pytorch_example_tpu_torch.telemetry.scope import (
    Telemetry,
    TelemetryConfig,
)
from distributed_pytorch_example_tpu_torch.telemetry.sentinels import (
    SENTINEL_KEYS,
    sentinel_metrics,
)
from distributed_pytorch_example_tpu_torch.telemetry.steptime import (
    StepClock,
    exchange_step_times,
)
from distributed_pytorch_example_tpu_torch.telemetry.trace import (
    PrefixedTrace,
    TraceWriter,
)

__all__ = [
    "SENTINEL_KEYS",
    "CostRegistry",
    "PrefixedTrace",
    "StepClock",
    "Telemetry",
    "TelemetryConfig",
    "TraceWriter",
    "exchange_step_times",
    "measure_overlap",
    "overlap_frac_from_times",
    "peak_bf16_flops",
    "scheduled_overlap",
    "sentinel_metrics",
    "split_trace_times",
]
