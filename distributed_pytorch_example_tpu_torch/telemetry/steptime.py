"""Rate-limited step timing and cross-process straggler detection (the
JAX package's telemetry/steptime.py).

Fencing the device every step to time it costs exactly the per-step sync
the asynchronous metrics avoid. :class:`StepClock` instead fences every
``sample_every`` steps (the caller's fence reads a live value on the
host, ``float(metrics["loss"])``) and spreads the measured wall time over
the window; the steps in between stay asynchronous.

:func:`exchange_step_times` gathers each process's sample at a log
boundary (one float32 per process, a ``torch.distributed`` all-gather)
and derives the max / median skew and the slow processes. With one
process it returns ``{}``: no skew fields, by contract.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from distributed_pytorch_example_tpu_torch.runtime import distributed


class StepClock:
    """Windowed step timer: a real fence every ``sample_every`` steps.

    ``tick(step, fence)`` once per step, after the step is dispatched. The
    first tick only anchors the window (so warm-up never pollutes the
    first sample); each later window of ``sample_every`` steps fences once
    and records the mean per-step wall time.
    """

    def __init__(self, sample_every: int = 8):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.sample_every = sample_every
        self.step_time_ms: Optional[float] = None  # latest real sample
        self._anchor_t: Optional[float] = None
        self._anchor_step: Optional[int] = None

    def tick(self, step: int, fence: Callable[[], object]) -> None:
        if self._anchor_step is None:
            fence()
            self._anchor_t = time.perf_counter()
            self._anchor_step = step
            return
        if step - self._anchor_step < self.sample_every:
            return
        fence()
        now = time.perf_counter()
        self.step_time_ms = (
            (now - self._anchor_t) / (step - self._anchor_step) * 1000.0
        )
        self._anchor_t = now
        self._anchor_step = step


def exchange_step_times(
    step_time_ms: Optional[float], skew_threshold: float = 1.5
) -> Dict[str, object]:
    """Per-process step times and skew at a log boundary; ``{}`` for one
    process.

    A collective: every process calls it at the same boundary (the
    Trainer's boundary cadence is a pure function of the step index).
    ``step_time_ms`` of None (no sample yet) skips the exchange, on every
    process for the same reason.
    """
    if distributed.process_count() == 1 or step_time_ms is None:
        return {}
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mine = torch.tensor([step_time_ms], dtype=torch.float32, device=device)
    parts = [torch.empty_like(mine)
             for _ in range(distributed.process_count())]
    dist.all_gather(parts, mine)
    times = torch.cat(parts).cpu().double().numpy()
    median = float(np.median(times))
    worst = float(np.max(times))
    out: Dict[str, object] = {
        "step_time_ms_per_host": [round(float(t), 3) for t in times],
        "step_time_ms_median_host": round(median, 3),
        "step_time_ms_max_host": round(worst, 3),
    }
    if median > 0:
        skew = worst / median
        out["step_time_skew"] = round(skew, 4)
        out["slow_hosts"] = [
            i for i, t in enumerate(times) if t > skew_threshold * median
        ]
    return out
