"""Measured comm/compute overlap accounting (the JAX package's
telemetry/overlap.py).

Host-side timing around the collectives' call sites cannot see how much
of their device time ran behind compute. The profiler can: capture a
``torch.profiler`` trace (CUDA activity) over a few steps, split the
device kernels' time into collective and compute, and compare with the
host-measured wall time of the same window:

    overlap_frac = clamp((compute + collective - wall) / collective, 0, 1)

If nothing overlapped, wall ~= compute + collective and the fraction is
0; if every collective ran behind compute, wall ~= compute and it is 1.

A device kernel is a collective when its name is NCCL's or a ring
kernel's (K3a ``all_gather_kernel``, K3b ``reduce_scatter_kernel``), or
when it was launched inside a wire scope (the ``record_function`` ranges
of ``parallel/wire.py`` and ``ops/collectives.py``, named as JAX names its
``named_scope``s). The launch is found through the trace's correlation id
of the kernel's runtime call, and the scopes around that call give the
per-scope roll-up ``by_scope``, inclusive as a profiler's ranges are: a
kernel counts under every wire scope around its launch (K3b under its
``wire_bucket<k>`` and under ``ring_reduce_scatter``), so the keys may sum
to more than the collective total. A trace with no device kernel (the
CPU) gives None, as JAX's does without a device plane.

:func:`scheduled_overlap` is the static, backend-free estimate from the
wire bucket plan (``parallel/wire.py`` ``plan_buckets``).
"""

from __future__ import annotations

import bisect
import json
import os
import re
import time
from typing import Callable, Dict, List, Optional

import torch

# device kernels that are communication by name (NCCL's; the ring
# kernels of csrc/ring_collectives.cu)
COLLECTIVE_KERNEL_RE = re.compile(
    r"nccl|all_gather_kernel|reduce_scatter_kernel", re.IGNORECASE)

# the wire / ring dispatch-boundary scopes: per-boundary attribution keys.
# "wire_bucket" matches the per-bucket scopes of the bucketed sync
# (wire_bucket0, wire_bucket1, ...), rolled up per bucket index
WIRE_SCOPES = (
    "wire_psum_scatter", "wire_all_gather", "wire_psum",
    "wire_replicate_params", "ring_all_gather", "ring_reduce_scatter",
    "wire_bucket",
)

_BUCKET_SCOPE_RE = re.compile(r"wire_bucket\d+")

# trace-event categories of device work, and of the host calls that
# launch it
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def is_collective(kernel: str, scope: str = "") -> bool:
    """Whether a device kernel is communication: by its name first, the
    wire scopes it was launched in (``scope``, a "/"-joined path) as a
    fallback."""
    if kernel and COLLECTIVE_KERNEL_RE.search(kernel):
        return True
    return any(name in scope for name in WIRE_SCOPES)


def overlap_frac_from_times(
    wall_us: float, collective_us: float, compute_us: float
) -> Optional[float]:
    """The fraction of collective time hidden behind compute; None when
    there was no collective time to hide."""
    if collective_us <= 0:
        return None
    hidden = compute_us + collective_us - wall_us
    return max(0.0, min(1.0, hidden / collective_us))


class _Scopes:
    """The wire-scope ranges of one host thread, for point lookups."""

    def __init__(self, ranges: List[dict]):
        self.ranges = sorted(ranges, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.ranges]

    def around(self, ts: float) -> str:
        """The "/"-joined names of the ranges open at ``ts``, outermost
        first."""
        hi = bisect.bisect_right(self.starts, ts)
        return "/".join(e["name"] for e in self.ranges[:hi]
                        if ts <= e["ts"] + e.get("dur", 0))


def _scope_keys(path: str) -> List[str]:
    """The by_scope keys of a launch path: every wire scope on it, a bucket
    by its own ``wire_bucket<k>`` name."""
    keys = []
    for name in path.split("/") if path else ():
        if (_BUCKET_SCOPE_RE.fullmatch(name) or name in WIRE_SCOPES) \
                and name not in keys:
            keys.append(name)
    return keys


def split_trace_times(trace_path: str) -> Optional[Dict[str, object]]:
    """Aggregate an exported Chrome trace into collective vs compute
    device time (us, totals over the whole window) plus per-wire-scope
    attribution; None when the trace holds no device kernel."""
    with open(trace_path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    device, launches, scopes = [], {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            device.append(e)
        elif cat in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat == "user_annotation" and any(
                name in e.get("name", "") for name in WIRE_SCOPES):
            scopes.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    if not device:
        return None
    scopes = {key: _Scopes(ranges) for key, ranges in scopes.items()}
    collective_us = compute_us = 0.0
    by_scope: Dict[str, float] = {}
    for k in device:
        dur = float(k.get("dur", 0.0))
        launch = launches.get((k.get("args") or {}).get("correlation"))
        path = ""
        if launch is not None:
            lane = scopes.get((launch.get("pid"), launch.get("tid")))
            if lane is not None:
                path = lane.around(launch["ts"])
        if not is_collective(k.get("name", ""), path):
            compute_us += dur
            continue
        collective_us += dur
        for key in _scope_keys(path):
            by_scope[key] = by_scope.get(key, 0.0) + dur
    return {
        "collective_us": collective_us,
        "compute_us": compute_us,
        "by_scope": by_scope,
    }


def measure_overlap(
    run_steps: Callable[[int], None],
    trace_dir: str,
    steps: int = 2,
    clock: Callable[[], float] = time.perf_counter,
    device=None,
) -> Optional[dict]:
    """Capture a ``torch.profiler`` trace (CUDA activity when ``device``
    is a card) around ``run_steps(steps)`` and compute the measured
    per-step overlap accounting.

    ``run_steps`` executes ``steps`` warmed-up steps. Returns
    ``{overlap_frac, wall_us_per_step, collective_us_per_step,
    compute_us_per_step, by_scope, steps}``, or None when the trace holds
    no device kernel (the CPU). The trace stays in ``trace_dir`` as
    ``overlap_trace.json``.
    """
    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = clock()
        run_steps(steps)
        if cuda:
            torch.cuda.synchronize(device)
        wall_s = clock() - t0
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "overlap_trace.json")
    prof.export_chrome_trace(path)
    split = split_trace_times(path)
    if split is None:
        return None
    per = max(steps, 1)
    wall_us = wall_s * 1e6
    return {
        "overlap_frac": overlap_frac_from_times(
            wall_us, split["collective_us"], split["compute_us"]),
        "steps": int(steps),
        "wall_us_per_step": wall_us / per,
        "collective_us_per_step": split["collective_us"] / per,
        "compute_us_per_step": split["compute_us"] / per,
        "by_scope": {k: v / per for k, v in split["by_scope"].items()},
    }


# -- scheduler-level overlap (static, backend-free) -------------------------


def scheduled_overlap(plan, grad_accum_steps: int = 1,
                      trace=None) -> Optional[dict]:
    """Scheduler-level overlap estimate from a static wire BucketPlan.

    The bucketed sync (``parallel/wire.py`` ``sync_grads``) issues bucket
    k's collective once the backward segment feeding it is done, so every
    bucket except the last has backward compute left to hide behind; the
    last one's wire time is the exposed tail:

        overlap_frac_scheduled = 1 - wire_bytes(last bucket) / total

    Byte-weighted, because wire time is bandwidth-bound at bucket sizes.
    ``grad_accum_steps`` does not change the ratio (the sync runs once per
    optimizer step, after the last microbatch's backward).

    ``trace`` (a ``telemetry.trace.TraceWriter``, optional) gets one
    complete event per bucket in the modelled issue order, with the
    bucket's kind, bytes and hideability in its args. ``plan`` None or
    empty is one inline sync chain: estimate 0.0.
    """
    if plan is None or not getattr(plan, "buckets", ()):
        return {
            "overlap_frac_scheduled": 0.0,
            "num_buckets": 0,
            "hideable_wire_bytes": 0,
            "total_wire_bytes": 0,
            "grad_accum_steps": int(grad_accum_steps),
            "per_bucket": [],
        }
    buckets = list(plan.buckets)
    total = float(sum(b.wire_bytes for b in buckets))
    exposed = float(buckets[-1].wire_bytes)
    frac = 0.0 if total <= 0 else max(0.0, 1.0 - exposed / total)
    per_bucket = []
    t_us = 0.0
    for k, b in enumerate(buckets):
        hideable = k < len(buckets) - 1
        # modelled issue timeline: a byte-proportional span per bucket, a
        # schedule picture, not a latency prediction
        dur_us = max(1.0, b.wire_bytes / 1e3)
        per_bucket.append({
            "scope": f"wire_bucket{b.index}",
            "kind": b.kind,
            "wire_bytes": int(b.wire_bytes),
            "elements": int(b.elements),
            "num_leaves": len(b.leaves),
            "hideable": hideable,
        })
        if trace is not None:
            trace.add_complete(
                f"wire_bucket{b.index}/issue", ts_us=t_us,
                dur_us=dur_us, pid=0,
                args={
                    "kind": b.kind,
                    "wire_bytes": int(b.wire_bytes),
                    "hideable": hideable,
                },
            )
        t_us += dur_us
    return {
        "overlap_frac_scheduled": round(frac, 4),
        "num_buckets": len(buckets),
        "hideable_wire_bytes": int(total - exposed),
        "total_wire_bytes": int(total),
        "grad_accum_steps": int(grad_accum_steps),
        "per_bucket": per_bucket,
    }
