"""Profiling hooks: a ``torch.profiler`` trace around a window of training
steps (the JAX package's runtime/profiler.py).

The reference has no profiler (only wall-clock epoch timing, reference
train.py:265,283). A :class:`StepProfiler` opens a ``torch.profiler``
capture when its step window opens (host activity, and the card's kernels
through CUPTI when the device is a card) and writes a Chrome trace
(``trace_steps_<start>_<stop>.json``) under ``logdir`` when it closes.
Process 0 profiles; the other processes do nothing (one trace per job).

Telemetry health triggers (non-finite gradients, cross-process step-time
skew) can :meth:`~StepProfiler.arm` a fresh window mid-run, so the trace
that explains an anomaly comes from the run that saw it. On resume the
Trainer calls :meth:`~StepProfiler.rebase`: a window of (10, 13) traces
the 10th-12th steps of this run, not of the job's history.

:func:`scope_marker` is the counterpart of ``jax.named_scope`` at the
wire and ring collectives' call sites: a ``record_function`` range per
call, which a trace shows around the kernels the call launched
(``telemetry/overlap.py`` attributes collective time by these names).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, List, Optional, Tuple

import torch

from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)


def scope_marker(name: str) -> Callable:
    """Decorate a function so each call runs in a profiler range ``name``
    (a fresh ``record_function`` per call: safe across threads)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


class StepProfiler:
    """Captures a trace for global steps [start, stop).

    Drive it from the training loop: ``profiler.step(global_step)`` once
    per step; the capture starts when the window opens and stops when it
    closes (or at :meth:`close` if the run ends first). ``device`` decides
    whether the card's activity is traced.
    """

    def __init__(
        self,
        logdir: Optional[str],
        window: Tuple[int, int] = (10, 13),
        process_index: int = 0,
        device: Optional[torch.device] = None,
    ):
        self.logdir = logdir if process_index == 0 else None
        self.start_step, self.stop_step = window
        self.device = torch.device(device) if device is not None else None
        self.trace_files: List[str] = []
        self._profile = None
        self._last_step = -1
        self._arm_reason = ""

    @property
    def _active(self) -> bool:
        return self._profile is not None

    def rebase(self, first_step: int) -> None:
        """Re-anchor the configured window at ``first_step`` (resume).

        The window is run-relative: resuming at step 500 with window
        (10, 13) traces steps [510, 513). No-op for fresh runs
        (``first_step == 0``) and once stepping has begun.
        """
        if self.logdir is None or self._active or self._last_step >= 0:
            return
        if first_step:
            self.start_step += first_step
            self.stop_step += first_step
            logger.info(
                "Profiler window rebased to [%d, %d) from resumed step %d",
                self.start_step, self.stop_step, first_step,
            )

    def arm(self, start_step: int, stop_step: int, reason: str = "") -> bool:
        """Arm a fresh trace window (the telemetry trigger path).

        Refused while a trace is active or a not-yet-passed window is still
        pending: one window at a time, first trigger wins.
        """
        if self.logdir is None or self._active:
            return False
        if self._last_step < self.stop_step:
            return False  # the configured window is still ahead or open
        if stop_step <= start_step or start_step <= self._last_step:
            return False
        self.start_step, self.stop_step = start_step, stop_step
        self._arm_reason = reason
        logger.info(
            "Profiler armed for steps [%d, %d)%s",
            start_step, stop_step, f": {reason}" if reason else "",
        )
        return True

    def _activities(self) -> list:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def step(self, global_step: int) -> None:
        self._last_step = global_step
        if self.logdir is None:
            return
        if not self._active and self.start_step <= global_step < self.stop_step:
            os.makedirs(self.logdir, exist_ok=True)
            self._profile = torch.profiler.profile(
                activities=self._activities())
            self._profile.start()
            logger.info("Profiler trace started at step %d -> %s",
                        global_step, self.logdir)
        elif self._active and global_step >= self.stop_step:
            self._stop()

    def _stop(self) -> None:
        profile, self._profile = self._profile, None
        path = os.path.join(
            self.logdir,
            f"trace_steps_{self.start_step}_{self.stop_step}.json")
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the window's kernels land
        try:
            profile.stop()
            profile.export_chrome_trace(path)
        except Exception:
            # a capture that failed must not take the run down at
            # teardown; the window state is reset either way
            logger.warning("Profiler stop failed", exc_info=True)
            return
        self.trace_files.append(path)
        logger.info("Profiler trace written to %s", self.logdir)

    def close(self) -> None:
        """Stop an open capture; report a window that never opened.

        Safe to call repeatedly, and clean for an armed-but-unopened window
        (run ended before ``start_step``): nothing to flush, but the miss is
        logged so a silent "no trace produced" has a visible cause.
        """
        if self._active:
            self._stop()
        elif (
            self.logdir is not None
            and self._last_step >= 0
            and self._last_step < self.start_step
        ):
            logger.info(
                "Profiler window [%d, %d) never opened (run ended at step "
                "%d)%s",
                self.start_step, self.stop_step, self._last_step,
                f"; armed: {self._arm_reason}" if self._arm_reason else "",
            )
