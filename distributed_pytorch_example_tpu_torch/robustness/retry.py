"""Bounded retry with deterministic exponential backoff.

Backoff is deterministic (no jitter), so a seeded fault plan that heals
after N failures always sees the same retry schedule. The serving engine
runs its device fetches, and the checkpoint ``AsyncSaver`` its writes,
under :func:`with_retries`.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type

from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)


def backoff_schedule(
    attempts: int, base_delay: float, max_delay: float
) -> list:
    """Delays slept between attempts: base * 2^k, capped at max_delay."""
    return [
        min(base_delay * (2.0 ** k), max_delay)
        for k in range(max(attempts - 1, 0))
    ]


def with_retries(
    fn: Callable,
    *,
    attempts: int = 4,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    describe: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Call ``fn()``; on a ``retry_on`` failure, back off and try again.

    At most ``attempts`` total calls. The final failure propagates
    unchanged (callers keep their native exception type); every retried
    failure is logged with the delay. ``on_retry(attempt_index, error)``
    fires before each re-attempt (counters).
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delays = backoff_schedule(attempts, base_delay, max_delay)
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as err:
            if attempt >= len(delays):
                logger.error(
                    "%s failed after %d attempt(s): %s",
                    describe, attempts, err,
                )
                raise
            delay = delays[attempt]
            logger.warning(
                "%s failed (attempt %d/%d): %s — retrying in %.2fs",
                describe, attempt + 1, attempts, err, delay,
            )
            if on_retry is not None:
                on_retry(attempt, err)
            sleep(delay)
