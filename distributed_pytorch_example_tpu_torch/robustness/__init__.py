"""Robustness: bounded retries, deterministic fault injection, the
checkpoint integrity envelope and mesh stamp, and the training loop's
bad-step budget error."""

from distributed_pytorch_example_tpu_torch.robustness import chaos
from distributed_pytorch_example_tpu_torch.robustness.integrity import (
    CheckpointCorruptError,
)
from distributed_pytorch_example_tpu_torch.robustness.retry import (
    backoff_schedule,
    with_retries,
)


class BadStepBudgetExceeded(RuntimeError):
    """Nonfinite-step skips exhausted ``max_bad_steps``.

    Raised by the Trainer when the step has skipped more nonfinite updates
    than the budget allows a second time after its one rollback to
    ``latest``, or with no checkpoint to roll back to: the fault is
    persistent — diverged optimization, bad data, a real numerics bug —
    and retrying further would only burn card time.
    """


__all__ = ["BadStepBudgetExceeded", "CheckpointCorruptError",
           "backoff_schedule", "chaos", "with_retries"]
