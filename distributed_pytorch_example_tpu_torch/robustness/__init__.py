"""Robustness: bounded retries and the serving fault-injection hooks."""

from distributed_pytorch_example_tpu_torch.robustness import chaos
from distributed_pytorch_example_tpu_torch.robustness.retry import (
    backoff_schedule,
    with_retries,
)

__all__ = ["backoff_schedule", "chaos", "with_retries"]
