"""Telemetry: Chrome trace-event spans."""

from distributed_pytorch_example_tpu_torch.telemetry.trace import (
    PrefixedTrace,
    TraceWriter,
)

__all__ = ["PrefixedTrace", "TraceWriter"]
