"""Runtime: device resolution, rank-tagged logging and the process group."""

from distributed_pytorch_example_tpu_torch.runtime.device import resolve_device
from distributed_pytorch_example_tpu_torch.runtime.logging import (
    get_logger,
    setup_logging,
)

__all__ = ["get_logger", "resolve_device", "setup_logging"]
