"""Data parallelism with ZeRO-1 (``api.py``) and the wire layer of the
gradient collectives (``wire.py``)."""

from distributed_pytorch_example_tpu_torch.parallel.api import (
    DEFAULT_OPT_SHARD_MIN_SIZE,
    Partitioner,
    data_parallel,
)
from distributed_pytorch_example_tpu_torch.parallel.wire import WireConfig

__all__ = [
    "DEFAULT_OPT_SHARD_MIN_SIZE",
    "Partitioner",
    "WireConfig",
    "data_parallel",
]
