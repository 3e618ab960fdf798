"""Data parallelism with ZeRO-1 and FSDP (``api.py``), the plan they
lower from (``plan.py``) and the wire layer of the gradient collectives
(``wire.py``)."""

from distributed_pytorch_example_tpu_torch.parallel.api import (
    DEFAULT_OPT_SHARD_MIN_SIZE,
    PartitionSpec,
    Partitioner,
    data_parallel,
    fsdp,
    shard_largest_axis,
)
from distributed_pytorch_example_tpu_torch.parallel.plan import PlanSpec
from distributed_pytorch_example_tpu_torch.parallel.wire import WireConfig

__all__ = [
    "DEFAULT_OPT_SHARD_MIN_SIZE",
    "PartitionSpec",
    "Partitioner",
    "PlanSpec",
    "WireConfig",
    "data_parallel",
    "fsdp",
    "shard_largest_axis",
]
