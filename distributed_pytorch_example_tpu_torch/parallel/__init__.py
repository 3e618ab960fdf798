"""Data parallelism with ZeRO-1 and FSDP (``api.py``), Megatron tensor
parallelism (``partition.py``'s rules, ``tensor_parallel.py``'s
collectives), the plan they lower from (``plan.py``) and the wire layer
of the gradient collectives (``wire.py``)."""

from distributed_pytorch_example_tpu_torch.parallel.api import (
    DEFAULT_OPT_SHARD_MIN_SIZE,
    PartitionSpec,
    Partitioner,
    data_parallel,
    fsdp,
    shard_largest_axis,
)
from distributed_pytorch_example_tpu_torch.parallel.partition import (
    TRANSFORMER_TP_RULES,
    transformer_partitioner,
)
from distributed_pytorch_example_tpu_torch.parallel.plan import PlanSpec
from distributed_pytorch_example_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
)
from distributed_pytorch_example_tpu_torch.parallel.wire import WireConfig

__all__ = [
    "DEFAULT_OPT_SHARD_MIN_SIZE",
    "PartitionSpec",
    "Partitioner",
    "PlanSpec",
    "TRANSFORMER_TP_RULES",
    "TensorParallel",
    "WireConfig",
    "data_parallel",
    "fsdp",
    "shard_largest_axis",
    "transformer_partitioner",
]
