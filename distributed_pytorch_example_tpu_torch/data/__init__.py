"""Data: deterministic sharded sampling, synthetic datasets, device feeding."""

from distributed_pytorch_example_tpu_torch.data.loader import DeviceLoader
from distributed_pytorch_example_tpu_torch.data.sampler import ShardedSampler
from distributed_pytorch_example_tpu_torch.data.synthetic import (
    SyntheticClassificationDataset,
    SyntheticTokenDataset,
)

__all__ = [
    "DeviceLoader",
    "ShardedSampler",
    "SyntheticClassificationDataset",
    "SyntheticTokenDataset",
]
