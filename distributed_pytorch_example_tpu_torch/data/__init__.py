"""Data: deterministic sharded sampling, synthetic datasets, token files,
device feeding."""

from distributed_pytorch_example_tpu_torch.data.loader import DeviceLoader
from distributed_pytorch_example_tpu_torch.data.sampler import ShardedSampler
from distributed_pytorch_example_tpu_torch.data.synthetic import (
    SyntheticClassificationDataset,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.data.text import (
    TokenWindowDataset,
    load_token_file,
    write_token_file,
)

__all__ = [
    "DeviceLoader",
    "ShardedSampler",
    "SyntheticClassificationDataset",
    "SyntheticTokenDataset",
    "TokenWindowDataset",
    "load_token_file",
    "write_token_file",
]
