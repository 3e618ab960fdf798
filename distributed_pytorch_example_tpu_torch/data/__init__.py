"""Data: deterministic sharded sampling, synthetic datasets, token files,
local vision datasets, host-side augmentation, device feeding."""

from distributed_pytorch_example_tpu_torch.data.augment import (
    AugmentedDataset,
    pad_crop_flip,
    random_resized_crop_flip,
)
from distributed_pytorch_example_tpu_torch.data.loader import DeviceLoader
from distributed_pytorch_example_tpu_torch.data.sampler import ShardedSampler
from distributed_pytorch_example_tpu_torch.data.synthetic import (
    SyntheticClassificationDataset,
    SyntheticImageDataset,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.data.text import (
    TokenWindowDataset,
    load_token_file,
    write_token_file,
)
from distributed_pytorch_example_tpu_torch.data.vision import (
    load_cifar10,
    load_digits,
    load_image_folder,
)

__all__ = [
    "AugmentedDataset",
    "DeviceLoader",
    "ShardedSampler",
    "SyntheticClassificationDataset",
    "SyntheticImageDataset",
    "SyntheticTokenDataset",
    "TokenWindowDataset",
    "load_cifar10",
    "load_digits",
    "load_image_folder",
    "load_token_file",
    "pad_crop_flip",
    "random_resized_crop_flip",
    "write_token_file",
]
