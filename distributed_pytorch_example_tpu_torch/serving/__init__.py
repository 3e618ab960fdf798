"""Serving: paged-KV continuous batching over the port's GPT-2."""

from distributed_pytorch_example_tpu_torch.serving.cache import (
    SCRATCH_BLOCK,
    BlockAllocator,
    PagedCacheConfig,
)
from distributed_pytorch_example_tpu_torch.serving.engine import (
    EngineFetchTimeout,
    InferenceEngine,
)
from distributed_pytorch_example_tpu_torch.serving.scheduler import (
    Request,
    RequestState,
    Scheduler,
)

__all__ = [
    "SCRATCH_BLOCK",
    "BlockAllocator",
    "EngineFetchTimeout",
    "InferenceEngine",
    "PagedCacheConfig",
    "Request",
    "RequestState",
    "Scheduler",
]
