"""Ops: attention dispatch, the flash-attention and paged-decode kernels,
and the chunked cross-entropy."""

from distributed_pytorch_example_tpu_torch.ops.attention import (
    dot_product_attention,
)
from distributed_pytorch_example_tpu_torch.ops.chunked_ce import (
    chunked_softmax_xent,
)
from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
    paged_attention_reference,
    paged_decode_attention,
    paged_flash_decode,
)

__all__ = [
    "chunked_softmax_xent",
    "dot_product_attention",
    "flash_attention",
    "paged_attention_reference",
    "paged_decode_attention",
    "paged_flash_decode",
]
