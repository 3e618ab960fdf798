"""Ops: attention dispatch and the paged-decode kernel."""

from distributed_pytorch_example_tpu_torch.ops.attention import (
    dot_product_attention,
)
from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
    paged_attention_reference,
    paged_decode_attention,
    paged_flash_decode,
)

__all__ = [
    "dot_product_attention",
    "paged_attention_reference",
    "paged_decode_attention",
    "paged_flash_decode",
]
