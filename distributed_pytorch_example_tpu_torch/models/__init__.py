"""Models: GPT-2, SimpleNet and the shared transformer blocks."""

from distributed_pytorch_example_tpu_torch.models.gpt2 import GPT2
from distributed_pytorch_example_tpu_torch.models.mlp import SimpleNet
from distributed_pytorch_example_tpu_torch.models.transformer import (
    MlpBlock,
    MultiHeadAttention,
    TransformerBlock,
    TransformerStack,
    tied_head_logits,
)

__all__ = [
    "GPT2",
    "MlpBlock",
    "MultiHeadAttention",
    "SimpleNet",
    "TransformerBlock",
    "TransformerStack",
    "tied_head_logits",
]
