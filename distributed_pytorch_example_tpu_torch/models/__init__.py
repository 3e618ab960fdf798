"""Models: SimpleNet, ResNet-18/50, ViT-B/16, BERT-base, GPT-2, LLaMA and
the shared transformer blocks.

``get_model(name, **overrides)`` is the string registry the CLI uses,
with the JAX package's names (its ``models/__init__.py``).
"""

from typing import Any

from torch import nn

from distributed_pytorch_example_tpu_torch.models.bert import BertBase
from distributed_pytorch_example_tpu_torch.models.gpt2 import GPT2
from distributed_pytorch_example_tpu_torch.models.llama import (
    Llama,
    LlamaBlock,
    RMSNorm,
    SwiGluMlp,
)
from distributed_pytorch_example_tpu_torch.models.batchnorm import BatchNorm
from distributed_pytorch_example_tpu_torch.models.mlp import SimpleNet
from distributed_pytorch_example_tpu_torch.models.resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet50,
)
from distributed_pytorch_example_tpu_torch.models.transformer import (
    MlpBlock,
    MultiHeadAttention,
    TransformerBlock,
    TransformerStack,
    tied_head_logits,
)
from distributed_pytorch_example_tpu_torch.models.vit import (
    ViTB16,
    VisionTransformer,
)

_REGISTRY = {
    ("mlp", "simplenet"): SimpleNet,
    ("resnet18", "resnet-18"): ResNet18,
    ("resnet50", "resnet-50"): ResNet50,
    ("vit-b16", "vit-b-16", "vit"): ViTB16,
    ("bert-base", "bert"): BertBase,
    ("gpt2", "gpt-2", "gpt2-124m"): GPT2,
    ("llama", "llama-tiny"): Llama,
}


def get_model(name: str, **overrides: Any) -> nn.Module:
    """Build a model by registry name (the JAX package's names); any
    other name raises ValueError."""
    key = name.lower().replace("_", "-")
    for names, cls in _REGISTRY.items():
        if key in names:
            return cls(**overrides)
    raise ValueError(
        f"model {name!r} is unknown; the registry holds "
        f"{sorted(n for names in _REGISTRY for n in names)}"
    )


__all__ = [
    "BasicBlock",
    "BatchNorm",
    "BertBase",
    "BottleneckBlock",
    "GPT2",
    "Llama",
    "LlamaBlock",
    "MlpBlock",
    "MultiHeadAttention",
    "ResNet",
    "ResNet18",
    "ResNet50",
    "RMSNorm",
    "SimpleNet",
    "SwiGluMlp",
    "TransformerBlock",
    "TransformerStack",
    "ViTB16",
    "VisionTransformer",
    "get_model",
    "tied_head_logits",
]
