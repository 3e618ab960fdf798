"""ViT-B/16 (the JAX package's models/vit.py; BASELINE.json config 3).

Patch embedding (a p x p / p VALID conv with bias, its patches flattened
in row-major (h, w) order) -> a zero-initialised [CLS] token and a learned
position table, N(0, 0.02), of 1 + (H/p)(W/p) positions -> the pre-LN
encoder (``TransformerStack``, LayerNorm eps 1e-6, non-causal) -> the
final LayerNorm (eps 1e-6) -> a float32 Dense head on token 0.

The input is NHWC, as in the JAX package. Torch needs the position
table's length when the model is built, so the model takes
``image_size`` (default 224; JAX infers it from the first input).
Attention goes through ``ops.attention.dot_product_attention`` with
``use_flash=None``: 197 tokens are no multiple of 128, so the plain path
runs, as XLA's does in JAX. Compute is in ``dtype`` with float32
parameters. Dropout (``dropout_rate`` > 0) is not ported and is refused,
as BERT's is.

Parameter names are flax's (``patch_embed``, ``cls_token``, ``pos_embed``,
``encoder.layers.<i>`` = ``encoder/layer_<i>``, ``final_ln``, ``head``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from distributed_pytorch_example_tpu_torch.models.transformer import (
    TransformerStack,
    _not_in_slice,
    layer_norm,
    lecun_normal_,
    normal_,
)
from distributed_pytorch_example_tpu_torch.runtime.device import resolve_device

LN_EPS = 1e-6


class VisionTransformer(nn.Module):
    def __init__(
        self,
        num_classes: int = 1000,
        patch_size: int = 16,
        model_dim: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        mlp_dim: int = 3072,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
        use_flash: Optional[bool] = None,
        *,
        image_size: int = 224,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
        **stack_kw,
    ):
        super().__init__()
        if dropout_rate:
            raise _not_in_slice("dropout (training)")
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch_size {patch_size}")
        dev = resolve_device(device)
        self.num_classes, self.patch_size = num_classes, patch_size
        self.model_dim, self.image_size, self.dtype = model_dim, image_size, dtype
        tokens = 1 + (image_size // patch_size) ** 2
        with torch.device("meta"):
            self.patch_embed = nn.Conv2d(3, model_dim, patch_size,
                                         stride=patch_size)  # RGB
            self.cls_token = nn.Parameter(torch.empty(1, 1, model_dim))
            self.pos_embed = nn.Parameter(torch.empty(1, tokens, model_dim))
            self.encoder = TransformerStack(
                num_layers, num_heads, model_dim // num_heads, model_dim,
                mlp_dim, causal=False, prenorm=True,
                layer_norm_epsilon=LN_EPS, dtype=dtype, use_flash=use_flash,
                **stack_kw,
            )
            self.final_ln = nn.LayerNorm(model_dim, eps=LN_EPS)
            self.head = nn.Linear(model_dim, num_classes)
        self.to_empty(device=dev)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun-normal patch and head kernels with
        zero biases, a zero [CLS] token, an N(0, 0.02) position table."""
        lecun_normal_(self.patch_embed.weight, generator)
        nn.init.zeros_(self.patch_embed.bias)
        nn.init.zeros_(self.cls_token)
        normal_(self.pos_embed, 0.02, generator)
        self.encoder.reset_parameters(generator)
        self.final_ln.reset_parameters()
        lecun_normal_(self.head.weight, generator)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> (B, num_classes) float32 logits."""
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)  # NHWC -> NCHW view
        w = self.patch_embed.weight.to(dt).contiguous(
            memory_format=torch.channels_last)
        x = F.conv2d(x, w, self.patch_embed.bias.to(dt),
                     stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)  # (B, (H/p)(W/p), D), row-major
        if x.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(
                f"{x.shape[1]} patches, but the position table was built "
                f"for image_size {self.image_size} "
                f"({self.pos_embed.shape[1] - 1} patches)")
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        x = self.encoder(x)
        x = layer_norm(self.final_ln, x, dt)
        return F.linear(x[:, 0].float(), self.head.weight, self.head.bias)


def ViTB16(num_classes: int = 1000, **kw) -> VisionTransformer:
    """ViT-Base/16: 12 layers, width 768, 12 heads, MLP 3072 (86M
    parameters at 224 x 224 and 1000 classes)."""
    return VisionTransformer(num_classes=num_classes, **kw)
