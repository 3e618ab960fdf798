"""BERT-base encoder with its masked-LM head (the JAX package's
models/bert.py, BASELINE.json config 4).

Post-LN transformer encoder (the original BERT): token + learned position
embeddings -> embedding LayerNorm -> post-LN blocks with non-causal
attention -> MLM head (dense, tanh GELU, LayerNorm) -> logits against the
tied token-embedding matrix plus ``mlm_bias``. Every LayerNorm takes
epsilon 1e-12. Compute in ``dtype`` (float32 or bfloat16) with float32
parameters, as flax's ``dtype=``. Attention auto-selects the flash kernel
(K1) on the card where its shapes allow (``use_flash=None``): at BERT's
512 tokens and head_dim 64 every layer runs it forward and backward.
``dropout_rate`` drops after the embedding LayerNorm and after each
block's attention and MLP in training (masks keyed through
:meth:`BertBase.fold_in`); ``remat`` recomputes each block in the
backward pass.

``pad_token_id`` (real, padded corpora) masks the keys at pad positions
out of every attention: ``kv_mask = tokens != pad_token_id`` streams
through K1. ``logits_mode="hidden"`` returns the MLM head's hidden states
for the fused chunked cross-entropy, which takes the tied table and the
bias from :meth:`BertBase.head_params`. MLM masking itself is the task's
(``train/tasks.py`` ``MLMTask``), so the loader ships raw token ids.

Parameter names are flax's (``tok_embed``, ``pos_embed``, ``embed_ln``,
``encoder.layers.<i>`` = ``encoder/layer_<i>``, ``mlm_dense``,
``mlm_ln``, ``mlm_bias``), so :mod:`interop` maps one tree onto the other.
Weights are drawn on the CPU from an explicit generator (``seed``) and
copied to ``device``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from distributed_pytorch_example_tpu_torch.models.transformer import (
    DropoutDraws,
    TransformerStack,
    dense,
    dropout,
    layer_norm,
    lecun_normal_,
    normal_,
    tied_head_logits,
)
from distributed_pytorch_example_tpu_torch.runtime.device import resolve_device

LN_EPS = 1e-12


class BertBase(nn.Module):
    def __init__(
        self,
        vocab_size: int = 30522,
        max_len: int = 512,
        model_dim: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        mlp_dim: int = 3072,
        *,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
        use_flash: Optional[bool] = None,
        pad_token_id: Optional[int] = None,
        logits_mode: str = "full",
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
        **stack_kw,
    ):
        super().__init__()
        if logits_mode not in ("full", "hidden"):
            raise ValueError(
                f"logits_mode must be 'full' or 'hidden', got {logits_mode!r}"
            )
        dev = resolve_device(device)
        self.vocab_size, self.max_len, self.model_dim = vocab_size, max_len, model_dim
        self.num_layers, self.num_heads = num_layers, num_heads
        self.dtype, self.logits_mode = dtype, logits_mode
        self.pad_token_id = pad_token_id
        self.dropout_rate = dropout_rate
        self.draws = DropoutDraws(seed)
        with torch.device("meta"):
            self.tok_embed = nn.Embedding(vocab_size, model_dim)
            self.pos_embed = nn.Parameter(torch.empty(1, max_len, model_dim))
            self.embed_ln = nn.LayerNorm(model_dim, eps=LN_EPS)
            self.encoder = TransformerStack(
                num_layers, num_heads, model_dim // num_heads, model_dim,
                mlp_dim, causal=False, prenorm=False,
                layer_norm_epsilon=LN_EPS, dtype=dtype, use_flash=use_flash,
                dropout_rate=dropout_rate, **stack_kw,
            )
            self.mlm_dense = nn.Linear(model_dim, model_dim)
            self.mlm_ln = nn.LayerNorm(model_dim, eps=LN_EPS)
            self.mlm_bias = nn.Parameter(torch.empty(vocab_size))
        self.to_empty(device=dev)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    def fold_in(self, step: int) -> None:
        """Key this train step's dropout masks from (seed, step)."""
        self.draws.fold_in(step)

    def head_params(self):
        """Tied MLM-head weights for the fused loss: ((V, D) table, bias)."""
        return self.tok_embed.weight, self.mlm_bias

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: N(0, 0.02) token and position tables,
        lecun-normal projections, zero biases (``mlm_bias`` too), unit
        LayerNorms."""
        normal_(self.tok_embed.weight, 0.02, generator)
        normal_(self.pos_embed, 0.02, generator)
        self.embed_ln.reset_parameters()
        self.encoder.reset_parameters(generator)
        lecun_normal_(self.mlm_dense.weight, generator)
        nn.init.zeros_(self.mlm_dense.bias)
        self.mlm_ln.reset_parameters()
        nn.init.zeros_(self.mlm_bias)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) int tokens -> (B, S, vocab) float32 logits, or the
        (B, S, D) MLM-head hidden states in ``dtype`` when
        ``logits_mode="hidden"``."""
        dt = self.dtype
        seq = tokens.shape[1]
        x = self.tok_embed(tokens).to(dt) + self.pos_embed[:, :seq].to(dt)
        x = layer_norm(self.embed_ln, x, dt)
        draw = (self.draws.next() if self.training and self.dropout_rate
                else None)
        x = dropout(x, self.dropout_rate, draw, (0, 0))
        kv_mask = None
        if self.pad_token_id is not None:
            kv_mask = tokens != self.pad_token_id
        x = self.encoder(x, kv_mask=kv_mask, draw=draw)
        x = F.gelu(dense(self.mlm_dense, x, dt), approximate="tanh")
        x = layer_norm(self.mlm_ln, x, dt)
        if self.logits_mode == "hidden":
            return x
        # float32 logits + the float32 bias: float32, as JAX promotes them
        return tied_head_logits(x, self.tok_embed.weight, dt) + self.mlm_bias
