"""Transformer building blocks (the JAX package's models/transformer.py).

Parameter names mirror the flax modules (``q/k/v/o``, ``up/down``,
``ln1/ln2``) so :mod:`interop` maps one tree onto the other by name.
Attention routes through ``ops.attention.dot_product_attention``; the
paged decode path through ``ops.paged_attention.paged_decode_attention``,
which launches the CUDA paged-decode kernel on the card.

Compute dtype follows flax's ``dtype=``: parameters stay float32, and
each module casts its parameters and inputs to ``dtype`` where it uses
them (``dense``: inputs, kernel and bias in ``dtype``; ``layer_norm``:
float32 statistics and affine, output in ``dtype``; GELU in ``dtype``).
``torch.autocast`` is not used: its casting rules differ from flax's.

This port carries what GPT-2 and BERT run: pre-LN (GPT-2) or post-LN
(BERT, ``prenorm=False``) blocks with the LayerNorm epsilon passed
through, causal or non-causal multi-head self-attention, an optional
(B, S) key-padding ``kv_mask`` (True = attend) carried block by block to
``dot_product_attention``, float32 or bfloat16. Not in it, and refused
when asked for: mixture-of-experts MLPs, rematerialisation and sequence
parallelism; the contiguous (non-paged) KV cache. GQA, RoPE and general
(Q, K) masks land with the models that use them (ROADMAP.md queue 1).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_pytorch_example_tpu_torch.ops.attention import (
    dot_product_attention,
)
from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
)


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; see ROADMAP.md "
        "queue 1"
    )


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator,
                  fan_in: Optional[int] = None) -> None:
    """flax's ``lecun_normal`` (truncated normal, variance 1/fan_in) for a
    torch ``Linear`` weight (out, in) or ``Conv2d`` weight (out, in, h, w):
    fan_in defaults to the product of every dimension after the first.
    Drawn on the CPU from ``generator`` and copied in, so the weights do
    not depend on the device."""
    if fan_in is None:
        fan_in = math.prod(weight.shape[1:])
    # 0.8796... = std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    cpu = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(cpu, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    with torch.no_grad():
        weight.copy_(cpu)


def normal_(param: torch.Tensor, std: float, generator: torch.Generator) -> None:
    cpu = torch.empty(param.shape, dtype=torch.float32)
    nn.init.normal_(cpu, std=std, generator=generator)
    with torch.no_grad():
        param.copy_(cpu)


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to
    ``dtype``, the product in ``dtype``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=...)``: statistics and the affine map in
    float32, the result cast to ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def tied_head_logits(x: torch.Tensor, embedding: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LM-head logits against a tied (V, D) embedding matrix: operands in
    ``dtype``, float32 accumulation and float32 logits, never rounded to
    ``dtype`` on the way (the JAX package's ``preferred_element_type``)."""
    return torch.matmul(x.to(dtype).float(), embedding.to(dtype).float().t())


class MultiHeadAttention(nn.Module):
    """Self-attention; layout (batch, seq, heads, head_dim) end to end.

    With ``paged_num_blocks > 0`` (and ``decode=True``) the module owns one
    layer's share of the paged KV pool as the buffers ``pages_k`` /
    ``pages_v`` of shape (num_blocks, block_size, num_heads, head_dim).
    Block 0 is the scratch block: unallocated table entries point at it,
    so writes past a row's true length land harmlessly. The engine passes
    ``page_table`` (batch, max_blocks) int32 and ``row_lens`` (batch,)
    int32 with every call; the module never changes them.
    """

    def __init__(
        self,
        num_heads: int,
        head_dim: int,
        model_dim: int,
        *,
        causal: bool = False,
        use_flash: Optional[bool] = None,
        dtype: torch.dtype = torch.float32,
        decode: bool = False,
        paged_num_blocks: int = 0,
        paged_block_size: int = 16,
        paged_max_blocks: int = 0,
    ):
        super().__init__()
        if decode and paged_num_blocks <= 0:
            raise _not_in_slice("the contiguous decode cache (generate())")
        if decode and not causal:
            raise ValueError("decode mode supports causal attention only")
        self.num_heads, self.head_dim = num_heads, head_dim
        self.causal = causal
        self.use_flash = use_flash
        self.dtype = dtype
        self.decode = decode
        self.paged_num_blocks = paged_num_blocks
        self.paged_block_size = paged_block_size
        self.paged_max_blocks = paged_max_blocks
        features = num_heads * head_dim
        self.q = nn.Linear(model_dim, features)
        self.k = nn.Linear(model_dim, features)
        self.v = nn.Linear(model_dim, features)
        self.o = nn.Linear(features, model_dim)
        if decode:
            nb, bs, mb = paged_num_blocks, paged_block_size, paged_max_blocks
            if nb < 2 or bs < 1 or mb < 1:
                raise ValueError(
                    "paged decode needs paged_num_blocks >= 2 (block 0 is "
                    "scratch), paged_block_size >= 1 and paged_max_blocks "
                    f">= 1; got {nb}/{bs}/{mb}"
                )
            shape = (nb, bs, num_heads, head_dim)
            # the pool is state, not weights: kept out of the state_dict
            self.register_buffer("pages_k", torch.zeros(shape),
                                 persistent=False)
            self.register_buffer("pages_v", torch.zeros(shape),
                                 persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.q, self.k, self.v, self.o):
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
        if self.decode:
            self.pages_k.zero_()
            self.pages_v.zero_()

    def forward(self, x, *, kv_mask=None, page_table=None, row_lens=None):
        batch, seq = x.shape[0], x.shape[1]
        shape = (batch, seq, self.num_heads, self.head_dim)
        dt = self.dtype
        q = dense(self.q, x, dt).reshape(shape)
        k = dense(self.k, x, dt).reshape(shape)
        v = dense(self.v, x, dt).reshape(shape)
        if self.decode:
            if kv_mask is not None:
                raise ValueError("decode mode supports causal attention "
                                 "only, without masks")
            if page_table is None or row_lens is None:
                raise ValueError(
                    "paged decode needs the engine's page_table and row_lens"
                )
            out = self._paged_step(q, k, v, page_table, row_lens)
        else:
            out = dot_product_attention(
                q, k, v, kv_mask=kv_mask, causal=self.causal,
                use_flash=self.use_flash,
            )
        return dense(self.o, out.reshape(batch, seq, -1), dt)

    def _paged_step(self, q, k, v, table, lens):
        """Paged-KV attention: ``seq > 1`` is a prefill of fresh rows
        (``row_lens == 0`` by engine contract, bucket-padded to a multiple
        of the block size); ``seq == 1`` the one-token decode step.

        Both write this call's K/V into the pool IN PLACE with
        ``index_put_`` (JAX returns a new pool instead); the pool is
        engine-owned state, so nothing else holds the old values.
        """
        batch, seq = q.shape[0], q.shape[1]
        bs, mb = self.paged_block_size, self.paged_max_blocks
        if seq > 1:
            # ---- prefill: K/V land in the rows' pool blocks via ONE batched
            # scatter over the (row, block) table entries; attention is plain
            # causal self-attention over this call's tokens (pad tokens sit
            # at later positions, so real logits never see them)
            if seq % bs:
                raise ValueError(
                    f"prefill length {seq} must be a multiple of "
                    f"paged_block_size {bs}"
                )
            n_blk = seq // bs
            if n_blk > mb:
                raise ValueError(
                    f"prefill bucket {seq} needs {n_blk} blocks > "
                    f"paged_max_blocks {mb}"
                )
            block_ids = table[:, :n_blk].reshape(-1).long()
            shape = (batch * n_blk, bs, self.num_heads, self.head_dim)
            self.pages_k[block_ids] = k.reshape(shape)
            self.pages_v[block_ids] = v.reshape(shape)
            return dot_product_attention(q, k, v, causal=True, use_flash=False)

        # ---- decode: the token of row b sits at absolute position
        # lens[b]; inactive rows' tables are all-scratch, so their writes
        # pile up on block 0 and are never read by a live row
        positions = lens[:, None].long() + torch.arange(seq, device=q.device)
        blk_j = positions // bs
        block_idx = torch.where(
            blk_j < mb,
            torch.gather(table.long(), 1, blk_j.clamp(max=mb - 1)),
            0,
        )
        off = positions % bs
        self.pages_k[block_idx, off] = k
        self.pages_v[block_idx, off] = v
        return paged_decode_attention(
            q, self.pages_k, self.pages_v, table, positions
        )


class MlpBlock(nn.Module):
    """Position-wise feed-forward: up -> tanh GELU (flax ``nn.gelu``'s
    default) -> down, all in ``dtype``."""

    def __init__(self, mlp_dim: int, model_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up = nn.Linear(model_dim, mlp_dim)
        self.down = nn.Linear(mlp_dim, model_dim)
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.up, self.down):
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x):
        h = F.gelu(dense(self.up, x, self.dtype), approximate="tanh")
        return dense(self.down, h, self.dtype)


class TransformerBlock(nn.Module):
    """One block: pre-LN (GPT, ``prenorm=True``): x + attn(ln1(x)), then
    + mlp(ln2(x)); post-LN (BERT): ln1(x + attn(x)), then ln2(x + mlp(x))."""

    def __init__(
        self,
        num_heads: int,
        head_dim: int,
        model_dim: int,
        mlp_dim: int,
        *,
        prenorm: bool = True,
        layer_norm_epsilon: float = 1e-5,
        dtype: torch.dtype = torch.float32,
        **attn_kw,
    ):
        super().__init__()
        self.prenorm = prenorm
        self.dtype = dtype
        self.attn = MultiHeadAttention(num_heads, head_dim, model_dim,
                                       dtype=dtype, **attn_kw)
        self.mlp = MlpBlock(mlp_dim, model_dim, dtype)
        self.ln1 = nn.LayerNorm(model_dim, eps=layer_norm_epsilon)
        self.ln2 = nn.LayerNorm(model_dim, eps=layer_norm_epsilon)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        for ln in (self.ln1, self.ln2):
            ln.reset_parameters()

    def forward(self, x, *, kv_mask=None, page_table=None, row_lens=None):
        dt = self.dtype
        kw = dict(kv_mask=kv_mask, page_table=page_table, row_lens=row_lens)
        if self.prenorm:
            x = x + self.attn(layer_norm(self.ln1, x, dt), **kw)
            return x + self.mlp(layer_norm(self.ln2, x, dt))
        x = layer_norm(self.ln1, x + self.attn(x, **kw), dt)
        return layer_norm(self.ln2, x + self.mlp(x), dt)


class TransformerStack(nn.Module):
    """N homogeneous transformer blocks (``layers.<i>`` = flax ``layer_i``)."""

    def __init__(
        self,
        num_layers: int,
        num_heads: int,
        head_dim: int,
        model_dim: int,
        mlp_dim: int,
        *,
        remat: bool = False,
        moe_experts: int = 0,
        seq_axis: Optional[str] = None,
        **block_kw,
    ):
        super().__init__()
        if remat:
            raise _not_in_slice("remat")
        if moe_experts:
            raise _not_in_slice("mixture-of-experts (moe_experts > 0)")
        if seq_axis is not None:
            raise _not_in_slice("sequence parallelism (seq_axis)")
        self.layers = nn.ModuleList(
            TransformerBlock(num_heads, head_dim, model_dim, mlp_dim, **block_kw)
            for _ in range(num_layers)
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x, *, kv_mask=None, page_table=None, row_lens=None):
        for layer in self.layers:
            x = layer(x, kv_mask=kv_mask, page_table=page_table,
                      row_lens=row_lens)
        return x
