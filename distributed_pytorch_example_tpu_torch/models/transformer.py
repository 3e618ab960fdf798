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

This port carries what GPT-2, BERT, ViT and LLaMA run: pre-LN (GPT-2,
ViT) or post-LN (BERT, ``prenorm=False``) blocks with the LayerNorm
epsilon passed through, causal or non-causal multi-head self-attention
with grouped-query heads (``num_kv_heads``) and rotary positions
(``rope``), an optional (B, S) key-padding ``kv_mask`` (True = attend)
carried block by block to ``dot_product_attention``, float32 or bfloat16,
dropout (:func:`dropout`) and per-block rematerialisation (``remat``).
Not in it, and refused when asked for: mixture-of-experts MLPs and
sequence parallelism; the contiguous (non-paged) KV cache.

Dropout masks are drawn from a generator seeded from the forward call's
``draw`` (model seed, train step, process, call in the step; see
:class:`DropoutDraws`) and the site (layer, site in the layer), never from
a generator that advances: ``torch.utils.checkpoint`` restores only the
global RNG states, so the recompute under ``remat`` draws the same masks
again only because each mask is a pure function of its key.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_pytorch_example_tpu_torch.ops.attention import (
    dot_product_attention,
)
from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
)
from distributed_pytorch_example_tpu_torch.ops.rope import rope
from distributed_pytorch_example_tpu_torch.runtime import distributed


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
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias (if any) cast
    to ``dtype``, the product in ``dtype``."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


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


class DropoutDraws:
    """The key of each training forward's dropout masks: (model seed, train
    step, process, call within the step). The train step calls
    :meth:`fold_in` with its step before the forward (the JAX step's
    ``fold_in(rng, step)``), so a resumed run draws the masks the
    uninterrupted run drew; processes and gradient-accumulation
    microbatches draw apart. The bits are torch's, not ``jax.random``'s."""

    def __init__(self, seed: int):
        self.seed, self.step, self.process, self.calls = int(seed), 0, 0, 0

    def fold_in(self, step: int) -> None:
        self.step, self.calls = int(step), 0
        self.process = distributed.process_index()

    def next(self) -> Tuple[int, ...]:
        """The key of one more forward call in this step."""
        self.calls += 1
        return (self.seed, self.step, self.process, self.calls)


def dropout(x: torch.Tensor, rate: float, draw: Optional[Tuple[int, ...]],
            site: Tuple[int, int]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate,
    scale the kept ones by 1 / (1 - rate). ``draw`` is the forward call's
    key (None: no dropout, as in eval), ``site`` the (layer, site) of this
    mask; the mask is drawn from a generator seeded from both alone."""
    if not rate or draw is None:
        return x
    seed = np.random.SeedSequence([*draw, *site]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=x.device).manual_seed(int(seed) >> 1)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def run_blocks(layers, x: torch.Tensor, remat: bool, **kw) -> torch.Tensor:
    """Apply the blocks in order; with ``remat`` (and gradients on) each
    block goes through ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward pass (``nn.remat`` in
    JAX)."""
    for layer in layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, use_reentrant=False, **kw)
        else:
            x = layer(x, **kw)
    return x


class MultiHeadAttention(nn.Module):
    """Self-attention; layout (batch, seq, heads, head_dim) end to end.

    ``num_kv_heads`` < ``num_heads`` is grouped-query attention: k and v
    project to ``num_kv_heads`` heads, each serving a group of query heads
    (the kernels and the plain path route query head n to kv head
    n // group). ``rope`` rotates q and k by their positions (``ops/
    rope.py``) after the projections, before attention.

    With ``paged_num_blocks > 0`` (and ``decode=True``) the module owns one
    layer's share of the paged KV pool as the buffers ``pages_k`` /
    ``pages_v`` of shape (num_blocks, block_size, kv_heads, head_dim).
    Block 0 is the scratch block: unallocated table entries point at it,
    so writes past a row's true length land harmlessly. The engine passes
    ``page_table`` (batch, max_blocks) int32 and ``row_lens`` (batch,)
    int32 with every call; the module never changes them. Under ``rope``
    both prefill and decode rotate at ``row_lens + arange(seq)``.
    """

    def __init__(
        self,
        num_heads: int,
        head_dim: int,
        model_dim: int,
        *,
        causal: bool = False,
        dropout_rate: float = 0.0,
        use_flash: Optional[bool] = None,
        dtype: torch.dtype = torch.float32,
        num_kv_heads: Optional[int] = None,
        rope: bool = False,
        rope_theta: float = 10000.0,
        decode: bool = False,
        paged_num_blocks: int = 0,
        paged_block_size: int = 16,
        paged_max_blocks: int = 0,
    ):
        super().__init__()
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {kv_heads}")
        if decode and paged_num_blocks <= 0:
            raise _not_in_slice("the contiguous decode cache (generate())")
        if decode and not causal:
            raise ValueError("decode mode supports causal attention only")
        self.num_heads, self.head_dim = num_heads, head_dim
        self.num_kv_heads = kv_heads
        self.causal = causal
        self.dropout_rate = dropout_rate
        self.use_flash = use_flash
        self.dtype = dtype
        self.rope, self.rope_theta = rope, rope_theta
        self.decode = decode
        self.paged_num_blocks = paged_num_blocks
        self.paged_block_size = paged_block_size
        self.paged_max_blocks = paged_max_blocks
        features = num_heads * head_dim
        self.q = nn.Linear(model_dim, features)
        self.k = nn.Linear(model_dim, kv_heads * head_dim)
        self.v = nn.Linear(model_dim, kv_heads * head_dim)
        self.o = nn.Linear(features, model_dim)
        if decode:
            nb, bs, mb = paged_num_blocks, paged_block_size, paged_max_blocks
            if nb < 2 or bs < 1 or mb < 1:
                raise ValueError(
                    "paged decode needs paged_num_blocks >= 2 (block 0 is "
                    "scratch), paged_block_size >= 1 and paged_max_blocks "
                    f">= 1; got {nb}/{bs}/{mb}"
                )
            shape = (nb, bs, kv_heads, head_dim)
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

    def forward(self, x, *, kv_mask=None, page_table=None, row_lens=None,
                draw=None, site=(0, 0)):
        batch, seq = x.shape[0], x.shape[1]
        dt = self.dtype
        q = dense(self.q, x, dt).reshape(batch, seq, self.num_heads,
                                         self.head_dim)
        kv_shape = (batch, seq, self.num_kv_heads, self.head_dim)
        k = dense(self.k, x, dt).reshape(kv_shape)
        v = dense(self.v, x, dt).reshape(kv_shape)
        if self.decode:
            if kv_mask is not None:
                raise ValueError("decode mode supports causal attention "
                                 "only, without masks")
            if page_table is None or row_lens is None:
                raise ValueError(
                    "paged decode needs the engine's page_table and row_lens"
                )
            # row b's tokens sit at absolute positions lens[b] + t
            positions = row_lens[:, None].long() + torch.arange(
                seq, device=q.device)
            if self.rope:
                q = rope(q, positions, self.rope_theta)
                k = rope(k, positions, self.rope_theta)
            out = self._paged_step(q, k, v, page_table, positions)
        else:
            if self.rope:
                q = rope(q, theta=self.rope_theta)
                k = rope(k, theta=self.rope_theta)
            out = dot_product_attention(
                q, k, v, kv_mask=kv_mask, causal=self.causal,
                use_flash=self.use_flash,
            )
        out = dense(self.o, out.reshape(batch, seq, -1), dt)
        return dropout(out, self.dropout_rate, draw, site)

    def _paged_step(self, q, k, v, table, positions):
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
            shape = (batch * n_blk, bs, self.num_kv_heads, self.head_dim)
            self.pages_k[block_ids] = k.reshape(shape)
            self.pages_v[block_ids] = v.reshape(shape)
            return dot_product_attention(q, k, v, causal=True, use_flash=False)

        # ---- decode: the token of row b sits at absolute position
        # lens[b]; inactive rows' tables are all-scratch, so their writes
        # pile up on block 0 and are never read by a live row
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
    default) -> down, all in ``dtype``, then dropout."""

    def __init__(self, mlp_dim: int, model_dim: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.up = nn.Linear(model_dim, mlp_dim)
        self.down = nn.Linear(mlp_dim, model_dim)
        self.dtype = dtype
        self.dropout_rate = dropout_rate

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.up, self.down):
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x, *, draw=None, site=(0, 0)):
        h = F.gelu(dense(self.up, x, self.dtype), approximate="tanh")
        return dropout(dense(self.down, h, self.dtype), self.dropout_rate,
                       draw, site)


class TransformerBlock(nn.Module):
    """One block: pre-LN (GPT, ``prenorm=True``): x + attn(ln1(x)), then
    + mlp(ln2(x)); post-LN (BERT): ln1(x + attn(x)), then ln2(x + mlp(x)).
    Block ``index`` i draws its attention and MLP dropout masks at sites
    (i + 1, 1) and (i + 1, 2)."""

    def __init__(
        self,
        num_heads: int,
        head_dim: int,
        model_dim: int,
        mlp_dim: int,
        *,
        index: int = 0,
        prenorm: bool = True,
        dropout_rate: float = 0.0,
        layer_norm_epsilon: float = 1e-5,
        dtype: torch.dtype = torch.float32,
        **attn_kw,
    ):
        super().__init__()
        self.index = index
        self.prenorm = prenorm
        self.dtype = dtype
        self.attn = MultiHeadAttention(num_heads, head_dim, model_dim,
                                       dtype=dtype, dropout_rate=dropout_rate,
                                       **attn_kw)
        self.mlp = MlpBlock(mlp_dim, model_dim, dtype, dropout_rate)
        self.ln1 = nn.LayerNorm(model_dim, eps=layer_norm_epsilon)
        self.ln2 = nn.LayerNorm(model_dim, eps=layer_norm_epsilon)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        for ln in (self.ln1, self.ln2):
            ln.reset_parameters()

    def forward(self, x, *, kv_mask=None, page_table=None, row_lens=None,
                draw=None):
        dt = self.dtype
        kw = dict(kv_mask=kv_mask, page_table=page_table, row_lens=row_lens,
                  draw=draw, site=(self.index + 1, 1))
        mlp_kw = dict(draw=draw, site=(self.index + 1, 2))
        if self.prenorm:
            x = x + self.attn(layer_norm(self.ln1, x, dt), **kw)
            return x + self.mlp(layer_norm(self.ln2, x, dt), **mlp_kw)
        x = layer_norm(self.ln1, x + self.attn(x, **kw), dt)
        return layer_norm(self.ln2, x + self.mlp(x, **mlp_kw), dt)


class TransformerStack(nn.Module):
    """N homogeneous transformer blocks (``layers.<i>`` = flax ``layer_i``);
    ``remat`` recomputes each block's activations in the backward pass."""

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
        if moe_experts:
            raise _not_in_slice("mixture-of-experts (moe_experts > 0)")
        if seq_axis is not None:
            raise _not_in_slice("sequence parallelism (seq_axis)")
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerBlock(num_heads, head_dim, model_dim, mlp_dim,
                             index=i, **block_kw)
            for i in range(num_layers)
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x, *, kv_mask=None, page_table=None, row_lens=None,
                draw=None):
        return run_blocks(self.layers, x, self.remat, kv_mask=kv_mask,
                          page_table=page_table, row_lens=row_lens, draw=draw)
