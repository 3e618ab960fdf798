"""Transformer building blocks (the JAX package's models/transformer.py).

Parameter names mirror the flax modules (``q/k/v/o``, ``up/down``,
``ln1/ln2``) so :mod:`interop` maps one tree onto the other by name.
Attention routes through ``ops.attention.dot_product_attention``; the
paged decode path through ``ops.paged_attention.paged_decode_attention``,
which launches the CUDA paged-decode kernel on the card for one-token
steps. Decode mode (``decode=True``) keeps K/V across calls in one of two
caches: the paged pool the serving engine addresses through page tables
(``paged_num_blocks > 0``), or a contiguous per-call cache that
``train/generate.py`` sizes before each generation (:func:`init_cache`).

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
sequence parallelism.

Tensor parallelism (``tensor_parallel``, a ``parallel.tensor_parallel.
TensorParallel`` of size above 1): attention keeps ``num_heads / size``
query and ``num_kv_heads / size`` kv heads, the rank's, with ``q/k/v``
column-parallel and ``o`` row-parallel, and the MLP ``mlp_dim / size`` of
its hidden features, ``up`` column- and ``down`` row-parallel (JAX's
``TRANSFORMER_TP_RULES``); the collectives are ``copy_to_tensor`` before
the column-parallel layers and ``reduce_from_tensor`` after the
row-parallel ones, and the row-parallel bias is added once, after the
sum. A size that does not divide the heads, the kv heads and ``mlp_dim``
is refused. The initialisers draw each sharded weight whole and keep the
rank's slice (:func:`lecun_normal_`'s ``shard``), so the weights equal
the slices of the replicated model's.

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
from distributed_pytorch_example_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
    copy_to_tensor,
    reduce_from_tensor,
    take,
)
from distributed_pytorch_example_tpu_torch.runtime import distributed


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; see ROADMAP.md "
        "queue 1"
    )


Shard = Optional[Tuple[int, TensorParallel]]


def _whole_shape(param: torch.Tensor, shard: Shard) -> Tuple[int, ...]:
    """The shape of the whole parameter of which ``param`` is the slice
    ``shard`` = (torch dim, tensor axis) names (``param``'s own without)."""
    shape = list(param.shape)
    if shard is not None:
        shape[shard[0]] *= shard[1].size
    return tuple(shape)


def _copy_in(param: torch.Tensor, cpu: torch.Tensor, shard: Shard) -> None:
    if shard is not None:
        cpu = take(cpu, shard[0], shard[1])
    with torch.no_grad():
        param.copy_(cpu)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator,
                  fan_in: Optional[int] = None, shard: Shard = None) -> None:
    """flax's ``lecun_normal`` (truncated normal, variance 1/fan_in) for a
    torch ``Linear`` weight (out, in) or ``Conv2d`` weight (out, in, h, w):
    fan_in defaults to the product of every dimension after the first.
    Drawn on the CPU from ``generator`` and copied in, so the weights do
    not depend on the device. With ``shard`` = (dim, tensor axis) the
    weight is this rank's slice: the whole weight is drawn (fan_in its
    own) and the slice kept."""
    shape = _whole_shape(weight, shard)
    if fan_in is None:
        fan_in = math.prod(shape[1:])
    # 0.8796... = std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    cpu = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(cpu, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    _copy_in(weight, cpu, shard)


def normal_(param: torch.Tensor, std: float, generator: torch.Generator,
            shard: Shard = None) -> None:
    cpu = torch.empty(_whole_shape(param, shard), dtype=torch.float32)
    nn.init.normal_(cpu, std=std, generator=generator)
    _copy_in(param, cpu, shard)


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias (if any) cast
    to ``dtype``, the product in ``dtype``."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def row_dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
              tp: Optional[TensorParallel]) -> torch.Tensor:
    """:func:`dense` of a row-parallel layer: the rank's partial product,
    summed over the tensor group, then the (replicated) bias once."""
    if tp is None or tp.size == 1:
        return dense(lin, x, dtype)
    out = reduce_from_tensor(F.linear(x.to(dtype), lin.weight.to(dtype)), tp)
    return out if lin.bias is None else out + lin.bias.to(dtype)


def column_row_dims(column: Tuple[str, ...], row: Tuple[str, ...],
                    tp: Optional[TensorParallel]) -> dict:
    """``tensor_dims`` of a block whose ``column`` Linears are cut on
    their outputs (weight dim 0, and their biases) and ``row`` Linears on
    their inputs (weight dim 1; the bias stays whole); empty without
    tensor parallelism."""
    if tp is None or tp.size == 1:
        return {}
    dims = {}
    for name in column:
        dims.update({f"{name}.weight": 0, f"{name}.bias": 0})
    dims.update({f"{name}.weight": 1 for name in row})
    return dims


def tp_shard(module: nn.Module, name: str):
    """The ``shard`` argument of the initialisers for ``module``'s
    parameter ``name`` (None when it is whole)."""
    dim = getattr(module, "tensor_dims", {}).get(name)
    return None if dim is None else (dim, module.tensor_parallel)


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
    prefill, decode and verify rotate at ``row_lens + arange(seq)``. A
    ``seq > 1`` call is a prefill of fresh rows, or, with ``verify=True``,
    a speculative verify chunk: a decode of ``seq`` tokens per row.

    With ``decode=True`` and no pool the module keeps a contiguous cache
    ``cache_k`` / ``cache_v`` of (batch, cache_len, kv_heads, head_dim)
    and a cursor, sized by :meth:`init_cache`. They are plain attributes,
    not buffers: the cache is made per generation and never enters the
    ``state_dict``, so a decode model loads the training model's weights.
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
        tensor_parallel: Optional[TensorParallel] = None,
    ):
        super().__init__()
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {kv_heads}")
        if decode and not causal:
            raise ValueError("decode mode supports causal attention only")
        tp = tensor_parallel or TensorParallel()
        if decode and tp.size > 1:
            raise NotImplementedError(
                "decoding under tensor parallelism (generate(partitioner=), "
                "the serving mesh) is not ported to the PyTorch package yet; "
                "see ROADMAP.md queue 1, item 11")
        # this rank's heads: the Megatron split of JAX's column rules
        num_heads = tp.split(num_heads, "num_heads")
        kv_heads = tp.split(kv_heads, "num_kv_heads")
        self.tensor_parallel = tp
        self.tensor_dims = column_row_dims(("q", "k", "v"), ("o",), tp)
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
        self.cache_k = self.cache_v = None
        self.cache_index = 0
        if decode and paged_num_blocks > 0:
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
        for name in ("q", "k", "v", "o"):
            lin = getattr(self, name)
            lecun_normal_(lin.weight, generator,
                          shard=tp_shard(self, f"{name}.weight"))
            nn.init.zeros_(lin.bias)
        if self.paged_num_blocks > 0:
            self.pages_k.zero_()
            self.pages_v.zero_()

    def init_cache(self, batch: int, length: int) -> None:
        """Size a fresh contiguous cache of ``length`` positions for
        ``batch`` rows (zeros, in the compute dtype, on the weights'
        device) and set the cursor to 0."""
        if not self.decode or self.paged_num_blocks > 0:
            raise ValueError("the contiguous cache needs decode=True "
                             "without paged_num_blocks")
        shape = (batch, length, self.num_kv_heads, self.head_dim)
        dev = self.q.weight.device
        self.cache_k = torch.zeros(shape, dtype=self.dtype, device=dev)
        self.cache_v = torch.zeros(shape, dtype=self.dtype, device=dev)
        self.cache_index = 0

    def clear_cache(self) -> None:
        """Drop the contiguous cache (its memory goes with it)."""
        self.cache_k = self.cache_v = None
        self.cache_index = 0

    def forward(self, x, *, kv_mask=None, page_table=None, row_lens=None,
                draw=None, site=(0, 0), verify=False):
        batch, seq = x.shape[0], x.shape[1]
        dt = self.dtype
        x = copy_to_tensor(x, self.tensor_parallel)
        q = dense(self.q, x, dt).reshape(batch, seq, self.num_heads,
                                         self.head_dim)
        kv_shape = (batch, seq, self.num_kv_heads, self.head_dim)
        k = dense(self.k, x, dt).reshape(kv_shape)
        v = dense(self.v, x, dt).reshape(kv_shape)
        if self.decode:
            if kv_mask is not None:
                raise ValueError("decode mode supports causal attention "
                                 "only, without masks")
            paged = self.paged_num_blocks > 0
            if paged and (page_table is None or row_lens is None):
                raise ValueError(
                    "paged decode needs the engine's page_table and row_lens"
                )
            if verify and not paged:
                raise ValueError("a verify chunk needs the paged pool "
                                 "(paged_num_blocks > 0)")
            # row b's tokens sit at absolute positions lens[b] + t (paged),
            # or at cursor + t for every row (contiguous)
            steps = torch.arange(seq, device=q.device)
            positions = (row_lens[:, None].long() + steps if paged
                         else (self.cache_index + steps)[None])
            if self.rope:
                q = rope(q, positions, self.rope_theta)
                k = rope(k, positions, self.rope_theta)
            out = (self._paged_step(q, k, v, page_table, positions, verify)
                   if paged else self._decode_step(q, k, v, positions[0]))
        else:
            if self.rope:
                q = rope(q, theta=self.rope_theta)
                k = rope(k, theta=self.rope_theta)
            out = dot_product_attention(
                q, k, v, kv_mask=kv_mask, causal=self.causal,
                use_flash=self.use_flash,
            )
        out = row_dense(self.o, out.reshape(batch, seq, -1), dt,
                        self.tensor_parallel)
        return dropout(out, self.dropout_rate, draw, site)

    def _decode_step(self, q, k, v, positions):
        """Contiguous-cache attention: write this call's K/V at the cursor,
        then attend the new queries (at ``positions`` = ``cursor +
        arange(seq)``) against every cached key at a position ``<=`` their
        own, through the plain attention (1..n-token queries)."""
        if self.cache_k is None:
            raise ValueError(
                "the contiguous decode cache is not sized: call "
                "init_cache(batch, length) first (generate() does)"
            )
        seq = q.shape[1]
        idx = self.cache_index
        cache_len = self.cache_k.shape[1]
        if idx + seq > cache_len:
            raise ValueError(f"{idx + seq} positions overflow the "
                             f"contiguous cache of {cache_len}")
        self.cache_k[:, idx:idx + seq] = k
        self.cache_v[:, idx:idx + seq] = v
        self.cache_index = idx + seq
        key_pos = torch.arange(cache_len, device=q.device)
        visible = key_pos[None, None, None, :] <= positions[:, None]
        return dot_product_attention(q, self.cache_k, self.cache_v,
                                     mask=visible, causal=False,
                                     use_flash=False)

    def _paged_step(self, q, k, v, table, positions, verify=False):
        """Paged-KV attention: ``seq > 1`` is a prefill of fresh rows
        (``row_lens == 0`` by engine contract, bucket-padded to a multiple
        of the block size), or with ``verify`` a decode chunk of ``seq``
        tokens per row; ``seq == 1`` the one-token decode step.

        All write this call's K/V into the pool IN PLACE with
        ``index_put_`` (JAX returns a new pool instead); the pool is
        engine-owned state, so nothing else holds the old values.
        """
        batch, seq = q.shape[0], q.shape[1]
        bs, mb = self.paged_block_size, self.paged_max_blocks
        if seq > 1 and not verify:
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

        # ---- decode (seq == 1) / verify chunk (seq > 1): token s of row b
        # sits at absolute position positions[b, s] = lens[b] + s. Inactive
        # rows' tables are all-scratch, so their writes pile up on block 0
        # and are never read by a live row; a verify window that runs past
        # the table near the context limit writes to block 0 too (those
        # queries' logits are discarded by the engine's acceptance loop).
        # Attention: the kernel for seq == 1 on the card, the plain
        # version for chunks (the JAX dispatcher's routing).
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
                 dropout_rate: float = 0.0,
                 tensor_parallel: Optional[TensorParallel] = None):
        super().__init__()
        tp = tensor_parallel or TensorParallel()
        mlp_dim = tp.split(mlp_dim, "mlp_dim")
        self.tensor_parallel = tp
        self.tensor_dims = column_row_dims(("up",), ("down",), tp)
        self.up = nn.Linear(model_dim, mlp_dim)
        self.down = nn.Linear(mlp_dim, model_dim)
        self.dtype = dtype
        self.dropout_rate = dropout_rate

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("up", "down"):
            lin = getattr(self, name)
            lecun_normal_(lin.weight, generator,
                          shard=tp_shard(self, f"{name}.weight"))
            nn.init.zeros_(lin.bias)

    def forward(self, x, *, draw=None, site=(0, 0)):
        x = copy_to_tensor(x, self.tensor_parallel)
        h = F.gelu(dense(self.up, x, self.dtype), approximate="tanh")
        return dropout(row_dense(self.down, h, self.dtype,
                                 self.tensor_parallel),
                       self.dropout_rate, draw, site)


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
        tensor_parallel: Optional[TensorParallel] = None,
        **attn_kw,
    ):
        super().__init__()
        self.index = index
        self.prenorm = prenorm
        self.dtype = dtype
        self.attn = MultiHeadAttention(num_heads, head_dim, model_dim,
                                       dtype=dtype, dropout_rate=dropout_rate,
                                       tensor_parallel=tensor_parallel,
                                       **attn_kw)
        self.mlp = MlpBlock(mlp_dim, model_dim, dtype, dropout_rate,
                            tensor_parallel)
        self.ln1 = nn.LayerNorm(model_dim, eps=layer_norm_epsilon)
        self.ln2 = nn.LayerNorm(model_dim, eps=layer_norm_epsilon)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        for ln in (self.ln1, self.ln2):
            ln.reset_parameters()

    def forward(self, x, *, kv_mask=None, page_table=None, row_lens=None,
                draw=None, verify=False):
        dt = self.dtype
        kw = dict(kv_mask=kv_mask, page_table=page_table, row_lens=row_lens,
                  draw=draw, site=(self.index + 1, 1), verify=verify)
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
                draw=None, verify=False):
        return run_blocks(self.layers, x, self.remat, kv_mask=kv_mask,
                          page_table=page_table, row_lens=row_lens, draw=draw,
                          verify=verify)


def init_cache(model: nn.Module, batch: int, length: int) -> None:
    """Size every attention layer's contiguous decode cache in ``model``
    for ``batch`` rows of ``length`` positions, cursors at 0."""
    for module in model.modules():
        if isinstance(module, MultiHeadAttention):
            module.init_cache(batch, length)


def clear_cache(model: nn.Module) -> None:
    """Drop every attention layer's contiguous decode cache in ``model``."""
    for module in model.modules():
        if isinstance(module, MultiHeadAttention):
            module.clear_cache()
