"""LLaMA-style decoder LM: RMSNorm + RoPE + SwiGLU + grouped-query
attention (the JAX package's models/llama.py).

- pre-norm **RMSNorm** (no centering, float32 statistics);
- **RoPE** on q and k (``ops/rope.py``), before the attention dispatch,
  so the flash kernel (K1) and the paged-decode kernel (K2) take rotated
  operands unchanged;
- **GQA**: ``num_kv_heads`` < ``num_heads`` (the default 12 over 4) shrinks
  the k/v projections and the paged KV pool by the group factor;
- **SwiGLU** MLP (bias-free ``gate`` / ``up`` / ``down``:
  ``down(silu(gate(x)) * up(x))``);
- an untied (D, V) ``lm_head``, bf16 operands with float32 accumulation
  and float32 logits in bf16 compute.

The defaults are the JAX package's ~110M single-card configuration
(vocab 32000, max_len 2048, width 768, 12 layers, 12 heads over 4 kv
heads, MLP 2048). Compute in ``dtype`` with float32 parameters, as flax's
``dtype=``. ``logits_mode="hidden"`` returns the final hidden states for
the fused chunked cross-entropy, which takes the head from
:meth:`Llama.head_params`. With ``decode=True`` and the paged fields set
the model serves over the paged KV pool (serving/engine.py), RoPE at each
row's ``row_lens + arange(seq)``; a ``seq > 1`` call is a prefill, or with
``verify=True`` (default ``paged_verify``) a speculative verify chunk.
With ``decode=True`` and no pool it decodes over a contiguous KV cache
that :meth:`Llama.init_cache` sizes (``train/generate.py``), RoPE at the
cache's cursor. ``remat`` recomputes each block in the backward pass.
LLaMA has no dropout, in JAX as here.

Parameter names are flax's (``tok_embed``, ``layers.<i>`` = ``layer_<i>``
with ``attn/{q,k,v,o}``, ``ln1``/``ln2`` ``scale``, ``mlp/{gate,up,
down}``, then ``final_ln`` and ``lm_head``), so :mod:`interop` maps one
tree onto the other. Not in it, and refused: mixture-of-experts blocks
and pipeline stages (ROADMAP.md item 15).

``tensor_parallel`` (a ``parallel.tensor_parallel.TensorParallel``) cuts
the attention heads (query and kv heads alike) and the SwiGLU's hidden
features over the tensor axis, ``gate`` / ``up`` column- and ``down``
row-parallel; where the tensor size divides the vocab (32000 does), the
token table and the head are vocab-parallel, as JAX's vocab rules place
them: each rank holds ``vocab / size`` rows of ``tok_embed`` and as many
columns of ``lm_head``, the lookup sums the ranks' rows
(``vocab_parallel_embedding``), and :meth:`Llama.head_shard` tells the
fused loss to run its vocab-parallel form (``ops/chunked_ce.py``); the
``full`` logits are gathered whole on every rank. ``remat`` and decoding
under it are refused (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from distributed_pytorch_example_tpu_torch.models.transformer import (
    MultiHeadAttention,
    _not_in_slice,
    clear_cache,
    column_row_dims,
    dense,
    init_cache,
    lecun_normal_,
    normal_,
    row_dense,
    run_blocks,
    tied_head_logits,
    tp_shard,
)
from distributed_pytorch_example_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
    copy_to_tensor,
    gather_from_tensor,
    vocab_parallel_embedding,
)
from distributed_pytorch_example_tpu_torch.runtime.device import resolve_device


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x²) + eps) * scale``: statistics and the scale in
    float32, the result in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.empty(dim))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.reciprocal(torch.sqrt(var + self.eps))
        return (y * self.scale.float()).to(self.dtype)


class SwiGluMlp(nn.Module):
    """``down(silu(gate(x)) * up(x))``, bias-free, in ``dtype``."""

    def __init__(self, mlp_dim: int, model_dim: int,
                 dtype: torch.dtype = torch.float32,
                 tensor_parallel: Optional[TensorParallel] = None):
        super().__init__()
        tp = tensor_parallel or TensorParallel()
        mlp_dim = tp.split(mlp_dim, "mlp_dim")
        self.tensor_parallel = tp
        self.tensor_dims = {
            name: dim for name, dim in column_row_dims(
                ("gate", "up"), ("down",), tp).items()
            if name.endswith(".weight")}
        self.dtype = dtype
        self.gate = nn.Linear(model_dim, mlp_dim, bias=False)
        self.up = nn.Linear(model_dim, mlp_dim, bias=False)
        self.down = nn.Linear(mlp_dim, model_dim, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("gate", "up", "down"):
            lecun_normal_(getattr(self, name).weight, generator,
                          shard=tp_shard(self, f"{name}.weight"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = copy_to_tensor(x, self.tensor_parallel)
        h = F.silu(dense(self.gate, x, dt)) * dense(self.up, x, dt)
        return row_dense(self.down, h, dt, self.tensor_parallel)


class LlamaBlock(nn.Module):
    """Pre-norm block: x + attn(ln1(x)), then + mlp(ln2(x)); causal
    attention with RoPE and GQA."""

    def __init__(self, num_heads: int, num_kv_heads: int, head_dim: int,
                 model_dim: int, mlp_dim: int, *, rope_theta: float = 10000.0,
                 layer_norm_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32,
                 tensor_parallel: Optional[TensorParallel] = None,
                 **attn_kw):
        super().__init__()
        self.attn = MultiHeadAttention(
            num_heads, head_dim, model_dim, causal=True, dtype=dtype,
            num_kv_heads=num_kv_heads, rope=True, rope_theta=rope_theta,
            tensor_parallel=tensor_parallel, **attn_kw)
        self.mlp = SwiGluMlp(mlp_dim, model_dim, dtype, tensor_parallel)
        self.ln1 = RMSNorm(model_dim, layer_norm_epsilon, dtype)
        self.ln2 = RMSNorm(model_dim, layer_norm_epsilon, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        self.ln1.reset_parameters()
        self.ln2.reset_parameters()

    def forward(self, x, *, page_table=None, row_lens=None, verify=False):
        x = x + self.attn(self.ln1(x), page_table=page_table,
                          row_lens=row_lens, verify=verify)
        return x + self.mlp(self.ln2(x))


class Llama(nn.Module):
    def __init__(
        self,
        vocab_size: int = 32000,
        max_len: int = 2048,
        model_dim: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        num_kv_heads: int = 4,
        mlp_dim: int = 2048,
        rope_theta: float = 10000.0,
        *,
        dtype: torch.dtype = torch.float32,
        use_flash: Optional[bool] = None,
        logits_mode: str = "full",
        decode: bool = False,
        paged_num_blocks: int = 0,
        paged_block_size: int = 16,
        paged_max_blocks: int = 0,
        paged_verify: bool = False,
        remat: bool = False,
        moe_experts: int = 0,
        pipe_axis: Optional[str] = None,
        seq_axis: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
        tensor_parallel: Optional[TensorParallel] = None,
    ):
        super().__init__()
        tp = tensor_parallel or TensorParallel()
        if tp.size > 1 and remat:
            raise NotImplementedError(
                "remat under tensor parallelism is not ported to the PyTorch "
                "package yet; see ROADMAP.md queue 1, item 11")
        if moe_experts:
            raise _not_in_slice("mixture-of-experts (moe_experts > 0, "
                                 "item 15)")
        if pipe_axis is not None:
            raise _not_in_slice("pipeline parallelism (pipe_axis)")
        if seq_axis is not None:
            raise _not_in_slice("sequence parallelism (seq_axis)")
        if logits_mode not in ("full", "hidden"):
            raise ValueError(
                f"logits_mode must be 'full' or 'hidden', got {logits_mode!r}"
            )
        if decode and logits_mode != "full":
            raise ValueError("decode mode requires logits_mode='full'")
        if paged_num_blocks > 0 and not decode:
            raise ValueError(
                "paged_num_blocks > 0 (paged KV cache) requires decode=True"
            )
        dev = resolve_device(device)
        self.vocab_size, self.max_len, self.model_dim = vocab_size, max_len, model_dim
        self.num_layers, self.num_heads = num_layers, num_heads
        self.num_kv_heads = num_kv_heads
        self.dtype, self.logits_mode, self.remat = dtype, logits_mode, remat
        self.decode = decode
        self.paged_num_blocks = paged_num_blocks
        self.paged_block_size = paged_block_size
        self.paged_max_blocks = paged_max_blocks
        self.paged_verify = paged_verify
        self.tensor_parallel = tp
        # JAX's vocab rules: the vocab on 'tensor' where the size divides it
        vocab_parallel = tp.size > 1 and vocab_size % tp.size == 0
        local_vocab = vocab_size // tp.size if vocab_parallel else vocab_size
        self.vocab_start = tp.index * local_vocab if vocab_parallel else 0
        self.tensor_dims = ({"tok_embed.weight": 0, "lm_head": 1}
                            if vocab_parallel else {})
        with torch.device("meta"):
            self.tok_embed = nn.Embedding(local_vocab, model_dim)
            self.layers = nn.ModuleList(
                LlamaBlock(num_heads, num_kv_heads, model_dim // num_heads,
                           model_dim, mlp_dim, rope_theta=rope_theta,
                           dtype=dtype, use_flash=use_flash, decode=decode,
                           paged_num_blocks=paged_num_blocks,
                           paged_block_size=paged_block_size,
                           paged_max_blocks=paged_max_blocks,
                           tensor_parallel=tp)
                for _ in range(num_layers)
            )
            self.final_ln = RMSNorm(model_dim, 1e-5, dtype)
            self.lm_head = nn.Parameter(torch.empty(model_dim, local_vocab))
        self.to_empty(device=dev)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.lm_head.device

    def head_params(self):
        """The untied head as the fused loss's (V, D) table, no bias (under
        vocab parallelism this rank's rows of it)."""
        return self.lm_head.t(), None

    def head_shard(self):
        """``(TensorParallel, first vocab id)`` of a head sharded over the
        vocab (the fused loss then runs its vocab-parallel form), or None
        when the head is whole."""
        if not self.tensor_dims:
            return None
        return self.tensor_parallel, self.vocab_start

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: N(0, 0.02) token table and head,
        lecun-normal projections, zero attention biases, unit RMSNorm
        scales."""
        normal_(self.tok_embed.weight, 0.02, generator,
                shard=tp_shard(self, "tok_embed.weight"))
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.final_ln.reset_parameters()
        normal_(self.lm_head, 0.02, generator, shard=tp_shard(self, "lm_head"))

    def init_cache(self, batch: int, length: int) -> None:
        """Size a fresh contiguous KV cache (``decode=True`` without the
        pool) for ``batch`` rows of ``length`` positions."""
        init_cache(self, batch, length)

    def clear_cache(self) -> None:
        clear_cache(self)

    def forward(self, tokens: torch.Tensor, *,
                page_table: Optional[torch.Tensor] = None,
                row_lens: Optional[torch.Tensor] = None,
                verify: Optional[bool] = None) -> torch.Tensor:
        """(B, S) int tokens -> (B, S, vocab) float32 logits, or the
        (B, S, D) final hidden states in ``dtype`` when
        ``logits_mode="hidden"``."""
        if self.paged_num_blocks and row_lens is None:
            raise ValueError("paged decode needs row_lens (and page_table)")
        if verify is None:
            verify = self.paged_verify
        shard = self.head_shard()
        if shard is None:
            x = self.tok_embed(tokens)
        else:
            x = vocab_parallel_embedding(self.tok_embed.weight, tokens,
                                         *shard)
        x = run_blocks(self.layers, x.to(self.dtype), self.remat,
                       page_table=page_table, row_lens=row_lens,
                       verify=verify)
        x = self.final_ln(x)
        if self.logits_mode == "hidden":
            return x
        if shard is None:
            return tied_head_logits(x, self.head_params()[0], self.dtype)
        x = copy_to_tensor(x, self.tensor_parallel)
        return gather_from_tensor(
            tied_head_logits(x, self.head_params()[0], self.dtype),
            self.tensor_parallel)
