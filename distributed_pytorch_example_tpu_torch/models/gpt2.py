"""GPT-2 (124M by default) decoder LM — the JAX package's models/gpt2.py.

Pre-LN causal transformer: token + learned position embeddings -> pre-LN
blocks with causal attention -> final LN (eps 1e-5) -> logits via the tied
token-embedding matrix. Compute in ``dtype`` (float32 or bfloat16) with
float32 parameters, as flax's ``dtype=``; without pipeline stages and
without MoE. Attention auto-selects the flash kernel (K1) on the card
where its shapes allow (``use_flash=None``). ``dropout_rate`` drops after
the embeddings and after each block's attention and MLP in training
(``transformer.dropout``; the train step keys the masks through
:meth:`GPT2.fold_in`), and ``remat`` recomputes each block in the backward
pass.

``logits_mode="hidden"`` returns the final hidden states instead of
logits, for the fused chunked cross-entropy (``ops/chunked_ce.py``), which
takes the tied head from :meth:`GPT2.head_params`.

With ``decode=True`` and ``paged_num_blocks > 0`` the model serves over
the paged KV pool (serving/engine.py): each call takes the engine's
``page_table`` / ``row_lens``, and the learned position table is gathered
per row at ``row_lens + arange(seq)``, clamped to ``max_len - 1``. A
``seq > 1`` call is a prefill, or with ``verify=True`` (default
``paged_verify``) a speculative verify chunk. With ``decode=True`` and no
pool the model decodes over a contiguous KV cache that
:meth:`GPT2.init_cache` sizes (``train/generate.py``); the position table
is read from a cursor that advances with it.

Weights are drawn on the CPU from an explicit generator (``seed``) and
copied to ``device``, so the same seed gives the same weights everywhere.

``tensor_parallel`` (a ``parallel.tensor_parallel.TensorParallel``) cuts
every block's attention heads and MLP over the tensor axis (``models/
transformer.py``); the token table, which the head reuses, and the
position table stay whole on every rank, as JAX's vocab rule leaves
GPT-2's odd vocab of 50257 (the head's logits are the same on every
rank). Dropout, ``remat``, decoding and a vocab the tensor size divides
(which JAX's vocab rule would cut) are refused under it (ROADMAP.md
queue 1, item 11).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from distributed_pytorch_example_tpu_torch.models.transformer import (
    DropoutDraws,
    TransformerStack,
    _not_in_slice,
    clear_cache,
    dropout,
    init_cache,
    layer_norm,
    normal_,
    tied_head_logits,
)
from distributed_pytorch_example_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
)
from distributed_pytorch_example_tpu_torch.runtime.device import resolve_device


class GPT2(nn.Module):
    def __init__(
        self,
        vocab_size: int = 50257,
        max_len: int = 1024,
        model_dim: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        mlp_dim: int = 3072,
        *,
        use_flash: Optional[bool] = None,
        dtype: torch.dtype = torch.float32,
        logits_mode: str = "full",
        decode: bool = False,
        paged_num_blocks: int = 0,
        paged_block_size: int = 16,
        paged_max_blocks: int = 0,
        dropout_rate: float = 0.0,
        pipe_axis: Optional[str] = None,
        paged_verify: bool = False,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
        tensor_parallel: Optional[TensorParallel] = None,
        **stack_kw,
    ):
        super().__init__()
        tp = tensor_parallel or TensorParallel()
        if tp.size > 1 and (dropout_rate or stack_kw.get("remat")
                            or vocab_size % tp.size == 0):
            raise NotImplementedError(
                "dropout, remat and a tied vocab-parallel table (a vocab "
                "the tensor size divides) under tensor parallelism are not "
                "ported to the PyTorch package yet; see ROADMAP.md queue 1, "
                "item 11")
        self.tensor_parallel = tp
        if paged_num_blocks > 0 and not decode:
            raise ValueError(
                "paged_num_blocks > 0 (paged KV cache) requires decode=True"
            )
        if pipe_axis is not None:
            raise _not_in_slice("pipeline parallelism (pipe_axis)")
        if logits_mode not in ("full", "hidden"):
            raise ValueError(
                f"logits_mode must be 'full' or 'hidden', got {logits_mode!r}"
            )
        if decode and logits_mode != "full":
            raise ValueError("decode mode requires logits_mode='full'")
        dev = resolve_device(device)
        self.vocab_size, self.max_len, self.model_dim = vocab_size, max_len, model_dim
        self.num_layers, self.num_heads = num_layers, num_heads
        self.dtype, self.logits_mode = dtype, logits_mode
        self.decode = decode
        self.paged_num_blocks = paged_num_blocks
        self.paged_block_size = paged_block_size
        self.paged_max_blocks = paged_max_blocks
        self.paged_verify = paged_verify
        self.pos_index = 0  # the contiguous cache's position cursor
        self.dropout_rate = dropout_rate
        self.draws = DropoutDraws(seed)
        # build without storage, then materialise once on the device
        with torch.device("meta"):
            self.wte = nn.Embedding(vocab_size, model_dim)
            self.wpe = nn.Parameter(torch.empty(1, max_len, model_dim))
            self.decoder = TransformerStack(
                num_layers, num_heads, model_dim // num_heads, model_dim,
                mlp_dim, causal=True, layer_norm_epsilon=1e-5, dtype=dtype,
                use_flash=use_flash, decode=decode,
                paged_num_blocks=paged_num_blocks,
                paged_block_size=paged_block_size,
                paged_max_blocks=paged_max_blocks, dropout_rate=dropout_rate,
                tensor_parallel=tp, **stack_kw,
            )
            self.final_ln = nn.LayerNorm(model_dim, eps=1e-5)
        self.to_empty(device=dev)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.wpe.device

    def fold_in(self, step: int) -> None:
        """Key this train step's dropout masks from (seed, step)."""
        self.draws.fold_in(step)

    def head_params(self):
        """Tied LM-head weights for the fused loss: ((V, D) table, bias)."""
        return self.wte.weight, None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: N(0, 0.02) token table, N(0, 0.01) position
        table, lecun-normal projections, zero biases, unit LayerNorms."""
        normal_(self.wte.weight, 0.02, generator)
        normal_(self.wpe, 0.01, generator)
        self.decoder.reset_parameters(generator)
        self.final_ln.reset_parameters()

    def init_cache(self, batch: int, length: int) -> None:
        """Size a fresh contiguous KV cache (``decode=True`` without the
        pool) for ``batch`` rows of ``length`` positions."""
        init_cache(self, batch, length)
        self.pos_index = 0

    def clear_cache(self) -> None:
        clear_cache(self)
        self.pos_index = 0

    def forward(self, tokens: torch.Tensor, *,
                page_table: Optional[torch.Tensor] = None,
                row_lens: Optional[torch.Tensor] = None,
                verify: Optional[bool] = None) -> torch.Tensor:
        """(B, S) int tokens -> (B, S, vocab) float32 logits, or the
        (B, S, D) final hidden states in ``dtype`` when
        ``logits_mode="hidden"``."""
        seq = tokens.shape[1]
        if verify is None:
            verify = self.paged_verify
        if self.decode and not self.paged_num_blocks:
            # the position cursor mirrors the attention caches' cursors;
            # the slice start is clamped into the table as JAX's
            # dynamic_slice clamps it
            start = min(self.pos_index, self.max_len - seq)
            pos = self.wpe[:, start:start + seq]
            self.pos_index += seq
        elif self.decode:
            if row_lens is None:
                raise ValueError("paged decode needs row_lens (and page_table)")
            # rows sit at independent offsets: gather the learned position
            # table per row from the engine-owned row_lens
            positions = row_lens[:, None].long() + torch.arange(
                seq, device=tokens.device
            )
            pos = self.wpe[0][positions.clamp(max=self.max_len - 1)]
        else:
            pos = self.wpe[:, :seq]
        x = self.wte(tokens).to(self.dtype) + pos.to(self.dtype)
        draw = (self.draws.next() if self.training and self.dropout_rate
                else None)
        x = dropout(x, self.dropout_rate, draw, (0, 0))
        x = self.decoder(x, page_table=page_table, row_lens=row_lens,
                         draw=draw, verify=verify)
        x = layer_norm(self.final_ln, x, self.dtype)
        if self.logits_mode == "hidden":
            return x
        return tied_head_logits(x, self.wte.weight, self.dtype)
