"""Chunked (vocab-blockwise) softmax cross-entropy for LM heads.

The counterpart of the JAX package's ``ops/chunked_ce.py``: the tied-head
matmul fused with the cross-entropy, streamed over vocabulary blocks, so
the (N, V) float32 logits never exist at once (~3.3 GB at GPT-2's 16 x
1024 tokens x 50257).

- forward: one (N, D) x (D, Vb) product per block (operands in ``dtype``,
  float32 accumulation and float32 logits), a running max / logsumexp, the
  target logit, and a streaming first-occurrence argmax for accuracy.
- backward (``torch.autograd.Function``): recomputes each block's logits,
  forms ``(softmax - onehot) * g`` per block, accumulates ``dx`` across
  blocks and writes each block's (Vb, D) slice of the embedding gradient
  once. The backward's products also take their operands in ``dtype``
  (on the TPU, JAX's default-precision float32 matmul rounds its operands
  to bf16 the same way); with ``dtype=float32`` it is float32 throughout.

In JAX this is XLA code, not a Pallas kernel, so plain torch is its port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

DEFAULT_BLOCK = 4096


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) with float32 accumulation and a float32 result.

    bf16 operands on the card go to cuBLAS with a float32 output; on the CPU
    they are widened first (bf16 values are exact in float32)."""
    if a.dtype == torch.float32:
        return torch.mm(a, b.float())
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _blocks(vocab: int, block_size: int):
    """(offset, width) spans covering [0, vocab); the last may be narrow."""
    return [(off, min(block_size, vocab - off))
            for off in range(0, vocab, block_size)]


def _block_logits(x, embedding, bias, off, width, dtype):
    logits = _mm_f32(x, embedding[off:off + width].to(dtype).t())
    if bias is not None:
        logits = logits + bias[off:off + width].float()
    return logits


def _target_in_block(targets, off, width):
    """(rows whose target lies in the block, the target's column there)."""
    hit = (targets >= off) & (targets < off + width)
    return hit, (targets - off).clamp(0, width - 1)


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, embedding, bias, targets, block_size, dtype):
        n = x.shape[0]
        dev = x.device
        m = torch.full((n,), float("-inf"), device=dev)
        s = torch.zeros(n, device=dev)
        tl = torch.zeros(n, device=dev)
        best_v = torch.full((n,), float("-inf"), device=dev)
        best_i = torch.zeros(n, dtype=torch.long, device=dev)
        for off, width in _blocks(embedding.shape[0], block_size):
            logits = _block_logits(x, embedding, bias, off, width, dtype)
            hit, col = _target_in_block(targets, off, width)
            tl = tl + torch.where(hit, logits.gather(1, col[:, None])[:, 0],
                                  0.0)
            bm, bi = logits.max(dim=1)
            nm = torch.maximum(m, bm)
            s = s * torch.exp(m - nm) + torch.exp(logits - nm[:, None]).sum(1)
            m = nm
            # strict > keeps the first occurrence across blocks
            better = bm > best_v
            best_v = torch.where(better, bm, best_v)
            best_i = torch.where(better, bi + off, best_i)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, embedding, bias, targets, lse)
        ctx.block_size, ctx.dtype = block_size, dtype
        ctx.mark_non_differentiable(best_i)
        return lse - tl, best_i

    @staticmethod
    def backward(ctx, g_loss, _g_argmax):
        x, embedding, bias, targets, lse = ctx.saved_tensors
        dtype = ctx.dtype
        g = g_loss.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        de = torch.empty(embedding.shape, dtype=torch.float32,
                         device=x.device)
        db = None if bias is None else torch.empty(
            bias.shape, dtype=torch.float32, device=x.device)
        for off, width in _blocks(embedding.shape[0], ctx.block_size):
            logits = _block_logits(x, embedding, bias, off, width, dtype)
            gmat = torch.exp(logits - lse[:, None])
            hit, col = _target_in_block(targets, off, width)
            rows = torch.nonzero(hit)[:, 0]
            gmat[rows, col[rows]] -= 1.0
            gmat *= g[:, None]
            e_blk = embedding[off:off + width].to(dtype)
            gd = gmat.to(dtype)
            dx += _mm_f32(gd, e_blk)
            de[off:off + width] = _mm_f32(gd.t(), x)
            if db is not None:
                db[off:off + width] = gmat.sum(0)
        return (dx.to(x.dtype), de.to(embedding.dtype),
                None if db is None else db.to(bias.dtype), None, None, None)


def chunked_softmax_xent(
    hidden: torch.Tensor,
    embedding: torch.Tensor,
    targets: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    block_size: int = DEFAULT_BLOCK,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused tied-head matmul + softmax cross-entropy, blockwise over vocab.

    Args:
      hidden: (..., D) final hidden states (any leading dims).
      embedding: (V, D) tied embedding / LM-head matrix.
      targets: (...) int target token ids, same leading dims as ``hidden``.
      bias: optional (V,) logit bias.
      block_size: vocab block width; peak live logits are (N, block) f32.
      dtype: matmul operand dtype; accumulation is always float32.

    Returns:
      ``(loss, argmax)``: per-position float32 cross-entropy of shape (...)
      and the int64 argmax token id per position, equal to the dense
      cross-entropy / argmax of the float32 logits.
    """
    lead = hidden.shape[:-1]
    dim = hidden.shape[-1]
    if embedding.shape[-1] != dim:
        raise ValueError(
            f"hidden dim {dim} != embedding dim {embedding.shape[-1]}"
        )
    if tuple(targets.shape) != tuple(lead):
        raise ValueError(
            f"targets shape {tuple(targets.shape)} != hidden leading dims "
            f"{tuple(lead)}"
        )
    x = hidden.reshape(-1, dim).to(dtype)
    t = targets.reshape(-1).long()
    loss, argmax = _ChunkedXent.apply(x, embedding, bias, t, int(block_size),
                                      dtype)
    return loss.reshape(lead), argmax.reshape(lead)
