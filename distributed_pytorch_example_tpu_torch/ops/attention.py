"""Multi-head scaled-dot-product attention with kernel dispatch.

Single entry point for the port's transformers. Layout convention:
(batch, seq, heads, head_dim) — "BSNH", the JAX package's layout, kept at
the public functions so tests compare like with like.

The plain path is ``_plain_attention``, the JAX package's
``_xla_attention`` in torch: float32 softmax, ``finfo(float32).min``
masking, GQA by repeating kv heads, and zeroed dead rows under
``kv_mask``. The JAX package leaves this work to XLA, so plain matmuls
are the counterpart here. The flash kernel (K1) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    kv_mask: Optional[torch.Tensor],
    causal: bool,
    softmax_scale: float,
) -> torch.Tensor:
    """Reference attention in plain torch ops. q: (B, S, N, H); k/v may
    have fewer heads (GQA) as long as N divides by them."""
    if k.shape[2] != q.shape[2]:  # GQA: broadcast kv heads across groups
        group = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    logits = torch.einsum("bqnh,bknh->bnqk", q, k) * softmax_scale
    # Upcast the softmax: bf16 logits lose too much precision in the reduce.
    logits = logits.float()
    fill = torch.finfo(torch.float32).min
    if causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        causal_mask = torch.ones(
            (q_len, k_len), dtype=torch.bool, device=q.device
        ).tril(k_len - q_len)
        logits = logits.masked_fill(~causal_mask, fill)
    if mask is not None:
        # mask: broadcastable to (B, N, Q, K); True = attend.
        logits = logits.masked_fill(~mask.bool(), fill)
    if kv_mask is not None:
        # kv_mask: (B, K) key-padding validity; True/nonzero = attend.
        logits = logits.masked_fill(~kv_mask.bool()[:, None, None, :], fill)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknh->bqnh", weights.to(v.dtype), v)
    if kv_mask is not None:
        # batch rows with NO valid key: softmax over all-min logits yields
        # a uniform average of V; emit zeros instead (the flash kernel's
        # fully-padded behaviour)
        any_valid = kv_mask.bool().any(dim=-1)
        out = torch.where(any_valid[:, None, None, None], out, 0)
    return out


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Scaled dot-product attention, (B, S, N, H) in and out.

    Args:
      mask: optional boolean mask broadcastable to (B, N, Q, K); True=attend.
      kv_mask: optional (B, K) key-padding validity; True=attend.
      causal: apply a causal mask (decoder LM).
      use_flash: ``True`` asks for the flash kernel, which this port does
        not have yet and refuses; ``None``/``False`` take the plain path.
    """
    if use_flash:
        raise NotImplementedError(
            "use_flash=True: the flash-attention kernel (K1, "
            "ops/pallas/flash_attention.py) is not ported yet; see "
            "ROADMAP.md queue 2, K1"
        )
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    return _plain_attention(q, k, v, mask, kv_mask, causal, softmax_scale)
