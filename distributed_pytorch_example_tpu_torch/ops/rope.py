"""Rotary position embeddings (RoPE), rotate-half formulation (the JAX
package's ops/rope.py).

Each (q, k) head-dim pair is rotated by a position-dependent angle: the
head dim splits in halves (x1, x2), rotated as (x1·cos − x2·sin,
x2·cos + x1·sin) with frequencies theta^(−2i/d). Applied to q and k before
the attention dispatch, so the flash kernel (K1) and the paged-decode
kernel (K2) take rotated operands unchanged. Angles and the rotation are
float32 whatever the compute dtype; the result is cast back to x's dtype.

In JAX this is XLA code outside any Pallas kernel, so plain torch is its
port.
"""

from __future__ import annotations

from typing import Optional

import torch


def rope(x: torch.Tensor, positions: Optional[torch.Tensor] = None,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotate (B, S, N, H) queries or keys by their positions.

    ``positions``: (S,) positions shared across the batch, or (B, S)
    per-row positions (paged serving: each row sits at its own offset);
    default ``arange(S)``.
    """
    head_dim = x.shape[-1]
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    half = head_dim // 2
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[..., None] * freqs  # (S, half) or (B, S, half)
    if positions.dim() == 1:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
