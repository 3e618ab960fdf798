"""Multi-head scaled-dot-product attention with kernel dispatch.

Single entry point for the port's transformers. Layout convention:
(batch, seq, heads, head_dim) — "BSNH", the JAX package's layout, kept at
the public functions so tests compare like with like.

The plain path is ``_plain_attention``, the JAX package's
``_xla_attention`` in torch: float32 softmax, ``finfo(float32).min``
masking, GQA by repeating kv heads, and zeroed dead rows under
``kv_mask``. The flash path is ``ops.flash_attention.flash_attention``,
whose CUDA kernels (K1) are the port of the TPU's Pallas flash kernel.
The dispatch rule is the JAX package's with "on TPU" read as "on a CUDA
tensor": a CPU tensor takes the plain path, as JAX off the TPU takes XLA.

The JAX package also has a head-major "fused projection layout"
(``fused_layout_eligible`` / ``_fused_layout_attention``) that saves XLA
a transpose around its (B, N, S, H) kernel. The port's kernel reads the
(B, S, N, H) projections through their strides, so there is no transpose
to avoid and no counterpart here; the q/k/v/o parameter names are the
same either way.

FLOPs. Inside :func:`count_flops` (one train or eval step a run, for the
cost record of ``telemetry/cost.py``) attention is counted by one formula
whichever path runs, and its own products are hidden from torch's FLOP
counter: the kernel's work is a ctypes launch the counter cannot see, and
the plain path would count at the full S x S. Per live (query, key) pair
and head dimension: the forward's two products (2 x 2 FLOPs) and the
backward's logits recompute plus its four products (5 x 2), only where
the backward runs. A causal call counts the lower triangle, a key mask
its live keys.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Iterator, List, Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes

from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    flash_attention,
)


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


_FWD_PRODUCTS, _BWD_PRODUCTS = 2, 5
_tally: Optional[List[int]] = None


@contextlib.contextmanager
def count_flops() -> Iterator[List[int]]:
    """``[flops]``: attention's FLOPs by the module's formula over the
    calls inside the block."""
    global _tally
    outer, _tally = _tally, [0]
    try:
        yield _tally
    finally:
        _tally = outer


def live_pairs(q_len: int, k_len: int, batch: int, heads: int,
               causal: bool, kv_mask: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> int:
    """(query, key) pairs attended over the batch and the query heads: the
    causal lower triangle (bottom-right aligned), a key mask's live keys,
    a general mask's True entries."""
    if mask is not None:
        live = mask.bool().cpu().expand(batch, heads, q_len, k_len)
        if causal:
            live = live & torch.ones((q_len, k_len), dtype=torch.bool).tril(
                k_len - q_len)
        if kv_mask is not None:
            live = live & kv_mask.bool().cpu()[:, None, None, :]
        return int(live.sum())
    # queries that may attend key j: i >= j - (k_len - q_len) under causal
    first = (torch.arange(k_len) - (k_len - q_len)).clamp(min=0)
    per_key = ((q_len - first).clamp(0, q_len) if causal
               else torch.full((k_len,), q_len))
    if kv_mask is None:
        return batch * heads * int(per_key.sum())
    return heads * int((kv_mask.bool().cpu().long() * per_key).sum())


def _keep(t):
    return t


class _Counted(torch.autograd.Function):
    """Runs ``fn(q, k, v)`` and its backward out of sight of the dispatch
    modes (torch's FLOP counter), adding the formula's backward FLOPs when
    the backward runs."""

    @staticmethod
    def forward(ctx, fn, bwd_flops, q, k, v):
        # the inner graph keeps its own saved tensors, whatever hooks an
        # enclosing activation checkpoint (remat) has pushed
        with _disable_current_modes(), torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            ctx.inputs = [t.detach().requires_grad_(t.requires_grad)
                          for t in (q, k, v)]
            ctx.out = fn(*ctx.inputs)
        ctx.bwd_flops = bwd_flops
        return ctx.out.detach()

    @staticmethod
    def backward(ctx, grad):
        if _tally is not None:
            _tally[0] += ctx.bwd_flops
        wanted = [t for t in ctx.inputs if t.requires_grad]
        with _disable_current_modes():
            got = iter(torch.autograd.grad(ctx.out, wanted, grad))
        return (None, None) + tuple(next(got) if t.requires_grad else None
                                    for t in ctx.inputs)


def _counted(fn, q, k, v, causal, kv_mask=None, mask=None):
    """``fn(q, k, v)``, counted by the formula (see the module doc)."""
    pairs = live_pairs(q.shape[1], k.shape[1], q.shape[0], q.shape[2],
                       causal, kv_mask, mask)
    per_product = 2 * q.shape[-1] * pairs
    _tally[0] += _FWD_PRODUCTS * per_product
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Counted.apply(fn, _BWD_PRODUCTS * per_product, q, k, v)
    with _disable_current_modes():
        return fn(q, k, v)


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
        General masks take the plain path (flash does not stream them).
      kv_mask: optional (B, K) key-padding validity; True=attend. The flash
        kernel takes it.
      causal: apply a causal mask (decoder LM).
      use_flash: force (True/False) or auto-select (None) the flash kernel.
    """
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])

    if use_flash is None:
        # flash only where the kernel serves the shapes natively; a
        # misaligned sequence (ViT's 197 tokens) takes the plain path, as
        # in JAX, where lane-padding it into flash measured slower
        use_flash = _flash_unsupported_reason(q, k, v, mask, causal) is None
    elif use_flash:
        reason = _flash_unsupported_reason(q, k, v, mask, causal)
        if reason is not None:
            if _only_seq_misaligned(q, k, v, mask, causal):
                # explicit opt-in: serve seq % 128 != 0 by padding (pad
                # keys masked out, pad-query outputs sliced off; their
                # cotangents are zero, so grads stay exact)
                return _flash_lane_padded(q, k, v, kv_mask, causal,
                                          softmax_scale)
            # forced flash must not silently degrade: say why it cannot
            raise ValueError(
                f"use_flash=True but the flash kernel does not support this "
                f"call: {reason}. Use use_flash=None to auto-select."
            )
    if use_flash:
        def run(q, k, v):
            return flash_attention(q, k, v, causal=causal, kv_mask=kv_mask,
                                   softmax_scale=softmax_scale)
    else:
        def run(q, k, v):
            return _plain_attention(q, k, v, mask, kv_mask, causal,
                                    softmax_scale)
    if _tally is not None:
        return _counted(run, q, k, v, causal, kv_mask, mask)
    return run(q, k, v)


def _only_seq_misaligned(q, k, v, mask, causal) -> bool:
    """True when sequence alignment is the ONLY flash blocker (self-
    attention with seq % 128 != 0) — the case padding can serve."""
    seq_q, seq_k = q.shape[1], k.shape[1]
    if seq_q != seq_k or seq_q % 128 == 0:
        return False
    padded = seq_q + (-seq_q % 128)
    probe = SimpleNamespace(shape=(q.shape[0], padded, *q.shape[2:]),
                            dtype=q.dtype, is_cuda=q.is_cuda)
    kprobe = SimpleNamespace(shape=(k.shape[0], padded, *k.shape[2:]))
    return _flash_unsupported_reason(probe, kprobe, kprobe, mask,
                                     causal) is None


def _flash_lane_padded(q, k, v, kv_mask, causal, softmax_scale):
    """Flash on a sequence padded to a multiple of 128: pad keys masked,
    pad queries discarded. Exact for the real positions (fully-padded rows
    emit zero output and zero gradients — the kernel's kv_mask contract).
    Reached only through an explicit ``use_flash=True``."""
    seq = q.shape[1]
    pad = -seq % 128
    valid = (torch.ones(q.shape[0], seq, dtype=torch.bool, device=q.device)
             if kv_mask is None else kv_mask.bool())
    mask_p = torch.nn.functional.pad(valid, (0, pad))

    def pad_seq(t):
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))

    out = flash_attention(pad_seq(q), pad_seq(k), pad_seq(v), causal=causal,
                          kv_mask=mask_p, softmax_scale=softmax_scale)
    return out[:, :seq]


def _flash_unsupported_reason(q, k, v, mask, causal) -> Optional[str]:
    """None if the flash kernel can serve this call, else a human reason."""
    if mask is not None:
        return "custom masks are not implemented in the flash kernel"
    seq_q, seq_k, head_dim = q.shape[1], k.shape[1], q.shape[-1]
    if causal and seq_q != seq_k:
        # flash causal masking is top-left (row >= col) aligned; the plain
        # path is bottom-right aligned — they agree only for seq_q == seq_k
        return f"causal with seq_q != seq_k ({seq_q} != {seq_k})"
    if q.shape[2] % k.shape[2]:
        return (
            f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}"
        )
    if not q.is_cuda:
        return "flash kernel is CUDA-only"
    if seq_q % 128 or seq_k % 128:
        return f"seq lengths ({seq_q}, {seq_k}) not multiples of 128"
    if head_dim not in HEAD_DIMS:
        return f"head_dim {head_dim} not in {HEAD_DIMS}"
    if q.dtype not in (torch.float32, torch.bfloat16):
        return f"dtype {q.dtype} not in (float32, bfloat16)"
    return None
