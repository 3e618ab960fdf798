"""Flash attention: the CUDA kernels, their plain versions, the autograd op.

- :func:`flash_attention_fwd` launches the forward kernel of
  ``csrc/flash_attention.cu`` (o and the float32 logsumexp);
  :func:`flash_attention_bwd` launches its backward (for bf16 the dq
  kernel, which also writes delta, then the dk/dv kernel; for float32
  delta, dq and dk/dv). They are the Hopper port of the TPU
  kernels in ``distributed_pytorch_example_tpu/ops/pallas/
  flash_attention.py`` (``_fwd`` / ``_fwd_single`` and ``_bwd`` /
  ``_bwd_single`` / ``_bwd_split``). Each launch adds one to
  ``flash_attention_fwd.launches`` or ``flash_attention_bwd.launches``.
- :func:`flash_attention_fwd_reference` and
  :func:`flash_attention_bwd_reference` are the plain versions of the same
  math: the forward is the TPU kernel's one-tile softmax, the backward the
  explicit formula (p recomputed from lse, dv = pᵀ·dO, dp = dO·vᵀ,
  ds = p ∘ (dp − delta), dq = ds·k·scale, dk = dsᵀ·q·scale), not autograd
  through the forward. CPU tensors and the tests use them.
- :func:`flash_attention` is the ``torch.autograd.Function`` the model
  calls: (B, S, N, H) in and out. On CUDA tensors it launches the kernels
  or raises; it never computes a CUDA call another way.

delta, the softmax backward's row term, is rowsum(dO ∘ O) in exact
arithmetic; the TPU kernel takes it from its bf16 output O. Here it is
rowsum(p ∘ dp), from the very p and dp that form ds, so each row of ds
sums to 0 to float32 rounding. Where every key's v is nearly the same (a
deep post-LN encoder at initialisation, BERT-base's upper layers), dp −
delta is a small difference that the bf16 O's rounding shifts by a
constant per row; dq and dk then gain a component along the keys' and
queries' shared direction, and BERT-base's layer-11 q/k kernel
gradients came out 1.9x their norm off a float32 step (plain bf16
attention: 4.7e-2; ``PERF.md``).

Semantics (the TPU kernel's): float32 logits, top-left causal mask
(row >= col), ``NEG_INF = -1e30`` as the masked logit, p cast to v's dtype
before p·v, float32 accumulation, GQA query head n reading kv head
n // group, and a row with no valid key giving output 0, lse NEG_INF and
zero gradients.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from distributed_pytorch_example_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def _kernel_fn(name: str):
    fn = getattr(_build.load_library("flash_attention"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "dpx_flash_tile":
            fn.argtypes = [i, i]
        else:
            n_ptr = 6 if name == "dpx_flash_fwd" else 11
            fn.argtypes = ([i, i] + [p] * n_ptr + [i] * 5
                           + [p, ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
    return fn


def kernel_tile(dtype: torch.dtype, head_dim: int) -> int:
    """Rows per tile in the kernels, read from the library
    (``dpx_flash_tile``): bf16 128, or 64 at head_dim 256; float32 64, or
    32 at head_dim 128 and 256. Sequence lengths must divide by it. Builds
    the library at first use; takes a dtype and head_dim the kernels
    serve."""
    return _kernel_fn("dpx_flash_tile")(_DTYPE_CODES[dtype], head_dim)


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """A (B, S, heads, H) operand the kernel reads or writes through its
    strides: on q's CUDA device, q's dtype, head dimension contiguous, rows
    on 16-byte boundaries."""
    if not t.is_cuda:
        raise ValueError(
            f"flash_attention: {name} is on {t.device}, not a CUDA device "
            "(the kernel is CUDA-only; CPU tensors take the plain version)"
        )
    if t.device != like.device:
        raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                         f"{like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"flash_attention: {name} is {t.dtype}, q is "
                         f"{like.dtype}")
    if t.dim() != 4:
        raise ValueError(f"flash_attention: {name} must be (B, S, heads, H), "
                         f"got {tuple(t.shape)}")
    vec = 16 // t.element_size()
    if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or (
        t.data_ptr() % 16
    ):
        raise ValueError(
            f"flash_attention: {name} needs a contiguous head dimension and "
            f"16-byte aligned rows, got strides {t.stride()}"
        )


def _check_kernel_inputs(q, k, v, kv_mask):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t, q)
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"flash_attention: dtype {q.dtype} not in float32/bfloat16"
        )
    batch, seq_q, heads, head_dim = q.shape
    seq_k, kv_heads = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != batch or k.shape[3] != head_dim:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} do not match"
        )
    if head_dim not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head_dim {head_dim} not in {HEAD_DIMS}"
        )
    if heads % kv_heads:
        raise ValueError(
            f"flash_attention: {heads} heads over {kv_heads} kv heads"
        )
    tile = kernel_tile(q.dtype, head_dim)
    if seq_q % tile or seq_k % tile:
        raise ValueError(
            f"flash_attention: seq lengths ({seq_q}, {seq_k}) must be "
            f"multiples of the kernel tile {tile}"
        )
    if kv_mask is not None and (
        kv_mask.dtype != torch.float32 or kv_mask.shape != (batch, seq_k)
        or not kv_mask.is_contiguous() or kv_mask.device != q.device
    ):
        raise ValueError(
            "flash_attention: kv_mask must be a contiguous (B, S_k) float32 "
            "tensor on q's device"
        )


def _strides(*tensors) -> "ctypes.Array":
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    kv_mask: Optional[torch.Tensor],
    softmax_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel on the card: ``(o (B, Sq, N, H), lse (B, N, Sq)
    float32)``. ``kv_mask`` is a (B, Sk) float32 0/1 tensor or None.

    Launches on the current stream without synchronising. Raises on any
    input the kernel does not take, on a failed build and on a refused
    launch; it never computes the result another way.
    """
    _check_kernel_inputs(q, k, v, kv_mask)
    batch, seq_q, heads, head_dim = q.shape
    seq_k, kv_heads = k.shape[1], k.shape[2]
    fn = _kernel_fn("dpx_flash_fwd")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32,
                      device=q.device)
    strides = _strides(q, k, v, o)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], head_dim, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(kv_mask), o.data_ptr(), lse.data_ptr(),
            batch, heads, kv_heads, seq_q, seq_k, strides,
            float(softmax_scale), int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool,
    kv_mask: Optional[torch.Tensor],
    softmax_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward kernels on the card: ``(dq, dk, dv)`` shaped like q, k, v.
    One call launches two kernels for bf16 (dq with delta, then dk/dv) or
    three for float32 (delta, dq, dk/dv) and counts once."""
    _check_kernel_inputs(q, k, v, kv_mask)
    _check_rows("o", o, q)
    _check_rows("do", do, q)
    batch, seq_q, heads, head_dim = q.shape
    seq_k, kv_heads = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: o and do must be shaped like q")
    if (lse.dtype != torch.float32 or lse.shape != (batch, heads, seq_q)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(
            "flash_attention_bwd: lse must be a contiguous (B, N, Sq) float32 "
            "tensor on q's device"
        )
    fn = _kernel_fn("dpx_flash_bwd")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    delta = torch.empty((batch, heads, seq_q), dtype=torch.float32,
                        device=q.device)
    strides = _strides(q, k, v, o, do, dq, dk, dv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], head_dim, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            _ptr(kv_mask), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), batch, heads, kv_heads, seq_q, seq_k, strides,
            float(softmax_scale), int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _expand_kv(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, KVH, H) -> (B, S, N, H): kv head n // group serves head n."""
    return torch.repeat_interleave(t, heads // t.shape[2], dim=2)


def _masked_logits(q, k, causal, kv_mask, scale):
    """(B, N, Sq, Sk) float32 logits with NEG_INF at masked keys, and the
    (B, Sk) key validity (or None)."""
    s = torch.einsum("bqnh,bknh->bnqk", q.float(),
                     _expand_kv(k, q.shape[2]).float()) * scale
    if causal:
        rows = torch.arange(s.shape[-2], device=q.device)[:, None]
        cols = torch.arange(s.shape[-1], device=q.device)[None, :]
        s = s.masked_fill(rows < cols, NEG_INF)
    valid = None
    if kv_mask is not None:
        valid = kv_mask > 0
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    return s, valid


def flash_attention_fwd_reference(q, k, v, *, causal, kv_mask, softmax_scale):
    """Plain forward: the TPU kernel's one-tile softmax. Returns
    ``(o like q, lse (B, N, Sq) float32)``."""
    s, _ = _masked_logits(q, k, causal, kv_mask, softmax_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bnqk,bknh->bnqh", p.to(v.dtype).float(),
                      _expand_kv(v, q.shape[2]).float())
    o = pv / l
    lse = m + torch.log(l)
    dead = m == NEG_INF  # no valid key at all
    o = torch.where(dead, 0.0, o)
    lse = torch.where(dead, NEG_INF, lse)
    return o.transpose(1, 2).to(q.dtype), lse[..., 0]


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal, kv_mask,
                                  softmax_scale):
    """Plain backward, the explicit formula the kernels compute: p from the
    saved lse (re-masked, so a dead row's p is 0), dv = pᵀ·dO,
    dp = dO·vᵀ, ds = p ∘ (dp − delta) · scale, dq = ds·k, dk = dsᵀ·q, with
    delta = rowsum(p ∘ dp) (rowsum(dO ∘ O) in exact arithmetic; ``o`` is
    taken for the signature's sake); dk/dv summed over each GQA group."""
    heads, kv_heads = q.shape[2], k.shape[2]
    s, valid = _masked_logits(q, k, causal, kv_mask, softmax_scale)
    p = torch.exp(s - lse[..., None])
    if valid is not None:
        p = torch.where(valid[:, None, None, :], p, 0.0)
    do_f = do.float()
    kx = _expand_kv(k, heads)
    vx = _expand_kv(v, heads)
    dv = torch.einsum("bnqk,bqnh->bknh", p.to(do.dtype).float(), do_f)
    dp = torch.einsum("bqnh,bknh->bnqk", do_f, vx.float())
    delta = (p * dp).sum(-1)  # (B, N, Sq): rowsum(dO ∘ O), from p and dp
    ds = p * (dp - delta[..., None]) * softmax_scale
    dq = torch.einsum("bnqk,bknh->bqnh", ds.to(k.dtype).float(), kx.float())
    dk = torch.einsum("bnqk,bqnh->bknh", ds.to(q.dtype).float(), q.float())
    if kv_heads != heads:  # fold each group's per-head terms into its kv head
        shape = (*k.shape[:2], kv_heads, heads // kv_heads, k.shape[3])
        dk = dk.reshape(shape).sum(3)
        dv = dv.reshape(shape).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the autograd op
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        kw = dict(causal=causal, kv_mask=kv_mask, softmax_scale=scale)
        if q.is_cuda:
            o, lse = flash_attention_fwd(q, k, v, **kw)
        else:
            o, lse = flash_attention_fwd_reference(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        kw = dict(causal=ctx.causal, kv_mask=kv_mask, softmax_scale=ctx.scale)
        if q.is_cuda:
            dq, dk, dv = flash_attention_bwd(
                q, k, v, o, lse, do.contiguous(), **kw
            )
        else:
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                       **kw)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused flash attention, (B, S, N, H) in and out, differentiable in
    q, k and v.

    ``kv_mask``: optional (B, S_k) key validity (True/nonzero = attend);
    queries whose keys are all masked give zero output and zero gradients.
    ``softmax_scale`` defaults to ``head_dim ** -0.5``. CUDA tensors launch
    the kernels (and raise on what they do not take); CPU tensors run the
    plain versions of the same math.
    """
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads ({q.shape[2]}) must be a multiple of kv heads "
            f"({k.shape[2]}) for GQA"
        )
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (q.shape[0], k.shape[1]):
            raise ValueError(
                f"kv_mask shape {tuple(kv_mask.shape)} != (batch, seq_k) "
                f"({q.shape[0]}, {k.shape[1]})"
            )
        kv_mask = (kv_mask != 0).to(torch.float32).contiguous()
    return _FlashAttention.apply(q, k, v, kv_mask, bool(causal),
                                 float(softmax_scale))


__all__ = [
    "HEAD_DIMS",
    "NEG_INF",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_fwd_reference",
    "kernel_tile",
]

