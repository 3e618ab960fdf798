"""Paged decode attention: the CUDA kernel, its plain version, the dispatch.

- :func:`paged_flash_decode` launches ``csrc/paged_decode.cu``, the Hopper
  port of the TPU kernel ``paged_flash_decode`` / ``_decode_kernel``
  (distributed_pytorch_example_tpu/ops/pallas/paged_attention.py): one
  query per row over the live blocks of the row's paged KV pool, online
  softmax in float32, reading only the blocks the table names. The sweep
  over a row's blocks is split over :func:`decode_splits` CTAs per (row,
  kv head), whose partial states a combine pass merges in split order.
  Each call adds one to ``paged_flash_decode.launches``.
- :func:`paged_attention_reference` is the plain version: gather the whole
  table out of the pool and run dense masked attention, as the JAX
  package's reference does. It serves ``seq > 1`` chunks and CPU tensors.
- :func:`paged_decode_split_reference` is the split arithmetic in plain
  torch (each split's (m, l, acc) over :func:`split_blocks`' ranges, merged
  in the kernel's order), for the tests; nothing on the main path uses it.
- :func:`paged_decode_attention` dispatches: a CPU tensor takes the
  reference; on a CUDA tensor ``seq == 1`` launches the kernel (or raises)
  and ``seq > 1`` takes the reference, as in JAX.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from distributed_pytorch_example_tpu_torch.ops import _build
from distributed_pytorch_example_tpu_torch.ops.attention import (
    dot_product_attention,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 8
# the split rule (see decode_splits and csrc/paged_decode.cu's note)
SPLIT_CTAS_PER_SM = 8
SPLIT_MIN_KEYS = 16
MAX_SPLITS = 1024  # the combine kernel's limit
NEG_INF = -1e30  # the kernel's: finite, exp() underflows to 0


def decode_splits(batch, kv_heads, max_blocks, block_size, num_sms):
    """How many CTAs share one (row, kv head)'s block sweep: about
    ``SPLIT_CTAS_PER_SM`` CTAs per SM over the whole grid, at most one per
    block of the table, none thinner than ``SPLIT_MIN_KEYS`` keys, and at
    most ``MAX_SPLITS``.

    A function of shapes only, never of the row lengths: reading those on
    the host would cost a synchronisation per layer.
    """
    want = -(-SPLIT_CTAS_PER_SM * num_sms // (batch * kv_heads))
    thin = -(-max_blocks * block_size // SPLIT_MIN_KEYS)
    return max(1, min(want, max_blocks, thin, MAX_SPLITS))


def split_blocks(pos, split, num_splits, block_size, max_blocks):
    """The blocks ``[begin, end)`` that split ``split`` of a row whose query
    sits at ``pos`` sweeps, as the kernel computes them: the row's live
    blocks ``ceil((min(pos, cap) + 1) / block_size)`` (none for pos < 0),
    cut into contiguous runs of ``ceil(live / num_splits)``; a split past
    the last run is empty (``begin >= end``). ``pos`` is an int or an
    integer tensor of positions; the bounds come back as tensors."""
    last = torch.as_tensor(pos).clamp(max=max_blocks * block_size - 1)
    live = torch.where(last < 0, 0, last // block_size + 1)
    per_split = (live + num_splits - 1) // num_splits
    return split * per_split, torch.minimum(live, (split + 1) * per_split)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_fn():
    lib = _build.load_library("paged_decode")
    fn = lib.dpx_paged_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q, pages_k, pages_v, page_table, row_lens):
    tensors = dict(q=q, pages_k=pages_k, pages_v=pages_v,
                   page_table=page_table, row_lens=row_lens)
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(
                f"paged_flash_decode: {name} is on {t.device}, not a CUDA "
                "device (the kernel runs on the card only; CPU tensors go "
                "through paged_decode_attention's plain version)"
            )
        if t.device != q.device:
            raise ValueError(
                f"paged_flash_decode: {name} on {t.device}, q on {q.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"paged_flash_decode: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"paged_flash_decode: dtype {q.dtype} not in float32/bfloat16"
        )
    if pages_k.dtype != q.dtype or pages_v.dtype != q.dtype:
        raise ValueError("paged_flash_decode: q and pages must share a dtype")
    if page_table.dtype != torch.int32 or row_lens.dtype != torch.int32:
        raise ValueError("paged_flash_decode: page_table/row_lens must be int32")
    if q.dim() != 3 or pages_k.dim() != 4 or pages_k.shape != pages_v.shape:
        raise ValueError(
            "paged_flash_decode: want q (B, N, H) and pages (NB, BS, KVH, H), "
            f"got {tuple(q.shape)}, {tuple(pages_k.shape)}, "
            f"{tuple(pages_v.shape)}"
        )
    batch, num_heads, head_dim = q.shape
    _, _, kv_heads, page_dim = pages_k.shape
    if page_dim != head_dim or head_dim not in _HEAD_DIMS:
        raise ValueError(
            f"paged_flash_decode: head_dim {head_dim} (pages {page_dim}) "
            f"not in {_HEAD_DIMS}"
        )
    if num_heads % kv_heads or num_heads // kv_heads > _MAX_GROUP:
        raise ValueError(
            f"paged_flash_decode: {num_heads} heads over {kv_heads} kv heads "
            f"(the kernel takes groups of 1..{_MAX_GROUP})"
        )
    if page_table.dim() != 2 or page_table.shape[0] != batch or (
        row_lens.shape != (batch,)
    ):
        raise ValueError(
            f"paged_flash_decode: page_table {tuple(page_table.shape)} / "
            f"row_lens {tuple(row_lens.shape)} do not match batch {batch}"
        )
    for name in ("q", "pages_k", "pages_v"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(
                f"paged_flash_decode: {name} is not 16-byte aligned"
            )


def paged_flash_decode(
    q: torch.Tensor,           # (batch, num_heads, head_dim)
    pages_k: torch.Tensor,     # (num_blocks, block_size, kv_heads, head_dim)
    pages_v: torch.Tensor,     # same
    page_table: torch.Tensor,  # (batch, max_blocks) int32, dead -> scratch 0
    row_lens: torch.Tensor,    # (batch,) int32: absolute query position
) -> torch.Tensor:
    """Single-token paged attention on the card; (batch, heads, head_dim).

    Launches on the current stream without synchronising: the split sweep
    and, when it has more than one split, the combine pass, into float32
    scratch of ``batch * heads * splits * (head_dim + 2)``. Raises on any
    input the kernel does not take, on a failed build and on a refused
    launch; it never computes the result another way.
    """
    _check_kernel_inputs(q, pages_k, pages_v, page_table, row_lens)
    batch, num_heads, head_dim = q.shape
    num_blocks, block_size, kv_heads, _ = pages_k.shape
    max_blocks = page_table.shape[1]
    fn = _kernel_fn()
    splits = decode_splits(batch, kv_heads, max_blocks, block_size,
                           _sm_count(q.device.index))
    out = torch.empty_like(q)
    partials = None
    if splits > 1:
        partials = torch.empty(batch * num_heads * splits * (head_dim + 2),
                               dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), pages_k.data_ptr(),
            pages_v.data_ptr(), page_table.data_ptr(), row_lens.data_ptr(),
            out.data_ptr(), None if partials is None else partials.data_ptr(),
            batch, num_heads, kv_heads, head_dim, block_size, max_blocks,
            num_blocks, splits, 1.0 / math.sqrt(head_dim), stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_flash_decode launch failed: cudaError {err}")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


def paged_attention_reference(q, pages_k, pages_v, page_table, positions):
    """Gather-based paged attention — the plain version of the kernel.

    ``q`` is (batch, seq, heads, head_dim) and ``positions`` (batch, seq)
    the absolute position of each query; each query attends keys at
    ``key_pos <= positions[b, s]`` of the gathered
    (batch, max_blocks * block_size, kv_heads, head_dim) cache.
    """
    batch, _, _, head_dim = q.shape
    _, block_size, kv_heads, _ = pages_k.shape
    max_blocks = page_table.shape[1]
    idx = page_table.long()
    gk = pages_k[idx].reshape(batch, max_blocks * block_size, kv_heads, head_dim)
    gv = pages_v[idx].reshape(batch, max_blocks * block_size, kv_heads, head_dim)
    key_pos = torch.arange(max_blocks * block_size, device=q.device)
    visible = key_pos[None, None, None, :] <= positions[:, None, :, None]
    return dot_product_attention(
        q, gk, gv, mask=visible, causal=False, use_flash=False
    )


def paged_decode_split_reference(q, pages_k, pages_v, page_table, row_lens,
                                 num_splits):
    """The kernel's split arithmetic in plain torch, for the tests.

    ``q`` (batch, heads, head_dim), ``row_lens`` (batch,) as for
    :func:`paged_flash_decode`. Each split's (m, l, acc) is taken over the
    keys ``key_pos <= row_lens[b]`` of :func:`split_blocks`' block range
    (an empty split has m = NEG_INF, l = 0, acc = 0), and the splits merge
    in order 0 .. num_splits - 1: M = max m_s, l = sum l_s e^(m_s - M),
    out = sum acc_s e^(m_s - M) / l, with l == 0 -> 1. float32 throughout;
    the result is cast to q's dtype.
    """
    batch, num_heads, head_dim = q.shape
    num_blocks, block_size, kv_heads, _ = pages_k.shape
    max_blocks = page_table.shape[1]
    group = num_heads // kv_heads
    keys = max_blocks * block_size
    idx = page_table.long().clamp(0, num_blocks - 1)
    gk, gv = (
        p[idx].reshape(batch, keys, kv_heads, head_dim).float()
        .repeat_interleave(group, dim=2)
        for p in (pages_k, pages_v)
    )
    scores = torch.einsum(
        "bnd,bknd->bnk", q.float() * (1.0 / math.sqrt(head_dim)), gk
    )
    key_pos = torch.arange(keys, device=q.device)
    block = key_pos // block_size
    pos = row_lens.long()
    parts = []
    for split in range(num_splits):
        begin, end = split_blocks(pos, split, num_splits, block_size,
                                  max_blocks)
        mask = ((block[None, :] >= begin[:, None])
                & (block[None, :] < end[:, None])
                & (key_pos[None, :] <= pos[:, None]))[:, None, :]
        s = torch.where(mask, scores, NEG_INF)
        m = s.amax(-1)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bnk,bknd->bnd", p, gv)))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    l_sum = torch.zeros_like(top)
    acc = torch.zeros(batch, num_heads, head_dim, device=q.device)
    for m, l, a in parts:
        w = torch.exp(m - top)
        l_sum = l_sum + l * w
        acc = acc + a * w[..., None]
    safe = torch.where(l_sum == 0, 1.0, l_sum)
    return (acc / safe[..., None]).to(q.dtype)


def paged_decode_attention(q, pages_k, pages_v, page_table, positions):
    """Dispatch paged attention: the CUDA kernel for one-token decode on
    the card, the plain version for CPU tensors and ``seq > 1`` chunks."""
    if q.device.type == "cpu" or q.shape[1] != 1:
        return paged_attention_reference(
            q, pages_k, pages_v, page_table, positions
        )
    out = paged_flash_decode(
        q[:, 0].contiguous(), pages_k, pages_v,
        page_table.to(torch.int32).contiguous(),
        positions[:, 0].to(torch.int32).contiguous(),
    )
    return out[:, None]
