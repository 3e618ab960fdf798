"""Paged decode attention: the CUDA kernel, its plain version, the dispatch.

- :func:`paged_flash_decode` launches ``csrc/paged_decode.cu``, the Hopper
  port of the TPU kernel ``paged_flash_decode`` / ``_decode_kernel``
  (distributed_pytorch_example_tpu/ops/pallas/paged_attention.py): one
  query per row over the live blocks of the row's paged KV pool, online
  softmax in float32, reading only the blocks the table names. Each launch
  adds one to ``paged_flash_decode.launches``.
- :func:`paged_attention_reference` is the plain version: gather the whole
  table out of the pool and run dense masked attention, as the JAX
  package's reference does. It serves ``seq > 1`` chunks and CPU tensors.
- :func:`paged_decode_attention` dispatches: a CPU tensor takes the
  reference; on a CUDA tensor ``seq == 1`` launches the kernel (or raises)
  and ``seq > 1`` takes the reference, as in JAX.
"""

from __future__ import annotations

import ctypes
import math

import torch

from distributed_pytorch_example_tpu_torch.ops import _build
from distributed_pytorch_example_tpu_torch.ops.attention import (
    dot_product_attention,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 8


def _kernel_fn():
    lib = _build.load_library("paged_decode")
    fn = lib.dpx_paged_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i,
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

    Launches on the current stream without synchronising. Raises on any
    input the kernel does not take, on a failed build and on a refused
    launch; it never computes the result another way.
    """
    _check_kernel_inputs(q, pages_k, pages_v, page_table, row_lens)
    batch, num_heads, head_dim = q.shape
    num_blocks, block_size, kv_heads, _ = pages_k.shape
    fn = _kernel_fn()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), pages_k.data_ptr(),
            pages_v.data_ptr(), page_table.data_ptr(), row_lens.data_ptr(),
            out.data_ptr(), batch, num_heads, kv_heads, head_dim, block_size,
            page_table.shape[1], num_blocks, 1.0 / math.sqrt(head_dim), stream,
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
