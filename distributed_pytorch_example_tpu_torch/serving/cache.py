"""Paged-KV block pool bookkeeping (host side).

The device state — per-layer ``pages_k``/``pages_v`` pool buffers — lives
in the model's attention modules (models/transformer.py ``_paged_step``);
the engine hands each call its ``page_table`` / ``row_lens``. This module
owns the HOST truth the scheduler mutates between device steps: which pool
blocks are free, which request holds which blocks, and how table rows are
laid out.

Block 0 is the scratch block: it is never allocated, every unallocated
``page_table`` entry points at it, and writes past a row's true length
land there (they are masked out of every live row's attention).

The pool is not sharded in this slice (no mesh), so there is one free
list; the JAX package's per-data-shard free lists land with sharded
serving (ROADMAP.md queue 1, C).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

SCRATCH_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Static shape of the paged KV cache; one per engine."""

    num_blocks: int          # pool blocks per layer, including scratch
    block_size: int          # tokens per block
    max_blocks_per_slot: int  # page-table width (max context / block_size)
    num_slots: int           # decode batch rows

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is scratch), got "
                f"{self.num_blocks}"
            )
        if self.block_size < 1 or self.max_blocks_per_slot < 1:
            raise ValueError("block_size and max_blocks_per_slot must be >= 1")
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")

    @property
    def max_context(self) -> int:
        return self.max_blocks_per_slot * self.block_size

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold positions [0, tokens)."""
        return -(-tokens // self.block_size)


class BlockAllocator:
    """A free list over the pool's allocatable blocks.

    Deterministic: blocks are handed out and recycled LIFO, so a replayed
    workload allocates identically — the property the chaos
    ``poison-request`` bit-identical assertion leans on — and in the same
    order as the JAX package's allocator.
    """

    def __init__(self, config: PagedCacheConfig):
        self.config = config
        # pop() hands out the low blocks first
        self._free: List[int] = list(
            range(config.num_blocks - 1, SCRATCH_BLOCK, -1)
        )

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks, or None (caller decides between queueing and
        preemption) without partial grants."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def release(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b == SCRATCH_BLOCK:
                raise ValueError("scratch block is never allocated/released")
            self._free.append(b)

    def table_row(self, blocks: Sequence[int]) -> List[int]:
        """A full-width page-table row: the request's blocks, scratch-
        padded to ``max_blocks_per_slot``."""
        mb = self.config.max_blocks_per_slot
        if len(blocks) > mb:
            raise ValueError(
                f"{len(blocks)} blocks exceed the table width {mb}"
            )
        return list(blocks) + [SCRATCH_BLOCK] * (mb - len(blocks))
