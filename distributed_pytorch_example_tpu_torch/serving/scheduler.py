"""Continuous-batching scheduler (host side, device-free).

Owns the request lifecycle around the engine's two device steps:

- **admission control** — a queued request is placed only when a decode
  slot is free AND the free-block count covers the prompt plus
  the first decode token; otherwise it waits (FIFO, head-of-line: later
  requests never jump an earlier one that is still waiting for blocks,
  which keeps replays deterministic);
- **in-flight insertion** — ``admit()`` runs at every decode-step
  boundary, so new requests drop into empty slots while resident
  requests keep decoding (``mode="static"`` disables this: a new wave is
  admitted only when every slot has drained — the classic static batch
  the bench compares against);
- **eviction + recycling** — ``finish()`` releases the request's blocks
  back to the allocator and frees the slot, at the same boundary;
- **preemption** — when a resident request crosses a block boundary and
  the pool has no free block, the youngest resident request is evicted
  and requeued (its blocks recycled) until the growth fits; a preempted
  request restarts from its prompt on re-admission and — because the rng
  is position-folded per request (serving/sampling.py) — reproduces the
  exact same tokens.

Everything here is plain Python on ints; the tests drive it with a
virtual clock and a stub engine.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from distributed_pytorch_example_tpu_torch.serving.cache import (
    BlockAllocator,
    PagedCacheConfig,
)


@dataclasses.dataclass
class Request:
    """One inference request (immutable workload description)."""

    rid: str
    prompt: Sequence[int]
    max_new_tokens: int
    seed: int = 0
    eos_id: Optional[int] = None
    arrival: float = 0.0  # open-loop submit time (load-generator clock)
    session: Optional[str] = None  # fleet router: session-affinity key


@dataclasses.dataclass
class RequestState:
    """Mutable per-request serving state; ``request`` stays untouched."""

    request: Request
    status: str = "queued"  # queued|running|done|error|rejected
    slot: int = -1
    blocks: List[int] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)
    error: str = ""
    admit_order: int = -1
    preemptions: int = 0
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0  # first token produced (end of prefill)
    t_done: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return len(self.request.prompt)

    @property
    def cached_len(self) -> int:
        """Tokens materialized in the KV cache: the prompt plus every
        generated token except the pending one (the next decode input)."""
        if not self.generated:
            return self.prompt_len
        return self.prompt_len + len(self.generated) - 1


class Scheduler:
    """Slot + block bookkeeping between decode-step boundaries."""

    def __init__(
        self,
        config: PagedCacheConfig,
        *,
        mode: str = "continuous",
    ):
        if mode not in ("continuous", "static"):
            raise ValueError(
                f"mode must be 'continuous' or 'static', got {mode!r}"
            )
        self.config = config
        self.mode = mode
        self.allocator = BlockAllocator(config)
        self.slots: List[Optional[RequestState]] = [None] * config.num_slots
        self.queue: Deque[RequestState] = deque()
        self.counters: Dict[str, int] = {
            "admitted": 0, "completed": 0, "errored": 0,
            "rejected": 0, "preempted": 0,
        }
        self._admit_seq = 0

    # -- queue side -------------------------------------------------------

    def submit(self, request: Request, now: float) -> RequestState:
        """Enqueue; reject outright only what can NEVER be served."""
        st = RequestState(request=request, t_submit=now)
        total = len(request.prompt) + request.max_new_tokens
        allocatable = self.config.num_blocks - 1  # block 0 is scratch
        if (
            len(request.prompt) < 1
            or request.max_new_tokens < 1
            or total > self.config.max_context
            or self.config.blocks_for(total) > allocatable
        ):
            st.status = "rejected"
            st.error = (
                f"needs {total} cached tokens "
                f"({self.config.blocks_for(total)} blocks); capacity is "
                f"{self.config.max_context} tokens / {allocatable} blocks"
            )
            self.counters["rejected"] += 1
            return st
        self.queue.append(st)
        return st

    def active(self) -> List[Tuple[int, RequestState]]:
        return [
            (slot, st) for slot, st in enumerate(self.slots)
            if st is not None
        ]

    # -- decode-boundary operations --------------------------------------

    def admit(self, now: float) -> List[RequestState]:
        """Place queued requests into free slots (the in-flight insertion
        point). Returns the newly admitted states, which the engine must
        prefill before the next decode step."""
        if self.mode == "static" and any(
            s is not None for s in self.slots
        ):
            return []  # static batching: drain the wave first
        admitted: List[RequestState] = []
        while self.queue:
            st = self.queue[0]
            slot = self._place(st)
            if slot is None:
                break  # head-of-line: keep FIFO order deterministic
            self.queue.popleft()
            st.slot = slot
            st.status = "running"
            st.t_admit = now
            st.admit_order = self._admit_seq
            self._admit_seq += 1
            self.counters["admitted"] += 1
            self.slots[slot] = st
            admitted.append(st)
        return admitted

    def _place(self, st: RequestState) -> Optional[int]:
        """The first free slot, when the pool can grant the prompt blocks."""
        slot = next(
            (i for i, s in enumerate(self.slots) if s is None), None
        )
        if slot is None:
            return None
        blocks = self.allocator.alloc(self.config.blocks_for(st.prompt_len + 1))
        if blocks is None:
            return None
        st.blocks = blocks
        return slot

    def grow(self, st: RequestState) -> bool:
        """Ensure the block holding position ``cached_len`` exists before
        the next decode write; allocate one when crossing a block
        boundary. The target is clamped to the request's own ceiling.
        False = the pool is out of blocks (caller preempts)."""
        ceiling = len(st.request.prompt) + st.request.max_new_tokens
        need = self.config.blocks_for(min(st.cached_len + 1, ceiling))
        while len(st.blocks) < need:
            got = self.allocator.alloc(1)
            if got is None:
                return False
            st.blocks.extend(got)
        return True

    def preempt_youngest(self) -> Optional[RequestState]:
        """Evict the most recently admitted resident request: blocks
        recycled, progress discarded, requeued at the FRONT (it keeps its
        FIFO seniority). Position-folded rng makes the retry bit-identical."""
        victims = [st for st in self.slots if st is not None]
        if not victims:
            return None
        st = max(victims, key=lambda s: s.admit_order)
        self._release(st)
        st.status = "queued"
        st.generated = []
        st.token_times = []
        st.preemptions += 1
        self.counters["preempted"] += 1
        self.queue.appendleft(st)
        return st

    def finish(self, st: RequestState, status: str, *,
               now: float, error: str = "") -> None:
        """Evict on EOS / max-tokens / nonfinite logits; recycle blocks."""
        assert status in ("done", "error")
        self._release(st)
        st.status = status
        st.error = error
        st.t_done = now
        self.counters["completed" if status == "done" else "errored"] += 1

    def _release(self, st: RequestState) -> None:
        if st.blocks:
            self.allocator.release(st.blocks)
            st.blocks = []
        if st.slot >= 0:
            self.slots[st.slot] = None
            st.slot = -1
