"""Continuous-batching inference over a paged KV cache.

Two device steps serve the whole workload:

- ``_prefill_step`` — one request, bucket-padded prompt. Runs causal
  self-attention over the prompt, writes its K/V into the request's pool
  blocks, and samples the first token from the last REAL position.
- ``_decode_step`` — one token for every slot of a fixed slot array.
  Inactive slots ride along pointed at the scratch block; their sampled
  tokens are discarded on the host. On the card its attention is the CUDA
  paged-decode kernel, launched once per layer.

The paged pool lives in the model's attention modules
(models/transformer.py ``_paged_step``); the engine builds the
``page_table`` / ``row_lens`` of every call from the scheduler's host
state.

Robustness: device fetches run under ``with_retries`` (and an optional
per-fetch deadline); a request whose last-position logits go nonfinite (or
is poisoned by the ``poison-request`` chaos fault) is evicted with an
error status at the next boundary while its co-residents' streams continue
unchanged — per-row attention, per-request position-seeded sampling and
per-row argmax share no cross-row state. Telemetry: per-request
queue/prefill/decode trace spans land in the Chrome trace.

Not in this slice, and refused when asked for: a partitioner (sharded
serving), speculative decoding, ``install_params`` (hot swap),
``serve_loop`` (the fleet replica loop) and the static-audit program views.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from distributed_pytorch_example_tpu_torch.robustness import chaos
from distributed_pytorch_example_tpu_torch.robustness.retry import with_retries
from distributed_pytorch_example_tpu_torch.runtime.device import resolve_device
from distributed_pytorch_example_tpu_torch.serving.cache import (
    SCRATCH_BLOCK,
    BlockAllocator,
    PagedCacheConfig,
)
from distributed_pytorch_example_tpu_torch.serving.sampling import sample_rows
from distributed_pytorch_example_tpu_torch.serving.scheduler import (
    Request,
    RequestState,
    Scheduler,
)

__all__ = ["EngineFetchTimeout", "InferenceEngine", "Request"]


class EngineFetchTimeout(RuntimeError):
    """A device fetch exceeded the engine's ``fetch_timeout_s`` deadline.

    Deliberately NOT retried: a hung transfer is a sick accelerator or
    runtime, not a transient flake, so it propagates out of the serving
    loop instead of the decode loop hanging forever.
    """


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; see ROADMAP.md "
        "queue 1"
    )


def _prefill_step(model, tokens, table, length, seed, poison, *,
                  temperature, top_k, top_p):
    """One bucket-padded prompt -> (first token, finite?) as device tensors."""
    lens = torch.zeros((1,), dtype=torch.int32, device=tokens.device)
    logits = model(tokens, page_table=table, row_lens=lens)
    # the last REAL position's logits, not the bucket end's
    row = logits[0, length - 1:length].float()  # (1, V)
    if poison:
        row = torch.full_like(row, float("nan"))
    ok = torch.isfinite(row).all()
    tok = sample_rows(row, [seed], [length], temperature, top_k, top_p)[0]
    return tok, ok


def _decode_step(model, tokens, table, lens, seeds, positions, poison, *,
                 temperature, top_k, top_p):
    """One token per slot -> (next tokens, finite mask) as device tensors.

    ``positions[b]`` is the absolute position of the token being SAMPLED
    for row b (= row_lens + 1); it seeds that row's draw.
    """
    logits = model(tokens[:, None], page_table=table, row_lens=lens)
    logits = logits[:, -1].float()  # (B, V)
    logits = torch.where(poison[:, None], float("nan"), logits)
    ok = torch.isfinite(logits).all(dim=-1)
    nxt = sample_rows(logits, seeds, positions, temperature, top_k, top_p)
    return nxt, ok


def _percentiles(samples: Sequence[float]) -> Dict[str, float]:
    if not samples:
        return {"p50": None, "p95": None, "p99": None}
    arr = np.asarray(samples, dtype=np.float64)
    return {
        f"p{q}": float(np.percentile(arr, q)) for q in (50, 95, 99)
    }


class InferenceEngine:
    """Continuous-batching serving loop over one paged-decode model.

    ``model`` must be a ``GPT2`` built with ``decode=True`` and the paged
    fields set (``paged_num_blocks`` / ``paged_block_size`` /
    ``paged_max_blocks``); it holds its weights. The engine moves it to
    ``device`` — ``cuda`` unless the caller passes ``device="cpu"``; with
    no card that raises.

    ``clock`` / ``sleep`` are injectable for virtual-clock tests; the
    open-loop ``run()`` honors each request's ``arrival`` timestamp
    against that clock.
    """

    def __init__(
        self,
        model,
        *,
        num_slots: int = 4,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        partitioner=None,
        trace=None,
        clock=time.monotonic,
        sleep=time.sleep,
        mode: str = "continuous",
        fetch_timeout_s: Optional[float] = None,
        spec_tokens: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        if partitioner is not None:
            raise _not_in_slice("sharded serving (partitioner)")
        if spec_tokens:
            raise _not_in_slice("speculative decoding (spec_tokens > 0)")
        nb = int(getattr(model, "paged_num_blocks", 0))
        bs = int(getattr(model, "paged_block_size", 0))
        mb = int(getattr(model, "paged_max_blocks", 0))
        if nb < 2 or not getattr(model, "decode", False):
            raise ValueError(
                "InferenceEngine needs a paged decode model: construct it "
                "with decode=True and paged_num_blocks/paged_block_size/"
                "paged_max_blocks set"
            )
        self.model = model.to(self.device).eval()
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.trace = trace
        self.clock = clock
        self.sleep = sleep
        self.mode = mode
        self.fetch_timeout_s = fetch_timeout_s
        self._fetch_pool: Optional[
            concurrent.futures.ThreadPoolExecutor
        ] = None
        self.config = PagedCacheConfig(
            num_blocks=nb, block_size=bs, max_blocks_per_slot=mb,
            num_slots=num_slots,
        )
        max_len = int(getattr(model, "max_len", self.config.max_context))
        if prefill_buckets is None:
            cap = min(self.config.max_context, max_len)
            prefill_buckets, b = [], bs
            while b <= cap:
                prefill_buckets.append(b)
                b *= 2
            if prefill_buckets and prefill_buckets[-1] != cap and (
                cap % bs == 0
            ):
                prefill_buckets.append(cap)
        self.prefill_buckets = sorted(set(int(b) for b in prefill_buckets))
        for b in self.prefill_buckets:
            if b % bs or b > max_len:
                raise ValueError(
                    f"prefill bucket {b} must be a multiple of "
                    f"block_size {bs} and <= max_len {max_len}"
                )
        # per-slot sampling state (host-written at boundaries)
        self._slot_seeds = np.zeros((num_slots,), np.int64)
        self._slot_tokens = np.zeros((num_slots,), np.int64)
        self._decode_time_s = 0.0
        self._decode_tokens = 0

    # -- out of this slice ------------------------------------------------

    def install_params(self, params, version, *, draft_params=None) -> None:
        raise _not_in_slice("weight hot-swap (install_params)")

    def serve_loop(self, **_kw):
        raise _not_in_slice("the fleet replica loop (serve_loop)")

    def lowered_programs(self) -> dict:
        raise _not_in_slice("lowered_programs (static audit)")

    def traced_programs(self) -> dict:
        raise _not_in_slice("traced_programs (static audit)")

    def plan_programs(self, partitioner) -> dict:
        raise _not_in_slice("plan_programs (static audit)")

    # -- plumbing ---------------------------------------------------------

    def _static_kw(self) -> dict:
        return dict(
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
        )

    def _bucket_for(self, prompt_len: int) -> int:
        for b in self.prefill_buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest prefill "
            f"bucket {self.prefill_buckets[-1]}"
        )

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device, non_blocking=True)

    def _fetch(self, thunk: Callable, describe: str):
        """Device fetch with the transient retry AND (when
        ``fetch_timeout_s`` is set) a per-attempt deadline: the thunk runs
        on a dedicated fetch thread and ``EngineFetchTimeout`` is raised —
        unretried — if it overruns. A timed-out thunk's thread stays
        blocked in the runtime; further fetches queue behind it and time
        out too, which is correct — the replica is dead."""
        if self.fetch_timeout_s is None:
            return with_retries(thunk, describe=describe)

        def bounded():
            if self._fetch_pool is None:
                self._fetch_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="dpx-serve-fetch"
                )
            fut = self._fetch_pool.submit(thunk)
            try:
                return fut.result(timeout=self.fetch_timeout_s)
            except concurrent.futures.TimeoutError:
                fut.cancel()
                raise EngineFetchTimeout(
                    f"{describe} exceeded the {self.fetch_timeout_s}s "
                    "fetch deadline"
                ) from None

        return with_retries(bounded, describe=describe)

    def _ts_us(self) -> int:
        return int(self.clock() * 1e6)

    def _span(self, name: str, t0_us: int) -> None:
        if self.trace is not None:
            self.trace.add_complete(name, t0_us, self._ts_us() - t0_us)

    # -- the two device steps ---------------------------------------------

    def _run_prefill(self, st: RequestState, alloc: BlockAllocator) -> bool:
        req = st.request
        plen = st.prompt_len
        bucket = self._bucket_for(plen)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :plen] = np.asarray(req.prompt, np.int64)
        table = np.asarray([alloc.table_row(st.blocks)], np.int32)
        poison = chaos.poison_request(req.rid, 0)
        t0 = self._ts_us()
        with torch.inference_mode():
            tok, ok = _prefill_step(
                self.model, self._to_device(tokens), self._to_device(table),
                plen, req.seed, poison, **self._static_kw(),
            )
            out = torch.stack([tok, ok.long()])
            tok, ok = self._fetch(
                lambda: out.cpu().tolist(), f"serve prefill fetch ({req.rid})"
            )
        self._span(f"prefill:{req.rid}", t0)
        now = self.clock()
        st.t_first = now
        st.token_times.append(now)
        st.generated.append(int(tok))
        self._slot_seeds[st.slot] = req.seed
        self._slot_tokens[st.slot] = int(tok)
        return bool(ok)

    def _run_decode(self, sched: Scheduler) -> None:
        """One fixed-slot decode boundary: one token per resident slot;
        requests that finish (done or evicted with an error) leave their
        slots here."""
        t_wall = self.clock()
        active = sched.active()
        ns = self.config.num_slots
        table = np.full(
            (ns, self.config.max_blocks_per_slot), SCRATCH_BLOCK, np.int32
        )
        lens = np.zeros((ns,), np.int32)
        positions = np.ones((ns,), np.int64)
        poison = np.zeros((ns,), bool)
        for slot, st in active:
            table[slot] = sched.allocator.table_row(st.blocks)
            lens[slot] = st.cached_len
            positions[slot] = st.cached_len + 1
            poison[slot] = chaos.poison_request(
                st.request.rid, len(st.generated)
            )
        t0 = self._ts_us()
        with torch.inference_mode():
            nxt, ok = _decode_step(
                self.model, self._to_device(self._slot_tokens.copy()),
                self._to_device(table), self._to_device(lens),
                self._slot_seeds.tolist(), positions.tolist(),
                self._to_device(poison), **self._static_kw(),
            )
            out = torch.stack([nxt, ok.long()])
            nxt, ok = self._fetch(
                lambda: out.cpu().numpy(), "serve decode fetch"
            )
        self._span("decode_step", t0)
        now = self.clock()
        for slot, st in active:
            req = st.request
            if not bool(ok[slot]):
                # bad-request isolation: evict THIS request, not the batch
                sched.finish(
                    st, "error", now=now,
                    error="nonfinite logits at generated token "
                          f"{len(st.generated)}",
                )
                self._span_request(st)
                continue
            tok = int(nxt[slot])
            st.generated.append(tok)
            st.token_times.append(now)
            self._slot_tokens[slot] = tok
            self._decode_tokens += 1
            if (
                (req.eos_id is not None and tok == req.eos_id)
                or len(st.generated) >= req.max_new_tokens
            ):
                sched.finish(st, "done", now=now)
                self._span_request(st)
        self._decode_time_s += max(self.clock() - t_wall, 0.0)

    def _span_request(self, st: RequestState) -> None:
        if self.trace is None:
            return
        us = lambda t: int(t * 1e6)  # noqa: E731
        rid = st.request.rid
        self.trace.add_complete(
            f"queue:{rid}", us(st.t_submit), us(st.t_admit) - us(st.t_submit)
        )
        self.trace.add_complete(
            f"decode:{rid}", us(st.t_first), us(st.t_done) - us(st.t_first)
        )
        # host-side finalize window (finish bookkeeping + result assembly
        # after the last token)
        self.trace.add_complete(
            f"finalize:{rid}", us(st.t_done), self._ts_us() - us(st.t_done)
        )

    # -- the serving loop -------------------------------------------------

    def warmup(self) -> int:
        """Warm the serving path: one tiny request per prefill bucket, each
        decoding at least one token, served via ``run()`` — so every
        bucket's prefill shape and the decode step (kernel build included)
        have run once before real traffic. Returns the number of warmup
        requests served."""
        bs = self.config.block_size
        reqs = []
        for i, bucket in enumerate(self.prefill_buckets):
            plen = max(1, bucket - bs + 1)
            max_new = 2 if plen + 2 <= self.config.max_context else 1
            reqs.append(Request(
                rid=f"_warmup{i}", prompt=[0] * plen,
                max_new_tokens=max_new,
            ))
        self.run(reqs)
        return len(reqs)

    def _prefill_and_maybe_finish(self, st: RequestState,
                                  sched: Scheduler) -> None:
        """Prefill a newly admitted request and finish it immediately on
        nonfinite logits, prompt-EOS, or a one-token budget."""
        ok = self._run_prefill(st, sched.allocator)
        req, tok = st.request, st.generated[-1]
        if not ok:
            sched.finish(
                st, "error", now=self.clock(),
                error="nonfinite logits at prefill",
            )
            self._span_request(st)
        elif (
            (req.eos_id is not None and tok == req.eos_id)
            or req.max_new_tokens <= 1
        ):
            sched.finish(st, "done", now=self.clock())
            self._span_request(st)

    def _grow_or_preempt(self, sched: Scheduler) -> None:
        """Grow each resident row's table at a decode boundary, preempting
        the youngest resident until the growth fits."""
        for _slot, st in list(sched.active()):
            while st.status == "running" and not sched.grow(st):
                victim = sched.preempt_youngest()
                if victim is None or victim is st:
                    break

    def run(self, requests: Sequence[Request], *,
            mode: Optional[str] = None) -> dict:
        """Serve an open-loop workload to completion; returns per-request
        results plus aggregate latency/throughput metrics."""
        sched = Scheduler(self.config, mode=mode or self.mode)
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        states: Dict[str, RequestState] = {}
        next_arrival = 0
        t_start = self.clock()
        decode_steps = 0
        occupied_rows = 0
        self._reset_decode_counters()

        while True:
            now = self.clock()
            while (
                next_arrival < len(pending)
                and pending[next_arrival].arrival <= now
            ):
                req = pending[next_arrival]
                states[req.rid] = sched.submit(req, now)
                next_arrival += 1
            for st in sched.admit(now):
                self._prefill_and_maybe_finish(st, sched)

            active = sched.active()
            if not active:
                if not sched.queue and next_arrival >= len(pending):
                    break  # drained
                if next_arrival < len(pending) and not sched.queue:
                    self.sleep(
                        max(pending[next_arrival].arrival - self.clock(), 0.0)
                        + 1e-4
                    )
                    continue
                if sched.queue:
                    # nothing resident yet nothing admitted: the head
                    # request is stuck — impossible unless bookkeeping
                    # leaked blocks; fail loudly rather than spin
                    raise RuntimeError(
                        "scheduler deadlock: queued requests but no "
                        "admissible slot on an empty batch"
                    )
                continue

            # decode boundary: grow each resident row's table; preempt the
            # youngest resident until the growth fits
            self._grow_or_preempt(sched)
            active = sched.active()
            if not active:
                continue
            self._run_decode(sched)
            decode_steps += 1
            occupied_rows += len(active)

        elapsed = max(self.clock() - t_start, 1e-9)
        return self._report(
            states, sched, elapsed, decode_steps, occupied_rows
        )

    def _reset_decode_counters(self) -> None:
        self._decode_time_s = 0.0
        self._decode_tokens = 0

    def decode_metrics(self) -> Dict[str, Optional[float]]:
        """Decode-side throughput since the last ``run()`` start: wall time
        spent at decode boundaries and tokens committed there (prefill
        tokens excluded). Speculation is not ported, so its accept rate is
        None and its counters 0."""
        return {
            "decode_time_s": self._decode_time_s,
            "decode_tokens": self._decode_tokens,
            "decode_tokens_per_sec": (
                self._decode_tokens / self._decode_time_s
                if self._decode_time_s > 0 else 0.0
            ),
            "spec_accept_rate": None,
            "spec_proposed": 0,
            "spec_accepted": 0,
        }

    def _report(self, states, sched, elapsed, decode_steps, occupied_rows):
        results = {}
        ttft, tpot, qwait = [], [], []
        generated = 0
        for rid, st in sorted(states.items()):
            results[rid] = {
                "status": st.status,
                "prompt_len": st.prompt_len,
                "tokens": list(st.generated),
                "error": st.error,
                "preemptions": st.preemptions,
                "ttft_s": (
                    st.t_first - st.t_submit if st.t_first else None
                ),
            }
            if st.status in ("done", "error"):
                generated += len(st.generated)
                if st.t_first:
                    ttft.append((st.t_first - st.t_submit) * 1e3)
                if st.t_admit:
                    qwait.append((st.t_admit - st.t_submit) * 1e3)
                tpot.extend(
                    (b - a) * 1e3 for a, b in zip(
                        st.token_times, st.token_times[1:]
                    )
                )
        metrics = {
            **sched.counters,
            "elapsed_s": elapsed,
            "decode_steps": decode_steps,
            "generated_tokens": generated,
            "tokens_per_sec": generated / elapsed,
            "slot_occupancy": (
                occupied_rows / (decode_steps * self.config.num_slots)
                if decode_steps else 0.0
            ),
            "ttft_ms": _percentiles(ttft),
            "tpot_ms": _percentiles(tpot),
            "queue_wait_ms": _percentiles(qwait),
            **self.decode_metrics(),
        }
        return {"results": results, "metrics": metrics}
