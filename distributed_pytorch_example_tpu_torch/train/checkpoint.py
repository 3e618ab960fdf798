"""Checkpoint save / load with the best+latest policy and epoch and step
resume (the JAX package's train/checkpoint.py, its gathered format).

Parity contract (reference train.py:178-209, 252-308), as in the JAX
package:

- the file is one logical view of the train state: the tree that
  ``flax.serialization.to_state_dict`` makes of the JAX ``TrainState``
  (``train/state.py``), inside a payload ``{epoch, loss, state, extra,
  mesh_manifest}``, flax-msgpack encoded (``utils/msgpack.py``) and sealed
  in the ``DPX-CRC1`` envelope (``robustness/integrity.py``). A file
  written by either package loads in the other;
- rank 0 writes, every rank reads; writes are atomic (tmp + rename);
- resume continues after the last finished epoch (the loop stamps an
  epoch-end save ``epoch + 1``); a mid-epoch save carries
  ``extra["batch_in_epoch"]`` and the loader stamp, and resume restarts at
  that batch;
- retention: each save lands in ``{path}.history/{seq:08d}.ckpt`` first and
  ``path`` becomes a hard link to it; the trail keeps ``retain`` entries;
- :func:`load_checkpoint` verifies the CRC and, when the newest candidate
  is torn or corrupt, walks back to the newest intact history entry,
  logging what it skipped and firing ``on_event("checkpoint_fallback",
  ...)``;
- ZeRO-1 saves gathered: every rank gathers its tiles into full leaves
  (a library all-gather, a collective), rank 0 writes, and all meet at a
  barrier; on load each rank slices its tile. So a checkpoint written
  replicated resumes under ZeRO-1 and the other way round.

The async save: the port updates parameters and moments in place, so the
snapshot is a synchronous device-to-host copy on the calling thread,
taken before the next step; :class:`AsyncSaver` then encodes, checksums
and writes it on a thread. As in the JAX package, the gathered format
saves asynchronously only in a one-process job (its gather is a
collective that must not race the step's).

Not in this slice: the sharded format (ROADMAP.md queue 1, item 9).
``sharded=True`` raises, and so does loading a file that starts with
:data:`SHARDED_MAGIC`.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from typing import Callable, List, Optional, Tuple

from distributed_pytorch_example_tpu_torch.robustness import chaos, elastic
from distributed_pytorch_example_tpu_torch.robustness.integrity import (
    CheckpointCorruptError,
    read_verified,
    seal_header,
)
from distributed_pytorch_example_tpu_torch.robustness.retry import (
    with_retries,
)
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger
from distributed_pytorch_example_tpu_torch.train.state import (
    TrainState,
    state_tree,
    to_host,
    train_state_from_flax,
)
from distributed_pytorch_example_tpu_torch.utils import msgpack

logger = get_logger(__name__)

BEST_NAME = "best_model.ckpt"
LATEST_NAME = "latest_model.ckpt"

# pointer-file magic of the JAX package's sharded format
SHARDED_MAGIC = b"DPX-SHARDED-V1\n"

# keep-last-K retention default: current + two ancestors; 0 disables the
# history trail
DEFAULT_RETAIN = 3

# re-attempts of a failed async write, and the first backoff's seconds
IO_RETRIES = 2
RETRY_BASE_DELAY = 0.1

_HISTORY_RE = re.compile(r"\d{8}\.ckpt")


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the sharded checkpoint format is not ported to the "
        "PyTorch package yet (ROADMAP.md queue 1, item 9); use the gathered "
        "format"
    )


class AsyncSaver:
    """Runs checkpoint writes on a background thread, one in flight.

    The caller has already copied the state to host memory; the job
    encodes, seals and writes it. Transient ``OSError``s are retried with
    bounded exponential backoff inside the thread (:data:`IO_RETRIES`
    re-attempts); a persistent failure surfaces at the next ``submit()``,
    ``check()`` or ``wait()``. ``records`` holds one dict per save (see
    :func:`save_checkpoint`).
    """

    def __init__(self):
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.io_retries_used = 0  # healed transient failures
        self.records: List[dict] = []

    def submit(self, fn: Callable[[], None]) -> None:
        self.wait()  # one in flight; also surfaces a prior failure

        def run():
            try:
                with_retries(
                    fn,
                    attempts=IO_RETRIES + 1,
                    base_delay=RETRY_BASE_DELAY,
                    retry_on=(OSError,),
                    describe="async checkpoint write",
                    on_retry=self._on_retry,
                )
            except BaseException as e:  # re-raised on next check/wait
                self._error = e

        self._pending = threading.Thread(target=run, daemon=True)
        self._pending.start()

    def _on_retry(self, attempt: int, err: BaseException) -> None:
        self.io_retries_used += 1

    def check(self) -> None:
        """Non-blocking: raise if a background save already failed."""
        if self._pending is not None and self._pending.is_alive():
            return
        self.wait()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err


def _next_history_seq(hist_dir: str) -> int:
    seqs = [int(n[:8]) for n in os.listdir(hist_dir)
            if _HISTORY_RE.fullmatch(n)]
    return max(seqs, default=-1) + 1


def _gathered_history_paths(path: str) -> List[str]:
    """History entries newest-first (fallback candidates)."""
    hist_dir = f"{path}.history"
    if not os.path.isdir(hist_dir):
        return []
    names = sorted((n for n in os.listdir(hist_dir)
                    if _HISTORY_RE.fullmatch(n)), reverse=True)
    return [os.path.join(hist_dir, n) for n in names]


def _payload(host_state, epoch: int, loss: float, extra,
             mesh_manifest: Optional[dict]) -> dict:
    payload = {
        "epoch": int(epoch),
        "loss": float(loss),
        "state": host_state,
        "extra": extra or {},
    }
    if mesh_manifest is not None:
        payload[elastic.MANIFEST_KEY] = mesh_manifest
    return payload


def _payload_blob(host_state, epoch: int, loss: float, extra,
                  mesh_manifest: Optional[dict] = None) -> list:
    """The sealed gathered payload as buffers, envelope header first and
    unjoined; joined, they are the JAX package's bytes for the same
    tree."""
    pieces = msgpack.msgpack_pieces(
        _payload(host_state, epoch, loss, extra, mesh_manifest))
    return [seal_header(pieces)] + pieces


def _atomic_write(path: str, pieces) -> int:
    """Write ``pieces`` (a list of buffers) to ``path`` through a
    temporary file and a rename; returns the bytes written."""
    chaos.on_write(path)  # deterministic fault injection (no-op unarmed)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        for piece in pieces:
            f.write(piece)
        size = f.tell()
    os.replace(tmp, path)
    return size


def _version(epoch: int, batch: Optional[int] = None) -> str:
    """Checkpoint version name, zero-padded so string order is age order:
    ``{epoch:08d}``, or ``{epoch:08d}.{batch:08d}`` for a mid-epoch save."""
    if not batch:
        return f"{epoch:08d}"
    return f"{epoch:08d}.{int(batch):08d}"


def _write_payload(path: str, host_state, epoch: int, loss: float, extra,
                   retain: int = DEFAULT_RETAIN,
                   mesh_manifest: Optional[dict] = None) -> int:
    """Seal and write one payload with its retention trail; returns the
    file's bytes."""
    pieces = _payload_blob(host_state, epoch, loss, extra, mesh_manifest)
    if retain > 0:
        # the sealed blob lands in {path}.history/ first, then `path` is
        # committed as a hard link (a copy where links fail): one write,
        # `retain` restorable generations
        hist_dir = f"{path}.history"
        os.makedirs(hist_dir, exist_ok=True)
        hist_path = os.path.join(hist_dir,
                                 f"{_next_history_seq(hist_dir):08d}.ckpt")
        size = _atomic_write(hist_path, pieces)
        chaos.crash_point("gathered-save:pre-commit")
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            if os.path.lexists(tmp):
                os.remove(tmp)
            os.link(hist_path, tmp)
        except OSError:
            shutil.copyfile(hist_path, tmp)
        os.replace(tmp, path)
        for stale in _gathered_history_paths(path)[retain:]:
            try:
                os.remove(stale)
            except OSError:
                pass
    else:
        size = _atomic_write(path, pieces)
    # a JAX job that wrote the sharded format here leaves {path}.shards;
    # once the gathered file is committed at `path`, nothing points at it
    stale = f"{path}.shards"
    if os.path.isdir(stale):
        shutil.rmtree(stale, ignore_errors=True)
        logger.info("Removed stale shard root %s (format switch)", stale)
    logger.info("Checkpoint saved to %s (version %s)", path,
                _version(epoch, (extra or {}).get("batch_in_epoch")))
    return size


def save_checkpoint(
    path: str,
    state: TrainState,
    epoch: int,
    loss: float,
    extra: Optional[dict] = None,
    saver: Optional[AsyncSaver] = None,
    sharded: bool = False,
    retain: int = DEFAULT_RETAIN,
    layout=None,
) -> dict:
    """Write a checkpoint of ``state`` (called on every rank).

    ``layout`` is the optimizer's state layout (the train step's
    ``layout(state)``; default replicated). The calling thread gathers
    (under ZeRO-1, a collective) and copies the state to host memory; with
    a ``saver`` in a one-process job the rest runs on its thread, else
    rank 0 writes here and every rank meets at a barrier.

    Returns the save's record (also appended to ``saver.records``):
    ``path``; ``copy_s``, the gather and the device-to-host copy;
    ``wait_s``, the wait for the saver's previous write to end; ``hold_s``,
    all the time the calling thread spent here (the copy, the wait and, in
    a synchronous save, the write and the barrier); ``write_s``, encoding,
    sealing and writing; and the file's ``bytes``. ``write_s`` and
    ``bytes`` fill in when an async write ends.
    """
    if sharded:
        raise _not_in_slice("checkpoint_format='sharded'")
    start = time.perf_counter()
    tree = state_tree(state, layout)
    stamp = elastic.mesh_manifest(
        tree, getattr(layout, "partitioner", None),
        world=distributed.process_count())
    world, rank = distributed.process_count(), distributed.process_index()
    host = to_host(tree) if rank == 0 else None
    copied = time.perf_counter()
    record = {"path": path, "copy_s": copied - start, "wait_s": 0.0,
              "hold_s": None, "write_s": None, "bytes": None}
    if saver is not None:
        saver.records.append(record)

    def write():
        t0 = time.perf_counter()
        record["bytes"] = _write_payload(path, host, epoch, loss, extra,
                                         retain=retain, mesh_manifest=stamp)
        record["write_s"] = time.perf_counter() - t0

    if saver is not None and world == 1:
        saver.wait()  # one in flight: the previous write ends first
        record["wait_s"] = time.perf_counter() - copied
        saver.submit(write)
    else:
        if rank == 0:
            write()
        distributed.barrier()  # the file is complete before any rank reads
    record["hold_s"] = time.perf_counter() - start
    return record


def _load_gathered_file(path: str, state: TrainState, layout,
                        target_axes: Optional[dict] = None
                        ) -> Tuple[TrainState, int, dict]:
    """Restore one gathered checkpoint file (CRC-verified) into
    ``state``."""
    payload = msgpack.msgpack_restore(read_verified(path))
    if not isinstance(payload, dict) or "state" not in payload:
        raise CheckpointCorruptError(
            f"{path}: not a gathered checkpoint payload")
    elastic.validate_resume(payload.get(elastic.MANIFEST_KEY), target_axes,
                            path)
    train_state_from_flax(state, payload["state"], layout)
    logger.info("Checkpoint loaded from %s, epoch %s", path,
                payload["epoch"])
    return state, int(payload["epoch"]), dict(payload.get("extra", {}))


def _is_sharded(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(SHARDED_MAGIC)) == SHARDED_MAGIC
    except OSError:
        return False


def load_checkpoint(
    path: str,
    state: TrainState,
    layout=None,
    on_event: Optional[Callable[..., None]] = None,
) -> Tuple[TrainState, int, dict]:
    """Restore ``(state, epoch, extra)`` in place (called on every rank;
    each reads the file, and under ZeRO-1 slices its own tiles).

    Every candidate is CRC-verified, and a torn or corrupt newest one walks
    back to the newest intact history entry, logged and reported as
    ``on_event("checkpoint_fallback", restored=..., epoch=...,
    skipped=[...])``; :class:`CheckpointCorruptError` lists every attempt
    when none restores. The walk takes the candidates newest first (the JAX
    package's order under ``DPX_ELASTIC=1``; without it, JAX prefers
    ancestors stamped with the target mesh, which matters only across the
    elastic reshapes of ROADMAP.md queue 1, item 9).
    """
    if _is_sharded(path):
        raise _not_in_slice(f"{path} is a sharded checkpoint")
    target_axes = {"data": distributed.process_count()}
    candidates = [path]
    for p in _gathered_history_paths(path):
        try:
            if os.path.samefile(p, path):
                continue  # `path` hard-links the newest history entry
        except OSError:
            pass
        candidates.append(p)
    skipped: List[Tuple[str, str]] = []
    for desc in candidates:
        try:
            state, epoch, extra = _load_gathered_file(desc, state, layout,
                                                      target_axes)
        except elastic.MissingMeshManifestError:
            raise  # a configuration error, not corruption
        except Exception as err:
            reason = f"{type(err).__name__}: {err}"
            skipped.append((desc, reason))
            logger.warning(
                "Checkpoint candidate %s unusable (%s); trying the "
                "next-newest ancestor", desc, reason,
            )
            continue
        if skipped:
            logger.warning(
                "Checkpoint fallback: restored %s (epoch %d) after "
                "skipping %d corrupt/torn candidate(s): %s",
                desc, epoch, len(skipped),
                "; ".join(f"{d} ({r})" for d, r in skipped),
            )
            if on_event is not None:
                on_event(
                    "checkpoint_fallback", restored=desc, epoch=epoch,
                    skipped=[{"candidate": d, "reason": r}
                             for d, r in skipped],
                )
        return state, epoch, extra
    raise CheckpointCorruptError(
        f"no intact checkpoint at {path}: all {len(skipped)} candidate(s) "
        "failed — " + "; ".join(f"{d} ({r})" for d, r in skipped)
    )

