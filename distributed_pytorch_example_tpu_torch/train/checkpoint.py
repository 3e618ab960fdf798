"""Checkpoint save / load with the best+latest policy and epoch and step
resume (the JAX package's train/checkpoint.py, both its formats).

Parity contract (reference train.py:178-209, 252-308), as in the JAX
package:

- a checkpoint is one logical view of the train state: the tree that
  ``flax.serialization.to_state_dict`` makes of the JAX ``TrainState``
  (``train/state.py``), flax-msgpack encoded (``utils/msgpack.py``), every
  file sealed in the ``DPX-CRC1`` envelope (``robustness/integrity.py``),
  and stamped with the format-3 mesh manifest. A checkpoint written by
  either package, in either format, loads in the other;
- resume continues after the last finished epoch (the loop stamps an
  epoch-end save ``epoch + 1``); a mid-epoch save carries
  ``extra["batch_in_epoch"]`` and the loader stamp, and resume restarts at
  that batch;
- :func:`load_checkpoint` detects the format, verifies every file's CRC
  and, when the newest candidate is torn or corrupt, walks back to the
  newest intact one (the pointed sharded version, older version dirs,
  then the gathered history), logging what it skipped and firing
  ``on_event("checkpoint_fallback", ...)``. After a failure it prefers
  candidates stamped with this world's mesh unless ``DPX_ELASTIC=1``
  asks for the newest intact one.

Two formats:

- **gathered**: one file, a payload ``{epoch, loss, state, extra,
  mesh_manifest}``. Under ZeRO-1 (and FSDP, the parameters too) every
  rank gathers its tiles into full leaves (a library all-gather, a
  collective); rank 0 writes and all meet
  at a barrier, so it saves on the saver's thread only in a one-process
  job. Retention: each save lands in ``{path}.history/{seq:08d}.ckpt``
  first and ``path`` becomes a hard link to it; the trail keeps
  ``retain`` entries.
- **sharded**: ``{path}.shards/{version}/shard_{rank:05d}.msgpack`` per
  process (``{path: [{start, data}]}``, what this rank owns: its ZeRO-1
  tiles or its FSDP tiles of the parameters and moments, written by the
  ranks of data index 0, and on rank 0 every replicated leaf) plus
  ``manifest.msgpack``
  (``epoch``, ``loss``, ``extra``, ``nproc``, ``leaves`` with each leaf's
  ``shape``, ``dtype`` and ``chunks``, ``host_leaves``,
  ``mesh_manifest``), and ``path`` itself a pointer file,
  :data:`SHARDED_MAGIC` + the version. No gather: the only collective is
  the barrier that begins a save, after rank 0 has removed a crashed
  save's dir of the same version; then every rank writes its file and
  rank 0, once every shard file has landed (a rendezvous on the shared
  filesystem, :data:`SHARD_WAIT_TIMEOUT_S`), commits the manifest and
  flips the pointer last, and removes all but the newest ``retain``
  version dirs. So it saves on the saver's thread at any process count.
  A load reassembles each leaf from every shard file, one leaf at a
  time, and keeps what the layout needs of it (this rank's tiles), so a
  checkpoint saved at one world or mode (replicated, ZeRO-1, FSDP)
  restores at any other.

The async save: the port updates parameters and moments in place, so the
snapshot is a synchronous device-to-host copy on the calling thread
(the gathered format's gather included), taken before the next step;
:class:`AsyncSaver` then encodes, checksums and writes it on a thread.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from distributed_pytorch_example_tpu_torch import interop
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
from distributed_pytorch_example_tpu_torch.train.optimizers import Chunk
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

# pointer-file magic of the sharded format (a gathered checkpoint is
# sealed msgpack, which never begins with this line)
SHARDED_MAGIC = b"DPX-SHARDED-V1\n"
# how long rank 0 waits for the other ranks' shard files of one version
SHARD_WAIT_TIMEOUT_S = 600.0

# keep-last-K retention default: current + two ancestors; 0 disables the
# history trail (the sharded format keeps at least the live version)
DEFAULT_RETAIN = 3

# re-attempts of a failed async write, and the first backoff's seconds
IO_RETRIES = 2
RETRY_BASE_DELAY = 0.1


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
            if elastic.HISTORY_RE.fullmatch(n)]
    return max(seqs, default=-1) + 1


def _gathered_history_paths(path: str) -> List[str]:
    """History entries newest-first (fallback candidates)."""
    hist_dir = f"{path}.history"
    if not os.path.isdir(hist_dir):
        return []
    names = sorted((n for n in os.listdir(hist_dir)
                    if elastic.HISTORY_RE.fullmatch(n)), reverse=True)
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


def _sealed(tree) -> list:
    """``tree`` flax-msgpack encoded in the ``DPX-CRC1`` envelope, as
    buffers (envelope header first, unjoined)."""
    pieces = msgpack.msgpack_pieces(tree)
    return [seal_header(pieces)] + pieces


def _payload_blob(host_state, epoch: int, loss: float, extra,
                  mesh_manifest: Optional[dict] = None) -> list:
    """The sealed gathered payload as buffers, envelope header first and
    unjoined; joined, they are the JAX package's bytes for the same
    tree."""
    return _sealed(_payload(host_state, epoch, loss, extra, mesh_manifest))


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
    ``{epoch:08d}``, or ``{epoch:08d}.{batch:08d}`` for a mid-epoch save
    (a unique name, so a crashed mid-epoch save never touches the intact
    version before it; it sorts after the save that opened its epoch and
    before the one that closes it)."""
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
    # a job that wrote the sharded format here leaves {path}.shards; once
    # the gathered file is committed at `path`, nothing points at it
    stale = f"{path}.shards"
    if os.path.isdir(stale):
        shutil.rmtree(stale, ignore_errors=True)
        logger.info("Removed stale shard root %s (format switch)", stale)
    logger.info("Checkpoint saved to %s (version %s)", path,
                _version(epoch, (extra or {}).get("batch_in_epoch")))
    return size


# ---------------------------------------------------------------------------
# sharded format
# ---------------------------------------------------------------------------


def _dtype_name(x) -> str:
    """The leaf's dtype as the JAX package names it (``str(dtype)``)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def _host_copy(x):
    """A host copy of one leaf's data that later in-place updates leave as
    it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _own_chunks(tree: dict, rank: int) -> Tuple[dict, dict]:
    """``(leaves, chunks)`` of a state tree made with ``gather=False``:
    the manifest's ``leaves`` (every leaf's shape, dtype and chunk count)
    and this rank's shard file ``{path: [{start, data}]}`` with the data
    copied to the host: its :class:`Chunk` s (those it writes: a tile that
    ranks of several data indices hold is written by data index 0's), and
    on rank 0 every whole leaf (replica 0 of a replicated leaf is rank
    0's)."""
    leaves, chunks = {}, {}
    for path, leaf in elastic.tree_leaves(tree):
        owned = leaf.primary if isinstance(leaf, Chunk) else rank == 0
        if not isinstance(leaf, Chunk):
            leaf = Chunk(tuple(leaf.shape), [0] * len(leaf.shape), leaf, 1)
        leaves[path] = {"shape": [int(d) for d in leaf.shape],
                        "dtype": _dtype_name(leaf.data),
                        "chunks": int(leaf.count)}
        if owned:
            chunks[path] = [{"start": [int(i) for i in leaf.start],
                             "data": _host_copy(leaf.data)}]
    return leaves, chunks


def _begin_sharded_save(path: str, version: str) -> None:
    """The calling thread's prologue, the format's one collective: rank 0
    removes a version dir that a crashed save (or an identical rerun) left
    behind, so its rendezvous never sees old shard files, and a barrier
    keeps every rank from writing before that."""
    step_dir = os.path.join(f"{path}.shards", version)
    if distributed.process_index() == 0 and os.path.isdir(step_dir):
        shutil.rmtree(step_dir, ignore_errors=True)
    distributed.barrier()


def _write_sharded(path: str, version: str, chunks: dict, leaves: dict,
                   epoch: int, loss: float, extra, rank: int, nproc: int,
                   retain: int, mesh_manifest: Optional[dict]) -> int:
    """Write this rank's shard file; on rank 0 also wait for every other
    rank's, then commit the manifest, flip the pointer and drop old
    version dirs. Returns this rank's shard file bytes."""
    step_dir = os.path.join(f"{path}.shards", version)
    os.makedirs(step_dir, exist_ok=True)
    size = _atomic_write(os.path.join(step_dir, f"shard_{rank:05d}.msgpack"),
                         _sealed(chunks))
    # this rank's shard is on disk and the pointer still names the
    # previous version: the window a preempted process dies in
    chaos.crash_point("sharded-save:post-shards")
    if rank != 0:
        return size
    deadline = time.monotonic() + SHARD_WAIT_TIMEOUT_S
    missing = [os.path.join(step_dir, f"shard_{i:05d}.msgpack")
               for i in range(nproc)]
    while True:
        missing = [f for f in missing if not os.path.exists(f)]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"sharded checkpoint: {len(missing)} shard files still "
                f"missing after {SHARD_WAIT_TIMEOUT_S}s: {missing[:3]}...")
        time.sleep(0.1)
    manifest = {
        "epoch": int(epoch),
        "loss": float(loss),
        "extra": extra or {},
        "nproc": int(nproc),
        "leaves": leaves,
        "host_leaves": {},
    }
    if mesh_manifest is not None:
        manifest[elastic.MANIFEST_KEY] = mesh_manifest
    _atomic_write(os.path.join(step_dir, "manifest.msgpack"),
                  _sealed(manifest))
    chaos.crash_point("sharded-save:post-manifest")
    _atomic_write(path, [SHARDED_MAGIC + version.encode()])
    # versions older than this commit are complete on every rank (each
    # rank's saves run in order); keep the newest retain - 1 of them as
    # fallback ancestors. A newer dir may hold a save still in flight.
    base = f"{path}.shards"
    older = sorted(n for n in os.listdir(base)
                   if elastic.VERSION_RE.fullmatch(n) and n < version)
    for name in older[:max(len(older) - max(retain - 1, 0), 0)]:
        shutil.rmtree(os.path.join(base, name), ignore_errors=True)
    logger.info("Sharded checkpoint saved to %s (version %s)", path, version)
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
    ``layout(state)``; default replicated). The calling thread copies the
    state to host memory (gathered: after the ZeRO-1 gather, a
    collective; sharded: after the begin barrier, only what this rank
    owns). With a ``saver`` the rest runs on its thread, for the sharded
    format at any process count and for the gathered one in a one-process
    job; else it runs here (gathered: rank 0 writes and every rank meets at
    a barrier; sharded: each rank writes its file and rank 0 commits).

    Returns the save's record (also appended to ``saver.records``):
    ``path``; ``copy_s``, the gather and the device-to-host copy;
    ``wait_s``, the wait for the saver's previous write to end; ``hold_s``,
    all the time the calling thread spent here (the copy, the wait, the
    sharded format's begin barrier and, in a synchronous save, the write);
    ``write_s``, encoding, sealing and writing; and the file's ``bytes``
    (sharded: this rank's shard file). ``write_s`` and ``bytes`` fill in
    when an async write ends.
    """
    start = time.perf_counter()
    world, rank = distributed.process_count(), distributed.process_index()
    record = {"path": path, "copy_s": 0.0, "wait_s": 0.0, "hold_s": None,
              "write_s": None, "bytes": None}
    if saver is not None:
        saver.records.append(record)
    partitioner = getattr(layout, "partitioner", None)
    if sharded:
        version = _version(epoch, (extra or {}).get("batch_in_epoch"))
        if saver is not None:
            # a previous write may still target this version's dir (a
            # rerun repeats a name): it lands before the cleanup
            saver.wait()
            record["wait_s"] = time.perf_counter() - start
        _begin_sharded_save(path, version)
        copy_start = time.perf_counter()
        tree = state_tree(state, layout, gather=False)
        stamp = elastic.mesh_manifest(tree, partitioner, world=world)
        leaves, chunks = _own_chunks(tree, rank)
        record["copy_s"] = time.perf_counter() - copy_start

        def write():
            t0 = time.perf_counter()
            record["bytes"] = _write_sharded(
                path, version, chunks, leaves, epoch, loss, extra, rank,
                world, retain, stamp)
            record["write_s"] = time.perf_counter() - t0

        if saver is not None:
            saver.submit(write)
        else:
            write()
        record["hold_s"] = time.perf_counter() - start
        return record

    tree = state_tree(state, layout)
    stamp = elastic.mesh_manifest(tree, partitioner, world=world)
    host = to_host(tree) if rank == 0 else None
    copied = time.perf_counter()
    record["copy_s"] = copied - start

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


def _pointed_version_dir(path: str) -> Optional[str]:
    """The version dir the pointer file names, or None if unparseable."""
    try:
        with open(path, "rb") as f:
            version = f.read()[len(SHARDED_MAGIC):].decode(
                "utf-8", errors="replace").strip()
    except OSError:
        return None
    if not elastic.VERSION_RE.fullmatch(version):
        logger.warning(
            "Corrupt sharded pointer %s (version %r); falling back to the "
            "version-dir scan", path, version[:40])
        return None
    return os.path.join(f"{path}.shards", version)


def _sharded_version_dirs(path: str) -> List[str]:
    """Committed-or-torn version dirs newest-first (fallback candidates)."""
    base = f"{path}.shards"
    if not os.path.isdir(base):
        return []
    names = sorted((n for n in os.listdir(base)
                    if elastic.VERSION_RE.fullmatch(n)), reverse=True)
    return [os.path.join(base, n) for n in names]


def _empty_leaf(meta: dict):
    """A host buffer for one leaf of the manifest (torch for bfloat16,
    which numpy lacks)."""
    shape = tuple(int(d) for d in meta["shape"])
    if meta["dtype"] == "bfloat16":
        return torch.empty(shape, dtype=torch.bfloat16)
    return np.empty(shape, np.dtype(meta["dtype"]))


def _place(full, mine):
    """What this rank keeps of one reassembled leaf: where the layout
    shards it (``mine`` is this rank's :class:`Chunk` of the live state),
    a copy of its tile as a :class:`Chunk`, which the layout takes as it
    is; else (and for a chunk the rank keeps whole) the whole leaf."""
    if not isinstance(mine, Chunk) or mine.whole:
        return full
    idx = tuple(slice(s, s + d) for s, d in zip(mine.start, mine.data.shape))
    return Chunk(mine.shape, list(mine.start),
                 interop.as_tensor(full)[idx].clone(), mine.count)


def _rebuild(template, full: dict, prefix: str = ""):
    """``template``'s nested maps (empty ones too) with each leaf replaced
    by ``full[path]``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, full, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    return full[prefix]


def _load_sharded_version(step_dir: str, state: TrainState, layout,
                          target_axes: Optional[dict] = None
                          ) -> Tuple[TrainState, int, dict]:
    """Restore one sharded version dir (CRC-verified manifest and shard
    files) into ``state``.

    Reassembly streams per leaf, as in the JAX package: the shard files
    are read one at a time, and as soon as a leaf's last chunk is in, the
    layout's part of it is kept (this rank's tile of a leaf the layout
    shards, else the whole leaf) and the full buffer freed. So the host
    holds at most this rank's own state, one decoded shard file and the
    leaves still being assembled, never the full ZeRO-1 moments. The kept
    parts go into the live state once every leaf is in, so a torn or
    foreign checkpoint raises before anything changes (JAX builds a new
    state; the port updates its own in place)."""
    manifest = msgpack.msgpack_restore(
        read_verified(os.path.join(step_dir, "manifest.msgpack")))
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        raise CheckpointCorruptError(
            f"{step_dir}: manifest is not a checkpoint manifest")
    elastic.validate_resume(manifest.get(elastic.MANIFEST_KEY), target_axes,
                            step_dir)
    template = state_tree(state, layout, gather=False)
    mine = dict(elastic.tree_leaves(template))
    meta = manifest["leaves"]
    host_leaves = manifest.get("host_leaves") or {}
    have = set(meta) | set(host_leaves)
    if have != set(mine):
        raise ValueError(
            f"{step_dir}: checkpoint leaves differ from this state's (another "
            f"model, optimizer, clipping, schedule or every_k?): missing "
            f"{sorted(set(mine) - have)[:5]}, unexpected "
            f"{sorted(have - set(mine))[:5]}")
    ready = {p: _place(v, mine[p]) for p, v in host_leaves.items()}
    buffers: dict = {}
    remaining = {p: int(m.get("chunks") or 1) for p, m in meta.items()}
    for i in range(int(manifest["nproc"])):
        chunks = msgpack.msgpack_restore(read_verified(
            os.path.join(step_dir, f"shard_{i:05d}.msgpack")))
        for p, entries in chunks.items():
            if p not in meta or p in ready:
                continue
            buf = buffers.get(p)
            if buf is None:
                buf = buffers[p] = _empty_leaf(meta[p])
            for entry in entries:
                data = entry["data"]
                idx = tuple(slice(int(s), int(s) + d)
                            for s, d in zip(entry["start"], data.shape))
                if isinstance(buf, torch.Tensor):
                    buf[idx] = interop.as_tensor(data)
                else:
                    buf[idx] = data
            remaining[p] -= len(entries)
            if remaining[p] <= 0:
                ready[p] = _place(buffers.pop(p), mine[p])
        del chunks
    short = sorted(set(meta) - set(ready))
    if short:
        raise CheckpointCorruptError(
            f"{step_dir}: chunks missing for {len(short)} leaves, e.g. "
            f"{short[:3]}")
    train_state_from_flax(state, _rebuild(template, ready), layout)
    logger.info("Sharded checkpoint loaded from %s, epoch %s", step_dir,
                manifest["epoch"])
    return state, int(manifest["epoch"]), dict(manifest.get("extra", {}))


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


def _peek_stamped_axes(desc: str) -> Optional[dict]:
    """The canonical stamped mesh axes of one fallback candidate, or None
    (unreadable or unstamped). A version dir reads its manifest; a
    gathered file is decoded whole (only on the fallback path)."""
    try:
        artifact = (os.path.join(desc, "manifest.msgpack")
                    if os.path.isdir(desc) else desc)
        blob = msgpack.msgpack_restore(read_verified(artifact))
        stamp = (blob.get(elastic.MANIFEST_KEY) if isinstance(blob, dict)
                 else None)
        if isinstance(stamp, dict):
            return elastic.canonical_axes(stamp.get("axes", {}))
    except Exception:
        return None
    return None


def _order_fallback_candidates(queue: list, target_axes: Optional[dict]
                               ) -> list:
    """The remaining candidates after a failure: in age order under
    ``DPX_ELASTIC=1`` (the newest intact one wins); otherwise those
    stamped with the target mesh first, age order within each group."""
    target = elastic.canonical_axes(target_axes)
    if elastic.elastic_enabled() or target is None:
        return queue
    same_mesh, other = [], []
    for cand in queue:
        (same_mesh if _peek_stamped_axes(cand[0]) == target
         else other).append(cand)
    if same_mesh and other:
        logger.info(
            "Checkpoint fallback ordering: preferring %d same-mesh "
            "ancestor(s) over %d cross-mesh one(s) (set %s=1 for "
            "newest-intact-wins)", len(same_mesh), len(other),
            elastic.ELASTIC_ENV)
    return same_mesh + other


def load_checkpoint(
    path: str,
    state: TrainState,
    layout=None,
    on_event: Optional[Callable[..., None]] = None,
) -> Tuple[TrainState, int, dict]:
    """Restore ``(state, epoch, extra)`` in place (called on every rank;
    each reads every file it needs, and under ZeRO-1 slices its own
    tiles). Either format, detected from ``path``.

    Candidates, newest first: a pointer's version, the other version dirs,
    then the gathered history (for a gathered ``path``: the file, its
    history, then any version dirs). Every candidate is CRC-verified; a
    torn or corrupt one is skipped, logged and reported as
    ``on_event("checkpoint_fallback", restored=..., epoch=...,
    skipped=[...])``, and after the first failure the rest are reordered
    to prefer this world's mesh (:func:`_order_fallback_candidates`).
    :class:`CheckpointCorruptError` lists every attempt when none
    restores; ``MissingMeshManifestError`` (an unstamped checkpoint under
    ``DPX_ELASTIC=1``) is raised at once.
    """
    partitioner = getattr(layout, "partitioner", None)
    target_axes = (dict(partitioner.mesh_shape) if partitioner is not None
                   else {"data": distributed.process_count()})
    candidates: List[Tuple[str, Callable]] = []

    def add_sharded(primary_first: bool) -> None:
        pointed = _pointed_version_dir(path) if primary_first else None
        dirs = _sharded_version_dirs(path)
        if pointed is not None:
            dirs = [pointed] + [d for d in dirs if os.path.basename(d)
                                != os.path.basename(pointed)]
        for d in dirs:
            candidates.append((d, lambda d=d: _load_sharded_version(
                d, state, layout, target_axes)))

    def add_history() -> None:
        for p in _gathered_history_paths(path):
            try:
                if os.path.samefile(p, path):
                    continue  # `path` hard-links the newest history entry
            except OSError:
                pass
            candidates.append((p, lambda p=p: _load_gathered_file(
                p, state, layout, target_axes)))

    if _is_sharded(path):
        add_sharded(primary_first=True)
        # a job that switched to the sharded format keeps its gathered
        # trail as the oldest candidates
        add_history()
    else:
        candidates.append((path, lambda: _load_gathered_file(
            path, state, layout, target_axes)))
        add_history()
        # a bit-flipped pointer no longer starts with the magic and reads
        # as a corrupt gathered file; intact version dirs still restore
        add_sharded(primary_first=False)

    skipped: List[Tuple[str, str]] = []
    queue, reordered = list(candidates), False
    while queue:
        desc, thunk = queue.pop(0)
        try:
            state, epoch, extra = thunk()
        except elastic.MissingMeshManifestError:
            raise  # a configuration error, not corruption
        except Exception as err:
            reason = f"{type(err).__name__}: {err}"
            skipped.append((desc, reason))
            logger.warning(
                "Checkpoint candidate %s unusable (%s); trying the "
                "next-newest ancestor", desc, reason,
            )
            if not reordered and queue:
                reordered = True  # one reorder per load
                queue = _order_fallback_candidates(queue, target_axes)
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
