"""Host -> device batch pipeline (the JAX package's data/loader.py).

The reference's ``DataLoader(pin_memory=...)`` + ``DistributedSampler``
pair, with the JAX package's batch contract:

- the dataset is sharded by process with :class:`ShardedSampler`; each
  process assembles its local ``global_batch_size / num_shards`` rows.
  Under a (data, fsdp) mesh (``runtime/mesh.py``) the process rank is
  the flat rank over (data, fsdp), row-major, so the batch splits over
  both axes as JAX's ``batch_spec`` ``P(("data", "fsdp"))`` splits it;
  at ``fsdp = 1`` that is the data rank, as before. Given the ``mesh``,
  the loader shards over its data axes only, at the rank's flat index
  there: under tensor parallelism every rank of a tensor group reads the
  same rows, as JAX's batch spec replicates them over ``tensor``;
- the final partial batch is padded by wrapping (``drop_last=True`` drops
  it), so every step has the same shape;
- the batches and their order equal the JAX ``DeviceLoader``'s, element
  for element.

A background thread assembles up to ``prefetch`` batches ahead in pinned
host memory; the consumer copies each one onto ``device`` with
``non_blocking=True``, on the current stream, so the copy is ordered
before the step that reads it and does not block the host.
"""

from __future__ import annotations

import queue
import threading
from contextlib import nullcontext
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from distributed_pytorch_example_tpu_torch.data.sampler import ShardedSampler
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.runtime import mesh as mesh_lib
from distributed_pytorch_example_tpu_torch.runtime.device import resolve_device

# seconds the consumer waits for one prefetched batch before it gives up
_GET_TIMEOUT_S = 300.0


def _get_batch(dataset, indices: np.ndarray) -> Dict[str, np.ndarray]:
    if hasattr(dataset, "get_batch"):
        return dataset.get_batch(indices)
    elems = [dataset[int(i)] for i in indices]
    first = elems[0]
    if isinstance(first, dict):
        return {k: np.stack([e[k] for e in elems]) for k in first}
    # tuple convention (x, y) — the reference's __getitem__ shape
    return {
        "x": np.stack([e[0] for e in elems]),
        "y": np.stack([e[1] for e in elems]),
    }


class DeviceLoader:
    """Iterates device batches for one process of a data-parallel job."""

    def __init__(
        self,
        dataset,
        global_batch_size: int,
        *,
        device: Optional[Union[str, torch.device]] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        num_shards: Optional[int] = None,
        shard_id: Optional[int] = None,
        mesh=None,
    ):
        self.dataset = dataset
        self.device = resolve_device(device)
        if mesh is not None:
            num_shards = mesh_lib.data_parallel_size(mesh)
            shard_id = mesh_lib.data_index(mesh)
        if num_shards is None:
            num_shards = distributed.process_count()
        if shard_id is None:
            shard_id = distributed.process_index()
        if global_batch_size % num_shards != 0:
            raise ValueError(
                f"global_batch_size {global_batch_size} not divisible by "
                f"{num_shards} processes"
            )
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // num_shards
        self.sampler = ShardedSampler(
            len(dataset), num_shards=num_shards, shard_id=shard_id,
            shuffle=shuffle, seed=seed, drop_last=drop_last,
        )
        self.drop_last = drop_last
        self.prefetch = prefetch
        # graft-scope (set by Trainer.fit): host-to-device transfers emit
        # "h2d" trace spans
        self.telemetry = None
        if drop_last:
            self.steps_per_epoch = len(self.sampler) // self.local_batch_size
        else:
            self.steps_per_epoch = -(-len(self.sampler) // self.local_batch_size)
        if self.steps_per_epoch == 0:
            raise ValueError("Dataset shard smaller than one batch with drop_last")

    def set_epoch(self, epoch: int) -> None:
        """Reseed the global shuffle (reference train.py:267 contract)."""
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return self.steps_per_epoch

    def _epoch_indices(self) -> np.ndarray:
        """This epoch's padded shard-local index order (pure fn of epoch)."""
        indices = self.sampler.shard_indices()
        n = self.steps_per_epoch * self.local_batch_size
        if n > len(indices):  # wrap-pad the final partial batch
            indices = np.concatenate([indices, indices[: n - len(indices)]])
        return indices

    def _assemble(self, step: int, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """Host batch for one step — a pure function of (epoch, step)."""
        lo = step * self.local_batch_size
        return _get_batch(self.dataset,
                          indices[lo : lo + self.local_batch_size])

    def _host_batch(self, step: int, indices: np.ndarray) -> Dict[str, torch.Tensor]:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in self._assemble(step, indices).items()}
        if self.device.type == "cuda":
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def _to_device(self, host: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        scope = self.telemetry
        with scope.span("h2d") if scope is not None else nullcontext():
            return {k: v.to(self.device, non_blocking=True)
                    for k, v in host.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self.iter_from(0)

    def iter_from(self, start_step: int) -> Iterator[Dict[str, torch.Tensor]]:
        """This epoch's batches from ``start_step`` on (step-level resume).

        The permutation is a pure function of (seed, epoch), so skipping
        the first ``start_step`` batches gives exactly the batches an
        uninterrupted run would see next; the skipped ones are never
        assembled or moved.
        """
        if not 0 <= start_step <= self.steps_per_epoch:
            raise ValueError(
                f"start_step {start_step} outside [0, {self.steps_per_epoch}]"
            )
        indices = self._epoch_indices()
        steps = range(start_step, self.steps_per_epoch)
        if self.prefetch <= 0:
            for step in steps:
                yield self._to_device(self._host_batch(step, indices))
            return
        ready: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    ready.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def work() -> None:
            try:
                for step in steps:
                    if stop.is_set():
                        return
                    put(("batch", self._host_batch(step, indices)))
            except Exception as err:  # handed to the consumer, raised there
                put(("error", err))

        worker = threading.Thread(
            target=work, name=f"loader-shard{self.sampler.shard_id}",
            daemon=True,
        )
        worker.start()
        try:
            for _ in steps:
                try:
                    kind, item = ready.get(timeout=_GET_TIMEOUT_S)
                except queue.Empty:
                    raise TimeoutError(
                        f"no batch from the loader thread in {_GET_TIMEOUT_S}"
                        " s"
                    ) from None
                if kind == "error":
                    raise item
                yield self._to_device(item)
        finally:
            stop.set()
            while True:  # drain, so a blocked put sees the stop flag
                try:
                    ready.get_nowait()
                except queue.Empty:
                    break
            worker.join(timeout=10.0)
