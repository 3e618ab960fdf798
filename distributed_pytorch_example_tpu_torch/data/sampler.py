"""Deterministic sharded sampling with per-epoch reshuffle (the JAX
package's data/sampler.py).

Contract parity with ``torch.utils.data.DistributedSampler`` as the
reference uses it (``shuffle=True``, ``set_epoch(epoch)``):

- every shard computes the SAME global permutation without communicating,
  seeded by ``seed + epoch``;
- the index list is padded by wrapping so it divides evenly by the shard
  count, or truncated when ``drop_last``;
- shard ``i`` takes the strided slice ``indices[i::num_shards]``.

The permutation is the JAX package's SplitMix64-seeded Fisher-Yates in
numpy, so shards are bit-identical to the JAX package's on every host.
The JAX package's native C++ backend for it is not ported yet (ROADMAP.md
queue 1, item 13); this numpy path is the one that backend matches.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np


def permutation(n: int, seed: int) -> np.ndarray:
    """Fisher-Yates over [0, n) with a SplitMix64 stream (vectorized draw,
    scalar swap); identical to the JAX package's ``permutation``."""
    # one SplitMix64 draw per position: positions n-1 .. 1 use draws 1..n-1
    state = np.arange(1, n, dtype=np.uint64)
    x = (np.uint64(seed) + state * np.uint64(0x9E3779B97F4A7C15)) & np.uint64(
        0xFFFFFFFFFFFFFFFF
    )
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    perm = np.arange(n, dtype=np.int64)
    # swap position i with z[i-1] % (i+1), descending — inside-out FY
    for i in range(n - 1, 0, -1):
        j = int(z[i - 1] % np.uint64(i + 1))
        perm[i], perm[j] = perm[j], perm[i]
    return perm


class ShardedSampler:
    """Per-epoch deterministic shard of a global (optionally shuffled)
    index set — the reference's ``DistributedSampler(dataset,
    num_replicas=world_size, rank=rank, shuffle=True)``."""

    def __init__(
        self,
        num_samples: int,
        num_shards: int = 1,
        shard_id: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not 0 <= shard_id < num_shards:
            raise ValueError(
                f"shard_id {shard_id} out of range for {num_shards} shards"
            )
        self.num_samples = num_samples
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.shard_len = num_samples // num_shards
        else:
            self.shard_len = math.ceil(num_samples / num_shards)
        self.total_size = self.shard_len * num_shards

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle for a new epoch (reference train.py:267)."""
        self.epoch = epoch

    def global_indices(self) -> np.ndarray:
        """The full (padded/truncated) global index order for this epoch."""
        if self.shuffle:
            indices = permutation(self.num_samples, self.seed + self.epoch)
        else:
            indices = np.arange(self.num_samples, dtype=np.int64)
        if self.drop_last:
            return indices[: self.total_size]
        if self.total_size > self.num_samples:
            # pad by wrapping from the front (DistributedSampler behaviour)
            pad = self.total_size - self.num_samples
            indices = np.concatenate([indices, indices[:pad]])
        return indices

    def shard_indices(self) -> np.ndarray:
        """This shard's strided slice of the global order."""
        return self.global_indices()[self.shard_id :: self.num_shards]

    def __iter__(self) -> Iterator[int]:
        return iter(self.shard_indices().tolist())

    def __len__(self) -> int:
        return self.shard_len
