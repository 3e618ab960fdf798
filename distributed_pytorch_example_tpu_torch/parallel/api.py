"""The ZeRO-1 part of the JAX package's ``Partitioner`` (parallel/api.py).

Pure data parallelism: every parameter is replicated and the batch is
split across processes (the reference's DDP semantics, train.py:233).
With ``dp_shard_opt_state=True`` the update becomes ZeRO-1: gradients
reduce-scatter, each process keeps optimizer state only for its tile of
each large leaf, and the updated tiles gather back into the replicated
parameters (``train/optimizers.py``). The leaf a tile is cut from, and the
dim it is cut along, follow the JAX package exactly: the dim is chosen on
the leaf's JAX layout (``interop.flax_leaves``) and the dims are keyed by
the JAX param path, so tiles and buckets equal JAX's.

Meshes, partition rules, FSDP, tensor parallelism and ``PlanSpec`` are not
ported (ROADMAP.md queue 1, item 11); the one axis is ``data``, of one
rank per process.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

from distributed_pytorch_example_tpu_torch.runtime import distributed

# ZeRO-1 floor: leaves below this many ELEMENTS stay replicated (64 KB at
# f32: a reduce-scatter of a bias costs more in latency than its shard
# saves)
DEFAULT_OPT_SHARD_MIN_SIZE = 1 << 14


class Partitioner:
    """The data axis (``world`` ranks, default: the processes) and the
    ZeRO-1 overlay over it; ``wire`` (a ``parallel.wire.WireConfig``)
    carries the gradient collectives' payload policy to the step."""

    def __init__(
        self,
        world: Optional[int] = None,
        dp_shard_opt_state: bool = False,
        opt_shard_axis: str = "data",
        opt_shard_min_size: int = DEFAULT_OPT_SHARD_MIN_SIZE,
        wire=None,
    ):
        self.world = distributed.process_count() if world is None else world
        self.dp_shard_opt_state = dp_shard_opt_state
        self.opt_shard_axis = opt_shard_axis
        self.opt_shard_min_size = opt_shard_min_size
        self.wire = wire

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return {self.opt_shard_axis: self.world}

    def zero1_dim(self, shape: Sequence[int]) -> Optional[int]:
        """The dim ZeRO-1 shards a leaf of this (JAX-layout) shape on, or
        None: the largest dim the axis size divides (the first of equal
        ones), for leaves of at least ``opt_shard_min_size`` elements."""
        shape = tuple(int(s) for s in shape)
        if not self.dp_shard_opt_state or not shape:
            return None
        size = self.world
        if size <= 1 or math.prod(shape) < self.opt_shard_min_size:
            return None
        best = None
        for dim, extent in enumerate(shape):
            if extent % size == 0 and (best is None or extent > shape[best]):
                best = dim
        return best

    def zero1_dims(self, shapes: Mapping[str, Sequence[int]]
                   ) -> Dict[str, Optional[int]]:
        """Per-leaf ZeRO-1 dims keyed by the JAX param path; ``shapes``
        maps each path to its JAX-layout shape. None = an all-reduced,
        replicated leaf."""
        return {path: self.zero1_dim(shape) for path, shape in shapes.items()}

    def grad_sync_axis(self) -> str:
        """The axis the gradient collectives run over."""
        return self.opt_shard_axis


def data_parallel(
    world: Optional[int] = None,
    dp_shard_opt_state: bool = False,
    opt_shard_min_size: int = DEFAULT_OPT_SHARD_MIN_SIZE,
    wire=None,
) -> Partitioner:
    """Pure DP over ``world`` ranks (default: the processes);
    ``dp_shard_opt_state=True`` flips the update to ZeRO-1."""
    return Partitioner(world, dp_shard_opt_state=dp_shard_opt_state,
                       opt_shard_min_size=opt_shard_min_size, wire=wire)
