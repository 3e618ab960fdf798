"""The process mesh (the JAX package's runtime/mesh.py).

JAX lays its devices out on a named multi-axis mesh and XLA compiles the
collectives that the shardings imply. Here one rank is one process (one
card per process, or the CPU), so the mesh lays the process ranks out
row-major over the same six axes, in JAX's order, and each axis of more
than one rank gets the torch process groups of its rank sets: the
collectives of that axis run over them.

Axis vocabulary (the JAX package's):

- ``data``     — pure data parallelism (the reference's DDP world);
- ``fsdp``     — data parallelism whose parameters and optimizer state are
  sharded; the batch is sharded over (data, fsdp) jointly;
- ``tensor``, ``sequence``, ``expert``, ``pipe`` — tensor, sequence,
  expert and pipeline parallelism. The port's steps serve ``data``,
  ``fsdp`` and ``tensor``; the CLI refuses the others above 1 (ROADMAP.md
  item 15).

``MeshSpec`` sizes multiply to the rank count; -1 means "absorb the rest"
(at most one axis). The multi-slice ("hybrid") layout of the JAX package,
which puts a slice boundary on a batch axis, is not ported (ROADMAP.md
item 11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from distributed_pytorch_example_tpu_torch.runtime import distributed

AXES = ("data", "fsdp", "tensor", "sequence", "expert", "pipe")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes for the global rank mesh."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    expert: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = dataclasses.asdict(self)
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"At most one mesh axis may be -1, got {unknown}")
        known = math.prod(v for v in sizes.values() if v != -1)
        if unknown:
            if n_devices % known != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {known}"
                )
            sizes[unknown[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(
                f"Mesh axes product {known} != device count {n_devices}"
            )
        return MeshSpec(**sizes)

    @property
    def axis_names(self) -> Sequence[str]:
        return AXES

    def axis_sizes(self) -> Sequence[int]:
        return (self.data, self.fsdp, self.tensor, self.sequence, self.expert, self.pipe)


class Mesh:
    """A resolved :class:`MeshSpec` over ``size`` ranks, seen from
    ``rank``: ``devices`` holds the ranks row-major in the axes' shape (as
    JAX's mesh holds its devices), ``shape`` the axis sizes by name.
    ``groups`` maps an axis to the process group of this rank's set along
    it; an axis that spans every rank uses the default group (None), and
    a mesh built without groups (:func:`make_mesh` with ``groups=False``)
    only answers shape questions."""

    def __init__(self, spec: MeshSpec, rank: int = 0,
                 groups: Optional[Dict[str, object]] = None):
        self.spec = spec
        self.axis_names = AXES
        self.shape: Dict[str, int] = dict(zip(AXES, spec.axis_sizes()))
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.devices = np.arange(self.size).reshape(tuple(spec.axis_sizes()))
        self.rank = rank
        self.coords: Dict[str, int] = dict(zip(AXES, (
            int(c) for c in np.unravel_index(rank, self.devices.shape))))
        self._groups = groups

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def axis_ranks(self, axis: str, rank: Optional[int] = None) -> List[int]:
        """The ranks that share every coordinate but ``axis`` with
        ``rank`` (default: this one), in axis order."""
        coords = np.unravel_index(self.rank if rank is None else rank,
                                  self.devices.shape)
        index = list(coords)
        index[AXES.index(axis)] = slice(None)
        return [int(r) for r in self.devices[tuple(index)]]

    def group(self, axis: str):
        """The process group of this rank's set along ``axis`` (None: the
        default group, whose ranks are every rank of the mesh)."""
        if self.shape[axis] in (1, self.size):
            return None
        if self._groups is None or axis not in self._groups:
            raise RuntimeError(
                f"this mesh was built without process groups; axis {axis!r} "
                "needs make_mesh(..., groups=True) on every rank")
        return self._groups[axis]

    def __enter__(self) -> "Mesh":
        _stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack.pop()

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items() if s != 1)
        return f"Mesh({axes or 'single'}, rank={self.rank})"


_stack: List[Mesh] = []


def make_mesh(spec: Optional[MeshSpec] = None, world: Optional[int] = None,
              rank: Optional[int] = None, groups: bool = True) -> Mesh:
    """A :class:`Mesh` over ``world`` ranks (default: the processes), as
    seen from ``rank`` (default: this process's).

    Default: every rank on the ``data`` axis, the reference's DDP world
    (train.py:233). With ``groups`` and more than one process, every
    axis whose size is neither 1 nor the world gets its process groups: a
    collective, so every rank builds the same mesh in the same order
    (``dist.new_group`` for each rank set, in the mesh's order)."""
    if world is None:
        world = distributed.process_count()
    if rank is None:
        rank = distributed.process_index() if world > 1 else 0
    spec = (spec or MeshSpec()).resolve(world)
    mesh = Mesh(spec, rank)
    made: Optional[Dict[str, object]] = None
    if groups and world > 1 and dist.is_available() and dist.is_initialized():
        made = {}
        for axis in AXES:
            if mesh.shape[axis] in (1, world):
                continue
            seen = set()
            for r in range(world):
                ranks = tuple(mesh.axis_ranks(axis, r))
                if ranks in seen:
                    continue
                seen.add(ranks)
                group = dist.new_group(list(ranks))
                if rank in ranks:
                    made[axis] = group
    mesh._groups = made
    return mesh


def current_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing ``with mesh:`` block, or None."""
    return _stack[-1] if _stack else None


def data_axes(mesh) -> Sequence[str]:
    """The mesh axes a global batch is sharded over (data + fsdp)."""
    return tuple(a for a in ("data", "fsdp") if a in mesh.axis_names)


def data_parallel_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def data_index(mesh) -> int:
    """This rank's flat index over the data axes, row-major: the batch
    shard it reads (every rank of one tensor group reads the same)."""
    index = 0
    for axis in data_axes(mesh):
        index = index * mesh.shape[axis] + mesh.axis_index(axis)
    return index


def data_group(mesh):
    """``(group, size)`` of this rank's set over the data axes: the ranks
    that split the batch and average the gradients (None: the default
    group, whose ranks are every rank, or size 1: no collective)."""
    size = data_parallel_size(mesh)
    if size in (1, mesh.size):
        return None, size
    axes = [a for a in data_axes(mesh) if mesh.shape[a] > 1]
    if len(axes) > 1:
        raise NotImplementedError(
            "a batch split over both data and fsdp beside another axis is "
            "not ported to the PyTorch package yet; see ROADMAP.md queue 1, "
            "item 11")
    return mesh.group(axes[0]), size
