"""Partitioner: path-rule -> partition spec assignment over state trees (the
JAX package's parallel/api.py).

Every leaf of the train state (params, optimizer moments, batch stats)
gets a :class:`PartitionSpec` chosen by the first matching rule on its
'/'-joined flax path, as in JAX: a spec names, per dimension of the leaf's
JAX layout, the mesh axis it is sharded over (or None). Rules are
``(regex, spec)`` where spec is a :class:`PartitionSpec` or a callable
``(shape) -> PartitionSpec`` (FSDP's "shard the largest divisible axis").
Leaves are keyed by their JAX param path and JAX-layout shape
(``interop.flax_leaves``), so a spec here equals JAX's for the same leaf.

Two families are served, each lowered from a ``PlanSpec``
(``parallel/plan.py``):

- **data**: everything replicated, the batch split over (data, fsdp) —
  the reference's DDP semantics (train.py:233). With
  ``dp_shard_opt_state=True`` the update becomes ZeRO-1: gradients
  reduce-scatter, each process keeps optimizer state only for its tile of
  each large leaf, and the updated tiles gather back into the replicated
  parameters (``train/optimizers.py`` ``ShardedUpdate``). The ZeRO-1 dim
  (:meth:`Partitioner.zero1_dim`) is the largest dim the axis size
  divides, the first of equal ones, for leaves of at least
  ``opt_shard_min_size`` elements;
- **fsdp**: every parameter and moment leaf sharded over ``fsdp`` on the
  dim :func:`shard_largest_axis` picks (the largest divisible one, ties
  to the last, no size floor); the step gathers the parameters and
  reduce-scatters the gradients (``train/optimizers.py`` ``FSDPUpdate``).

- **transformer**: Megatron tensor parallelism, JAX's
  ``TRANSFORMER_TP_RULES`` (``parallel/partition.py``) plus the
  vocab-parallel embedding and head: column-parallel ``q/k/v/up/gate``
  on their output dim, row-parallel ``o/down`` on their input dim, a
  vocab the tensor size divides on ``tensor``, every other leaf
  replicated; the batch splits over the data axes only, and a tensor
  group's ranks read the same rows. The layers hold only their slices
  and place the collectives themselves (``parallel/tensor_parallel.py``);
  :meth:`Partitioner.tensor_dim` is the dim the axis cuts.

The multi-slice mesh is not ported (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import math
import re
from typing import (Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.runtime import mesh as mesh_lib

# ZeRO-1 floor: leaves below this many ELEMENTS stay replicated (64 KB at
# f32: a reduce-scatter of a bias costs more in latency than its shard
# saves)
DEFAULT_OPT_SHARD_MIN_SIZE = 1 << 14


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s value: one entry per leading dim
    of a leaf, each None (replicated), an axis name, or a tuple of axis
    names; trailing dims left out are replicated. ``P()`` = replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec
SpecLike = Union[PartitionSpec, Callable[[Tuple[int, ...]], PartitionSpec]]
Rule = Tuple[str, SpecLike]


def shard_largest_axis(axis_name: str, mesh) -> Callable[[Tuple[int, ...]],
                                                         PartitionSpec]:
    """Spec factory: place ``axis_name`` on the leaf's largest divisible
    dim (JAX layout). Ties break toward the last dimension; leaves with no
    divisible dim stay replicated."""
    size = mesh.shape[axis_name]

    def spec(shape: Tuple[int, ...]) -> PartitionSpec:
        if size == 1 or not shape:
            return P()
        best = None
        for dim, extent in enumerate(shape):
            if extent % size == 0 and (best is None or extent >= shape[best]):
                best = dim
        if best is None:
            return P()
        entries: list = [None] * len(shape)
        entries[best] = axis_name
        return P(*entries)

    return spec


def _map_tree(fn, tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _shape_of(leaf) -> Tuple[int, ...]:
    shape = getattr(leaf, "shape", leaf)
    return tuple(int(s) for s in (shape or ()))


class Partitioner:
    """Assigns partition specs to state trees and batches over a mesh.

    ``mesh`` is a ``runtime.mesh.Mesh``, or an int: that many ranks on the
    ``data`` axis (default: the processes), the form of the earlier
    slices. ``wire`` (a ``parallel.wire.WireConfig``) carries the gradient
    collectives' payload policy to the step; ``fsdp_axis`` names the axis
    whose parameters the step keeps sharded between steps (set by
    ``PlanSpec(family="fsdp").lower``; None: the parameters are
    replicated); ``tensor_axis`` the axis the model's layers are cut over
    (set by ``PlanSpec(family="transformer").lower``)."""

    def __init__(
        self,
        mesh=None,
        rules: Sequence[Rule] = (),
        default: SpecLike = P(),
        dp_shard_opt_state: bool = False,
        opt_shard_axis: str = "data",
        opt_shard_min_size: int = DEFAULT_OPT_SHARD_MIN_SIZE,
        wire=None,
        fsdp_axis: Optional[str] = None,
        tensor_axis: Optional[str] = None,
    ):
        if not isinstance(mesh, mesh_lib.Mesh):
            world = distributed.process_count() if mesh is None else mesh
            mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(data=world),
                                      world=world, groups=False)
        self.mesh = mesh
        self.rules = [(re.compile(pattern), spec) for pattern, spec in rules]
        self.default = default
        self.dp_shard_opt_state = dp_shard_opt_state
        self.opt_shard_axis = opt_shard_axis
        self.opt_shard_min_size = opt_shard_min_size
        self.wire = wire
        self.fsdp_axis = fsdp_axis
        self.tensor_axis = tensor_axis

    @property
    def world(self) -> int:
        """Ranks in the mesh."""
        return self.mesh.size

    @property
    def mesh_shape(self) -> Dict[str, int]:
        """The stamped axes of a checkpoint: ``{"data": world}`` for the
        data family, ``{"data": D, "fsdp": F}`` once ``fsdp`` is above 1,
        ``{"data": D, "tensor": T}`` under tensor parallelism."""
        shape = {a: self.mesh.shape[a] for a in mesh_lib.data_axes(self.mesh)
                 if a == "data" or self.mesh.shape[a] > 1}
        if self.tensor_axis is not None and self.mesh.shape[
                self.tensor_axis] > 1:
            shape[self.tensor_axis] = self.mesh.shape[self.tensor_axis]
        return shape

    # -- specs (JAX's Partitioner) -----------------------------------------

    def _fits(self, spec: PartitionSpec, shape: Tuple[int, ...]) -> bool:
        """Whether ``spec`` is applicable to a leaf of this shape (a rule
        matched by path may not fit a state leaf of another rank, such as
        adafactor's factored statistics)."""
        if len(spec) > len(shape):
            return False
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            size = math.prod(self.mesh.shape[a] for a in axes)
            if shape[dim] % size:
                return False
        return True

    def spec_for(self, path: str, shape: Tuple[int, ...]) -> PartitionSpec:
        """The spec of the leaf at ``path`` of (JAX-layout) ``shape``; the
        ZeRO-1 overlay adds ``data`` to an opt-state leaf's free dim."""
        base = self._base_spec(path, tuple(shape))
        if self.dp_shard_opt_state and re.search(r"(^|/)opt_state(/|$)",
                                                 path):
            dim = self.zero1_dim(shape) if not any(
                e is not None for e in base) else None
            if dim is not None:
                entries = list(base) + [None] * (len(shape) - len(base))
                entries[dim] = self.opt_shard_axis
                return P(*entries)
        return base

    def _base_spec(self, path: str, shape: Tuple[int, ...]) -> PartitionSpec:
        for pattern, spec in self.rules:
            if pattern.search(path):
                s = spec(shape) if callable(spec) else spec
                if self._fits(s, shape):
                    return s
                break
        d = self.default
        s = d(shape) if callable(d) else d
        return s if self._fits(s, shape) else P()

    def tree_specs(self, tree: Any, path_prefix: str = "") -> Any:
        """A spec per leaf of a nested mapping (leaves: tensors, arrays or
        shapes), in its structure."""
        return _map_tree(
            lambda path, leaf: self.spec_for(path_prefix + path,
                                             _shape_of(leaf)), tree)

    def batch_spec(self) -> PartitionSpec:
        """Leading-dim sharding over the joint data axes (global batch):
        rank r takes rows ``r * B/(D*F)`` on, its flat rank in (data,
        fsdp)."""
        return P(tuple(mesh_lib.data_axes(self.mesh)))

    # -- the dims the step shards ------------------------------------------

    def zero1_dim(self, shape: Sequence[int]) -> Optional[int]:
        """The dim ZeRO-1 shards a leaf of this (JAX-layout) shape on, or
        None: the largest dim the axis size divides (the first of equal
        ones), for leaves of at least ``opt_shard_min_size`` elements."""
        shape = tuple(int(s) for s in shape)
        if not self.dp_shard_opt_state or not shape:
            return None
        size = self.mesh.shape[self.opt_shard_axis]
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

    def _axis_dim(self, axis: Optional[str], path: str,
                  shape: Sequence[int]) -> Optional[int]:
        if axis is None:
            return None
        for dim, entry in enumerate(self._base_spec(path, tuple(shape))):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if axis in axes:
                return dim
        return None

    def fsdp_dim(self, path: str, shape: Sequence[int]) -> Optional[int]:
        """The dim of the leaf at ``path`` that the FSDP axis shards, or
        None (replicated, or no FSDP axis)."""
        return self._axis_dim(self.fsdp_axis, path, shape)

    def tensor_dim(self, path: str, shape: Sequence[int]) -> Optional[int]:
        """The dim of the leaf at ``path`` (of whole JAX-layout ``shape``)
        that the tensor axis cuts, or None (replicated, or no tensor
        axis)."""
        if self.tensor_axis is None or self.mesh.shape[self.tensor_axis] == 1:
            return None
        return self._axis_dim(self.tensor_axis, path, shape)

    def sync_dims(self, shapes: Mapping[str, Sequence[int]]
                  ) -> Dict[str, Optional[int]]:
        """Per param path, the dim its gradient reduce-scatters on (FSDP's
        or ZeRO-1's), or None for an all-reduced leaf."""
        if self.fsdp_axis is not None:
            return {p: self.fsdp_dim(p, s) for p, s in shapes.items()}
        if self.dp_shard_opt_state:
            return self.zero1_dims(shapes)
        return dict.fromkeys(shapes)

    def grad_sync_axis(self) -> str:
        """The axis the gradient collectives run over."""
        return self.fsdp_axis or self.opt_shard_axis

    def manifest_spec(self, path: str, shape: Sequence[int]
                      ) -> Tuple[list, Optional[int]]:
        """``(entries, zero1_dim)`` of one state leaf for the checkpoint's
        mesh stamp: the spec's entries padded to the leaf's rank, and the
        ZeRO-1 dim of an opt-state leaf (else None)."""
        shape = tuple(int(s) for s in shape)
        if self.fsdp_axis is not None or self.tensor_axis is not None:
            spec = list(self.spec_for(path, shape))
            if all(e is None for e in spec):
                return [], None
            return spec + [None] * (len(shape) - len(spec)), None
        dim = self.zero1_dim(shape) if path.startswith("opt_state/") else None
        if dim is None:
            return [], None
        return [self.opt_shard_axis if d == dim else None
                for d in range(len(shape))], dim


def data_parallel(
    world=None,
    dp_shard_opt_state: bool = False,
    opt_shard_min_size: int = DEFAULT_OPT_SHARD_MIN_SIZE,
    wire=None,
) -> Partitioner:
    """Pure DP over ``world`` (a mesh, or that many ranks on ``data``;
    default: the processes); ``dp_shard_opt_state=True`` flips the update
    to ZeRO-1. Lowers ``PlanSpec(family="data", ...)``."""
    from distributed_pytorch_example_tpu_torch.parallel.plan import PlanSpec

    return PlanSpec(family="data", zero1=dp_shard_opt_state,
                    opt_shard_min_size=opt_shard_min_size,
                    wire=wire).lower(mesh=world)


def fsdp(mesh, axis: str = "fsdp") -> Partitioner:
    """ZeRO-3-style: every param/moment leaf sharded on its largest dim.
    Lowers ``PlanSpec(family="fsdp", fsdp_axis=axis)``."""
    from distributed_pytorch_example_tpu_torch.parallel.plan import PlanSpec

    return PlanSpec(family="fsdp", fsdp_axis=axis).lower(mesh=mesh)
