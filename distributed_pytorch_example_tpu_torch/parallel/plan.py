"""PlanSpec: the declarative parallelism plan the entry points lower (the
JAX package's parallel/plan.py).

One frozen value holds the whole contract — the mesh, the rule family,
the ZeRO-1 overlay, the wire policy, bucketing and gradient accumulation:

    PlanSpec(mesh=MeshSpec(data=1, fsdp=2), family="fsdp")

``lower()`` is the one place partition rules are built; the factories
``data_parallel`` and ``fsdp`` (``parallel/api.py``) are one-line
lowerings of a PlanSpec, as in JAX. The port serves the three
families: ``data``, ``fsdp`` and ``transformer`` (Megatron tensor
parallelism: ``parallel/partition.py``'s rules plus the vocab-parallel
embedding and head). ``fsdp_rest`` and ZeRO-1 under ``transformer`` are
refused until ROADMAP.md queue 1 item 11 ports them. The JAX planner that
scores PlanSpecs (``--auto-mesh``) waits on item 16.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from distributed_pytorch_example_tpu_torch.parallel.api import (
    DEFAULT_OPT_SHARD_MIN_SIZE,
    P,
    Partitioner,
    shard_largest_axis,
)
from distributed_pytorch_example_tpu_torch.parallel.wire import WireConfig
from distributed_pytorch_example_tpu_torch.runtime.mesh import (
    AXES,
    MeshSpec,
    make_mesh,
)

# the JAX package's families
FAMILIES: Tuple[str, ...] = ("data", "fsdp", "transformer")


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """One point in the parallelism-plan space (JAX's fields).

    ``family`` picks the base rule table, ``zero1`` adds the
    optimizer-state overlay on top of it, ``wire`` compresses the gradient
    collectives, ``grad_accum`` multiplies the per-step microbatches, and
    ``bucket_bytes`` > 0 fuses the gradient sync into buckets (merged
    into the wire config by :meth:`lower`). ``schedule`` is informational
    (pipelines are not ported)."""

    mesh: MeshSpec = MeshSpec()
    family: str = "data"
    fsdp_rest: bool = False
    fsdp_axis: str = "fsdp"
    zero1: bool = False
    opt_shard_min_size: int = DEFAULT_OPT_SHARD_MIN_SIZE
    grad_accum: int = 1
    wire: Optional[WireConfig] = None
    schedule: Optional[str] = None
    bucket_bytes: int = 0

    # -- lowering ----------------------------------------------------------

    def lower(self, mesh=None) -> Partitioner:
        """Build the Partitioner this plan denotes. ``mesh`` (a
        ``runtime.mesh.Mesh``, or a rank count for the data axis) skips
        building one; otherwise ``self.mesh`` is resolved over the
        processes (:func:`runtime.mesh.make_mesh`, a collective at world
        > 1)."""
        if self.family not in FAMILIES:
            raise ValueError(
                f"unknown plan family {self.family!r}; expected one of {FAMILIES}"
            )
        if self.fsdp_rest or (self.family == "transformer" and self.zero1):
            raise NotImplementedError(
                f"PlanSpec(family={self.family!r}, fsdp_rest="
                f"{self.fsdp_rest}, zero1={self.zero1}) is not ported to "
                "the PyTorch package yet; see ROADMAP.md queue 1, item 11")
        if self.family == "fsdp" and self.zero1:
            raise ValueError("zero1 is redundant under family 'fsdp' (FSDP "
                             "already shards optimizer state with the "
                             "params)")
        if mesh is None:
            mesh = make_mesh(self.mesh)
        elif not hasattr(mesh, "shape"):
            mesh = make_mesh(MeshSpec(data=int(mesh)), world=int(mesh),
                             groups=False)
        wire = self.wire
        if self.bucket_bytes > 0:
            wire = dataclasses.replace(wire or WireConfig(),
                                       bucket_bytes=self.bucket_bytes)
        if self.family == "fsdp":
            return Partitioner(
                mesh, rules=((r".*", shard_largest_axis(self.fsdp_axis,
                                                        mesh)),),
                default=P(), opt_shard_min_size=self.opt_shard_min_size,
                wire=wire, fsdp_axis=self.fsdp_axis)
        if self.family == "transformer":
            return Partitioner(
                mesh, rules=self._transformer_rules(mesh), default=P(),
                opt_shard_min_size=self.opt_shard_min_size, wire=wire,
                tensor_axis="tensor")
        return Partitioner(mesh, dp_shard_opt_state=self.zero1,
                           opt_shard_min_size=self.opt_shard_min_size,
                           wire=wire)

    @staticmethod
    def _transformer_rules(mesh) -> list:
        """JAX's Megatron table plus the shape-dependent vocab-parallel
        embedding and head: the vocab dim on ``tensor`` where the tensor
        size divides it, else replicated (the default)."""
        from distributed_pytorch_example_tpu_torch.parallel.partition import (
            TRANSFORMER_TP_RULES,
        )

        tsize = mesh.shape["tensor"]

        def vocab_embed(shape):  # (V, D)
            if tsize > 1 and shape and shape[0] % tsize == 0:
                return P("tensor", None)
            return P()

        def vocab_head(shape):  # (D, V)
            if tsize > 1 and shape and shape[-1] % tsize == 0:
                return P(None, "tensor")
            return P()

        return list(TRANSFORMER_TP_RULES) + [
            (r"(wte|tok_embed)/embedding$", vocab_embed),
            (r"lm_head$", vocab_head),
        ]

    # -- identity / serialization ------------------------------------------

    def name(self) -> str:
        """Stable human-readable id, e.g. ``fsdp:data1,fsdp2``."""
        axes = ",".join(
            f"{ax}{getattr(self.mesh, ax)}"
            for ax in AXES
            if getattr(self.mesh, ax) not in (1,)
        ) or "single"
        tag = {"data": "dp", "fsdp": "fsdp", "transformer": "tf"}[self.family]
        parts = [f"{tag}:{axes}"]
        if self.fsdp_rest:
            parts.append("rest-fsdp")
        if self.zero1:
            parts.append("zero1")
        if self.wire is not None and self.wire.compress != "none":
            parts.append(self.wire.compress)
        if self.bucket_bytes > 0 or (
            self.wire is not None and self.wire.bucketed
        ):
            parts.append("overlap")
        if self.grad_accum > 1:
            parts.append(f"ga{self.grad_accum}")
        if self.schedule:
            parts.append(self.schedule)
        return "+".join(parts)

    def to_json(self) -> dict:
        return {
            "mesh": dataclasses.asdict(self.mesh),
            "family": self.family,
            "fsdp_rest": self.fsdp_rest,
            "fsdp_axis": self.fsdp_axis,
            "zero1": self.zero1,
            "opt_shard_min_size": self.opt_shard_min_size,
            "grad_accum": self.grad_accum,
            "wire": dataclasses.asdict(self.wire) if self.wire else None,
            "schedule": self.schedule,
            "bucket_bytes": self.bucket_bytes,
        }

    @classmethod
    def from_json(cls, d: dict) -> "PlanSpec":
        d = dict(d)
        mesh = MeshSpec(**d.pop("mesh", {}))
        wire = d.pop("wire", None)
        return cls(
            mesh=mesh,
            wire=WireConfig(**wire) if wire else None,
            **{k: v for k, v in d.items() if k in {
                f.name for f in dataclasses.fields(cls)
            }},
        )
