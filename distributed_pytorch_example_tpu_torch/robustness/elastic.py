"""The mesh stamp of a checkpoint (the part of the JAX package's
robustness/elastic.py that the gathered format calls).

Every save carries a format-3 ``mesh_manifest``: the mesh axes and their
sizes, the per-leaf partition specs and the ZeRO-1 scatter dims. The
port's one axis is ``data`` (one rank per process); its ZeRO-1 overlay
shards an ``opt_state`` leaf on the dim ``Partitioner.zero1_dim`` picks,
everything else is replicated. :func:`mesh_manifest` writes, for the same
world and mode, the stamp the JAX package writes: a replicated leaf's spec
is ``[]``, a sharded leaf's lists ``"data"`` at its dim and ``None``
elsewhere. Axes are compared canonically, size-1 axes dropped, so the
JAX package's ``data=N, fsdp=1, ...`` is the port's ``data=N``.

:func:`validate_resume` gates a restore on the stamp: an unstamped
checkpoint under ``DPX_ELASTIC=1`` raises
:class:`MissingMeshManifestError`; a stamped one saved under another mesh
is logged and restored (the gathered format holds full leaves, so a
checkpoint written replicated restores under ZeRO-1 and the other way
round). Shrink-to-survivors and ``resume_gap_steps`` are not ported yet
(ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Union

from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)

# checkpoint manifest format carrying the mesh stamp. 1 = unsealed,
# 2 = CRC-sealed (unstamped), 3 = stamped.
MANIFEST_FORMAT = 3
MANIFEST_KEY = "mesh_manifest"
ELASTIC_ENV = "DPX_ELASTIC"

SpecEntry = Union[None, str, List[str]]


class MissingMeshManifestError(RuntimeError):
    """Elastic resume attempted from an unstamped checkpoint.

    A checkpoint without ``mesh_manifest`` loads under the same-mesh
    contract, but ``DPX_ELASTIC=1`` resume refuses it instead of guessing
    the topology it was saved under.
    """


def elastic_enabled(env: Optional[Mapping[str, str]] = None) -> bool:
    """True when ``DPX_ELASTIC`` is set truthy (elastic resume mode)."""
    val = (env if env is not None else os.environ).get(ELASTIC_ENV, "")
    return val not in ("", "0", "false", "False")


def canonical_axes(axes: Optional[Mapping]) -> Optional[Dict[str, int]]:
    """Axis name -> size with size-1 axes dropped (topology identity)."""
    if axes is None:
        return None
    return {str(k): int(v) for k, v in axes.items() if int(v) != 1}


def _leaves(tree, prefix: str = ""):
    """(path, leaf) in the tree's map order (the order the JAX package's
    flatten of the same TrainState visits)."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{prefix}/{key}" if prefix else key)
    else:
        yield prefix, tree


def mesh_manifest(state_tree: Mapping, partitioner=None,
                  world: int = 1) -> dict:
    """The format-3 stamp of a train-state tree (``train_state_to_flax``'s
    form): axes ``{"data": world}``, every leaf's spec, and the ZeRO-1
    scatter dim of each sharded ``opt_state`` leaf. ``partitioner`` (a
    ``parallel.api.Partitioner``) gives the world and the ZeRO-1 dims;
    without one, every leaf is replicated over ``world`` ranks."""
    if partitioner is not None:
        world = partitioner.world
    specs: Dict[str, List[SpecEntry]] = {}
    zero1_dims: Dict[str, int] = {}
    for path, leaf in _leaves(state_tree):
        shape = tuple(getattr(leaf, "shape", ()))
        dim = None
        if partitioner is not None and path.startswith("opt_state/"):
            dim = partitioner.zero1_dim(shape)
        if dim is None:
            specs[path] = []
        else:
            specs[path] = ["data" if d == dim else None
                           for d in range(len(shape))]
            zero1_dims[path] = dim
    return {
        "format": MANIFEST_FORMAT,
        "axes": {"data": int(world)},
        "specs": specs,
        "zero1_dims": zero1_dims,
    }


def validate_resume(
    stamp: Optional[dict],
    target_axes: Optional[Mapping],
    source: str,
    elastic: Optional[bool] = None,
) -> Optional[dict]:
    """Gate one restore attempt on the manifest stamp; returns the stamp.

    - unstamped + ``DPX_ELASTIC=1`` -> :class:`MissingMeshManifestError`;
    - unstamped otherwise -> the same-mesh contract, no validation;
    - stamped + a shape change -> allowed in both modes, logged.
    """
    if elastic is None:
        elastic = elastic_enabled()
    if not isinstance(stamp, dict):
        stamp = None
    if stamp is None:
        if elastic:
            raise MissingMeshManifestError(
                f"{source}: checkpoint has no '{MANIFEST_KEY}' stamp "
                f"(pre-format-{MANIFEST_FORMAT}). Elastic resume "
                f"({ELASTIC_ENV}=1) cannot verify the saved mesh topology; "
                f"resume on the original mesh shape with {ELASTIC_ENV} "
                "unset (which re-stamps on the next save), then retry "
                "elastically."
            )
        return None
    stamped = canonical_axes(stamp.get("axes", {}))
    target = canonical_axes(target_axes)
    if target is not None and stamped != target:
        logger.warning(
            "Cross-mesh resume from %s: checkpoint stamped %s, restoring "
            "onto %s (%s)", source, stamped, target,
            "elastic mode" if elastic else "reshard-on-load",
        )
    return stamp
