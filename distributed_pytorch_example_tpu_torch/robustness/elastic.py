"""Mesh-shape-agnostic resume (the JAX package's robustness/elastic.py):
the mesh stamp of a checkpoint, the gate on it, and how far behind the
newest save a restore landed.

Every save (both formats) carries a format-3 ``mesh_manifest``: the mesh axes and their
sizes, the per-leaf partition specs and the ZeRO-1 scatter dims. The
port's batch axes are ``data`` and, under FSDP, ``fsdp`` (one rank per
process); its ZeRO-1 overlay shards an ``opt_state`` leaf on the dim
``Partitioner.zero1_dim`` picks, FSDP every leaf on the dim
``shard_largest_axis`` picks, everything else is replicated.
:func:`mesh_manifest` writes, for the same world and mode, the stamp the
JAX package writes: a replicated leaf's spec is ``[]``, a sharded leaf's
lists its axis at its dim and ``None`` elsewhere. Axes are compared canonically, size-1 axes dropped, so the
JAX package's ``data=N, fsdp=1, ...`` is the port's ``data=N``.

:func:`validate_resume` gates a restore on the stamp: an unstamped
checkpoint under ``DPX_ELASTIC=1`` raises
:class:`MissingMeshManifestError`; a stamped one saved under another mesh
is logged and restored (both formats reassemble full leaves on load, so a
checkpoint written at one world or mode restores at any other).
:func:`resume_gap_steps` counts the steps between the restored cursor and
the newest save attempt. The shrink to survivors itself lives in
``runtime/distributed.py``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional, Union

from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)

# checkpoint manifest format carrying the mesh stamp. 1 = unsealed,
# 2 = CRC-sealed (unstamped), 3 = stamped.
MANIFEST_FORMAT = 3
MANIFEST_KEY = "mesh_manifest"
ELASTIC_ENV = "DPX_ELASTIC"

SpecEntry = Union[None, str, List[str]]

# a sharded version dir (``{epoch:08d}`` or ``{epoch:08d}.{batch:08d}``)
# and a gathered history entry
VERSION_RE = re.compile(r"\d{8}(\.\d{8})?")
HISTORY_RE = re.compile(r"\d{8}\.ckpt")


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


def tree_leaves(tree, prefix: str = ""):
    """(path, leaf) of a state tree in its map order; the path is the JAX
    package's ``_path_str`` of the same ``TrainState`` leaf (``/``-joined
    keys, ``opt_state/0/mu/Dense_0/kernel``). An empty map has none."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from tree_leaves(value, f"{prefix}/{key}" if prefix else key)
    else:
        yield prefix, tree


def mesh_manifest(state_tree: Mapping, partitioner=None,
                  world: int = 1) -> dict:
    """The format-3 stamp of a train-state tree (``train_state_to_flax``'s
    form): the batch axes (``{"data": world}``, with ``fsdp`` under
    FSDP), every leaf's spec, and the ZeRO-1 scatter dim of each sharded
    ``opt_state`` leaf. ``partitioner`` (a ``parallel.api.Partitioner``)
    gives the axes, the specs and the ZeRO-1 dims
    (``Partitioner.manifest_spec``); without one, every leaf is
    replicated over ``world`` ranks."""
    axes = ({"data": int(world)} if partitioner is None
            else {k: int(v) for k, v in partitioner.mesh_shape.items()})
    specs: Dict[str, List[SpecEntry]] = {}
    zero1_dims: Dict[str, int] = {}
    for path, leaf in tree_leaves(state_tree):
        shape = tuple(getattr(leaf, "shape", ()))
        entries, dim = ([], None) if partitioner is None else (
            partitioner.manifest_spec(path, shape))
        specs[path] = entries
        if dim is not None:
            zero1_dims[path] = dim
    return {
        "format": MANIFEST_FORMAT,
        "axes": axes,
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


def _parse_version(name: str):
    if "." in name:
        epoch, batch = name.split(".", 1)
        return int(epoch), int(batch)
    return int(name), 0


def resume_gap_steps(path: str, restored_epoch: int,
                     restored_extra: Optional[dict] = None) -> Optional[int]:
    """Steps between the restored cursor and the newest save attempt.

    0: the newest checkpoint restored (no work lost); a positive number:
    the steps between the restored mid-epoch cursor and the newest
    (possibly torn) save of the same epoch; None: the gap spans an epoch
    boundary (steps per epoch are unknown offline), or the format cannot
    tell.
    """
    restored = (int(restored_epoch),
                int((restored_extra or {}).get("batch_in_epoch") or 0))
    shards = f"{path}.shards"
    if os.path.isdir(shards):
        names = sorted(n for n in os.listdir(shards)
                       if VERSION_RE.fullmatch(n))
        if not names:
            return None
        newest = _parse_version(names[-1])
        if newest == restored:
            return 0
        if newest[0] == restored[0]:
            return max(newest[1] - restored[1], 0)
        return None
    history = f"{path}.history"
    if os.path.isdir(history):
        names = sorted(n for n in os.listdir(history)
                       if HISTORY_RE.fullmatch(n))
        if names:
            try:
                if os.path.samefile(os.path.join(history, names[-1]), path):
                    return 0
            except OSError:
                pass
        return None
    # a single file: nothing newer can exist
    return 0
