"""Sealed data files and the loader's checkpoint stamp (the parts of the
JAX package's data/intake.py that token corpora and checkpoints use).

A data file may carry a ``DPX-CRC1`` sidecar, ``<file>.dpxcrc``: the
checkpoint envelope (``robustness/integrity.py``) around ``<I crc32><Q
size>`` of the file's bytes. :func:`seal_file` writes it and
:func:`verify_file` checks it; the bytes are the JAX package's, so a
sidecar written by either package verifies in the other. A file without
a sidecar is legacy data: readable, unverified.

A checkpoint stamps the loader's cursor whenever the loader has a sampler,
as the JAX package's does: the epoch, the batch to resume at (in global
batches), the sampler's seed and shuffle flag, and the quarantine set with
its digest. The sampler's permutation is a pure function of (seed, epoch),
so resuming at the cursor with the same seed repeats no sample and skips
none. The port's loader quarantines nothing yet (the streaming input plane
is ROADMAP.md queue 1, item 13), so a stamp that carries a quarantine is
refused rather than resumed without it.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, Optional

import numpy as np

from distributed_pytorch_example_tpu_torch.robustness.integrity import (
    CheckpointCorruptError,
    seal_header,
    unseal,
)

SIDECAR_SUFFIX = ".dpxcrc"
_SIDECAR_FMT = "<IQ"

LOADER_MANIFEST_KEY = "loader_manifest"
LOADER_MANIFEST_FORMAT = 1

# the sampler's SplitMix64 constants (data/sampler.py)
_GOLDEN = 0x9E3779B97F4A7C15
_MASK64 = 0xFFFFFFFFFFFFFFFF


class ShardCorruptError(RuntimeError):
    """A sealed data file failed its sidecar check."""


def sidecar_path(path: str) -> str:
    return path + SIDECAR_SUFFIX


def _crc_and_size(path: str):
    """crc32 and length of the file's bytes, read in 16 MiB pieces."""
    crc, size = 0, 0
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(1 << 24), b""):
            crc = zlib.crc32(piece, crc)
            size += len(piece)
    return crc, size


def seal_file(path: str) -> str:
    """Write the ``DPX-CRC1`` sidecar of ``path``; returns its path."""
    crc, size = _crc_and_size(path)
    body = struct.pack(_SIDECAR_FMT, crc, size)
    side = sidecar_path(path)
    with open(side, "wb") as f:
        f.write(seal_header([body]) + body)
    return side


def verify_file(path: str) -> Optional[bool]:
    """Check ``path`` against its sidecar: None without one (legacy,
    unverified), True when the file matches, False on a mismatch, a
    truncation or a torn sidecar (then neither half can be trusted)."""
    side = sidecar_path(path)
    if not os.path.exists(side):
        return None
    try:
        with open(side, "rb") as f:
            body = unseal(f.read(), source=side)
        want_crc, want_size = struct.unpack(_SIDECAR_FMT, body)
        crc, size = _crc_and_size(path)
    except (CheckpointCorruptError, OSError, struct.error):
        return False
    return size == want_size and crc == want_crc


def _splitmix64_array(x: np.ndarray) -> np.ndarray:
    """Vectorized SplitMix64 finalizer, bit-identical to the JAX
    package's."""
    z = (x.astype(np.uint64) + np.uint64(_GOLDEN)) & np.uint64(_MASK64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def quarantine_digest(shards: Iterable[int]) -> int:
    """Order-independent 64-bit digest of a quarantine set (0 = empty)."""
    d = 0
    for s in sorted(int(x) for x in set(shards)):
        d = int(_splitmix64_array(np.asarray([d ^ (s + 1)], np.uint64))[0])
    return d


def loader_manifest(loader, epoch: int, batch_in_epoch: int
                    ) -> Optional[dict]:
    """The checkpoint stamp for a loader with a sampler, or None."""
    sampler = getattr(loader, "sampler", None)
    if sampler is None:
        return None
    quarantine = getattr(
        getattr(loader, "dataset", None), "quarantined_shards", None
    )
    qlist = sorted(int(s) for s in quarantine) if quarantine else []
    return {
        "format": LOADER_MANIFEST_FORMAT,
        "epoch": int(epoch),
        "batch_in_epoch": int(batch_in_epoch),
        "seed": int(sampler.seed),
        "shuffle": bool(sampler.shuffle),
        "quarantine": qlist,
        "quarantine_digest": quarantine_digest(qlist),
    }


def restore_loader_state(loader, manifest: dict) -> int:
    """Check a stamped ``loader_manifest`` against ``loader``; returns the
    batch cursor to resume at.

    The seed must match: another seed is another permutation, and resuming
    on it would repeat some samples and skip others. A stamp with a
    quarantine list raises.
    """
    sampler = getattr(loader, "sampler", None)
    if sampler is None:
        raise ValueError(
            "checkpoint carries a loader_manifest but the training loader "
            "has no sampler to restore it onto"
        )
    saved_seed = int(manifest.get("seed", sampler.seed))
    if saved_seed != int(sampler.seed):
        raise ValueError(
            f"loader_manifest seed {saved_seed} != training loader seed "
            f"{sampler.seed}: resuming would permute samples differently, "
            "repeating some and skipping others. Pass the original seed."
        )
    quarantine = [int(s) for s in manifest.get("quarantine", [])]
    if quarantine:
        raise NotImplementedError(
            f"the checkpoint's loader quarantined shards {quarantine}; the "
            "port's loader has no quarantine to restore them into (the "
            "streaming input plane is ROADMAP.md queue 1, item 13)"
        )
    return int(manifest.get("batch_in_epoch", 0))
