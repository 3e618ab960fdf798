"""The loader's checkpoint stamp (the part of the JAX package's
data/intake.py that checkpoints carry).

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

from typing import Iterable, Optional

import numpy as np

LOADER_MANIFEST_KEY = "loader_manifest"
LOADER_MANIFEST_FORMAT = 1

# the sampler's SplitMix64 constants (data/sampler.py)
_GOLDEN = 0x9E3779B97F4A7C15
_MASK64 = 0xFFFFFFFFFFFFFFFF


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
