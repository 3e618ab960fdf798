"""Deterministic fault injection (the JAX package's robustness/chaos.py,
its training and serving halves).

A :class:`ChaosPlan` is a seeded, serializable list of faults; the code
calls the hook functions below at its fault-relevant points. With no plan
installed every hook is a no-op costing one global read. Plans travel to
child processes via the ``DPX_CHAOS`` environment variable (a preset name
or a JSON plan), or the CLI's ``--chaos``.

Fault kinds are the JAX package's full list, so a plan written for either
package parses in both. This port acts on:

- ``nan-batch`` / ``inf-batch`` — overwrite the first float leaf of the
  training batch with NaN/Inf for ``count`` steps from global step
  ``step`` (:func:`corrupt_batch`; the step skips the update);
- ``io-error`` — raise a transient ``OSError`` on the next ``count``
  checkpoint writes whose path contains ``path_substr`` (:func:`on_write`;
  the ``AsyncSaver`` retries);
- ``kill`` — SIGKILL this process the ``nth`` time the named crash point is
  reached (:func:`crash_point`: ``step``, the per-step boundary of the
  loop, and ``gathered-save:pre-commit``, between a checkpoint's history
  entry and its commit);
- ``rendezvous-flake`` — fail the next ``count`` entries into the named
  transient site (:func:`transient_failure`: ``rendezvous``);
- ``poison-request`` — NaN-poison the logits of serving request ``at``
  for ``count`` sampled tokens from generated-token index ``step``
  (:func:`poison_request`; the engine evicts that request).

:func:`corrupt_file` damages a file between runs (tests). The fleet and
data hooks land with the slices that port those paths.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import os
import signal
import time
from typing import Any, List, Optional

import torch

from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)

ENV_VAR = "DPX_CHAOS"
KINDS = (
    "nan-batch", "inf-batch", "io-error", "kill", "rendezvous-flake",
    "poison-request", "kill-replica", "stall-replica", "flaky-channel",
    "corrupt-shard", "slow-shard-io", "kill-decode-worker",
    "corrupt-publish", "torn-publish", "kill-during-swap",
)


@dataclasses.dataclass
class Fault:
    """One seeded fault; see module docstring for per-kind semantics."""

    kind: str
    step: int = -1          # nan/inf-batch: first global step; poison-request:
    #                         first poisoned token index
    count: int = 1          # nan/inf-batch: steps; io/rendezvous: failures
    path_substr: str = ""   # io-error: only writes whose path contains this
    at: str = ""            # kill: crash point; poison-request: request id
    nth: int = 1            # kill: trigger on the Nth visit of that point
    delay_s: float = 0.0    # rendezvous-flake: sleep before failing
    fired: int = 0          # live counter

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown chaos fault kind {self.kind!r} (one of {KINDS})"
            )


class ChaosPlan:
    """A seeded list of faults, serializable for child processes."""

    def __init__(self, faults: List[Fault], seed: int = 0):
        self.faults = list(faults)
        self.seed = int(seed)

    @classmethod
    def from_json(cls, text: str) -> "ChaosPlan":
        spec = json.loads(text)
        return cls(
            [Fault(**f) for f in spec.get("faults", [])],
            seed=spec.get("seed", 0),
        )

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "faults": [
                {
                    k: v
                    for k, v in dataclasses.asdict(f).items()
                    if k != "fired"
                }
                for f in self.faults
            ],
        })

    def __repr__(self):
        return f"ChaosPlan(seed={self.seed}, faults={self.faults!r})"


def preset(name: str) -> ChaosPlan:
    """Named plans, the same names as the JAX package's presets."""
    if name == "nan-step":
        # one poisoned batch well past warmup; the step skips its update
        return ChaosPlan([Fault("nan-batch", step=3)])
    if name == "io-flake":
        # two transient write failures on `latest`; the retry heals both
        return ChaosPlan([Fault("io-error", path_substr="latest", count=2)])
    if name == "kill-replica":
        return ChaosPlan([Fault("kill-replica", at="r1", step=8)])
    if name == "stall-replica":
        return ChaosPlan([Fault("stall-replica", at="r1", step=8)])
    if name == "flaky-channel":
        return ChaosPlan([Fault("flaky-channel", count=2)])
    raise ValueError(f"unknown chaos preset {name!r}")


# ---------------------------------------------------------------------------
# plan installation (module-global; one plan active per process)
# ---------------------------------------------------------------------------

_plan: Optional[ChaosPlan] = None
_env_checked = False


def install(plan: Optional[ChaosPlan]) -> None:
    global _plan, _env_checked
    _plan = plan
    _env_checked = True  # an explicit install wins over the env var
    if plan is not None:
        logger.warning("chaos: fault plan installed: %s", plan)


def uninstall() -> None:
    global _plan, _env_checked
    _plan = None
    _env_checked = False


def active() -> Optional[ChaosPlan]:
    """The installed plan, lazily parsing ``DPX_CHAOS`` on first use."""
    global _plan, _env_checked
    if not _env_checked:
        _env_checked = True
        spec = os.environ.get(ENV_VAR)
        if spec:
            try:
                _plan = (
                    ChaosPlan.from_json(spec)
                    if spec.lstrip().startswith("{")
                    else preset(spec)
                )
                logger.warning(
                    "chaos: fault plan from $%s: %s", ENV_VAR, _plan
                )
            except (ValueError, TypeError, KeyError) as err:
                raise ValueError(
                    f"malformed ${ENV_VAR} chaos spec: {err}"
                ) from err
    return _plan


# ---------------------------------------------------------------------------
# hooks (called from the code; no-ops without a matching fault)
# ---------------------------------------------------------------------------


def corrupt_batch(batch: Any, step: int) -> Any:
    """Poison the first float leaf of ``batch`` if a fault targets
    ``step``; the poisoned leaf keeps its shape, dtype and device, so the
    step runs the same code as on a clean batch."""
    plan = active()
    if plan is None:
        return batch
    fault = next(
        (
            f for f in plan.faults
            if f.kind in ("nan-batch", "inf-batch")
            and f.step <= step < f.step + f.count
        ),
        None,
    )
    if fault is None:
        return batch
    val = float("nan") if fault.kind == "nan-batch" else float("inf")
    for key, leaf in batch.items():
        if leaf.is_floating_point():
            fault.fired += 1
            logger.warning(
                "chaos: %s injected into batch leaf %r at step %d",
                fault.kind, key, step,
            )
            return {**batch, key: torch.full_like(leaf, val)}
    logger.warning(
        "chaos: %s fault at step %d found no float batch leaf to poison "
        "(integer-token task?); batch left clean", fault.kind, step,
    )
    return batch


def on_write(path: str) -> None:
    """Transient-``OSError`` injection point (top of a checkpoint write)."""
    plan = active()
    if plan is None:
        return
    for fault in plan.faults:
        if (
            fault.kind == "io-error"
            and fault.fired < fault.count
            and fault.path_substr in path
        ):
            fault.fired += 1
            logger.warning(
                "chaos: injected transient OSError on write %d/%d to %s",
                fault.fired, fault.count, path,
            )
            raise OSError(
                errno.EIO, "chaos: injected transient I/O error", path
            )


def crash_point(name: str) -> None:
    """SIGKILL this process at a named site when a kill fault matches."""
    plan = active()
    if plan is None:
        return
    for fault in plan.faults:
        if fault.kind == "kill" and fault.at == name:
            fault.fired += 1
            if fault.fired == fault.nth:
                logger.warning(
                    "chaos: SIGKILL at crash point %r (visit %d)",
                    name, fault.fired,
                )
                os.kill(os.getpid(), signal.SIGKILL)


def transient_failure(name: str) -> None:
    """Named transient-failure site (rendezvous); raises while armed."""
    plan = active()
    if plan is None:
        return
    for fault in plan.faults:
        if (
            fault.kind == "rendezvous-flake"
            and (not fault.at or fault.at == name)
            and fault.fired < fault.count
        ):
            fault.fired += 1
            if fault.delay_s:
                time.sleep(fault.delay_s)
            logger.warning(
                "chaos: injected transient failure at %r (%d/%d)",
                name, fault.fired, fault.count,
            )
            raise RuntimeError(
                f"chaos: injected transient failure at {name!r}"
            )


def poison_request(request_id: str, token_index: int) -> bool:
    """Whether a serving request's logits should be NaN-poisoned for the
    generated token at ``token_index`` (0-based). The engine feeds the
    flag into its step as a regular input, so a poisoned step runs the
    same code as a clean one."""
    plan = active()
    if plan is None:
        return False
    for fault in plan.faults:
        if (
            fault.kind == "poison-request"
            and fault.at == str(request_id)
            and fault.step <= token_index < fault.step + fault.count
        ):
            fault.fired += 1
            logger.warning(
                "chaos: poisoning request %r at generated token %d",
                request_id, token_index,
            )
            return True
    return False


# ---------------------------------------------------------------------------
# offline corruption (tests attacking files between runs)
# ---------------------------------------------------------------------------


def corrupt_file(path: str, mode: str = "bitflip", seed: int = 0) -> None:
    """Deterministically damage an existing file.

    ``bitflip`` flips one bit at a seed-chosen offset (checksum mismatch);
    ``truncate`` cuts the file to half (torn write).
    """
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
        logger.warning("chaos: truncated %s to %d bytes", path, size // 2)
    elif mode == "bitflip":
        # LCG: dependency-free and the same offset as the JAX package's
        offset = (seed * 2654435761 + 12345) % size
        with open(path, "r+b") as f:
            f.seek(offset)
            byte = f.read(1)
            f.seek(offset)
            f.write(bytes([byte[0] ^ 0x40]))
        logger.warning("chaos: flipped bit at offset %d of %s", offset, path)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
