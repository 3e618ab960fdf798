"""Deterministic fault injection, the part serving uses.

A :class:`ChaosPlan` is a seeded, serializable list of faults; the serving
engine asks :func:`poison_request` at every sampled token. With no plan
installed the hook is a no-op costing one global read. Plans travel to
child processes via the ``DPX_CHAOS`` environment variable (a preset name
or a JSON plan).

Fault kinds are the JAX package's full list, so a plan written for either
package parses in both. This port acts on ``poison-request`` only — NaN-poison
the logits of serving request ``at`` for ``count`` sampled tokens starting
at generated-token index ``step``: the engine evicts that request with an
error status and its co-residents' streams continue unchanged. The training,
fleet and data hooks land with the slices that port those paths.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

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
    """One seeded fault; see module docstring for the serving semantics."""

    kind: str
    step: int = -1          # poison-request: first poisoned token index
    count: int = 1          # poison-request: poisoned tokens
    path_substr: str = ""   # io-error: only writes whose path contains this
    at: str = ""            # poison-request: the request id
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
        return ChaosPlan([Fault("nan-batch", step=3)])
    if name == "io-flake":
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
