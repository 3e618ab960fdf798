"""Multi-process bootstrap and rendezvous (the JAX package's
runtime/distributed.py).

The topology comes from the environment, the reference's contract
(entrypoint.sh): flags for science, env for topology.

- ``REPLICAS`` (or ``NUM_PROCESSES``) — number of processes.
- ``PROCESS_ID`` (or ``NODE_RANK``) — this process's rank; when unset it
  is the hostname's numeric suffix, like ``NODE_RANK=${HOSTNAME##*-}``.
- ``COORDINATOR_ADDRESS`` (or ``MASTER_ADDR``) — ``host[:port]``; when
  unset it is ``{base}-0.{NF_DISCOVERY_SERVICE}:{port}``.
- ``COORDINATOR_PORT`` (or ``MASTER_PORT``) — default 29500.

:func:`initialize` joins the process group only when the world has more
than one process: ``init_process_group`` over ``tcp://<coordinator>`` with
nccl for a CUDA device and gloo for the CPU, retried with bounded
exponential backoff (a coordinator that is not listening yet is a
transient failure). The JAX package's elastic shrink-to-survivors path is
not ported yet (ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
import os
import socket
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist

from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)

# how long a collective (and the rendezvous) may wait on a slow peer
_PROCESS_GROUP_TIMEOUT = timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Resolved topology."""

    num_processes: int
    process_id: int
    coordinator_address: Optional[str]  # host:port, None for one process

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def derive_process_id(hostname: Optional[str] = None) -> int:
    """Rank from the hostname's trailing numeric suffix (``worker-3`` ->
    3); 0 when there is none."""
    hostname = hostname if hostname is not None else socket.gethostname()
    suffix = hostname.rsplit("-", 1)[-1]
    return int(suffix) if suffix.isdigit() else 0


def derive_coordinator_address(
    hostname: Optional[str] = None,
    discovery_service: Optional[str] = None,
    port: Optional[int] = None,
) -> str:
    """Replica 0's stable hostname: host ``myjob-3`` with discovery service
    ``svc`` -> ``myjob-0.svc:<port>``; without a service, ``myjob-0``."""
    hostname = hostname if hostname is not None else socket.gethostname()
    if discovery_service is None:
        discovery_service = os.environ.get("NF_DISCOVERY_SERVICE")
    if port is None:
        port = int(os.environ.get("COORDINATOR_PORT",
                                  os.environ.get("MASTER_PORT", "29500")))
    base = hostname.rsplit("-", 1)[0] if "-" in hostname else hostname
    coordinator_host = f"{base}-0"
    if discovery_service:
        coordinator_host = f"{coordinator_host}.{discovery_service}"
    return f"{coordinator_host}:{port}"


def resolve_config(env: Optional[dict] = None) -> DistributedConfig:
    """Resolve the topology from the environment (module docstring)."""
    env = dict(os.environ) if env is None else env
    num_processes = int(env.get("NUM_PROCESSES", env.get("REPLICAS", "1")))
    if num_processes <= 1:
        return DistributedConfig(1, 0, None)
    process_id = env.get("PROCESS_ID", env.get("NODE_RANK"))
    if process_id is None:
        process_id = derive_process_id(env.get("HOSTNAME"))
    port = env.get("COORDINATOR_PORT", env.get("MASTER_PORT", "29500"))
    coordinator = env.get("COORDINATOR_ADDRESS", env.get("MASTER_ADDR"))
    if coordinator is None:
        coordinator = derive_coordinator_address(
            hostname=env.get("HOSTNAME"),
            discovery_service=env.get("NF_DISCOVERY_SERVICE"),
            port=int(port),
        )
    elif ":" not in coordinator:
        coordinator = f"{coordinator}:{port}"
    return DistributedConfig(num_processes, int(process_id), coordinator)


def initialize(
    config: Optional[DistributedConfig] = None,
    device: Union[str, torch.device] = "cuda",
    max_attempts: Optional[int] = None,
) -> DistributedConfig:
    """Join the process group (the reference's ``setup_distributed``).

    A no-op for one process, and idempotent. ``device`` picks the backend:
    nccl for CUDA, gloo for the CPU; a CUDA process binds to card
    ``rank % device_count`` before joining. ``max_attempts`` defaults to
    ``$DPX_RENDEZVOUS_RETRIES`` + 1 = 4, with ``$DPX_RENDEZVOUS_BACKOFF``
    (default 1.0 s) as the first backoff.
    """
    from distributed_pytorch_example_tpu_torch.robustness import retry

    if config is None:
        config = resolve_config()
    if not config.is_distributed:
        logger.info("Single-process mode (no rendezvous needed)")
        return config
    if dist.is_initialized():
        return config
    if max_attempts is None:
        max_attempts = int(os.environ.get("DPX_RENDEZVOUS_RETRIES", "3")) + 1
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(config.process_id % torch.cuda.device_count())

    def join():
        dist.init_process_group(
            backend=backend,
            init_method=f"tcp://{config.coordinator_address}",
            world_size=config.num_processes,
            rank=config.process_id,
            timeout=_PROCESS_GROUP_TIMEOUT,
        )

    retry.with_retries(
        join,
        attempts=max_attempts,
        base_delay=float(os.environ.get("DPX_RENDEZVOUS_BACKOFF", "1.0")),
        max_delay=30.0,
        retry_on=(RuntimeError, OSError, ConnectionError),
        describe="coordinator rendezvous",
    )
    logger.info(
        "Initialized distributed runtime: process_id=%d, num_processes=%d, "
        "coordinator=%s, backend=%s", config.process_id,
        config.num_processes, config.coordinator_address, backend,
    )
    return config


def shutdown() -> None:
    """Tear down the process group (reference train.py:85-86)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_coordinator() -> bool:
    """True on rank 0, which owns the logs (reference ``rank == 0``)."""
    return process_index() == 0


def barrier() -> None:
    """Block until every process reaches this point (``dist.barrier``)."""
    if process_count() > 1:
        dist.barrier()


def all_reduce_mean_(tensor: torch.Tensor) -> torch.Tensor:
    """In-place cross-process mean; the identity for one process."""
    world = process_count()
    if world > 1:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
        tensor.div_(world)
    return tensor
