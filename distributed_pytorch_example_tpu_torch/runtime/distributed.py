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
than one process: ``init_process_group`` over ``tcp://<coordinator>``,
retried with bounded exponential backoff (a coordinator that is not
listening yet is a transient failure). The backend is nccl only when every
process on a host has a card of its own; processes that share a card, and
the CPU, use gloo (NCCL refuses two ranks on one device). Ranks on one
host are ``$LOCAL_WORLD_SIZE`` when set, else every process when the
coordinator is a loopback address, else one. The JAX package's elastic
shrink-to-survivors path is not ported yet (ROADMAP.md queue 1, item 9).

The library collectives the port needs (:func:`all_reduce_sum_`,
:func:`all_gather_tiled`, :func:`reduce_scatter_tiled`,
:func:`all_to_all_rows`) take CUDA or CPU tensors on either backend. Gloo
has no reduce-scatter, so there it is an all-reduce followed by this
rank's tile (the numbers of ``psum_scatter``). Gloo's support for CUDA
tensors differs from one collective to the next, so under gloo every
CUDA payload is staged through the host; on the ZeRO-1 path that touches
the psum leaves below the ZeRO-1 floor, the metrics, the IPC handle swap
and, with a float32 parameter gather, the gathered parameters. bfloat16
payloads that are only moved travel as their bytes.
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


def _local_processes(config: DistributedConfig, env: dict) -> int:
    if env.get("LOCAL_WORLD_SIZE"):
        return int(env["LOCAL_WORLD_SIZE"])
    host = (config.coordinator_address or "").rsplit(":", 1)[0]
    if host in ("localhost", "::1", "[::1]") or host.startswith("127."):
        return config.num_processes
    return 1


def choose_backend(device: torch.device, config: DistributedConfig,
                   env: Optional[dict] = None) -> str:
    """nccl when every process on a host has a card of its own, else
    gloo (and gloo on the CPU)."""
    if device.type != "cuda":
        return "gloo"
    env = dict(os.environ) if env is None else env
    local = _local_processes(config, env)
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize(
    config: Optional[DistributedConfig] = None,
    device: Union[str, torch.device] = "cuda",
    max_attempts: Optional[int] = None,
) -> DistributedConfig:
    """Join the process group (the reference's ``setup_distributed``).

    A no-op for one process, and idempotent. ``device`` and the host's
    cards pick the backend (:func:`choose_backend`); a CUDA process binds
    to card ``rank % device_count`` before joining. ``max_attempts`` defaults to
    ``$DPX_RENDEZVOUS_RETRIES`` + 1 = 4, with ``$DPX_RENDEZVOUS_BACKOFF``
    (default 1.0 s) as the first backoff.
    """
    from distributed_pytorch_example_tpu_torch.robustness import chaos, retry

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
    backend = choose_backend(dev, config)
    if dev.type == "cuda":
        torch.cuda.set_device(config.process_id % torch.cuda.device_count())

    def join():
        chaos.transient_failure("rendezvous")  # no-op without a plan
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
        all_reduce_sum_(tensor)
        tensor.div_(world)
    return tensor


def _staged(x: torch.Tensor) -> bool:
    """Whether ``x`` goes through the host: a CUDA tensor under gloo."""
    return x.is_cuda and dist.get_backend() == "gloo"


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A payload that is only moved, in a dtype every backend takes (its
    bytes: gloo moves no bfloat16 or int16)."""
    return x.view(torch.uint8) if x.dtype == torch.bfloat16 else x


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """In-place cross-process sum (``psum``); the identity for one
    process."""
    if process_count() == 1:
        return tensor
    if _staged(tensor):
        host = tensor.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def all_gather_tiled(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``lax.all_gather(..., axis=dim, tiled=True)``)."""
    world = process_count()
    if world == 1:
        return x
    src = _bits(x.contiguous())
    if _staged(src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src)
    out = torch.cat(parts, dim=dim).to(x.device)
    return out.view(x.dtype) if out.dtype != x.dtype else out


def reduce_scatter_tiled(x: torch.Tensor) -> torch.Tensor:
    """This rank's tile of the cross-process sum of ``x`` along axis 0
    (``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``)."""
    world = process_count()
    if world == 1:
        return x
    if x.shape[0] % world:
        raise ValueError(f"leading dim of {tuple(x.shape)} does not split "
                         f"over {world} processes")
    chunk = x.shape[0] // world
    if dist.get_backend() == "nccl":
        out = torch.empty((chunk,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous())
        return out
    # gloo has no reduce-scatter: all-reduce, then this rank's tile
    total = all_reduce_sum_(x.clone())
    rank = process_index()
    return total[rank * chunk:(rank + 1) * chunk].clone()


def all_to_all_rows(x: torch.Tensor) -> torch.Tensor:
    """Row j of ``x`` (shape ``(world, ...)``) goes to rank j; row i of
    the result came from rank i (``lax.all_to_all(split_axis=0,
    concat_axis=0)``)."""
    if process_count() == 1:
        return x
    src = _bits(x.contiguous())
    if _staged(src):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src)
    out = out.to(x.device)
    return out.view(x.dtype) if out.dtype != x.dtype else out
