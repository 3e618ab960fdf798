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
coordinator is a loopback address, else one.

Shrink to survivors (``DPX_ELASTIC=1``): when every join attempt fails
because peers are gone for good, each surviving process probes every
peer's address (:func:`peer_address`, the launcher's host naming), so
all survivors derive the same smaller world (:func:`shrink_to_survivors`:
ranks renumbered densely in their old order, the lowest survivor the new
coordinator) and join it. :func:`initialize` returns the world it
joined; the caller resumes from the last intact checkpoint, which both
formats reshard onto the new world. Without the variable, or when every
peer answers the probe (then the failure is not a lost peer), the join's
error propagates.

The library collectives the port needs (:func:`all_reduce_sum_`,
:func:`all_gather_tiled`, :func:`reduce_scatter_tiled`,
:func:`all_to_all_rows`) take CUDA or CPU tensors on either backend, over
the world or over the process group of one mesh axis (``group``,
``runtime/mesh.py``). Gloo
has no reduce-scatter, so there it is an all-reduce followed by this
rank's tile (the numbers of ``psum_scatter``). Gloo's support for CUDA
tensors differs from one collective to the next, so under gloo every
CUDA payload is staged through the host; on the ZeRO-1 path that touches
the psum leaves below the ZeRO-1 floor, the metrics, the IPC handle swap
and, with a float32 parameter gather, the gathered parameters. bfloat16
payloads that are only moved travel as their bytes.

Inside :func:`count_collectives` every collective of the port (these
four, and the ring kernels of ``ops/collectives.py``) adds its kind and
result bytes to a tally, keyed as the JAX package keys the collectives
of a compiled program (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``all-to-all``): the cost record of one train step
(``telemetry/cost.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
from datetime import timedelta
from typing import Dict, Iterator, Optional, Union

import torch
import torch.distributed as dist

from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)

# how long a join, or a collective, may wait on a slow peer
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


def peer_address(config: DistributedConfig, process_id: int) -> str:
    """Process ``process_id``'s address derived from the coordinator's:
    the launcher names hosts ``{base}-{k}`` behind one discovery service,
    so ``myjob-0.svc:29500`` -> ``myjob-3.svc:29500``."""
    if not config.coordinator_address:
        raise ValueError("peer_address needs a distributed config")
    host, _, port = config.coordinator_address.rpartition(":")
    name, _, domain = host.partition(".")
    base = name.rsplit("-", 1)[0] if "-" in name else name
    peer = f"{base}-{process_id}"
    if domain:
        peer = f"{peer}.{domain}"
    return f"{peer}:{port}"


def _default_probe(address: str, timeout: float = 2.0) -> bool:
    """Whether the host at ``address`` (host:port) is there: a TCP
    handshake, where a refused connection counts as alive (only the
    coordinator listens on the port, but the host answered). A failed
    name lookup (a host moved away loses its record), a timeout or an
    unreachable network count as dead."""
    host, _, port = address.rpartition(":")
    try:
        socket.create_connection((host, int(port)), timeout=timeout).close()
        return True
    except ConnectionRefusedError:
        return True
    except OSError:
        return False


def compute_survivor_config(config: DistributedConfig,
                            responsive: list) -> DistributedConfig:
    """The smaller world of the ``responsive`` process ids (this one
    included): ranks renumbered densely in their old order, the lowest
    survivor the coordinator."""
    survivors = sorted(set(responsive) | {config.process_id})
    return DistributedConfig(
        num_processes=len(survivors),
        process_id=survivors.index(config.process_id),
        coordinator_address=peer_address(config, survivors[0]),
    )


def shrink_to_survivors(config: DistributedConfig,
                        probe=None) -> DistributedConfig:
    """Probe every peer and return the world of those that answer. Every
    survivor probes the same list, so all derive the same world without
    talking to each other."""
    probe = probe if probe is not None else _default_probe
    responsive = [config.process_id]
    for k in range(config.num_processes):
        if k == config.process_id:
            continue
        address = peer_address(config, k)
        alive = probe(address)
        logger.info("Elastic probe: process %d (%s) %s", k, address,
                    "alive" if alive else "unresponsive")
        if alive:
            responsive.append(k)
    return compute_survivor_config(config, responsive)


def _attempt_join(config: DistributedConfig, max_attempts: int,
                  backend: str) -> None:
    """One bounded-retry join of a fixed world."""
    from distributed_pytorch_example_tpu_torch.robustness import chaos, retry

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


def initialize(
    config: Optional[DistributedConfig] = None,
    device: Union[str, torch.device] = "cuda",
    max_attempts: Optional[int] = None,
    probe=None,
) -> DistributedConfig:
    """Join the process group (the reference's ``setup_distributed``);
    returns the world actually joined, which under ``DPX_ELASTIC=1`` may
    be smaller than ``config``'s: callers use it, and
    :func:`process_count` follows it.

    A no-op for one process, and idempotent. ``device`` and the host's
    cards pick the backend (:func:`choose_backend`); a CUDA process binds
    to card ``rank % device_count`` before joining. ``max_attempts``
    defaults to ``$DPX_RENDEZVOUS_RETRIES`` + 1 = 4, with
    ``$DPX_RENDEZVOUS_BACKOFF`` (default 1.0 s) as the first backoff.
    ``probe`` (an address -> alive callable) replaces the TCP probe of
    the shrink path.
    """
    from distributed_pytorch_example_tpu_torch.robustness import elastic

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
    try:
        _attempt_join(config, max_attempts, backend)
    except Exception as err:
        if not elastic.elastic_enabled():
            raise
        shrunk = shrink_to_survivors(config, probe=probe)
        if shrunk.num_processes >= config.num_processes:
            # every peer answered: not a lost peer (a bad port, a wrong
            # address); the same world at another size would fail alike
            raise
        logger.warning(
            "Rendezvous exhausted at world size %d (%s); %s=1: shrinking "
            "to %d survivor(s), new process_id=%d, coordinator=%s",
            config.num_processes, err, elastic.ELASTIC_ENV,
            shrunk.num_processes, shrunk.process_id,
            shrunk.coordinator_address)
        config = shrunk
        if not config.is_distributed:
            logger.info("Single-process mode (the only survivor)")
            return config
        backend = choose_backend(dev, config)
        if dev.type == "cuda":
            torch.cuda.set_device(
                config.process_id % torch.cuda.device_count())
        _attempt_join(config, max_attempts, backend)
    return config


def shutdown() -> None:
    """Tear down the process group (reference train.py:85-86)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_index(group=None) -> int:
    """This process's rank in ``group`` (default: the world)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return 0


def process_count(group=None) -> int:
    """The ranks of ``group`` (default: the world)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def is_coordinator() -> bool:
    """True on rank 0, which owns the logs (reference ``rank == 0``)."""
    return process_index() == 0


def barrier() -> None:
    """Block until every process reaches this point (``dist.barrier``)."""
    if process_count() > 1:
        dist.barrier()


_tally: Optional[Dict[str, Dict[str, int]]] = None


@contextlib.contextmanager
def count_collectives() -> Iterator[Dict[str, Dict[str, int]]]:
    """``{kind: {count, bytes}}`` of the collectives this process runs
    inside the block (result bytes, as the JAX package counts them)."""
    global _tally
    outer, _tally = _tally, {}
    try:
        yield _tally
    finally:
        _tally = outer


def note_collective(kind: str, result: torch.Tensor) -> None:
    """Count one collective of ``kind`` whose result is ``result``."""
    if _tally is not None:
        rec = _tally.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += result.numel() * result.element_size()


def all_reduce_mean_(tensor: torch.Tensor) -> torch.Tensor:
    """In-place cross-process mean; the identity for one process."""
    world = process_count()
    if world > 1:
        all_reduce_sum_(tensor)
        tensor.div_(world)
    return tensor


def _staged(x: torch.Tensor, group=None) -> bool:
    """Whether ``x`` goes through the host: a CUDA tensor under gloo."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A payload that is only moved, in a dtype every backend takes (its
    bytes: gloo moves no bfloat16 or int16)."""
    return x.view(torch.uint8) if x.dtype == torch.bfloat16 else x


def all_reduce_sum_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over the processes of ``group`` (default: the world;
    ``psum``); the identity for one process."""
    if process_count(group) == 1:
        return tensor
    note_collective("all-reduce", tensor)
    if _staged(tensor, group):
        host = tensor.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def all_gather_tiled(x: torch.Tensor, dim: int = 0,
                     group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``lax.all_gather(..., axis=dim, tiled=True)``) over ``group``."""
    world = process_count(group)
    if world == 1:
        return x
    src = _bits(x.contiguous())
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim).to(x.device)
    note_collective("all-gather", out)
    return out.view(x.dtype) if out.dtype != x.dtype else out


def reduce_scatter_tiled(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's tile of the sum of ``x`` along axis 0 over ``group``
    (``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``)."""
    world = process_count(group)
    if world == 1:
        return x
    if x.shape[0] % world:
        raise ValueError(f"leading dim of {tuple(x.shape)} does not split "
                         f"over {world} processes")
    chunk = x.shape[0] // world
    if dist.get_backend(group) == "nccl":
        out = torch.empty((chunk,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        note_collective("reduce-scatter", out)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out
    # gloo has no reduce-scatter: all-reduce, then this rank's tile (the
    # tally counts what the program asked for: one reduce-scatter)
    with count_collectives():
        total = all_reduce_sum_(x.clone(), group)
    rank = process_index(group)
    out = total[rank * chunk:(rank + 1) * chunk].clone()
    note_collective("reduce-scatter", out)
    return out


def all_to_all_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Row j of ``x`` (shape ``(world, ...)``) goes to rank j of ``group``;
    row i of the result came from rank i (``lax.all_to_all(split_axis=0,
    concat_axis=0)``)."""
    if process_count(group) == 1:
        return x
    src = _bits(x.contiguous())
    if _staged(src, group):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    note_collective("all-to-all", out)
    out = out.to(x.device)
    return out.view(x.dtype) if out.dtype != x.dtype else out
