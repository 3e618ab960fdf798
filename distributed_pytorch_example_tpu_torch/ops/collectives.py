"""All-gather (K3a) and reduce-scatter (K3b) over peer memory: the CUDA
kernels, their plain versions and the peer workspace.

Both kernels (``csrc/ring_collectives.cu``) are one-shot pushes across the
H100's all-to-all NVLink: every rank stores what each peer needs straight
into that peer's workspace (one hop, no ring), and the peer finishes the
collective locally.

- :func:`ring_all_gather` launches K3a, the Hopper port of the TPU kernel
  ``ring_all_gather`` / ``_ag_kernel``
  (distributed_pytorch_example_tpu/ops/pallas/collectives.py): the tiled
  axis-0 all-gather. Every rank pushes its payload to every peer, and each
  peer copies it into that rank's row. It moves bytes, so it takes any
  dtype.
- :func:`ring_reduce_scatter` launches K3b, the port of
  ``ring_reduce_scatter`` / ``_rs_kernel``: the tiled reduce-scatter. Every
  rank pushes each destination's part to that rank, and the destination
  adds the parts in float32 in the TPU ring's order, bit for bit
  (:func:`ring_reduce_scatter_ring_order`), cast back to the input dtype.
- Each launch adds one to ``ring_all_gather.launches`` /
  ``ring_reduce_scatter.launches``.
- :func:`ring_all_gather_reference` / :func:`ring_reduce_scatter_reference`
  are the plain versions. They take the list of every rank's tensor and
  return every rank's result. :func:`ring_reduce_scatter_ring_order` is
  the plain sum in the ring's order, which K3b must equal exactly; the
  tests and the card checks use it.

The kernels take what the TPU kernels take: a local payload that splits
into two halves of 128-element rows (:func:`half_rows`), on a ring of at
least two ranks; callers (``parallel/wire.py``) send anything else to the
library collective, as the JAX package sends it to XLA's. The pushes need
no halves, but the rule decides which calls reach the library, so it
stays the TPU kernels'.

**The peer workspace** (:class:`PeerRing`; the TPU reaches its neighbours
over ICI and needs none). Each rank allocates one fixed device buffer,
once, for the staging slots and the flags (264 MiB: 32 MiB of slots per
collective id; ``cudaMalloc``, so that it can be exported). Ranks in separate processes swap CUDA IPC handles with
``dist.all_gather_object`` and open each other's buffers; ranks that share
one process (the card checks: the CUDA counterpart of the JAX tests' fake
multi-device mesh) fill the table with the raw pointers of their local
buffers, since a process cannot open its own IPC handle. The kernel gets
the table as a device array of base pointers.

On a CUDA tensor a wrapper launches its kernel or raises; a failed build,
a refused launch and a wait that timed out all raise. A timed-out wait
shows up in the ring's device error word, which :meth:`PeerRing.check`
(and :func:`check_rings`, at the train step's host sync) reads. A CPU
tensor takes the plain version across processes: the library collective
over the process group, which computes what the list-form plain version
computes. Each wrapper runs in a profiler range of its name (the JAX
kernels' ``named_scope``) and counts its result in the collective tally
of ``runtime/distributed.py`` (the step cost record).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch

from distributed_pytorch_example_tpu_torch.ops import _build
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.runtime.profiler import (
    scope_marker,
)

_LANES = 128  # the TPU kernels' row width: halves are (rows, 128)
MAX_STREAMS = 4  # stream ids per collective kind with their own buffers
DEFAULT_TIMEOUT_S = 10.0
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {2: "a slot's acknowledgement", 3: "a slot's data"}


def half_rows(n: int) -> Optional[int]:
    """Rows of the (rows, 128) half-payload, or None when ``n`` elements
    do not split into two 128-aligned halves (the TPU kernels' rule)."""
    if n and n % (2 * _LANES) == 0:
        return n // 2 // _LANES
    return None


def ring_eligible(x: torch.Tensor, world: int) -> bool:
    """Whether the ring kernels take ``x`` as a local payload: on the
    card, more than one rank, and :func:`half_rows` holds."""
    return x.is_cuda and world > 1 and half_rows(x.numel()) is not None


def _set_index(stream: int, kind: int) -> int:
    """Gathers take the even collective ids, reduce-scatters the odd."""
    return 2 * (int(stream) % MAX_STREAMS) + kind


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("ring_collectives")
    if lib.dpx_ring_all_gather.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dpx_ring_alloc.argtypes = [i, ctypes.POINTER(p)]
        lib.dpx_ring_free.argtypes = [p]
        lib.dpx_ring_card_ranks.argtypes = [p, i]
        lib.dpx_ipc_get_handle.argtypes = [p, p]
        lib.dpx_ipc_open.argtypes = [i, p, ctypes.POINTER(p)]
        lib.dpx_ipc_close.argtypes = [p]
        lib.dpx_ring_all_gather.argtypes = [p, i, i, i, p, p, ll, p, ll, p]
        lib.dpx_ring_reduce_scatter.argtypes = [p, i, i, i, i, p, p, ll, p,
                                                ll, p]
        for fn in (lib.dpx_ring_alloc, lib.dpx_ring_free,
                   lib.dpx_ring_card_ranks,
                   lib.dpx_ipc_get_handle, lib.dpx_ipc_open,
                   lib.dpx_ipc_close, lib.dpx_ring_all_gather,
                   lib.dpx_ring_reduce_scatter):
            fn.restype = i
    return lib


def _cuda_call(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def _alloc_workspace(device: torch.device) -> int:
    ptr = ctypes.c_void_p()
    _cuda_call("ring workspace cudaMalloc",
               _lib().dpx_ring_alloc(device.index or 0, ctypes.byref(ptr)))
    return ptr.value


class PeerRing:
    """One rank's view of a ring of peer workspaces on the card.

    ``peer_ptrs[r]`` is rank r's workspace base as this process addresses
    it; ``own`` is the workspace this object frees on :meth:`close`, and
    ``opened`` the peer mappings it closes. ``err`` is this rank's device
    error word; ``timeout_s`` bounds every wait of its kernels.
    ``card_ranks`` is how many of the ring's ranks run on this card at once
    (all of them for in-process ranks, one for a ring over processes): the
    kernels' grid divides the card among them.
    """

    def __init__(self, rank: int, world: int, device: torch.device,
                 peer_ptrs: Sequence[int], *, own: Optional[int] = None,
                 opened: Sequence[int] = (),
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 card_ranks: Optional[int] = None):
        self.rank, self.world, self.device = rank, world, device
        self.peers = torch.tensor(list(peer_ptrs), dtype=torch.int64,
                                  device=device)
        self.err = torch.zeros(1, dtype=torch.int32, device=device)
        self.timeout_ns = int(timeout_s * 1e9)
        self._own = own
        self._opened = list(opened)
        _lib().dpx_ring_card_ranks(ctypes.c_void_p(self.peers.data_ptr()),
                                   card_ranks or world)

    @classmethod
    def local_group(cls, world: int, device="cuda",
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> List["PeerRing"]:
        """``world`` in-process ranks on one card, each with its own
        workspace; each rank's kernel must run on its own CUDA stream."""
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"PeerRing needs a CUDA device, got {device}")
        device = torch.device("cuda", device.index or 0)
        ptrs = [_alloc_workspace(device) for _ in range(world)]
        return [cls(r, world, device, ptrs, own=ptrs[r], timeout_s=timeout_s,
                    card_ranks=world) for r in range(world)]

    @classmethod
    def over_process_group(cls, device,
                           timeout_s: float = DEFAULT_TIMEOUT_S,
                           group=None) -> "PeerRing":
        """This process's rank of a ring over ``group`` (default: every
        process): a collective (every rank of the group calls it), which
        swaps CUDA IPC handles with ``dist.all_gather_object``."""
        import torch.distributed as dist

        device = torch.device(device)
        device = torch.device("cuda", device.index
                              if device.index is not None
                              else torch.cuda.current_device())
        rank = distributed.process_index(group)
        world = distributed.process_count(group)
        lib = _lib()
        own = _alloc_workspace(device)
        handle = ctypes.create_string_buffer(lib.dpx_ipc_handle_bytes())
        _cuda_call("cudaIpcGetMemHandle",
                   lib.dpx_ipc_get_handle(ctypes.c_void_p(own), handle))
        handles: List[Optional[bytes]] = [None] * world
        dist.all_gather_object(handles, handle.raw, group=group)
        ptrs, opened = [], []
        for r, h in enumerate(handles):
            if r == rank:
                ptrs.append(own)
                continue
            ptr = ctypes.c_void_p()
            _cuda_call(f"cudaIpcOpenMemHandle of rank {r}'s workspace",
                       lib.dpx_ipc_open(device.index, h, ctypes.byref(ptr)))
            ptrs.append(ptr.value)
            opened.append(ptr.value)
        return cls(rank, world, device, ptrs, own=own, opened=opened,
                   timeout_s=timeout_s, card_ranks=1)

    def check(self) -> None:
        """Raise if one of this rank's kernels timed out waiting on a
        peer (a device read: it waits for the stream)."""
        code = int(self.err.item())
        if code:
            raise RuntimeError(
                f"ring collective on rank {self.rank} of {self.world}: a "
                f"wait for {_ERRORS.get(code, f'code {code}')} timed out "
                f"after {self.timeout_ns / 1e9:g} s; a peer never arrived"
            )

    def close(self) -> None:
        """Unmap the peers' workspaces and free this rank's own."""
        lib = _lib()
        torch.cuda.synchronize(self.device)
        lib.dpx_ring_card_ranks(ctypes.c_void_p(self.peers.data_ptr()), 0)
        for ptr in self._opened:
            lib.dpx_ipc_close(ctypes.c_void_p(ptr))
        if self._own is not None:
            lib.dpx_ring_free(ctypes.c_void_p(self._own))
        self._opened, self._own = [], None


_process_rings: Dict[tuple, PeerRing] = {}


def process_ring(device, group=None) -> PeerRing:
    """The ring over ``group`` (default: every process) on ``device``,
    built at its first use (a collective: every rank of the group reaches
    it together, since every rank issues the same collectives)."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device(),
           distributed.process_index(), distributed.process_count(),
           None if group is None else id(group))
    ring = _process_rings.get(key)
    if ring is None:
        ring = _process_rings[key] = PeerRing.over_process_group(
            device, group=group)
    return ring


def check_rings() -> None:
    """:meth:`PeerRing.check` on every process ring built so far."""
    for ring in _process_rings.values():
        ring.check()


def _payload(x: torch.Tensor, ring: PeerRing, what: str) -> torch.Tensor:
    if x.device != ring.device:
        raise ValueError(f"{what}: tensor on {x.device}, ring on "
                         f"{ring.device}")
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


@scope_marker("ring_all_gather")
def ring_all_gather(x: torch.Tensor, ring: Optional[PeerRing] = None, *,
                    stream: int = 0, group=None) -> torch.Tensor:
    """Tiled axis-0 all-gather: ``(n0, ...)`` on each rank ->
    ``(world * n0, ...)``, rank r's rows at ``r * n0``. The contract of
    ``lax.all_gather(x, axis, axis=0, tiled=True)``.

    ``stream`` picks the buffer and flag set (the TPU kernel's
    collective id ``2 * stream``): collectives in flight at once need
    distinct ids (modulo :data:`MAX_STREAMS`). ``group`` (without
    ``ring``) picks the process ring of one mesh axis. Launches on the
    current CUDA stream without synchronising.
    """
    if not x.is_cuda:
        return distributed.all_gather_tiled(x, group=group)
    ring = ring if ring is not None else process_ring(x.device, group)
    x = _payload(x, ring, "ring_all_gather")
    if ring.world < 2 or half_rows(x.numel()) is None:
        raise ValueError(
            f"ring_all_gather: {x.numel()} elements over {ring.world} ranks; "
            "the kernel takes two halves of 128-element rows on >= 2 ranks"
        )
    out = torch.empty((ring.world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().dpx_ring_all_gather(
            ring.peers.data_ptr(), ring.rank, ring.world,
            _set_index(stream, 0), x.data_ptr(), out.data_ptr(),
            x.numel() * x.element_size(), ring.err.data_ptr(),
            ring.timeout_ns, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _cuda_call("ring_all_gather launch", err)
    ring_all_gather.launches += 1
    distributed.note_collective("all-gather", out)
    return out


ring_all_gather.launches = 0


@scope_marker("ring_reduce_scatter")
def ring_reduce_scatter(x: torch.Tensor, ring: Optional[PeerRing] = None, *,
                        stream: int = 0, group=None) -> torch.Tensor:
    """Tiled reduce-scatter over axis 0: ``(world * c, ...)`` on each
    rank -> this rank's ``(c, ...)`` tile of the sum over ranks, summed
    in float32 in the TPU ring's order (:func:`ring_reduce_scatter_ring_order`)
    and cast back to ``x.dtype`` (float32 or bfloat16). The contract of
    ``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``;
    ``stream`` picks the set of odd collective id ``2 * stream + 1``;
    ``group`` as in :func:`ring_all_gather`. Launches on the current CUDA
    stream without synchronising.
    """
    if not x.is_cuda:
        return distributed.reduce_scatter_tiled(x, group=group)
    ring = ring if ring is not None else process_ring(x.device, group)
    x = _payload(x, ring, "ring_reduce_scatter")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"ring_reduce_scatter: dtype {x.dtype} not in "
                         "float32/bfloat16")
    world = ring.world
    if world < 2 or x.dim() == 0 or x.shape[0] % world:
        raise ValueError(
            f"ring_reduce_scatter: leading dim of {tuple(x.shape)} does not "
            f"split over {world} ranks"
        )
    n = x.numel() // world
    if half_rows(n) is None:
        raise ValueError(
            f"ring_reduce_scatter: a {n}-element chunk does not split into "
            "two halves of 128-element rows"
        )
    out = torch.empty((x.shape[0] // world,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().dpx_ring_reduce_scatter(
            ring.peers.data_ptr(), ring.rank, world, _set_index(stream, 1),
            _DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), n,
            ring.err.data_ptr(), ring.timeout_ns,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _cuda_call("ring_reduce_scatter launch", err)
    ring_reduce_scatter.launches += 1
    distributed.note_collective("reduce-scatter", out)
    return out


ring_reduce_scatter.launches = 0


def ring_all_gather_reference(xs: Sequence[torch.Tensor]
                              ) -> List[torch.Tensor]:
    """Plain K3a: every rank gets the axis-0 concatenation of all ranks'
    payloads (one tensor, shared by every rank's entry)."""
    out = torch.cat(list(xs), dim=0)
    return [out] * len(xs)


def ring_reduce_scatter_reference(xs: Sequence[torch.Tensor]
                                  ) -> List[torch.Tensor]:
    """Plain K3b: the float32 sum over ranks (rank order), cut into
    ``len(xs)`` tiles along axis 0, each cast back to the input dtype;
    rank r gets tile r."""
    world = len(xs)
    acc = xs[0].float().clone()
    for x in xs[1:]:
        acc += x.float()
    chunk = acc.shape[0] // world
    return [acc[r * chunk:(r + 1) * chunk].to(xs[0].dtype)
            for r in range(world)]


def ring_reduce_scatter_ring_order(xs: Sequence[torch.Tensor]
                                  ) -> List[torch.Tensor]:
    """Plain K3b in the TPU ring's summation order, which the kernel
    equals bit for bit: rank c's tile of ``(world * chunk, ...)`` sums the
    ranks' float32 tiles c as ``((x[c+1] + x[c+2]) + ...) + x[c]`` over the
    low half of the flattened tile and ``((x[c-1] + x[c-2]) + ...) + x[c]``
    over the high half (rank indices mod world), cast back to the input
    dtype: ``_rs_kernel``'s clockwise partial seeded at c + 1 with an
    own-part add at every hop, and its counter-clockwise mirror."""
    world = len(xs)
    tiles = [x.float().reshape(world, -1) for x in xs]
    chunk = tiles[0].shape[1]
    half = chunk // 2
    out = []
    for c in range(world):
        low = tiles[(c + 1) % world][c, :half].clone()
        high = tiles[(c - 1) % world][c, half:].clone()
        for j in range(2, world):
            low += tiles[(c + j) % world][c, :half]
            high += tiles[(c - j) % world][c, half:]
        low += tiles[c][c, :half]
        high += tiles[c][c, half:]
        shape = (xs[c].shape[0] // world,) + tuple(xs[c].shape[1:])
        out.append(torch.cat([low, high]).reshape(shape).to(xs[c].dtype))
    return out
