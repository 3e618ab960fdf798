"""Step cost registry: measured FLOPs, peak memory and collectives as run
telemetry (the JAX package's telemetry/cost.py, redesigned).

JAX reads what its compiler knows about a step program
(``cost_analysis()``, ``memory_analysis()``, the collectives in the
compiled HLO). PyTorch compiles nothing, so the port measures one real
step instead, the first train step and the first eval step of a run
(:meth:`CostRegistry.measure`):

- ``flops_per_step_per_device``: ``torch.utils.flop_counter.
  FlopCounterMode`` over the step (the products of the linear layers and
  of the chunked loss, its recompute included), plus attention by the
  formula of ``ops/attention.py`` whichever implementation ran (K1 is a
  ctypes launch the counter cannot see, and the plain path would count
  at the full S x S). So the count is the same on the CPU and the card;
- ``hbm_peak_bytes``: the step's residency on this rank, what JAX's
  field counts (there the compiler's estimate for the compiled step:
  arguments + outputs + temporaries - aliased bytes, the whole train
  state included): the bytes of the train state and the batch resident on
  the device when the step starts (``resident``: the parameters and
  buffers, the optimizer's parameters, i.e. the ZeRO-1 / FSDP tiles, and
  its state), plus the step's growth, ``max_memory_allocated`` during it
  minus ``memory_allocated`` at its start. So a tensor alive beside the
  state (another run's, an earlier phase's) does not count. The Trainer
  takes it on the run's second train step (:meth:`CostRegistry.
  measure_memory`), the first whose optimizer state exists: torch makes
  Adam's moments at the end of the first. None on the CPU (no counter);
  the counter is injectable (``memory``);
- ``collectives``: ``{kind: {count, bytes}}`` of the collectives the
  step ran on this process, keyed as the JAX package keys a compiled
  program's (``runtime/distributed.py`` ``count_collectives``).

:meth:`CostRegistry.mfu_analytic` divides the FLOPs by the step time and
the card's dense bf16 peak (:func:`peak_bf16_flops`), as JAX does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Iterator, Optional

import torch

# dense bf16 tensor-core FLOP/s by CUDA device name (NVIDIA's H100 data
# sheet; the SXM part reports "NVIDIA H100 80GB HBM3"). Any other name,
# and the CPU, has no entry.
PEAK_BF16 = (
    ("H100 NVL", 835e12),
    ("H100 PCIe", 756e12),
    ("H100 80GB HBM3", 989.4e12),
)


def device_kind(device) -> str:
    """The device's name: ``torch.cuda.get_device_name`` for a card,
    ``"cpu"`` otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def peak_bf16_flops(device) -> Optional[float]:
    """Dense bf16 FLOP/s of one card, or None when unknown (the CPU)."""
    kind = device_kind(device)
    for key, peak in PEAK_BF16:
        if key in kind:
            return peak
    return None


class CudaMemory:
    """The card's allocator counters, which :class:`CostRegistry` reads
    (a test passes a fake with the same methods)."""

    def __init__(self, device):
        self.device = torch.device(device)

    def synchronize(self) -> None:
        torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        torch.cuda.reset_peak_memory_stats(self.device)

    def allocated(self) -> int:
        return torch.cuda.memory_allocated(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)


def _card_memory(device) -> Optional[CudaMemory]:
    return CudaMemory(device) if device.type == "cuda" else None


def resident_bytes(tensors: Iterable[torch.Tensor], device) -> int:
    """Bytes of the distinct storages under ``tensors`` that lie on
    ``device`` (a storage shared by several tensors counts once; a freed
    one, such as an FSDP parameter's between steps, counts 0)."""
    device = torch.device(device)
    seen, total = set(), 0
    for t in tensors:
        if t.device.type != device.type:
            continue
        storage = t.untyped_storage()
        key = (storage.data_ptr(), storage.nbytes())
        if storage.nbytes() and key not in seen:
            seen.add(key)
            total += storage.nbytes()
    return total


class CostRegistry:
    """Per-run registry of measured step cost records, keyed by tag.

    Tags are the Trainer's step names ("train_step", "eval_step"); a tag
    measured again overwrites its record. ``memory(device)`` gives the
    allocator counters of a device, or None where there are none (the
    default: :class:`CudaMemory` for a card, None for the CPU).
    """

    def __init__(self, memory: Optional[Callable[[torch.device],
                                                 object]] = None):
        self.records: Dict[str, Dict[str, object]] = {}
        self._memory = memory or _card_memory

    @contextlib.contextmanager
    def _memory_of(self, device, resident: Optional[Callable[[], int]]
                   ) -> Iterator[Dict[str, Optional[int]]]:
        """``{"hbm_peak_bytes": ...}`` of the block (module docstring),
        filled when it ends; None without a counter."""
        counter = self._memory(torch.device(device))
        out: Dict[str, Optional[int]] = {"hbm_peak_bytes": None}
        if counter is None:
            yield out
            return
        counter.synchronize()
        counter.reset_peak()
        start = counter.allocated()
        base = resident() if resident is not None else 0
        yield out
        counter.synchronize()
        out["hbm_peak_bytes"] = int(base + counter.peak() - start)

    @contextlib.contextmanager
    def measure(self, tag: str, device,
                resident: Optional[Callable[[], int]] = None
                ) -> Iterator[Dict[str, object]]:
        """Measure the step run inside the block; its record (filled when
        the block ends) is yielded and kept under ``tag``. ``resident``
        returns the bytes of the train state and batch on the device at
        the step's start (0 when not given)."""
        from torch.utils.flop_counter import FlopCounterMode

        from distributed_pytorch_example_tpu_torch.ops.attention import (
            count_flops,
        )
        from distributed_pytorch_example_tpu_torch.runtime.distributed import (
            count_collectives,
        )

        device = torch.device(device)
        record: Dict[str, object] = {"tag": tag}
        counter = FlopCounterMode(display=False)
        with self._memory_of(device, resident) as memory:
            with counter, count_flops() as attention, \
                    count_collectives() as collectives:
                yield record
        matmul = int(counter.get_total_flops())
        record.update({
            "flops_per_step_per_device": float(matmul + attention[0]),
            "matmul_flops": matmul,
            "attention_flops": attention[0],
            "bytes_accessed": None,
            "hbm_peak_bytes": memory["hbm_peak_bytes"],
            "collectives": collectives,
            "device_kind": device_kind(device),
            "peak_bf16_flops": peak_bf16_flops(device),
        })
        self.records[tag] = record

    @contextlib.contextmanager
    def measure_memory(self, tag: str, device,
                       resident: Optional[Callable[[], int]] = None
                       ) -> Iterator[None]:
        """Take ``tag``'s ``hbm_peak_bytes`` anew on the step run inside
        the block (the record's other fields stay those of the step that
        :meth:`measure` counted)."""
        with self._memory_of(device, resident) as memory:
            yield
        self.records[tag]["hbm_peak_bytes"] = memory["hbm_peak_bytes"]

    def get(self, tag: str) -> Optional[Dict[str, object]]:
        return self.records.get(tag)

    def mfu_analytic(
        self, tag: str, step_time_ms: Optional[float]
    ) -> Optional[float]:
        """flops / (step_time * peak bf16); None when either is unknown."""
        rec = self.records.get(tag)
        if not rec or not step_time_ms:
            return None
        flops = rec.get("flops_per_step_per_device")
        peak = rec.get("peak_bf16_flops")
        if not flops or not peak:
            return None
        return float(flops) / (step_time_ms / 1000.0) / float(peak)
