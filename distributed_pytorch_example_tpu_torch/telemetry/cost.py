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
- ``hbm_peak_bytes``: ``torch.cuda.max_memory_allocated()`` over the
  step, reset before it; None on the CPU;
- ``collectives``: ``{kind: {count, bytes}}`` of the collectives the
  step ran on this process, keyed as the JAX package keys a compiled
  program's (``runtime/distributed.py`` ``count_collectives``).

:meth:`CostRegistry.mfu_analytic` divides the FLOPs by the step time and
the card's dense bf16 peak (:func:`peak_bf16_flops`), as JAX does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

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


class CostRegistry:
    """Per-run registry of measured step cost records, keyed by tag.

    Tags are the Trainer's step names ("train_step", "eval_step"); a tag
    measured again overwrites its record.
    """

    def __init__(self):
        self.records: Dict[str, Dict[str, object]] = {}

    @contextlib.contextmanager
    def measure(self, tag: str, device) -> Iterator[Dict[str, object]]:
        """Measure the step run inside the block; its record (filled when
        the block ends) is yielded and kept under ``tag``."""
        from torch.utils.flop_counter import FlopCounterMode

        from distributed_pytorch_example_tpu_torch.ops.attention import (
            count_flops,
        )
        from distributed_pytorch_example_tpu_torch.runtime.distributed import (
            count_collectives,
        )

        device = torch.device(device)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        record: Dict[str, object] = {"tag": tag}
        counter = FlopCounterMode(display=False)
        with counter, count_flops() as attention, \
                count_collectives() as collectives:
            yield record
        if cuda:
            torch.cuda.synchronize(device)
        matmul = int(counter.get_total_flops())
        record.update({
            "flops_per_step_per_device": float(matmul + attention[0]),
            "matmul_flops": matmul,
            "attention_flops": attention[0],
            "bytes_accessed": None,
            "hbm_peak_bytes": (torch.cuda.max_memory_allocated(device)
                               if cuda else None),
            "collectives": collectives,
            "device_kind": device_kind(device),
            "peak_bf16_flops": peak_bf16_flops(device),
        })
        self.records[tag] = record

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
