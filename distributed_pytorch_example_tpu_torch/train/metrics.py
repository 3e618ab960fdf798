"""Metric accumulation without per-step host syncs (the JAX package's
train/metrics.py).

The reference pays a host sync every step (``loss.item()``,
train.py:141). Here each step's metrics stay on the device as a running
sum; :meth:`MetricAccumulator.result` fetches them once, at a log
boundary or an epoch end. Memory is one device scalar per metric key.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch


def fetch_scalars(metrics: Dict[str, torch.Tensor],
                  keys: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """ONE host fetch of the selected scalar metrics."""
    wanted = set(keys) if keys is not None else None
    names = [k for k, v in metrics.items()
             if (wanted is None or k in wanted) and v.dim() == 0]
    if not names:
        return {}
    values = torch.stack([metrics[k].detach().float() for k in names])
    return dict(zip(names, values.tolist()))


class MetricAccumulator:
    """Equal-weight running mean of device-scalar metric dicts."""

    def __init__(self):
        self._sums: Optional[Dict[str, torch.Tensor]] = None
        self._count = 0

    def append(self, metrics: Dict[str, torch.Tensor]) -> None:
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        if self._sums is None:
            self._sums = metrics
        else:
            self._sums = {k: v + metrics[k] for k, v in self._sums.items()}
        self._count += 1

    def __len__(self) -> int:
        return self._count

    def result(self) -> Dict[str, float]:
        """Fetch the running sums and average (one host sync)."""
        if not self._count:
            return {}
        return {k: v / self._count
                for k, v in fetch_scalars(self._sums).items()}

    def reset(self) -> None:
        self._sums = None
        self._count = 0
