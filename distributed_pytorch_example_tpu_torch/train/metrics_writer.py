"""Structured metrics sink: one JSON line per epoch, rank 0 only (the JAX
package's train/metrics_writer.py).

The reference's observability is log lines (reference train.py:285-290);
machine-readable history is the framework's addition — the epoch records the
Trainer already builds stream to ``metrics.jsonl`` so runs can be compared,
plotted, or regression-checked without log parsing.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional


class MetricsWriter:
    """Append-only JSONL writer; no-op off rank 0 or when path is None."""

    def __init__(self, path: Optional[str], enabled: bool = True,
                 append: bool = False):
        self.path = path if enabled else None
        if self.path:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            # fresh run truncates (one file per run); resume appends so the
            # history stays continuous across restarts
            self._fh = open(self.path, "a" if append else "w", buffering=1)
        else:
            self._fh = None

    def write(self, record: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        # NaN/Inf are not valid JSON: drop the value instead of emitting
        # tokens strict parsers (jq, JSON.parse) reject — but leave a
        # `<key>_nonfinite: true` marker so a NaN loss is VISIBLE in the
        # record rather than silently absent
        clean: Dict[str, Any] = {}
        for k, v in record.items():
            if isinstance(v, float) and not math.isfinite(v):
                clean[f"{k}_nonfinite"] = True
            else:
                clean[k] = v
        self._fh.write(json.dumps(clean, sort_keys=True, allow_nan=False) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
