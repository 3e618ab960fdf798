"""Where the port's entry points run.

The card is the default. ``device=None`` means ``cuda``; when no card is
visible that raises instead of carrying on on the CPU, so a run that was
meant for the GPU can never quietly measure the host. Tests pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a visible card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the "
            "CPU (the port's entry points default to the card)"
        )
    return dev
