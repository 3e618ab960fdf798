"""Health sentinels: the train step's device-side scalars (the training
half of the JAX package's telemetry/sentinels.py).

The reference reads training health off a per-step host sync
(``loss.item()``, reference train.py:141). Here the health scalars (the
global gradient norm, the parameter norm and the number of non-finite
gradient elements) are part of the step's metrics: float32 device
scalars, fetched together with the loss at a log boundary, never on
their own.

Under ZeRO-1 a rank holds tiles of the sharded leaves: the step takes
their squares and counts as partial sums and reduces them in the one
collective it already runs for the gradient norm
(``train/optimizers.py`` ``ShardedUpdate``), so the values are the same
on every rank.

The serving half (``ServeSentinels``) waits for the fleet (ROADMAP.md,
D).
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Union

import torch

# the keys sentinel_metrics adds to the step's metrics dict
SENTINEL_KEYS = ("grad_norm", "param_norm", "nonfinite_grads")

Tensors = Union[Iterable[torch.Tensor], Mapping[str, torch.Tensor]]


def _leaves(tree: Tensors):
    values = tree.values() if isinstance(tree, Mapping) else tree
    return [t for t in values if t is not None]


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt(sum of squared elements) over every tensor, accumulated in
    float32 (a bf16 tensor is upcast first); a float32 device scalar, NaN
    or Inf when any element is."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros(())
    norms = torch._foreach_norm([t.detach().float() for t in leaves])
    return torch.linalg.vector_norm(torch.stack(norms))


def nonfinite_count(tree: Tensors) -> torch.Tensor:
    """Number of NaN or Inf elements over every tensor, as a float32
    device scalar (the train step's skip predicate)."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros(())
    finite = torch.stack([torch.isfinite(t).sum() for t in leaves]).sum()
    return (sum(t.numel() for t in leaves) - finite).float()


def sentinel_metrics(grads: Tensors, params: Tensors
                     ) -> Dict[str, torch.Tensor]:
    """The sentinel scalars the train step merges into its metrics:
    float32 device scalars, asynchronous until a boundary fetch."""
    return {
        "grad_norm": global_norm(grads),
        "param_norm": global_norm(params),
        "nonfinite_grads": nonfinite_count(grads),
    }
