"""Train state (the JAX package's train/state.py).

What a step mutates: the step count, the model (its float32 parameters
and its BatchNorm running statistics) and the optimizer (moments and
schedule position). JAX carries them in
one immutable pytree that the compiled step donates; here the model and
the optimizer update in place, and the state object only names them
together.

:func:`train_state_to_flax` and :func:`train_state_from_flax` carry the
whole state across to the tree that ``flax.serialization.to_state_dict``
makes of the JAX package's ``TrainState`` — the checkpoint's ``state``:

- ``step``: int32, 0-d (a skipped step counts, as in JAX);
- ``params``: the flax param tree (``interop.params_to_flax``);
- ``opt_state``: the optax tree of the same optimizer configuration
  (``Optimizer.state_tree``);
- ``model_state``: the BatchNorm running statistics,
  ``{"batch_stats": {...}}`` (``interop.model_state_to_flax``), or ``{}``
  for a model with none (SimpleNet, GPT-2, BERT, ViT);
- ``rng``: the raw uint32 key data, shape (2,). The port draws no
  randomness from it; it starts as ``key_data(key(seed))`` and carries
  whatever a loaded checkpoint held, so a JAX run resumed here and saved
  again gets its own key back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.train.optimizers import (
    Optimizer,
    StateLayout,
    _expect_keys,
    layout_of,
)

STATE_KEYS = ("step", "params", "opt_state", "model_state", "rng")


def seed_key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` of the default
    threefry key under 32-bit JAX: ``[0, seed mod 2**32]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    rng: np.ndarray = dataclasses.field(default_factory=lambda: seed_key(0))


def state_tree(state: TrainState, layout: Optional[StateLayout] = None,
               gather: bool = True) -> dict:
    """The state as the flax tree, its tensors where they live (views in
    the JAX layout; under ZeRO-1 the moments are gathered, under FSDP the
    parameters too: collectives). ``layout`` defaults to the replicated
    one of ``state.model`` (its tensor-parallel one when the model is cut
    over a tensor axis: ``optimizers.layout_of``). ``gather=False``: a leaf the layout shards is
    this rank's ``Chunk`` instead, and nothing is exchanged (the sharded
    checkpoint format)."""
    if layout is None:
        layout = layout_of(state.model)
    return {
        "step": np.asarray(state.step, dtype=np.int32),
        "params": layout.params(gather),
        "opt_state": state.optimizer.state_tree(layout, gather=gather),
        "model_state": interop.model_state_to_flax(state.model),
        "rng": np.array(state.rng, dtype=np.uint32),
    }


def to_host(tree: Any) -> Any:
    """A copy of every tensor of ``tree`` in host memory (synchronous), so
    the copy stays as it is while the originals update in place."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def to_numpy(tree: Any) -> Any:
    """Every tensor of a host tree as a C-contiguous numpy array."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return np.ascontiguousarray(tree.numpy())
    return tree


def train_state_to_flax(state: TrainState,
                        layout: Optional[StateLayout] = None) -> dict:
    """The state as the JAX ``TrainState``'s state dict, numpy leaves."""
    return to_numpy(to_host(state_tree(state, layout)))


@torch.no_grad()
def train_state_from_flax(state: TrainState, tree: dict,
                          layout: Optional[StateLayout] = None
                          ) -> TrainState:
    """Load a JAX ``TrainState``'s state dict (either package's) into
    ``state`` in place; returns it. Raises, before changing anything, on a
    tree of another model or optimizer configuration."""
    if layout is None:
        layout = layout_of(state.model)
    _expect_keys(tree, STATE_KEYS, "state")
    rng = np.asarray(tree["rng"])
    if rng.dtype != np.uint32 or rng.shape != (2,):
        raise ValueError(f"checkpoint rng: {rng.dtype}{rng.shape}, want "
                         "uint32 key data of shape (2,)")
    state.optimizer.load_state_tree(tree["opt_state"], layout,
                                    check_only=True)
    interop.model_state_from_flax(state.model, tree["model_state"],
                                  check_only=True)
    layout.load_params(tree["params"])
    interop.model_state_from_flax(state.model, tree["model_state"])
    layout.refresh()
    state.optimizer.load_state_tree(tree["opt_state"], layout)
    state.step = int(tree["step"])
    state.rng = rng.copy()
    return state
