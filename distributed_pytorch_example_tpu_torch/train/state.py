"""Train state (the JAX package's train/state.py).

What a step mutates: the step count, the model (its float32 parameters)
and the optimizer (moments and schedule position). JAX carries them in
one immutable pytree that the compiled step donates; here the model and
the optimizer update in place, and the state object only names them
together.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from distributed_pytorch_example_tpu_torch.train.optimizers import Optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
