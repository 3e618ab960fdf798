"""SimpleNet — the reference's smoke-test MLP (the JAX package's
models/mlp.py).

flatten -> Dense(784, 256) -> ReLU -> Dropout(0.2) -> Dense(256, 256) ->
ReLU -> Dropout(0.2) -> Dense(256, 10); 269,322 parameters. The layers
keep flax's auto-names (``Dense_0`` .. ``Dense_2``) so :mod:`interop`
maps the trees by name. Weights are flax's defaults (lecun-normal kernels,
zero biases) drawn on the CPU from ``seed``; dropout draws its keep-masks
from an explicit generator on the model's device, which the train step
reseeds from (``seed``, step) before every step (:meth:`SimpleNet.fold_in`,
the counterpart of JAX's ``fold_in(rng, step)``), so a resumed run draws
the masks the uninterrupted run drew (the bits differ from JAX's, so tests
compare with dropout off).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from distributed_pytorch_example_tpu_torch.models.transformer import (
    dense,
    lecun_normal_,
)
from distributed_pytorch_example_tpu_torch.runtime.device import resolve_device


class SimpleNet(nn.Module):
    def __init__(
        self,
        input_size: int = 784,
        hidden_size: int = 256,
        num_classes: int = 10,
        dropout_rate: float = 0.2,
        dtype: torch.dtype = torch.float32,
        *,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.Dense_0 = nn.Linear(input_size, hidden_size, device=dev)
        self.Dense_1 = nn.Linear(hidden_size, hidden_size, device=dev)
        self.Dense_2 = nn.Linear(hidden_size, num_classes, device=dev)
        gen = torch.Generator().manual_seed(seed)
        for lin in (self.Dense_0, self.Dense_1, self.Dense_2):
            lecun_normal_(lin.weight, gen)
            nn.init.zeros_(lin.bias)
        self.seed = seed
        self._dropout_gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def fold_in(self, step: int) -> None:
        """Reseed the dropout generator from (seed, step)."""
        self._dropout_gen.manual_seed(
            ((self.seed + 1) * 0x9E3779B1 + int(step)) % 2**63)

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or not self.dropout_rate:
            return x
        keep = torch.rand(x.shape, generator=self._dropout_gen,
                          device=x.device) >= self.dropout_rate
        return x * keep / (1.0 - self.dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)  # nn.Flatten parity
        for lin in (self.Dense_0, self.Dense_1):
            x = self._dropout(F.relu(dense(lin, x, self.dtype)))
        return dense(self.Dense_2, x, self.dtype)
