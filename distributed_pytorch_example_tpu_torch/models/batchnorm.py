"""BatchNorm with flax's arithmetic (the JAX package's ``nn.BatchNorm`` as
its models/resnet.py configures it: momentum 0.9, epsilon 1e-5).

``nn.BatchNorm2d`` does not serve. Flax (0.12, ``_compute_stats`` and
``_normalize``):

- takes the statistics in float32 whatever the compute dtype, as
  ``var = E[x^2] - E[x]^2`` clipped at 0;
- normalises in float32, ``(x - mean) * (rsqrt(var + eps) * scale) +
  bias``, and casts the result to the compute dtype;
- updates the running statistics as ``0.9 * ra + 0.1 * batch`` with the
  **biased** batch variance (torch keeps the unbiased one, n / (n - 1)
  times larger, and counts ``num_batches_tracked``).

:class:`BatchNorm` keeps flax's names under torch's: parameters
``weight`` / ``bias`` are ``scale`` / ``bias``, buffers ``running_mean``
/ ``running_var`` are ``batch_stats``' ``mean`` / ``var``
(``interop.model_state_to_flax``). Inputs are NCHW (any memory format;
the ResNet passes channels_last); statistics are per channel over N, H
and W.

Batch statistics across processes. In the JAX package's replicated step
BatchNorm sees the global batch (its models/resnet.py: "free SyncBN").
The port's replicated step at world > 1 runs its forward under
:func:`global_batch_stats`, and :class:`_BatchNormFn` then all-reduces
[sum x, sum x^2, n] in the forward and [sum dy, sum dy * x_hat] in the
backward, so every process normalises with the global statistics and
backpropagates through them. ``nn.SyncBatchNorm`` does not serve: it
refuses CPU tensors and keeps the unbiased running variance. Outside the
context (one process, or the manual path's per-shard statistics) the
same function runs with no collective.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, List

import torch
from torch import nn

from distributed_pytorch_example_tpu_torch.runtime import distributed

MOMENTUM, EPSILON = 0.9, 1e-5

_ACROSS = contextvars.ContextVar("batch_stats_across_processes",
                                 default=False)


@contextlib.contextmanager
def global_batch_stats(enabled: bool = True) -> Iterator[None]:
    """Within the block, a training-mode :class:`BatchNorm` forward takes
    its statistics over every process's batch (a collective: every process
    must run the same forward)."""
    token = _ACROSS.set(enabled)
    try:
        yield
    finally:
        _ACROSS.reset(token)


def _channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


_DIMS = (0, 2, 3)  # N, H, W of NCHW


class _BatchNormFn(torch.autograd.Function):
    """Training-mode batch norm: ``(y, mean, var)``, the batch statistics
    over this process's rows, or every process's when ``across``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, across: bool):
        c = x.shape[1]
        xf = x.float()
        stats = torch.cat([xf.sum(_DIMS), xf.square().sum(_DIMS),
                           xf.new_full((1,), x.numel() // c)])
        if across:
            distributed.all_reduce_sum_(stats)
        count = stats[2 * c:]
        mean = stats[:c] / count
        var = (stats[c:2 * c] / count - mean * mean).clamp_min(0.0)
        inv = torch.rsqrt(var + eps)
        y = ((xf - _channel(mean)) * _channel(inv * weight)
             + _channel(bias)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, inv, count)
        ctx.across = across
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, inv, count = ctx.saved_tensors
        c = x.shape[1]
        xhat = (x.float() - _channel(mean)) * _channel(inv)
        dyf = dy.float()
        sums = torch.cat([dyf.sum(_DIMS), (dyf * xhat).sum(_DIMS)])
        dbias, dweight = sums[:c].clone(), sums[c:].clone()  # this rank's
        if ctx.across:
            distributed.all_reduce_sum_(sums)
        sums = sums / count
        dx = ((dyf - _channel(sums[:c]) - xhat * _channel(sums[c:]))
              * _channel(inv * weight))
        return dx.to(x.dtype), dweight, dbias, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of an NCHW input; float32 parameters and statistics, the output in the
    input's dtype. ``zero_scale`` starts ``weight`` at 0 (the last norm of
    a residual block)."""

    def __init__(self, num_features: int, *, zero_scale: bool = False):
        super().__init__()
        self.num_features, self.zero_scale = num_features, zero_scale
        kw = dict(dtype=torch.float32)
        self.weight = nn.Parameter(torch.empty(num_features, **kw))
        self.bias = nn.Parameter(torch.empty(num_features, **kw))
        self.register_buffer("running_mean", torch.empty(num_features, **kw))
        self.register_buffer("running_var", torch.empty(num_features, **kw))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:  # flax use_running_average=True
            inv = torch.rsqrt(self.running_var + EPSILON)
            return ((x.float() - _channel(self.running_mean))
                    * _channel(inv * self.weight)
                    + _channel(self.bias)).to(x.dtype)
        y, mean, var = _BatchNormFn.apply(x, self.weight, self.bias,
                                          EPSILON, _ACROSS.get())
        with torch.no_grad():
            self.running_mean.mul_(MOMENTUM).add_(mean, alpha=1 - MOMENTUM)
            self.running_var.mul_(MOMENTUM).add_(var, alpha=1 - MOMENTUM)
        return y

    def extra_repr(self) -> str:
        return f"{self.num_features}, zero_scale={self.zero_scale}"


def running_stats(model: nn.Module) -> List[torch.Tensor]:
    """Every :class:`BatchNorm`'s ``running_mean`` and ``running_var``, in
    module order: what a train step mutates besides the parameters."""
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]
