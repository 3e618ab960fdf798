"""Megatron tensor parallelism by hand: the collectives that GSPMD inserts
for the JAX package's ``TRANSFORMER_TP_RULES`` (``parallel/partition.py``).

JAX shards the weights by rule and lets XLA place the all-reduces.
PyTorch has no such compiler, so the port's layers are built at their
local widths and call these functions where XLA puts a collective, over
the mesh's ``tensor`` process group:

- :func:`copy_to_tensor` before a column-parallel layer (``q/k/v``,
  ``up``/``gate``, a vocab-sharded head): the identity forward, an
  all-reduce of the input's gradient backward (each rank's partial
  gradient from its columns);
- :func:`reduce_from_tensor` after a row-parallel layer (``o``,
  ``down``): an all-reduce of the partial outputs forward, the identity
  backward;
- :func:`vocab_parallel_embedding`: a lookup in this rank's rows of a
  vocab-sharded table, ids outside them giving 0, then
  :func:`reduce_from_tensor`;
- :func:`gather_from_tensor`: a vocab-sharded head's logits whole on
  every rank (the ``full`` logits mode), the rank's slice backward.

The all-reduces sum in float32 and round once to the operands' dtype.
:data:`counts` tallies the tensor group's collectives, ``forward`` and
``backward`` (the checks read it; :func:`reset_counts` zeroes it).

:class:`TensorParallel` is a rank's place on the axis. A module built
with one of size above 1 holds only its slice of each sharded parameter
and names them in its ``tensor_dims`` (parameter name -> the torch dim cut
into ``size`` equal parts, part ``index`` here); :func:`sharded_params`
collects them over a model, and :func:`gather_leaves` / :func:`take` turn
slices into whole leaves and back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from distributed_pytorch_example_tpu_torch.runtime import distributed

# the tensor group's collectives since the last reset_counts()
counts: Dict[str, int] = {"forward": 0, "backward": 0}


def reset_counts() -> None:
    counts["forward"] = counts["backward"] = 0


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A rank's place on the tensor axis: ``size`` ranks, this one at
    ``index``, their process ``group`` (None: the default group, right
    only when the axis spans every process, or at size 1)."""

    size: int = 1
    index: int = 0
    group: Any = None

    @classmethod
    def from_mesh(cls, mesh, axis: str = "tensor") -> "TensorParallel":
        return cls(mesh.shape[axis], mesh.axis_index(axis), mesh.group(axis))

    def split(self, n: int, what: str) -> int:
        """``n / size``; raises when ``size`` does not divide ``n`` (JAX
        would shard inside a head there, the port does not)."""
        if n % self.size:
            raise ValueError(
                f"tensor parallelism over {self.size} ranks needs {what} "
                f"({n}) divisible by {self.size}")
        return n // self.size


def _all_reduce(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum of ``x`` over the tensor group, in float32, as ``x.dtype``;
    a new tensor."""
    out = x.to(torch.float32, copy=True)
    distributed.all_reduce_sum_(out, tp.group)
    return out.to(x.dtype)


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        counts["backward"] += 1
        return _all_reduce(grad, ctx.tp), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        counts["forward"] += 1
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        counts["forward"] += 1
        ctx.tp, ctx.width = tp, x.shape[-1]
        return distributed.all_gather_tiled(x.contiguous(), x.dim() - 1,
                                            tp.group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.tp.index * ctx.width,
                           ctx.width).contiguous(), None


def copy_to_tensor(x: torch.Tensor, tp: Optional[TensorParallel]
                   ) -> torch.Tensor:
    """The input of a column-parallel layer: ``x`` forward, the sum of the
    gradients over the tensor group backward."""
    if tp is None or tp.size == 1:
        return x
    return _CopyToTensor.apply(x, tp)


def reduce_from_tensor(x: torch.Tensor, tp: Optional[TensorParallel]
                       ) -> torch.Tensor:
    """The output of a row-parallel layer: the sum of the ranks' partial
    outputs forward, the gradient as it is backward."""
    if tp is None or tp.size == 1:
        return x
    return _ReduceFromTensor.apply(x, tp)


def gather_from_tensor(x: torch.Tensor, tp: Optional[TensorParallel]
                       ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last dim in rank order;
    backward, this rank's slice of the gradient."""
    if tp is None or tp.size == 1:
        return x
    return _GatherFromTensor.apply(x, tp)


def vocab_parallel_embedding(weight: torch.Tensor, ids: torch.Tensor,
                             tp: TensorParallel, start: int) -> torch.Tensor:
    """Rows ``ids`` of a (V, D) table of which this rank holds rows
    ``start`` to ``start + weight.shape[0]``: a lookup in the rank's rows
    (0 for an id outside them), summed over the tensor group. Exactly the
    whole table's lookup: one rank adds each row, the others 0."""
    local = ids.long() - start
    hit = (local >= 0) & (local < weight.shape[0])
    rows = torch.nn.functional.embedding(
        local.clamp(0, weight.shape[0] - 1), weight)
    rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    return reduce_from_tensor(rows, tp)


# -- sharded parameters ------------------------------------------------------


def sharded_params(model: torch.nn.Module) -> Dict[str, int]:
    """Parameter name -> the torch dim its module cuts over the tensor
    axis (the modules' ``tensor_dims``); empty for a model built without
    tensor parallelism."""
    out: Dict[str, int] = {}
    for name, module in model.named_modules():
        for pname, dim in getattr(module, "tensor_dims", {}).items():
            out[f"{name}.{pname}" if name else pname] = dim
    return out


def tensor_parallel_of(model: torch.nn.Module) -> Optional[TensorParallel]:
    """The model's :class:`TensorParallel` when it was built over more than
    one tensor rank, else None."""
    tp = getattr(model, "tensor_parallel", None)
    return tp if tp is not None and tp.size > 1 else None


def take(full: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    """This rank's part of a whole leaf cut along ``dim`` (a view)."""
    if full.shape[dim] % tp.size:
        raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split "
                         f"over {tp.size} tensor ranks")
    n = full.shape[dim] // tp.size
    return full.narrow(dim, tp.index * n, n)


def gather_leaves(parts: Sequence[torch.Tensor],
                  dims: Sequence[Optional[int]],
                  tp: Optional[TensorParallel]) -> List[torch.Tensor]:
    """The whole leaves of this rank's ``parts``: each part with a dim in
    ``dims`` gathered along it over the tensor group (all of them in one
    float32 all-gather, a collective), the others as they are."""
    out = list(parts)
    idx = [i for i, d in enumerate(dims) if d is not None]
    if tp is None or tp.size == 1 or not idx:
        return out
    flat = torch.cat([parts[i].reshape(-1).float() for i in idx])
    rows = distributed.all_gather_tiled(flat[None], group=tp.group)
    offset = 0
    for i in idx:
        part, dim = parts[i], dims[i]
        n = part.numel()
        full = rows[:, offset:offset + n].reshape(
            (tp.size,) + tuple(part.shape)).movedim(0, dim)
        shape = list(part.shape)
        shape[dim] *= tp.size
        out[i] = full.reshape(shape)
        offset += n
    return out
