"""Carry model weights (and gradients) and BatchNorm statistics between the
JAX package and this port.

One mapping, :func:`flax_leaves`, names each of a model's parameters by
its path in the JAX package's flax param tree, with the view that turns
it into its JAX layout:

- ``Linear`` ``weight`` (out, in) <-> ``Dense`` ``kernel`` (in, out),
  transposed; ``bias`` <-> ``bias``;
- ``Conv2d`` ``weight`` (out, in, h, w) <-> ``Conv`` ``kernel`` (h, w,
  in, out), ``permute(2, 3, 1, 0)`` one way and ``permute(3, 2, 0, 1)``
  the other; ``bias`` <-> ``bias`` (ViT's patch embedding);
- ``LayerNorm`` and ``BatchNorm`` ``weight`` / ``bias`` <-> ``scale`` /
  ``bias``;
- ``Embedding`` ``weight`` (V, D) <-> ``embedding``;
- a bare parameter keeps its name (GPT-2's ``wpe`` and BERT's
  ``pos_embed``, both (1, max_len, D); BERT's (V,) ``mlm_bias``; ViT's
  ``cls_token`` and ``pos_embed``; the space-to-depth ResNet stem's
  ``stem_conv_kernel``, kept in flax's HWIO layout);
- ``<stack>.layers.<i>`` <-> flax ``<stack>/layer_<i>`` (GPT-2's
  ``decoder``, BERT's and ViT's ``encoder``); every other module keeps its
  name (SimpleNet's ``Dense_<i>``, the ResNet's ``stage<s>_block<b>`` and
  flax's auto-names inside a block, ``Conv_<i>`` / ``BatchNorm_<i>``).

The tied heads need nothing of their own: GPT-2's and BERT's logits read
the token table (``wte/embedding``, ``tok_embed/embedding``) the
embedding lookup uses.

Leaves come in the order ``jax.tree_util.tree_leaves`` walks the JAX
tree (paths sorted), so the wire layer (``parallel/wire.py``) lays out
tiles, buckets and quantization blocks exactly as the JAX package does.

:func:`params_to_flax` and :func:`params_from_flax` carry a model's
parameters (or, through :func:`grads_of`, its gradients) to and from the
flax tree along those paths, as the checkpoint does;
:func:`model_state_to_flax` and :func:`model_state_from_flax` carry the
BatchNorm running statistics as the ``model_state`` collection
``{"batch_stats": {<path>: {"mean", "var"}}}`` (``{}`` for a model with
no BatchNorm); ``train/state.py`` carries the whole train state (step,
optimizer, rng) on top.

Both directions copy values exactly, so a round trip is bit-exact. This
module imports neither JAX nor the JAX package: the tree is plain nested
dicts of tensors or numpy arrays (``jax.device_get`` of the flax
params).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from torch import nn

import numpy as np
import torch

from distributed_pytorch_example_tpu_torch.models.batchnorm import BatchNorm

def grads_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's gradients by parameter name, for
    :func:`params_to_flax`."""
    return {name: p.grad for name, p in model.named_parameters()
            if p.grad is not None}


@dataclasses.dataclass(frozen=True)
class FlaxLeaf:
    """One parameter under its flax path. ``perm``: the JAX leaf is the
    parameter with its dimensions in this order (a ``Dense`` kernel is
    (in, out), a ``Linear.weight`` (out, in): ``(1, 0)``), or None when
    the layouts agree."""

    path: Tuple[str, ...]
    name: str
    perm: Optional[Tuple[int, ...]] = None

    @property
    def key(self) -> str:
        """The path as one string, ``decoder/layer_0/attn/q/kernel``."""
        return "/".join(self.path)

    def to_jax(self, t: torch.Tensor) -> torch.Tensor:
        """This parameter (or its gradient) in the JAX layout: a view."""
        return t if self.perm is None else t.permute(self.perm)

    def from_jax(self, t: torch.Tensor) -> torch.Tensor:
        """A leaf in the JAX layout as this parameter's layout: a view."""
        if self.perm is None:
            return t
        inverse = [0] * len(self.perm)
        for i, p in enumerate(self.perm):
            inverse[p] = i
        return t.permute(inverse)


_TRANSPOSE, _HWIO = (1, 0), (2, 3, 1, 0)
_ATTRS = (
    (nn.Linear, {"weight": ("kernel", _TRANSPOSE), "bias": ("bias", None)}),
    (nn.Conv2d, {"weight": ("kernel", _HWIO), "bias": ("bias", None)}),
    (nn.LayerNorm, {"weight": ("scale", None), "bias": ("bias", None)}),
    (BatchNorm, {"weight": ("scale", None), "bias": ("bias", None)}),
    (nn.Embedding, {"weight": ("embedding", None)}),
)


def _flax_path(owner: str) -> List[str]:
    """A module's dotted name as its flax path: ``<stack>.layers.<i>`` is
    ``<stack>/layer_<i>``, every other part keeps its name."""
    path: List[str] = []
    parts = owner.split(".") if owner else []
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts):
            path.append(f"layer_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    return path


def _leaf_of(module: nn.Module, attr: str) -> Tuple[str, Optional[tuple]]:
    for cls, attrs in _ATTRS:
        if isinstance(module, cls):
            return attrs.get(attr, (attr, None))
    return attr, None


def flax_leaves(model: nn.Module) -> List[FlaxLeaf]:
    """The model's parameters in the JAX tree's leaf order (sorted flax
    paths), each with its flax name and layout (module docstring)."""
    modules = dict(model.named_modules())
    leaves = []
    for name, _ in model.named_parameters():
        owner, _, attr = name.rpartition(".")
        leaf, perm = _leaf_of(modules[owner], attr)
        leaves.append(FlaxLeaf(tuple(_flax_path(owner)) + (leaf,), name,
                               perm))
    return sorted(leaves, key=lambda leaf: leaf.path)


def as_tensor(x) -> torch.Tensor:
    """A CPU tensor over a decoded checkpoint leaf (a numpy array, copied
    only when it is read-only), or the tensor itself."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if not x.flags.writeable:
        x = x.copy()
    return torch.from_numpy(x)


def params_to_flax(model: nn.Module,
                   tensors: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> dict:
    """The model's parameters as its flax param tree, each leaf a view in
    the JAX layout (keys in the JAX tree's sorted order). ``tensors``, a
    name -> tensor mapping shaped like the parameters (a ``state_dict``,
    :func:`grads_of`), maps in their place; its leaves absent there are
    left out."""
    named = (dict(model.named_parameters()) if tensors is None
             else tensors)
    tree: dict = {}
    for leaf in flax_leaves(model):
        if leaf.name not in named:
            continue
        node = tree
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = leaf.to_jax(named[leaf.name].detach())
    return tree


def _paths(node, prefix=()):
    if isinstance(node, Mapping):
        for key, value in node.items():
            yield from _paths(value, prefix + (key,))
    else:
        yield prefix


@torch.no_grad()
def _load(targets: List[Tuple[Tuple[str, ...], torch.Tensor]], tree: Mapping,
          what: str, check_only: bool) -> None:
    """Copy the leaves of ``tree`` at each target's path into the target
    (a view in the JAX layout), exactly; raises, before copying anything,
    on a missing, extra or misshapen leaf."""
    extra = set(_paths(tree)) - {path for path, _ in targets}
    if extra:
        raise ValueError(f"checkpoint {what} hold leaves this model lacks: "
                         + ", ".join("/".join(p) for p in sorted(extra)))
    pairs = []
    for path, dst in targets:
        node = tree
        for key in path:
            if not isinstance(node, Mapping) or key not in node:
                raise ValueError(f"checkpoint {what} lack {'/'.join(path)}")
            node = node[key]
        src = as_tensor(node)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint {what} {'/'.join(path)}: shape "
                             f"{tuple(src.shape)}, this model's "
                             f"{tuple(dst.shape)}")
        pairs.append((dst, src))
    if not check_only:
        for dst, src in pairs:
            dst.copy_(src)


def params_from_flax(model: nn.Module, tree: Mapping) -> None:
    """Copy a flax param tree (numpy arrays or tensors) into the model's
    parameters, exactly; raises, before copying anything, on a missing,
    extra or misshapen leaf."""
    named = dict(model.named_parameters())
    _load([(leaf.path, leaf.to_jax(named[leaf.name]))
           for leaf in flax_leaves(model)], tree, "params", False)


def _batch_stats(model: nn.Module
                 ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path under ``model_state``, buffer) of every BatchNorm statistic,
    in the JAX tree's order."""
    out = []
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            base = ("batch_stats",) + tuple(_flax_path(name))
            out += [(base + ("mean",), module.running_mean),
                    (base + ("var",), module.running_var)]
    return sorted(out, key=lambda item: item[0])


def model_state_to_flax(model: nn.Module) -> dict:
    """The model's BatchNorm running statistics as the flax ``model_state``
    tree, ``{"batch_stats": {<module path>: {"mean", "var"}}}`` of the
    buffers themselves; ``{}`` for a model without BatchNorm (GPT-2, BERT,
    SimpleNet, ViT)."""
    tree: dict = {}
    for path, t in _batch_stats(model):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.detach()
    return tree


def model_state_from_flax(model: nn.Module, tree: Mapping,
                          check_only: bool = False) -> None:
    """Copy a flax ``model_state`` tree into the model's BatchNorm
    statistics, exactly; raises, before copying anything, on a missing,
    extra or misshapen leaf. ``check_only``: raise or return, copy
    nothing."""
    _load(_batch_stats(model), tree, "model_state", check_only)
