"""Carry SimpleNet, GPT-2 and BERT weights (and gradients) between the
JAX package and this port.

One mapping, :func:`flax_leaves`, names each of a model's parameters by
its path in the JAX package's flax param tree, with the view that turns
it into its JAX layout:

- ``Linear`` ``weight`` (out, in) <-> ``Dense`` ``kernel`` (in, out),
  transposed; ``bias`` <-> ``bias``;
- ``LayerNorm`` ``weight`` / ``bias`` <-> ``scale`` / ``bias``;
- ``Embedding`` ``weight`` (V, D) <-> ``embedding``;
- a bare parameter keeps its name (GPT-2's ``wpe`` and BERT's
  ``pos_embed``, both (1, max_len, D); BERT's (V,) ``mlm_bias``);
- ``<stack>.layers.<i>`` <-> flax ``<stack>/layer_<i>`` (GPT-2's
  ``decoder``, BERT's ``encoder``); SimpleNet's ``Dense_<i>`` keep their
  names.

The tied heads need nothing of their own: GPT-2's and BERT's logits read
the token table (``wte/embedding``, ``tok_embed/embedding``) the
embedding lookup uses.

Leaves come in the order ``jax.tree_util.tree_leaves`` walks the JAX
tree (paths sorted), so the wire layer (``parallel/wire.py``) lays out
tiles, buckets and quantization blocks exactly as the JAX package does.

:func:`params_to_flax` and :func:`params_from_flax` carry a model's
parameters (or, through :func:`grads_of`, its gradients) to and from the
flax tree along those paths, as the checkpoint does; ``train/state.py``
carries the whole train state (step, optimizer, rng) on top.

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

def grads_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's gradients by parameter name, for
    :func:`params_to_flax`."""
    return {name: p.grad for name, p in model.named_parameters()
            if p.grad is not None}


@dataclasses.dataclass(frozen=True)
class FlaxLeaf:
    """One parameter under its flax path. ``transposed``: the JAX leaf is
    the parameter transposed (a ``Dense`` kernel is (in, out), a
    ``Linear.weight`` (out, in))."""

    path: Tuple[str, ...]
    name: str
    transposed: bool

    @property
    def key(self) -> str:
        """The path as one string, ``decoder/layer_0/attn/q/kernel``."""
        return "/".join(self.path)

    def to_jax(self, t: torch.Tensor) -> torch.Tensor:
        """This parameter (or its gradient) in the JAX layout: a view."""
        return t.t() if self.transposed else t

    from_jax = to_jax  # a transpose is its own inverse


_ATTRS = {
    nn.Linear: {"weight": ("kernel", True), "bias": ("bias", False)},
    nn.LayerNorm: {"weight": ("scale", False), "bias": ("bias", False)},
    nn.Embedding: {"weight": ("embedding", False)},
}


def flax_leaves(model: nn.Module) -> List[FlaxLeaf]:
    """The model's parameters in the JAX tree's leaf order (sorted flax
    paths): ``<stack>.layers.<i>`` is ``<stack>/layer_<i>``, a
    ``Linear``'s weight its transposed ``kernel``, a ``LayerNorm``'s
    weight its ``scale``, an ``Embedding``'s weight its ``embedding``,
    and a bare parameter keeps its name (GPT-2's ``wpe``, BERT's
    ``pos_embed`` and ``mlm_bias``)."""
    modules = dict(model.named_modules())
    leaves = []
    for name, _ in model.named_parameters():
        owner, _, attr = name.rpartition(".")
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
        leaf, transposed = _ATTRS.get(type(modules[owner]), {}).get(
            attr, (attr, False))
        leaves.append(FlaxLeaf(tuple(path) + (leaf,), name, transposed))
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


@torch.no_grad()
def params_from_flax(model: nn.Module, tree: Mapping) -> None:
    """Copy a flax param tree (numpy arrays or tensors) into the model's
    parameters, exactly; raises, before copying anything, on a missing,
    extra or misshapen leaf."""
    named = dict(model.named_parameters())
    leaves = flax_leaves(model)
    want = {leaf.path for leaf in leaves}

    def paths(node, prefix=()):
        if isinstance(node, Mapping):
            for key, value in node.items():
                yield from paths(value, prefix + (key,))
        else:
            yield prefix

    extra = set(paths(tree)) - want
    if extra:
        raise ValueError("checkpoint params hold leaves this model lacks: "
                         + ", ".join("/".join(p) for p in sorted(extra)))
    pairs = []
    for leaf in leaves:
        node = tree
        for key in leaf.path:
            if not isinstance(node, Mapping) or key not in node:
                raise ValueError(f"checkpoint params lack {leaf.key}")
            node = node[key]
        dst = leaf.to_jax(named[leaf.name])
        src = as_tensor(node)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint param {leaf.key}: shape "
                             f"{tuple(src.shape)}, this model's "
                             f"{tuple(dst.shape)}")
        pairs.append((dst, src))
    for dst, src in pairs:
        dst.copy_(src)
