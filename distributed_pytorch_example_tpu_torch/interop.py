"""Carry GPT-2 and SimpleNet weights (and gradients) between the JAX
package and this port.

The JAX package's GPT-2 param tree, as numpy arrays, maps onto the port's
``state_dict`` by name:

- ``Dense`` ``kernel`` (in, out) <-> ``Linear.weight`` (out, in), ``bias``
  <-> ``bias``;
- ``LayerNorm`` ``scale`` / ``bias`` <-> ``weight`` / ``bias``;
- ``wte.embedding`` (V, D) <-> ``wte.weight``;
- ``wpe`` (1, max_len, D) <-> ``wpe``;
- flax ``decoder.layer_<i>`` <-> ``decoder.layers.<i>``.

SimpleNet's flax ``Dense_<i>`` layers map onto the port's ``Dense_<i>``.
Any name -> tensor mapping shaped like a ``state_dict`` maps the same way,
so :func:`grads_of` carries a model's gradients to the flax tree of the
JAX package's ``jax.grad``, leaf by leaf.

:func:`flax_leaves` lists a model's parameters under their flax paths,
in the order ``jax.tree_util.tree_leaves`` walks the JAX tree (paths
sorted), with the view that turns each into its JAX layout: the wire
layer (``parallel/wire.py``) lays out tiles, buckets and quantization
blocks exactly as the JAX package does.

Both directions copy values exactly, so a round trip is bit-exact. This
module imports neither JAX nor the JAX package: the tree is plain nested
dicts of numpy arrays (``jax.device_get`` of the flax params).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

from torch import nn

import numpy as np
import torch

_DENSE = ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.up", "mlp.down")
_NORMS = ("ln1", "ln2")


def _layer_count(tree: Mapping) -> int:
    return len([k for k in tree["decoder"] if k.startswith("layer_")])


def gpt2_flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX GPT-2 params (nested dict of arrays) -> the port's state_dict."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    sd = {
        "wte.weight": t(params["wte"]["embedding"]),
        "wpe": t(params["wpe"]),
        "final_ln.weight": t(params["final_ln"]["scale"]),
        "final_ln.bias": t(params["final_ln"]["bias"]),
    }
    for i in range(_layer_count(params)):
        layer = params["decoder"][f"layer_{i}"]
        pre = f"decoder.layers.{i}"
        for name in _DENSE:
            group, proj = name.split(".")
            dense = layer[group][proj]
            sd[f"{pre}.{name}.weight"] = t(np.asarray(dense["kernel"]).T)
            sd[f"{pre}.{name}.bias"] = t(dense["bias"])
        for name in _NORMS:
            sd[f"{pre}.{name}.weight"] = t(layer[name]["scale"])
            sd[f"{pre}.{name}.bias"] = t(layer[name]["bias"])
    return sd


def gpt2_state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict -> a JAX GPT-2 param tree of numpy arrays."""
    def a(name):
        return state_dict[name].detach().cpu().numpy().copy()

    layers = sorted({
        int(k.split(".")[2]) for k in state_dict if k.startswith("decoder.layers.")
    })
    decoder = {}
    for i in layers:
        pre = f"decoder.layers.{i}"
        layer: dict = {"attn": {}, "mlp": {}}
        for name in _DENSE:
            group, proj = name.split(".")
            layer[group][proj] = {
                "kernel": np.ascontiguousarray(a(f"{pre}.{name}.weight").T),
                "bias": a(f"{pre}.{name}.bias"),
            }
        for name in _NORMS:
            layer[name] = {
                "scale": a(f"{pre}.{name}.weight"),
                "bias": a(f"{pre}.{name}.bias"),
            }
        decoder[f"layer_{i}"] = layer
    return {
        "wte": {"embedding": a("wte.weight")},
        "wpe": a("wpe"),
        "decoder": decoder,
        "final_ln": {"scale": a("final_ln.weight"), "bias": a("final_ln.bias")},
    }


def simplenet_flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX SimpleNet params -> the port's SimpleNet state_dict."""
    sd = {}
    for name, dense in params.items():
        sd[f"{name}.weight"] = torch.from_numpy(
            np.array(np.asarray(dense["kernel"]).T, copy=True))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(dense["bias"], copy=True))
    return sd


def simplenet_state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's SimpleNet state_dict (or gradients) -> a flax tree."""
    names = sorted({k.split(".")[0] for k in state_dict})
    return {
        name: {
            "kernel": np.ascontiguousarray(
                state_dict[f"{name}.weight"].detach().cpu().numpy().T),
            "bias": state_dict[f"{name}.bias"].detach().cpu().numpy().copy(),
        }
        for name in names
    }


def grads_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's gradients by parameter name, shaped like its
    state_dict, for :func:`gpt2_state_dict_to_flax` /
    :func:`simplenet_state_dict_to_flax`."""
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
    paths): ``decoder.layers.<i>`` is ``decoder/layer_<i>``, a
    ``Linear``'s weight its transposed ``kernel``, a ``LayerNorm``'s
    weight its ``scale``, an ``Embedding``'s weight its ``embedding``,
    and a bare parameter keeps its name (GPT-2's ``wpe``)."""
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
