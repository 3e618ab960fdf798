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

Both directions copy values exactly, so a round trip is bit-exact. This
module imports neither JAX nor the JAX package: the tree is plain nested
dicts of numpy arrays (``jax.device_get`` of the flax params).
"""

from __future__ import annotations

from typing import Dict, Mapping

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
