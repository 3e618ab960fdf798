"""GPT-2 and SimpleNet weights cross between the JAX package and the port
bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu.models.mlp import SimpleNet as JaxSimpleNet
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models import GPT2, SimpleNet
from distributed_pytorch_example_tpu_torch.train.state import to_host, to_numpy

torch.set_num_threads(2)

KW = dict(vocab_size=97, max_len=64, model_dim=32, num_layers=2,
          num_heads=4, mlp_dim=64)


def test_flax_torch_flax_roundtrip_is_bit_exact():
    params = JaxGPT2(**KW).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = GPT2(**KW, device="cpu")
    # every parameter of the port is covered, with the port's shapes:
    # a missing, extra or misshapen leaf raises
    interop.params_from_flax(model, tree)
    assert torch.equal(
        model.decoder.layers[1].attn.q.weight,
        torch.from_numpy(np.array(tree["decoder"]["layer_1"]["attn"]["q"]["kernel"].T)),
    )
    back = to_numpy(to_host(interop.params_to_flax(model)))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        other = flat_b[path]
        assert other.dtype == leaf.dtype and other.shape == leaf.shape, path
        np.testing.assert_array_equal(other, leaf)


def test_seeded_init_is_device_independent_and_flax_shaped():
    a = GPT2(**KW, device="cpu", seed=3)
    b = GPT2(**KW, device="cpu", seed=3)
    c = GPT2(**KW, device="cpu", seed=4)
    for (name, pa), pb, pc in zip(
        a.state_dict().items(), b.state_dict().values(), c.state_dict().values()
    ):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.wte.weight, c.wte.weight)
    assert a.wpe.shape == (1, KW["max_len"], KW["model_dim"])
    # flax's initialisers: zero biases, unit LayerNorm scales
    assert torch.count_nonzero(a.decoder.layers[0].attn.q.bias) == 0
    assert torch.all(a.final_ln.weight == 1)


def test_simplenet_roundtrip_is_bit_exact():
    params = JaxSimpleNet().init(jax.random.key(0),
                                 jnp.zeros((1, 784)))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = SimpleNet(device="cpu")
    interop.params_from_flax(model, tree)
    back = to_numpy(to_host(interop.params_to_flax(model)))
    assert back.keys() == tree.keys() == {"Dense_0", "Dense_1", "Dense_2"}
    for name in tree:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][leaf], tree[name][leaf])
