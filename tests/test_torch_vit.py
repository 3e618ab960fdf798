"""The port's ViT against the JAX package's, on the CPU.

A 2-layer ViT (width 32, 2 heads, MLP 64, patch 4 on 16 x 16 images: 16
patches and the [CLS] token) starts from the port's seeded weights,
carried to a flax tree by ``interop``; images come from a numpy seed. Both
sides take the plain attention path (17 tokens).

Tolerances: float32 logits 1e-5 and each gradient leaf 2e-5 absolute
(float32 on both sides, one summation order apart, as
``tests/test_torch_bert.py``); bfloat16 logits
within 3e-2 of their largest entry (the two frameworks round bf16 at
other places; a few bf16 ulps).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_pytorch_example_tpu.models.vit import (
    VisionTransformer as JaxViT,
)
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models import (
    VisionTransformer,
    get_model,
)
from distributed_pytorch_example_tpu_torch.train.state import (
    to_host,
    to_numpy,
)

torch.set_num_threads(2)

KW = dict(num_classes=5, patch_size=4, model_dim=32, num_layers=2,
          num_heads=2, mlp_dim=64)
SIZE, BATCH = 16, 3
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_TOL = 2e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(tree):
    return to_numpy(to_host(tree))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(dtype="float32", seed=0):
    tdt, jdt = DTYPES[dtype]
    model = VisionTransformer(**KW, dtype=tdt, image_size=SIZE, device="cpu",
                              seed=seed)
    return model, JaxViT(**KW, dtype=jdt), _np(interop.params_to_flax(model))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32),
            rng.integers(0, KW["num_classes"], (BATCH,)).astype(np.int32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_logits_match_jax_in_train_and_eval_mode(dtype):
    model, jmodel, params = _pair(dtype)
    x, _ = _data()
    want = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(
        {"params": params}, x), np.float32)
    tol = TOL[dtype] * (np.abs(want).max() if dtype == "bfloat16" else 1.0)
    for train in (True, False):
        model.train(train)
        got = model(torch.from_numpy(x))
        assert got.dtype == torch.float32  # the float32 head
        assert np.abs(got.detach().numpy() - want).max() <= tol, train


def test_one_steps_gradients_match_jax():
    model, jmodel, params = _pair()
    x, y = _data()

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, x, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = torch.nn.functional.cross_entropy(model(torch.from_numpy(x)),
                                             torch.from_numpy(y).long())
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= TOL["float32"]
    got = _leaves(_np(interop.params_to_flax(model, interop.grads_of(model))))
    want = _leaves(jgrads)
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        err = np.abs(leaf - want[key]).max()
        assert err <= GRAD_TOL, f"grad{key}: off by {err:.3e}"


def test_flax_round_trip_is_bit_exact_and_names_match():
    model, jmodel, params = _pair()
    want = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(want))
    assert params["patch_embed"]["kernel"].shape == (4, 4, 3, 32)  # HWIO
    assert params["pos_embed"].shape == (1, 17, 32)
    assert not params["cls_token"].any()  # zero-initialised
    other = VisionTransformer(**KW, image_size=SIZE, device="cpu", seed=5)
    interop.params_from_flax(other, params)
    back = _np(interop.params_to_flax(other))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    assert interop.model_state_to_flax(other) == {}  # no batch statistics


def test_refuses_dropout_and_another_image_size():
    # dropout is ported (tests/test_torch_item7.py); mixture-of-experts
    # blocks are not
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VisionTransformer(**KW, moe_experts=2, image_size=SIZE,
                          device="cpu")
    model = VisionTransformer(**KW, image_size=SIZE, device="cpu")
    with pytest.raises(ValueError, match="image_size 16"):
        model(torch.zeros(1, 2 * SIZE, 2 * SIZE, 3))


def test_registry_builds_vit_b16():
    """ViT-B/16's widths (one layer of its twelve, to keep the draw
    small): the same parameter count as the JAX package's."""
    model = get_model("vit-b-16", device="meta", num_layers=1)
    assert (model.patch_size, model.model_dim, model.image_size,
            model.num_classes) == (16, 768, 224, 1000)
    assert model.pos_embed.shape == (1, 197, 768)
    want = jax.eval_shape(lambda: JaxViT(num_layers=1).init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)))["params"])
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))
