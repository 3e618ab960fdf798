"""The port's ResNet and its BatchNorm state against the JAX package's, on
the CPU.

Narrow ResNets (``num_filters=8``, two stages, the second with stride 2)
of both block kinds and every stem start from the port's seeded weights,
carried to a flax tree by ``interop``; images come from a numpy seed, at
batch 2, where torch's unbiased running variance would be twice flax's
biased one. Cases:

- ``basic-cifar``: BasicBlock, the CIFAR 3x3 stem, 16 x 16;
- ``bottleneck-imagenet``: BottleneckBlock, the 7x7/2 stem and the 3x3/2
  max pool, 32 x 32 (every stride-2 window on an even size: SAME pads
  (2, 3) in the stem, (0, 1) in the pool and the 3x3/2 conv);
- ``bottleneck-s2d``: the same with the space-to-depth stem;
- ``basic-odd``: BasicBlock and the ImageNet stem on 23 x 23 (odd sizes:
  SAME pads (3, 3), (1, 1)).

Tolerances (float32 on both sides; the two frameworks sum in other
orders): logits 1e-4 absolute, each gradient leaf 1e-4 of that leaf's
largest JAX entry (or of 1e-3, for a leaf whose gradient is smaller:
a zero-scale norm's bias), the updated ``batch_stats`` 1e-5 absolute. Batch
normalisation at batch 2 divides by a standard deviation taken over 2 x
H x W values, so rounding in an early layer is scaled up a little on its
way to the logits; measured at most a few 1e-6. bfloat16 (the
BatchNorm alone): within 2e-2 of the output's largest entry (bf16
outputs, 2^-8 relative per rounding).
"""

import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_pytorch_example_tpu.models import resnet as jresnet
from distributed_pytorch_example_tpu.train import checkpoint as jax_ckpt
from distributed_pytorch_example_tpu.train import loop as jax_loop
from distributed_pytorch_example_tpu.train import optimizers as jax_opt
from distributed_pytorch_example_tpu.train import tasks as jax_tasks
from distributed_pytorch_example_tpu.data import DeviceLoader as JaxLoader
from distributed_pytorch_example_tpu.data import (
    SyntheticImageDataset as JaxImages,
)
from distributed_pytorch_example_tpu.train.state import TrainState as JaxState
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticImageDataset,
)
from distributed_pytorch_example_tpu_torch.models import (
    BasicBlock,
    BatchNorm,
    BottleneckBlock,
    ResNet,
    get_model,
)
from distributed_pytorch_example_tpu_torch.models.resnet import _same
from distributed_pytorch_example_tpu_torch.train import (
    ClassificationTask,
    Trainer,
    TrainState,
    build_train_step,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train.state import (
    to_host,
    to_numpy,
)
from distributed_pytorch_example_tpu_torch.train.tasks import (
    dequantize_inputs,
)

torch.set_num_threads(2)

BATCH, CLASSES = 2, 5
LOGIT_TOL, GRAD_TOL, STATS_TOL, BF16_TOL = 1e-4, 1e-4, 1e-5, 2e-2
# case -> (block, small_inputs, space_to_depth_stem, image size)
CASES = {
    "basic-cifar": ("basic", True, False, 16),
    "bottleneck-imagenet": ("bottleneck", False, False, 32),
    "bottleneck-s2d": ("bottleneck", False, True, 32),
    "basic-odd": ("basic", False, False, 23),
}
BLOCKS = {"basic": (BasicBlock, jresnet.BasicBlock),
          "bottleneck": (BottleneckBlock, jresnet.BottleneckBlock)}


def _np(tree):
    return to_numpy(to_host(tree))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(case, dtype=torch.float32, jdtype=jnp.float32, seed=0):
    block, small, s2d, _ = CASES[case]
    kw = dict(stage_sizes=(1, 1), num_classes=CLASSES, num_filters=8,
              small_inputs=small, space_to_depth_stem=s2d)
    model = ResNet(block_cls=BLOCKS[block][0], dtype=dtype, device="cpu",
                   seed=seed, **kw)
    jmodel = jresnet.ResNet(block_cls=BLOCKS[block][1], dtype=jdtype, **kw)
    return model, jmodel


def _images(size, seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, size, size, 3)).astype(np.float32),
            rng.integers(0, CLASSES, (batch,)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_side(case):
    """JAX's train-mode logits, updated batch_stats and gradients and its
    eval-mode logits, from the port's seed-0 weights."""
    model, jmodel = _pair(case)
    variables = {"params": _np(interop.params_to_flax(model)),
                 **_np(interop.model_state_to_flax(model))}
    x, y = _images(CASES[case][3])

    def loss_fn(params):
        logits, new = jmodel.apply({**variables, "params": params}, x,
                                   train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (logits, new["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    eval_logits = jax.jit(functools.partial(jmodel.apply, train=False))(
        {**variables, "batch_stats": stats}, x)
    return {"loss": float(loss), "logits": np.asarray(logits),
            "stats": _leaves(stats), "grads": _leaves(grads),
            "eval": np.asarray(eval_logits)}


def _port_side(case):
    model, _ = _pair(case)
    x, y = _images(CASES[case][3])
    model.train()
    logits = model(torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    model.eval()
    with torch.no_grad():
        eval_logits = model(torch.from_numpy(x))
    return model, loss, logits, eval_logits


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax_in_train_and_eval_mode(case):
    want = _jax_side(case)
    _, loss, logits, eval_logits = _port_side(case)
    assert abs(loss.item() - want["loss"]) <= LOGIT_TOL
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"],
                               atol=LOGIT_TOL, rtol=0)
    # eval mode reads the running statistics the train forward updated
    np.testing.assert_allclose(eval_logits.numpy(), want["eval"],
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_steps_gradients_match_jax(case):
    want = _jax_side(case)["grads"]
    model, *_ = _port_side(case)
    got = _leaves(_np(interop.params_to_flax(model, interop.grads_of(model))))
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        scale = max(np.abs(want[key]).max(), 1e-3)
        err = np.abs(leaf - want[key]).max()
        assert err <= GRAD_TOL * scale, f"grad{key}: off by {err:.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_updated_batch_stats_match_jax_at_batch_2(case):
    want = _jax_side(case)["stats"]
    model, *_ = _port_side(case)
    got = _leaves(_np(interop.model_state_to_flax(model))["batch_stats"])
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        np.testing.assert_allclose(leaf, want[key], atol=STATS_TOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("size", [7, 8, 23, 32, 224])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2), (7, 2)])
def test_same_padding_is_xla_s(size, k, stride):
    """(lo, hi) as XLA pads SAME, odd and even sizes alike."""
    assert _same(size, k, stride) == tuple(
        jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0])


@pytest.mark.parametrize("size", [7, 8])
def test_max_pool_pads_same_with_minus_infinity(size):
    """The stem's 3x3/2 pool on all-negative inputs: a zero pad would win
    every edge window."""
    from distributed_pytorch_example_tpu_torch.models.resnet import same_pad

    x = -1 - np.random.default_rng(size).random((1, size, size, 2)).astype(
        np.float32)
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    t, padding = same_pad(t, 3, 2, value=-float("inf"))
    got = torch.nn.functional.max_pool2d(t, 3, 2, padding=padding)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_space_to_depth_stem_equals_the_plain_stem():
    s2d, _ = _pair("bottleneck-s2d")
    plain, _ = _pair("bottleneck-imagenet")
    with torch.no_grad():
        plain.stem_conv.weight.copy_(s2d.stem_conv_kernel.permute(3, 2, 0, 1))
    x = torch.from_numpy(_images(224, batch=1)[0])
    nchw = x.permute(0, 3, 1, 2)
    torch.testing.assert_close(s2d._stem_s2d(nchw), plain.stem_conv(nchw),
                               atol=1e-5, rtol=0)


def test_batchnorm_in_bf16_matches_flax():
    """float32 statistics, the affine map in float32, a bf16 output, and
    the biased running variance."""
    x = np.random.default_rng(3).standard_normal((2, 5, 5, 6)).astype(
        np.float32) * 3 + 1
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
        bn.bias.uniform_(-1, 1, generator=torch.Generator().manual_seed(1))
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=jnp.bfloat16)
    variables = {"params": {"scale": bn.weight.detach().numpy(),
                            "bias": bn.bias.detach().numpy()},
                 "batch_stats": {"mean": np.zeros(6, np.float32),
                                 "var": np.ones(6, np.float32)}}
    xb = jnp.asarray(x, jnp.bfloat16)
    want, new = jbn.apply(variables, xb, mutable=["batch_stats"])
    got = bn(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().detach().numpy()
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)


def test_flax_round_trip_of_params_and_batch_stats_is_bit_exact():
    model, jmodel = _pair("bottleneck-s2d")
    model.train()
    model(torch.from_numpy(_images(32)[0]))  # statistics away from 0 / 1
    params = _np(interop.params_to_flax(model))
    state = _np(interop.model_state_to_flax(model))
    want = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                              jnp.zeros((1, 32, 32, 3))))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(want["params"]))
    assert (jax.tree_util.tree_structure(state["batch_stats"])
            == jax.tree_util.tree_structure(want["batch_stats"]))
    other, _ = _pair("bottleneck-s2d", seed=3)
    interop.params_from_flax(other, params)
    interop.model_state_from_flax(other, state)
    for src, back in ((params, interop.params_to_flax(other)),
                      (state, interop.model_state_to_flax(other))):
        flat = jax.tree_util.tree_flatten_with_path(src)[0]
        for (path, a), b in zip(flat, jax.tree_util.tree_leaves(_np(back))):
            assert a.dtype == b.dtype and np.array_equal(a, b), path
    bad = {"batch_stats": {**state["batch_stats"], "extra": {
        "mean": np.zeros(1, np.float32)}}}
    with pytest.raises(ValueError, match="lacks"):
        interop.model_state_from_flax(other, bad)


def test_a_poisoned_step_leaves_the_running_stats_bit_equal():
    """A NaN in one pixel makes the forward's batch statistics NaN; the
    skipped step puts the running statistics back, and neither parameters
    nor moments move."""
    model, _ = _pair("basic-cifar")
    optimizer = make_optimizer(model.parameters(), "adam", 1e-3)
    state = TrainState(step=0, model=model, optimizer=optimizer)
    step = build_train_step(ClassificationTask())
    x, y = _images(16)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    step(state, batch)  # one good step: moments and statistics move
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [t.clone() for group in optimizer.optimizer.state.values()
               for t in group.values() if torch.is_tensor(t)]
    poisoned = dict(batch, x=batch["x"].clone())
    poisoned["x"][1, 3, 4, 0] = float("nan")
    metrics = step(state, poisoned)
    assert float(metrics["bad_step"]) == 1.0 and state.step == 2
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key
    after = [t for group in optimizer.optimizer.state.values()
             for t in group.values() if torch.is_tensor(t)]
    assert all(torch.equal(a, b) for a, b in zip(after, moments))
    metrics = step(state, batch)  # and the next good step applies
    assert float(metrics["bad_step"]) == 0.0
    assert not torch.equal(model.stem_norm.running_mean,
                           before["stem_norm.running_mean"])


def test_uint8_images_are_rescaled_and_low_rank_uint8_refused():
    images = torch.tensor([[[[0, 255, 51]]]], dtype=torch.uint8)
    torch.testing.assert_close(dequantize_inputs(images),
                               torch.tensor([[[[0.0, 1.0, 0.2]]]]))
    tokens = torch.ones(2, 3)
    assert dequantize_inputs(tokens) is tokens
    with pytest.raises(TypeError, match="not an image"):
        dequantize_inputs(torch.zeros(2, 3, dtype=torch.uint8))
    with pytest.raises(TypeError, match="not an image"):
        jax_tasks.dequantize_inputs(jnp.zeros((2, 3), jnp.uint8))


def test_registry_builds_the_jax_packages_defaults():
    r18 = get_model("resnet-18", device="meta")
    assert (r18.num_classes, r18.small_inputs, r18.stage_sizes) == (
        10, True, (2, 2, 2, 2))
    r50 = get_model("resnet50", device="meta")
    assert (r50.num_classes, r50.small_inputs, r50.stage_sizes) == (
        1000, False, (3, 4, 6, 3))
    assert sum(p.numel() for p in r50.parameters()) == 25_557_032
    assert isinstance(r50.stage3_block2, BottleneckBlock)


# ---------------------------------------------------------------------------
# checkpoints across the packages, with batch_stats
# ---------------------------------------------------------------------------

CKPT_SIZE, CKPT_BATCH, CKPT_LR, LOSS_TOL = 16, 4, 1e-3, 1e-4
CKPT_DATA = dict(num_samples=16, image_size=CKPT_SIZE, num_classes=CLASSES)


def _port_trainer(seed, checkpoint_dir=None):
    model, _ = _pair("basic-cifar", seed=seed)
    trainer = Trainer(model, ClassificationTask(),
                      make_optimizer(model.parameters(), "adam", CKPT_LR),
                      log_every=100, checkpoint_dir=checkpoint_dir)
    seen, step_fn = [], trainer.train_step

    def step(state, batch):
        out = step_fn(state, batch)
        seen.append(float(out["loss"]))
        return out

    trainer.train_step = step
    return trainer, seen


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """A JAX ResNet trained one epoch from the port's seed-0 weights and
    statistics and saved; its own resumed epoch 1; a port run resumed from
    the JAX file; a JAX run resumed from the port's file."""
    root = tmp_path_factory.mktemp("resnet_cross")
    model, jmodel = _pair("basic-cifar")
    params = jax.tree_util.tree_map(jnp.asarray,
                                    _np(interop.params_to_flax(model)))
    ms = jax.tree_util.tree_map(jnp.asarray,
                                _np(interop.model_state_to_flax(model)))
    jt = jax_loop.Trainer(jmodel, jax_tasks.ClassificationTask(),
                          jax_opt.make_optimizer("adam", CKPT_LR),
                          telemetry=False, log_every=100,
                          checkpoint_dir=str(root / "jax"))
    jt.state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=jt.optimizer.init(params), model_state=ms,
                        rng=jax.random.key(0))
    jseen, jstep = [], jt.train_step

    def record(state, batch):
        state, metrics = jstep(state, batch)
        jseen.append(float(metrics["loss"]))
        return state, metrics

    jt.train_step = record
    loader = lambda: JaxLoader(JaxImages(seed=0, **CKPT_DATA),  # noqa: E731
                               CKPT_BATCH, seed=0)
    jt.fit(loader(), None, epochs=1)
    jax_file = str(root / "jax" / jax_ckpt.LATEST_NAME)
    saved = root / "jax_epoch1.ckpt"
    saved.write_bytes(open(jax_file, "rb").read())
    jseen.clear()
    jt.fit(loader(), None, epochs=2, resume=str(saved))
    jax_epoch1 = list(jseen)
    pt, pseen = _port_trainer(0, str(root / "port"))
    pt.fit(_port_loader(), None, epochs=1)
    port_file = root / "port_epoch1.ckpt"
    port_file.write_bytes(open(root / "port" / jax_ckpt.LATEST_NAME,
                               "rb").read())
    jseen.clear()
    jt.fit(loader(), None, epochs=2, resume=str(port_file))
    pseen.clear()
    pt.fit(_port_loader(), None, epochs=2, resume=str(port_file))
    return {"jax_file": str(saved), "jax_epoch1": jax_epoch1,
            "port_epoch1": list(pseen), "jax_from_port": list(jseen),
            "jax_stats": _leaves(jt.state.model_state),
            "port_stats": _leaves(_np(interop.model_state_to_flax(
                pt.model)))}


def _port_loader():
    return DeviceLoader(SyntheticImageDataset(seed=0, **CKPT_DATA),
                        CKPT_BATCH, device="cpu", seed=0)


def test_jax_resnet_checkpoint_resumes_in_the_port(cross):
    trainer, seen = _port_trainer(1)  # other weights: the file must win
    history = trainer.fit(_port_loader(), None, epochs=2,
                          resume=cross["jax_file"])
    assert [r["epoch"] for r in history] == [1]
    assert len(seen) == len(cross["jax_epoch1"]) == 4
    np.testing.assert_allclose(seen, cross["jax_epoch1"], atol=LOSS_TOL,
                               rtol=0)
    assert trainer.state.step == 8


def test_port_resnet_checkpoint_resumes_in_jax(cross):
    assert len(cross["jax_from_port"]) == 4
    np.testing.assert_allclose(cross["jax_from_port"], cross["port_epoch1"],
                               atol=LOSS_TOL, rtol=0)
    # the statistics came across too: JAX's after its epoch resumed from
    # the port's file are the port's after the same resumed epoch
    got = cross["port_stats"]
    assert got.keys() == cross["jax_stats"].keys()
    for key, value in got.items():
        np.testing.assert_allclose(value, cross["jax_stats"][key],
                                   atol=1e-4, rtol=0, err_msg=key)


def test_step_resume_carries_the_running_statistics(tmp_path):
    """Saves every 2 of an epoch's 4 steps; a run resumed from the
    mid-epoch entry ends in the uninterrupted run's parameters and
    running statistics, bit for bit."""
    from distributed_pytorch_example_tpu_torch.train import checkpoint as ck
    from distributed_pytorch_example_tpu_torch.train.state import (
        train_state_to_flax,
    )

    def run(checkpoint_dir=None, resume=None, seed=0):
        model, _ = _pair("basic-cifar", seed=seed)
        trainer = Trainer(model, ClassificationTask(),
                          make_optimizer(model.parameters(), "adam", CKPT_LR),
                          log_every=100, checkpoint_dir=checkpoint_dir,
                          save_every_steps=2, checkpoint_retain=5)
        trainer.fit(_port_loader(), None, epochs=1, resume=resume)
        return train_state_to_flax(trainer.state)

    ckdir = str(tmp_path / "ck")
    full = run(ckdir)
    trail = ck._gathered_history_paths(os.path.join(ckdir, ck.LATEST_NAME))
    mid = trail[-1]  # the oldest: epoch 0, batch 2
    resumed = run(resume=mid, seed=1)  # other weights: the file must win
    for part in ("params", "model_state"):
        for (path, a), b in zip(
                jax.tree_util.tree_flatten_with_path(full[part])[0],
                jax.tree_util.tree_leaves(resumed[part])):
            assert np.array_equal(a, b), (part, path)
    assert full["model_state"]["batch_stats"]  # there were statistics
