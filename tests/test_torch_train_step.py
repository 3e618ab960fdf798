"""The port's training path against the JAX package's, on the CPU.

A small GPT-2 (2 layers, width 128, 2 heads of 64, vocab 256, seq 128,
batch 2) starts from the port's seeded weights, carried to a flax tree by
``interop``; batches come from the same synthetic datasets and loaders
(numpy, from a seed). One train step is compared leaf by leaf (loss,
gradients, parameters after the Adam update) for both LM-loss paths, then
a short ``Trainer.fit`` step by step, then SimpleNet.

Tolerances, float32: loss 1e-5 and gradients 2e-5 (both sides float32,
summation order only). Parameters after one Adam step: Adam's first
update is -lr * g / (|g| + eps), which a last-bit difference in g barely
moves where |g| >= 1e-5 (tolerance 1e-5), but moves by up to 2 * lr where
g is tiny — the k-projection bias, for one, whose gradient is exactly
zero in exact arithmetic (a softmax ignores a shift shared by a whole row
of logits) and holds rounding noise on both sides; there the bound is
2 * lr. Over several steps Adam keeps amplifying such differences: losses
after 4 to 8 steps agree to 1e-4.

bfloat16 (the model computes in bf16, the frameworks round at different
places): loss 2e-2, and each gradient leaf within 3e-2 of its own largest
entry: max|g - g_ref| <= 3e-2 * max(max|g_ref|, 1e-3). Measured here at
most 2.0e-2 (a few bf16 ulps of the leaf's largest entry); a gradient with
a wrong or missing term is off by O(1). The floor 1e-3 is for the
k-projection bias, whose gradient is zero in exact arithmetic and holds
only bf16 rounding noise (about 2e-5) on both sides; the smallest real
leaf scale in this case is 7e-4. Parameters after an Adam step are not
compared in bf16: the first update is about +-lr per entry whatever the
gradient's size, so they would not tell a wrong gradient from a right one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.data.loader import (
    DeviceLoader as JaxLoader,
)
from distributed_pytorch_example_tpu.data.synthetic import (
    SyntheticClassificationDataset as JaxClassData,
    SyntheticTokenDataset as JaxTokenData,
)
from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu.models.mlp import SimpleNet as JaxSimpleNet
from distributed_pytorch_example_tpu.train import loop as jax_loop
from distributed_pytorch_example_tpu.train import optimizers as jax_opt
from distributed_pytorch_example_tpu.train import step as jax_step
from distributed_pytorch_example_tpu.train import tasks as jax_tasks
from distributed_pytorch_example_tpu.train.state import TrainState as JaxState
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticClassificationDataset,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.models import GPT2, SimpleNet
from distributed_pytorch_example_tpu_torch.parallel import data_parallel
from distributed_pytorch_example_tpu_torch.train.checkpoint import (
    SHARDED_MAGIC,
)
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    ClassificationTask,
    Trainer,
    TrainState,
    build_train_step,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train.optimizers import (
    ShardedUpdate,
)
from distributed_pytorch_example_tpu_torch.train.state import to_host, to_numpy

torch.set_num_threads(2)

KW = dict(vocab_size=256, max_len=128, model_dim=128, num_layers=2,
          num_heads=2, mlp_dim=512)
SEQ, BATCH, LR = 128, 2, 1e-3
MODES = {"fused": "hidden", "dense": "full"}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(loss=1e-5, grad=2e-5, grad_rel=None, param=1e-5),
       "bfloat16": dict(loss=2e-2, grad=None, grad_rel=3e-2, param=None)}
GRAD_FLOOR = 1e-3  # the leaf scale below which bf16 grads are held absolutely


def _np(tree):
    """A flax tree of tensor views (``interop.params_to_flax``) as numpy
    copies."""
    return to_numpy(to_host(tree))


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, atol, what, grads=None):
    """Leaf by leaf; with ``grads`` (the reference gradients), entries whose
    gradient is below 1e-5 get Adam's bound 2 * lr instead of ``atol``."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        tol = np.full(leaf.shape, atol, np.float32)
        if grads is not None:
            tol[np.abs(_leaves(grads)[key]) < 1e-5] = max(atol, 2 * LR)
        bad = np.abs(leaf - want[key]) > tol
        assert not bad.any(), (
            f"{what}{key}: {bad.sum()} of {bad.size} entries off by up to "
            f"{np.abs(leaf - want[key]).max():.3e}"
        )


def _assert_grads_close_rel(got, want, rtol):
    """Leaf by leaf: max|got - want| <= rtol * max(max|want|, GRAD_FLOOR)."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        scale = max(float(np.abs(want[key]).max()), GRAD_FLOOR)
        err = float(np.abs(leaf - want[key]).max())
        assert err <= rtol * scale, (
            f"grad{key}: off by {err:.3e}, {err / scale:.3e} of the leaf's "
            f"scale {scale:.3e} (tol {rtol})"
        )


def _gpt2_pair(mode, dtype):
    tdt, jdt = DTYPES[dtype]
    model = GPT2(**KW, dtype=tdt, logits_mode=MODES[mode], device="cpu",
                 seed=0)
    params = _np(interop.params_to_flax(model))
    jmodel = JaxGPT2(**KW, dtype=jdt, logits_mode=MODES[mode])
    return model, jmodel, params


def _tokens(seed=0, n=BATCH):
    return np.random.default_rng(seed).integers(0, KW["vocab_size"],
                                                (n, SEQ)).astype(np.int32)


@pytest.mark.parametrize("mode,dtype", [("fused", "float32"),
                                        ("dense", "float32"),
                                        ("fused", "bfloat16")])
def test_gpt2_train_step_matches_jax(mode, dtype):
    model, jmodel, params = _gpt2_pair(mode, dtype)
    tokens = _tokens()
    jbatch = {"tokens": jnp.asarray(tokens)}
    jtask = jax_tasks.CausalLMTask()
    joptim = jax_opt.make_optimizer("adam", LR)
    jparams = _jax_tree(params)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=jparams,
                     opt_state=joptim.init(jparams), model_state={},
                     rng=jax.random.key(0))
    jgrads = jax.grad(lambda p: jtask.compute_loss(
        jmodel, p, {}, jbatch, jax.random.key(1), train=True)[0])(jparams)
    new_state, jmetrics = jax_step.build_train_step(
        jmodel, jtask, joptim, sentinels=False)(state, jbatch)

    optimizer = make_optimizer(model.parameters(), "adam", LR)
    tstate = TrainState(step=0, model=model, optimizer=optimizer)
    metrics = build_train_step(CausalLMTask())(
        tstate, {"tokens": torch.from_numpy(tokens)})

    tol = TOL[dtype]
    assert tstate.step == 1 and float(metrics["bad_step"]) == 0.0
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= tol["loss"]
    assert abs(float(metrics["accuracy"])
               - float(jmetrics["accuracy"])) <= 100.0 / (BATCH * (SEQ - 1))
    grads = _np(interop.params_to_flax(model, interop.grads_of(model)))
    if tol["grad_rel"] is not None:
        _assert_grads_close_rel(grads, jgrads, tol["grad_rel"])
    else:
        _assert_trees_close(grads, jgrads, tol["grad"], "grad")
    if tol["param"] is not None:
        after = _np(interop.params_to_flax(model))
        _assert_trees_close(after, new_state.params, tol["param"], "param",
                            grads=jgrads)


def test_gpt2_trainer_fit_matches_jax_step_by_step():
    """One epoch of 4 steps plus validation through both Trainers, on the
    same weights and the same loader batches: per-step losses agree."""
    model, jmodel, params = _gpt2_pair("fused", "float32")
    seqs = dict(num_samples=8, seq_len=SEQ, vocab_size=KW["vocab_size"])
    jtrainer = jax_loop.Trainer(jmodel, jax_tasks.CausalLMTask(),
                                jax_opt.make_optimizer("adam", LR),
                                telemetry=False, log_every=1)
    jparams = _jax_tree(params)
    jtrainer.state = JaxState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=jtrainer.optimizer.init(jparams), model_state={},
        rng=jax.random.key(0),
    )
    trainer = Trainer(model, CausalLMTask(),
                      make_optimizer(model.parameters(), "adam", LR),
                      log_every=1)
    losses = {}
    for name, tr in (("jax", jtrainer), ("port", trainer)):
        step_fn, seen = tr.train_step, []

        def recording(state, batch, step_fn=step_fn, seen=seen):
            out = step_fn(state, batch)
            metrics = out[1] if isinstance(out, tuple) else out
            seen.append(float(metrics["loss"]))
            return out

        tr.train_step = recording
        losses[name] = seen
    jhist = jtrainer.fit(
        JaxLoader(JaxTokenData(seed=0, **seqs), BATCH, seed=0),
        JaxLoader(JaxTokenData(seed=1, num_samples=4, seq_len=SEQ,
                               vocab_size=KW["vocab_size"]), BATCH,
                  shuffle=False),
        epochs=1,
    )
    hist = trainer.fit(
        DeviceLoader(SyntheticTokenDataset(seed=0, **seqs), BATCH,
                     device="cpu", seed=0),
        DeviceLoader(SyntheticTokenDataset(seed=1, num_samples=4, seq_len=SEQ,
                                           vocab_size=KW["vocab_size"]),
                     BATCH, device="cpu", shuffle=False),
        epochs=1,
    )
    assert len(losses["port"]) == len(losses["jax"]) == 4
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=1e-4,
                               rtol=0)
    assert abs(hist[0]["val_loss"] - jhist[0]["val_loss"]) <= 1e-4


def _simplenet_pair(dropout_rate):
    model = SimpleNet(dropout_rate=dropout_rate, device="cpu", seed=0)
    params = _np(interop.params_to_flax(model))
    return model, JaxSimpleNet(dropout_rate=dropout_rate), params


def _simplenet_fit(model, jmodel, params, epochs=1):
    data = dict(num_samples=256, seed=0)
    jtrainer = jax_loop.Trainer(jmodel, jax_tasks.ClassificationTask(),
                                jax_opt.make_optimizer("adam", LR),
                                telemetry=False)
    jparams = _jax_tree(params)
    jtrainer.state = JaxState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=jtrainer.optimizer.init(jparams), model_state={},
        rng=jax.random.key(0),
    )
    trainer = Trainer(model, ClassificationTask(),
                      make_optimizer(model.parameters(), "adam", LR))
    jhist = jtrainer.fit(
        JaxLoader(JaxClassData(**data), 64, seed=0),
        JaxLoader(JaxClassData(num_samples=64, seed=1), 64, shuffle=False),
        epochs=epochs,
    )
    hist = trainer.fit(
        DeviceLoader(SyntheticClassificationDataset(**data), 64, device="cpu",
                     seed=0),
        DeviceLoader(SyntheticClassificationDataset(num_samples=64, seed=1),
                     64, device="cpu", shuffle=False),
        epochs=epochs,
    )
    return hist, jhist, trainer


def test_simplenet_fit_matches_jax_without_dropout():
    """The reference model at its sizes, dropout off (JAX's and torch's
    random bits differ): two epochs of 4 steps agree to 1e-4."""
    hist, jhist, _ = _simplenet_fit(*_simplenet_pair(0.0), epochs=2)
    for got, want in zip(hist, jhist):
        for key in ("train_loss", "val_loss"):
            assert abs(got[key] - want[key]) <= 1e-4, (key, got, want)
        assert got["val_accuracy"] == want["val_accuracy"]


def test_simplenet_at_defaults_matches_jax_where_dropout_is_off():
    """At its defaults (dropout 0.2) the model has the reference's 269,322
    parameters and the same eval-mode function as JAX's; training draws
    dropout masks, so train mode differs from eval mode and one epoch
    trains to a finite loss."""
    model, jmodel, params = _simplenet_pair(0.2)
    assert sum(p.numel() for p in model.parameters()) == 269_322
    x = np.random.default_rng(2).standard_normal((4, 784), dtype=np.float32)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = jmodel.apply({"params": _jax_tree(params)}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    model.train()
    with torch.no_grad():
        assert not np.allclose(model(torch.from_numpy(x)).numpy(), got)
    hist, jhist, _ = _simplenet_fit(model, jmodel, params)
    assert np.isfinite(hist[0]["train_loss"])
    assert abs(hist[0]["val_loss"] - jhist[0]["val_loss"]) <= 0.1


def test_nonfinite_step_leaves_params_and_moments_untouched():
    model = SimpleNet(dropout_rate=0.0, device="cpu", seed=0)
    optimizer = make_optimizer(model.parameters(), "adam", LR)
    state = TrainState(step=0, model=model, optimizer=optimizer)
    step = build_train_step(ClassificationTask())
    x = torch.randn(8, 784, generator=torch.Generator().manual_seed(0))
    y = torch.arange(8) % 10
    step(state, {"x": x, "y": y})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [s["exp_avg"].clone() for s in optimizer.optimizer.state.values()]
    lr = optimizer.lr
    x[0, 0] = float("nan")
    metrics = step(state, {"x": x, "y": y})
    assert float(metrics["bad_step"]) == 1.0 and state.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for m, s in zip(moments, optimizer.optimizer.state.values()):
        assert torch.equal(m, s["exp_avg"]) and int(s["step"]) == 1
    assert optimizer.lr == lr


class _Poisoned(ClassificationTask):
    """The port's classification loss plus ``value * Dense_2.bias[0]``:
    the gradient gains ``value`` on that one element and nowhere else."""

    def __init__(self, value):
        self.value = value

    def compute_loss(self, model, batch, *, train):
        loss, metrics = super().compute_loss(model, batch, train=train)
        return loss + self.value * model.Dense_2.bias[0], metrics


class _JaxPoisoned(jax_tasks.ClassificationTask):
    """The JAX package's counterpart of :class:`_Poisoned`."""

    def __init__(self, value):
        self.value = value

    def compute_loss(self, model, params, model_state, batch, rng, *, train):
        loss, metrics, ms = super().compute_loss(
            model, params, model_state, batch, rng, train=train)
        return loss + self.value * params["Dense_2"]["bias"][0], metrics, ms


@pytest.mark.parametrize("value,bad", [(1e20, 0.0), (float("nan"), 1.0)],
                         ids=["finite-1e20", "nan"])
def test_skip_predicate_counts_nonfinite_elements_as_jax_does(value, bad):
    """One gradient element of 1e20 overflows the float32 norm but is
    finite: both packages apply the step (SGD: no squared moment to
    overflow), to the same parameters within the float32 tolerance; a NaN
    element makes both skip and leave the parameters as they were. The
    learning rate is a power of two, so the 1e20 element's update rounds
    once on either side."""
    lr = 2.0 ** -4
    model, jmodel, params = _simplenet_pair(0.0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 784)).astype(np.float32)
    y = (np.arange(8) % 10).astype(np.int32)
    joptim = jax_opt.make_optimizer("sgd", lr)
    jparams = _jax_tree(params)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=jparams,
                      opt_state=joptim.init(jparams), model_state={},
                      rng=jax.random.key(0))
    jstep = jax_step.build_train_step(jmodel, _JaxPoisoned(value), joptim,
                                      sentinels=False)
    jstate, jmetrics = jstep(jstate, {"x": jnp.asarray(x),
                                      "y": jnp.asarray(y)})
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters(), "sgd",
                                                lr))
    metrics = build_train_step(_Poisoned(value))(
        state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()})
    assert float(jmetrics["bad_step"]) == bad
    assert float(metrics["bad_step"]) == bad
    got = _np(interop.params_to_flax(model))
    _assert_trees_close(got, jax.tree_util.tree_map(np.asarray,
                                                    jstate.params),
                        TOL["float32"]["param"], "param")
    if bad:
        _assert_trees_close(got, params, 0.0, "unchanged param")
    else:
        assert float(got["Dense_2"]["bias"][0]) < -1e18  # the step applied


def test_refused_options_raise(tmp_path):
    model = SimpleNet(device="cpu")
    opt = make_optimizer(model.parameters())
    with pytest.raises(NotImplementedError, match="item 9"):
        Trainer(model, ClassificationTask(), opt, checkpoint_dir=str(tmp_path),
                checkpoint_format="sharded")
    # a JAX sharded-format pointer file is refused on load, not misread
    pointer = tmp_path / "latest_model.ckpt"
    pointer.write_bytes(SHARDED_MAGIC + b"00000001\n")
    trainer = Trainer(model, ClassificationTask(), opt,
                      checkpoint_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 9"):
        trainer.load(str(pointer))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_train_step(ClassificationTask(), sentinels=True)
    # adafactor's factored statistics span a whole leaf: no ZeRO-1 tiles
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ShardedUpdate(model, make_optimizer(model, "adafactor"),
                      data_parallel(2, dp_shard_opt_state=True), 0, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPT2(**KW, pipe_axis="pipe", device="cpu")
