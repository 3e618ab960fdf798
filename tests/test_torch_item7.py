"""Item 7 of the port's roadmap on the CPU: adafactor against
``optax.adafactor``, ``--remat``, and dropout in GPT-2, BERT and ViT.
(Lamb under ZeRO-1 runs in ``tests/test_torch_zero1.py``'s gloo pair;
adafactor's state tree after three steps in ``tests/test_torch_checkpoint.
py``.)

Tolerances. adafactor: parameters and statistics within 1e-6 of optax's
over five steps (float32 throughout; the row and column means and the
block RMS sum in other orders). ``remat``: gradients bit-equal with and
without it, dropout off and on (the recompute repeats the same float32
operations on the same inputs, and draws the same masks). Dropout's keep
fraction within 3 sigma of 1 - p, sigma = sqrt(p (1 - p) / n). JAX's
threefry masks cannot be reproduced, so dropout is held to statistics and
to self-consistency, not to JAX's masks.
"""

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from distributed_pytorch_example_tpu.train import checkpoint as jax_ckpt
from distributed_pytorch_example_tpu.train import optimizers as jax_opt
from distributed_pytorch_example_tpu.train.state import TrainState as JaxState
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models import (
    GPT2,
    BertBase,
    Llama,
    SimpleNet,
    VisionTransformer,
    transformer,
)
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    ClassificationTask,
    TrainState,
    build_train_step,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train.optimizers import StateLayout
from distributed_pytorch_example_tpu_torch.train.tasks import MLMTask
from distributed_pytorch_example_tpu_torch.train.state import (
    to_host,
    to_numpy,
    train_state_to_flax,
)

torch.set_num_threads(2)


def _np(tree):
    return to_numpy(to_host(tree))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- (a) adafactor -----------------------------------------------------------


class Mixed(nn.Module):
    """Leaves of every adafactor kind: factored (both large dims >= 128,
    unequal and tied), unfactored 2-D (one dim < 128) and 1-D."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.wide = nn.Linear(200, 130)      # kernel (200, 130): factored
        self.square = nn.Linear(130, 130)    # (130, 130): factored, a tie
        self.narrow = nn.Linear(20, 300)     # (20, 300): unfactored
        self.table = nn.Embedding(300, 160)  # (300, 160): factored
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            self.square.bias.zero_()  # rms 0: the 1e-3 parameter-scale floor


@pytest.mark.parametrize("kw", [{}, dict(weight_decay=0.1, schedule="cosine",
                                         warmup_steps=2, total_steps=10)],
                         ids=["plain", "wd-cosine"])
def test_adafactor_matches_optax_adafactor(kw):
    model = Mixed()
    opt = make_optimizer(model, "adafactor", 1e-2, **kw)
    tx = jax_opt.make_optimizer("adafactor", 1e-2, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray,
                                _np(interop.params_to_flax(model)))
    jstate = tx.init(jp)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(0)
    named = dict(model.named_parameters())
    for i in range(5):
        grads = {k: torch.from_numpy((rng.standard_normal(p.shape) * (
            3.0 if i % 2 else 0.1)).astype(np.float32))
            for k, p in named.items()}
        for k, p in named.items():
            p.grad = grads[k]
        jg = jax.tree_util.tree_map(
            jnp.asarray, _np(interop.params_to_flax(model, grads)))
        updates, jstate = update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step()
        got = _leaves(_np(interop.params_to_flax(model)))
        for key, want in _leaves(jp).items():
            err = np.abs(got[key] - want).max()
            assert err <= 1e-6, f"step {i}: param{key} off by {err:.3e}"
    got = _leaves(_np(opt.state_tree(StateLayout(model))))
    want = _leaves(flax_ser.to_state_dict(jstate))
    assert list(got) == list(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, atol=1e-6, rtol=1e-5,
                                   err_msg=key)
    # the 130 x 130 tie keeps its rows and columns in JAX's order
    assert got["['0']['v_row']['square']['kernel']"].shape == (130,)


def test_adafactor_from_bare_parameters_refuses_to_checkpoint():
    """Given parameters (not the model), adafactor would not know each
    leaf's JAX layout, and its statistics could not be saved as optax's:
    make_optimizer refuses to build it."""
    model = Mixed()
    with pytest.raises(ValueError, match="make_optimizer\\(model"):
        make_optimizer(model.parameters(), "adafactor", 1e-2)


NET = dict(input_size=12, hidden_size=256, num_classes=3)


def _simplenet_state(seed, wd):
    model = SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=seed)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model, "adafactor", 1e-2,
                                               weight_decay=wd))


def _batches():
    rng = np.random.default_rng(1)
    return [(rng.standard_normal((8, 12)).astype(np.float32),
             rng.integers(0, 3, 8).astype(np.int32)) for _ in range(2)]


def test_adafactor_checkpoints_cross_load_both_ways(tmp_path):
    """A port checkpoint loads in JAX's ``load_checkpoint`` and a JAX one
    in the port's, adafactor's state tree whole (with the decayed-weights
    part): every leaf equal."""
    wd = 1e-3
    state = _simplenet_state(0, wd)
    step = build_train_step(ClassificationTask())
    for x, y in _batches():
        step(state, {"x": torch.from_numpy(x),
                     "y": torch.from_numpy(y).long()})
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, state, 1, 0.5, {"best_accuracy": 1.0})
    tx = jax_opt.make_optimizer("adafactor", 1e-2, weight_decay=wd)
    other = jax.tree_util.tree_map(jnp.asarray, _np(interop.params_to_flax(
        SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=4))))
    template = JaxState(step=jnp.zeros((), jnp.int32), params=other,
                        opt_state=tx.init(other), model_state={},
                        rng=jax.random.key(0))
    loaded, epoch, _ = jax_ckpt.load_checkpoint(path, template)
    assert epoch == 1 and int(loaded.step) == 2
    want = _leaves(train_state_to_flax(state))
    got = _leaves(flax_ser.to_state_dict(jax_ckpt._gather_to_host(loaded)))
    assert got.keys() == want.keys()
    for key, w in want.items():
        if not isinstance(w, str):
            np.testing.assert_array_equal(np.asarray(got[key]), w, key)
    # and back: JAX writes, the port loads the same tree
    jpath = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(jpath, loaded, 1, 0.5, {"best_accuracy": 1.0})
    again = _simplenet_state(7, wd)
    _, epoch, _ = ckpt.load_checkpoint(jpath, again)
    assert epoch == 1 and again.step == 2 and again.optimizer.updates == 2
    back = _leaves(train_state_to_flax(again))
    for key, w in want.items():
        if not isinstance(w, str):
            np.testing.assert_array_equal(back[key], w, key)


# -- (b) --remat and dropout -------------------------------------------------

LM = dict(vocab_size=128, max_len=64, model_dim=32, num_layers=2,
          num_heads=4, mlp_dim=64)
VIT = dict(num_classes=5, patch_size=4, model_dim=32, num_layers=2,
           num_heads=4, mlp_dim=64, image_size=8)
BUILD = {
    "gpt2": lambda **kw: GPT2(**LM, logits_mode="hidden", **kw),
    "bert": lambda **kw: BertBase(**LM, **kw),
    "vit": lambda **kw: VisionTransformer(**VIT, **kw),
    "llama": lambda **kw: Llama(**{**LM, "num_kv_heads": 2}, **kw),
}


def _task_and_batch(name):
    rng = np.random.default_rng(2)
    if name == "vit":
        x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
        return ClassificationTask(), {"x": torch.from_numpy(x),
                                      "y": torch.tensor([0, 1, 2, 3])}
    tokens = {"tokens": torch.from_numpy(
        rng.integers(1, 128, (4, 32)).astype(np.int32))}
    if name == "bert":
        return MLMTask(128, mask_token_id=103), tokens
    return CausalLMTask(), tokens


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _grads(name, remat, rate, step=3, dtype="float32"):
    """One train step's gradients (JAX layout, by flax path) of the seed-0
    model at train step ``step``, computing in ``dtype``."""
    kw = dict(remat=remat, device="cpu", seed=0, dtype=DTYPES[dtype])
    if rate is not None:
        kw["dropout_rate"] = rate
    model = BUILD[name](**kw)
    task, batch = _task_and_batch(name)
    state = TrainState(step=step, model=model,
                       optimizer=make_optimizer(model, "sgd", 0.0))
    metrics = build_train_step(task, seed=1)(state, batch)
    grads = _leaves(_np(interop.params_to_flax(model,
                                               interop.grads_of(model))))
    return grads, float(metrics["loss"])


def _assert_bit_equal(got, want):
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        assert np.array_equal(got[key], leaf), key


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,rate", [("gpt2", None), ("bert", None),
                                       ("vit", None), ("llama", None),
                                       ("gpt2", 0.1), ("bert", 0.1),
                                       ("vit", 0.1)])
def test_remat_gradients_are_bit_equal(name, rate, dtype):
    """``remat`` recomputes every block in the backward pass: the same
    gradients bit for bit, in float32 and bf16 compute, with dropout too
    (its masks are keyed by (seed, step, process, call, layer, site), so
    the recompute redraws them)."""
    want, loss = _grads(name, False, rate, dtype=dtype)
    got, remat_loss = _grads(name, True, rate, dtype=dtype)
    assert remat_loss == loss
    _assert_bit_equal(got, want)


def test_an_untied_dropout_generator_breaks_remat(monkeypatch):
    """The trap the keyed masks avoid: masks drawn from one generator that
    advances (``torch.utils.checkpoint`` does not restore it) differ in
    the recompute, and remat's gradients come out wrong without an
    error."""
    gen = torch.Generator().manual_seed(0)

    def untied(x, rate, draw, site):
        if not rate or draw is None:
            return x
        keep = torch.rand(x.shape, generator=gen) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    monkeypatch.setattr(transformer, "dropout", untied)
    want, _ = _grads("gpt2", False, 0.1)
    got, _ = _grads("gpt2", True, 0.1)
    assert any(not np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["gpt2", "bert", "vit"])
def test_dropout_rate_zero_is_the_model_without_dropout(name, dtype):
    """Rate 0 draws nothing: the same loss and gradients bit for bit as the
    model built without the argument."""
    want, loss = _grads(name, False, None, dtype=dtype)
    got, zero_loss = _grads(name, False, 0.0, dtype=dtype)
    assert zero_loss == loss
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("name", ["gpt2", "bert", "vit"])
def test_masks_follow_seed_step_and_call(name):
    """The same (seed, step) draws the same masks; another step, another
    seed or another call in the step draws others; eval draws none."""
    model = BUILD[name](dropout_rate=0.5, device="cpu", seed=0)
    _, batch = _task_and_batch(name)
    inputs = batch["x"] if name == "vit" else batch["tokens"].long()

    def out(step, seed=0, calls=1):
        model.draws.seed = seed
        model.fold_in(step)
        with torch.no_grad():
            for _ in range(calls):
                y = model(inputs)
        return y

    model.train()
    a = out(3)
    assert torch.equal(a, out(3))
    assert not torch.equal(a, out(4))
    assert not torch.equal(a, out(3, seed=1))
    assert not torch.equal(a, out(3, calls=2))
    model.eval()
    e = out(3)
    assert torch.equal(e, out(4))  # eval: no dropout
    assert not torch.equal(a, e)


def test_keep_fraction_is_within_three_sigma():
    n = 1 << 20
    x = torch.ones(n)
    for rate, site in ((0.1, (0, 0)), (0.5, (1, 1)), (0.9, (5, 2))):
        y = transformer.dropout(x, rate, (0, 0, 0, 1), site)
        kept = (y != 0).float().mean().item()
        sigma = (rate * (1 - rate) / n) ** 0.5
        assert abs(kept - (1 - rate)) <= 3 * sigma, (site, kept)
        assert torch.all((y == 0) | (y == 1 / (1 - rate)))


@pytest.mark.parametrize("name", ["gpt2", "bert", "vit"])
def test_a_resumed_run_redraws_the_masks(tmp_path, name):
    """Two steps with dropout, against one step, a checkpoint, and the
    second step taken by a fresh model loaded from it: the same second
    loss bit for bit (the masks come from (seed, step), not from a
    generator's history)."""
    task, batch = _task_and_batch(name)

    def fresh(seed=0):
        model = BUILD[name](dropout_rate=0.1, device="cpu", seed=seed)
        return TrainState(step=0, model=model,
                          optimizer=make_optimizer(model, "adam", 1e-3))

    step = build_train_step(task, seed=1)
    state = fresh()
    step(state, batch)
    path = str(tmp_path / "step1.ckpt")
    ckpt.save_checkpoint(path, state, 0, 0.0, {})
    want = float(step(state, batch)["loss"])
    resumed = fresh(seed=0)
    ckpt.load_checkpoint(path, resumed)
    assert resumed.step == 1
    assert float(step(resumed, batch)["loss"]) == want
