"""The port's BERT-base masked-LM path against the JAX package's, on the CPU.

A tiny BERT (vocab 128, so the [MASK] id 103 exists; max_len 128, width
32, 2 layers, 2 heads, MLP 64) starts from the port's seeded weights,
carried to a flax tree by ``interop``; tokens come from a numpy seed.
JAX runs with ``use_flash=False`` (XLA attention), the port on the CPU
takes its plain attention; K1's plain versions are held against the TPU
kernel's single-tile variants (``_fwd_single`` / ``_bwd_single``, the
ones BERT's 512 tokens reach) in interpret mode, at BERT's kind of key
mask: padded tails of varied length and an all-pad row.

Tolerances. float32: logits and hidden states 1e-5 (both sides float32,
summation order only); the MLM loss 1e-5 and each gradient leaf 2e-5
(as ``tests/test_torch_train_step.py``). bfloat16: logits and hidden
states within 3e-2 of the output's largest entry, max|got - ref| <=
3e-2 * max|ref| (the model computes in bf16 and the two frameworks round
at different places; measured at most 1.5e-2, a few bf16 ulps (2^-8) of
the largest entry). lamb against
``optax.lamb``: 1e-6 over six steps (float32, one reduction order apart).
"""

import os

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_pytorch_example_tpu.models.bert import BertBase as JaxBert
from distributed_pytorch_example_tpu.ops.pallas import flash_attention as jfa
from distributed_pytorch_example_tpu.train import checkpoint as jax_ckpt
from distributed_pytorch_example_tpu.train import optimizers as jax_opt
from distributed_pytorch_example_tpu.train import tasks as jax_tasks
from distributed_pytorch_example_tpu.train.state import TrainState as JaxState
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models import BertBase, get_model
from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_fwd_reference,
)
from distributed_pytorch_example_tpu_torch.train import (
    Trainer,
    TrainState,
    build_eval_step,
    build_train_step,
    cli,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train.tasks import MLMTask
from distributed_pytorch_example_tpu_torch.train.state import (
    to_host,
    to_numpy,
    train_state_to_flax,
)

torch.set_num_threads(2)

KW = dict(vocab_size=128, max_len=128, model_dim=32, num_layers=2,
          num_heads=2, mlp_dim=64)
SEQ, BATCH, MASK_ID, LR = 64, 4, 103, 1e-3
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# float32: absolute; bfloat16: relative to the output's largest entry
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
LOSS_TOL, GRAD_TOL, LAMB_TOL = 1e-5, 2e-5, 1e-6
# padded tails of varied length; the last row all pad
LENS = (SEQ, SEQ - 5, 1, 0)


def _np(tree):
    return to_numpy(to_host(tree))


def _tokens(pad, seed=0, lens=LENS):
    tokens = np.random.default_rng(seed).integers(
        1, KW["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    if pad is not None:
        for row, n in enumerate(lens):
            tokens[row, n:] = pad
    return tokens


def _pair(dtype="float32", mode="full", pad=None, seed=0):
    tdt, jdt = DTYPES[dtype]
    model = BertBase(**KW, dtype=tdt, logits_mode=mode, pad_token_id=pad,
                     device="cpu", seed=seed)
    jmodel = JaxBert(**KW, dtype=jdt, logits_mode=mode, pad_token_id=pad,
                     use_flash=False)
    return model, jmodel, _np(interop.params_to_flax(model))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- (a) forward -------------------------------------------------------------


@pytest.mark.parametrize("pad", [None, 0], ids=["no-pad", "pad"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_logits_and_hidden_states_match_jax(dtype, pad):
    """Logits (float32, with the float32 mlm_bias) and the MLM head's
    hidden states; with a pad id, the rows have padded tails of varied
    length and the last is all pad (a dead row in every attention)."""
    tokens = _tokens(pad)
    for mode in ("full", "hidden"):
        model, jmodel, params = _pair(dtype, mode, pad)
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens)),
                         np.float32)
        with torch.no_grad():
            got = model(torch.from_numpy(tokens))
        assert got.dtype == (torch.float32 if mode == "full"
                             else DTYPES[dtype][0])
        atol = TOL[dtype] * (np.abs(ref).max() if dtype == "bfloat16" else 1)
        np.testing.assert_allclose(got.float().numpy(), ref, atol=atol,
                                   rtol=0, err_msg=mode)


def test_all_pad_row_attends_to_nothing():
    """A row of pad only: every attention of it is a dead row (output 0);
    the other rows' states do not depend on it, and its own equal JAX's."""
    model, jmodel, params = _pair("float32", "hidden", pad=0)
    tokens = _tokens(0)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
        alone = model(torch.from_numpy(tokens[:3]))
    np.testing.assert_allclose(got[:3].numpy(), alone.numpy(), atol=1e-6,
                               rtol=0)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens)))
    np.testing.assert_allclose(got[3].numpy(), ref[3], atol=TOL["float32"],
                               rtol=0)


def test_k1_plain_versions_match_the_tpu_single_tile_kernels():
    """BERT's attention at one tile (non-causal, a key mask with padded
    tails and an all-pad row): the port's ``flash_attention`` on CPU
    tensors (K1's plain forward and backward) against the TPU kernel's
    ``_fwd_single`` / ``_bwd_single`` in interpret mode. Tolerances of
    ``tests/test_torch_flash_attention.py``: output 2e-5, gradients 5e-4."""
    rng = np.random.default_rng(3)
    shape = (4, 128, 2, 64)
    q, k, v, g = (rng.standard_normal(shape, dtype=np.float32)
                  for _ in range(4))
    mask = np.arange(128)[None, :] < np.array([128, 100, 1, 0])[:, None]

    def kernel(q, k, v):
        return jfa.flash_attention(q, k, v, causal=False,
                                   kv_mask=jnp.asarray(mask), interpret=True)

    ro, vjp = jax.vjp(kernel, *map(jnp.asarray, (q, k, v)))
    rgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=False,
                        kv_mask=torch.from_numpy(mask))
    o.backward(torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ro), atol=2e-5,
                               rtol=0)
    for name, t, want in zip("qkv", (tq, tk, tv), rgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=5e-4, rtol=0, err_msg=f"d{name}")
    assert np.all(o.detach().numpy()[3] == 0)
    assert np.all(tq.grad.numpy()[3] == 0)


def test_k1_plain_backward_keeps_dk_on_collapsed_keys():
    """BERT-base at initialisation collapses: its upper layers' keys,
    queries and values all point nearly one way. There dP - delta is a
    small difference, and a delta taken as rowsum(dO * O) from the bf16
    output O (the TPU kernel's) shifts it by a constant per row: x^T dK,
    the k projection's weight gradient, comes out many times its norm off
    a float64 computation. K1's plain backward (the kernels' math) sums
    delta from its own p and dp instead and holds it within 0.15, as the
    card test of the same name holds the kernels."""
    gen = torch.Generator().manual_seed(11)

    def shared(width=64):  # a common direction plus 5 % noise
        return (torch.randn(1, 1, 1, width, generator=gen)
                + 0.05 * torch.randn(1, 512, 1, width, generator=gen))

    q, k, v = (shared().bfloat16() for _ in range(3))
    do = torch.randn(1, 512, 1, 64, generator=gen).bfloat16()
    x = shared()[0, :, 0].double()
    q64, k64, v64, do64 = (t[0, :, 0].double() for t in (q, k, v, do))
    p = torch.softmax(q64 @ k64.t() / 8, -1)
    dp = do64 @ v64.t()
    want = x.t() @ ((p * (dp - (p * dp).sum(-1, keepdim=True)) / 8).t()
                    @ q64)
    kw = dict(causal=False, kv_mask=None, softmax_scale=0.125)
    o, lse = flash_attention_fwd_reference(q, k, v, **kw)
    dk = flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)[1]
    err = ((x.t() @ dk[0, :, 0].double() - want).norm() / want.norm()).item()
    assert err <= 0.15
    # the TPU kernel's delta, rowsum(dO * O) from the bf16 O
    delta = (do.float() * o.float()).sum(-1)[0, :, 0].double()
    ds = (p * (dp - delta[:, None]) / 8).bfloat16().double()
    old = ((x.t() @ (ds.t() @ q64) - want).norm() / want.norm()).item()
    assert old > 1.0


# -- (b) the MLM loss and one step's gradients on JAX's own draws ------------


def _jax_draws(task, tokens, rng):
    """``selected`` and ``masked_inputs`` from the same jax.random calls
    as the JAX package's MLMTask.compute_loss."""
    rng_sel, rng_kind, rng_rand, _ = jax.random.split(
        jax.random.fold_in(rng, 1), 4)
    tokens = jnp.asarray(tokens)
    selected = jax.random.uniform(rng_sel, tokens.shape) < task.mask_rate
    if task.pad_token_id is not None:
        selected &= tokens != task.pad_token_id
    kind = jax.random.uniform(rng_kind, tokens.shape)
    if task.pad_token_id is None:
        random_tokens = jax.random.randint(
            rng_rand, tokens.shape, 0, task.vocab_size, dtype=tokens.dtype)
    else:
        r = jax.random.randint(rng_rand, tokens.shape, 0,
                               task.vocab_size - 1, dtype=tokens.dtype)
        random_tokens = jnp.where(r >= task.pad_token_id, r + 1, r)
    inputs = jnp.where(
        selected & (kind < 0.8), jnp.asarray(task.mask_token_id, tokens.dtype),
        jnp.where(selected & (kind >= 0.9), random_tokens, tokens))
    return np.asarray(inputs), np.asarray(selected)


@pytest.mark.parametrize("mode,pad", [("hidden", None), ("full", None),
                                      ("hidden", 0)],
                         ids=["fused", "dense", "fused-pad"])
def test_mlm_loss_and_gradients_match_jax_on_its_draws(mode, pad):
    model, jmodel, params = _pair("float32", mode, pad)
    tokens = _tokens(pad)
    jtask = jax_tasks.MLMTask(KW["vocab_size"], MASK_ID, mask_rate=0.5,
                              pad_token_id=pad)
    rng = jax.random.key(7)
    batch = {"tokens": jnp.asarray(tokens)}

    def jloss(p):
        return jtask.compute_loss(jmodel, p, {}, batch, rng, train=True)[:2]

    (jl, jmetrics), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    inputs, selected = _jax_draws(jtask, tokens, rng)
    assert selected.sum() > 0

    task = MLMTask(KW["vocab_size"], MASK_ID, mask_rate=0.5,
                   pad_token_id=pad)
    tt = torch.from_numpy(tokens).long()
    loss, metrics = task.loss(model, model(torch.tensor(inputs).long()),
                              tt, torch.tensor(selected))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_TOL
    assert abs(float(metrics["accuracy"]) - float(jmetrics["accuracy"])) <= 1e-4
    got = _leaves(_np(interop.params_to_flax(model, interop.grads_of(model))))
    want = _leaves(jgrads)
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        err = np.abs(leaf - want[key]).max()
        assert err <= GRAD_TOL, f"grad{key}: off by {err:.3e}"


# -- (c) the masking recipe ------------------------------------------------


def _task(pad=0, rate=0.15):
    return MLMTask(KW["vocab_size"], MASK_ID, mask_rate=rate,
                   pad_token_id=pad)


def test_pad_is_never_selected_and_an_all_pad_batch_scores_zero():
    model, _, _ = _pair("float32", "hidden", pad=0)
    task = _task(rate=0.9)
    tokens = torch.from_numpy(_tokens(0)).long()
    gen = torch.Generator().manual_seed(0)
    inputs, selected = task.corrupt(tokens, gen)
    assert not selected[tokens == 0].any() and selected.any()
    assert torch.equal(inputs[tokens == 0], tokens[tokens == 0])
    loss, _ = task.compute_loss(model, {"tokens": tokens}, train=False,
                                generator=gen)
    assert torch.isfinite(loss) and loss.item() > 0
    # nothing is selectable in an all-pad batch: exactly 0, where a
    # selected pad position would score above 0
    loss, metrics = task.compute_loss(
        model, {"tokens": torch.zeros_like(tokens)}, train=False,
        generator=gen)
    assert float(loss) == 0.0 and float(metrics["accuracy"]) == 0.0


@pytest.mark.parametrize("pad", [0, 5, KW["vocab_size"] - 1])
def test_random_replacement_never_draws_pad(pad):
    """mask_rate 1: every non-pad position is selected; the 10 % random
    draws cover the vocabulary but the pad id."""
    task = _task(pad=pad, rate=1.0)
    tokens = torch.full((64, 128), (pad + 1) % KW["vocab_size"])
    inputs, selected = task.corrupt(tokens, torch.Generator().manual_seed(1))
    assert selected.all()
    assert not (inputs == pad).any()
    replaced = set(inputs[(inputs != MASK_ID) & (inputs != tokens)].tolist())
    assert len(replaced) >= KW["vocab_size"] - 4  # nearly every other id


def test_80_10_10_shares_over_a_large_draw():
    task = _task(pad=None)
    tokens = torch.full((256, 512), 7)  # 7 is neither MASK_ID nor drawn much
    inputs, selected = task.corrupt(tokens, torch.Generator().manual_seed(2))
    n = selected.sum().item()
    assert abs(n / tokens.numel() - 0.15) < 0.005
    masked = (inputs == MASK_ID)[selected].float().mean().item()
    kept = (inputs == 7)[selected].float().mean().item()
    assert masked == pytest.approx(0.8, abs=0.01)
    # a random draw of 7 itself lands in "kept": 0.1 + 0.1 / vocab
    assert kept == pytest.approx(0.1 + 0.1 / KW["vocab_size"], abs=0.01)
    assert not (inputs != tokens)[~selected].any()


def test_train_and_eval_draws_follow_seed_step_and_batch():
    """The step's generator is a function of (seed, step) and the eval
    step's of (seed, batch index): the same indices draw the same masks,
    other ones other masks."""
    seen = []

    class Recording(MLMTask):
        def corrupt(self, tokens, generator):
            out = super().corrupt(tokens, generator)
            seen.append(out[1].clone())
            return out

    task = Recording(KW["vocab_size"], MASK_ID)
    batch = {"tokens": torch.from_numpy(_tokens(None)).long()}

    def run(seed, steps):
        model = BertBase(**KW, logits_mode="hidden", device="cpu")
        state = TrainState(step=0, model=model, optimizer=make_optimizer(
            model.parameters(), "adam", LR))
        step = build_train_step(task, seed=seed)
        for _ in range(steps):
            step(state, batch)
        evaluate = build_eval_step(task, seed=seed)
        for idx in (0, 1, 0):
            evaluate(state, batch, idx)

    run(0, 2)
    run(0, 1)
    run(1, 1)
    (t0, t1, e0, e1, e0b), (u0, f0, f1, f0b), (v0, *_) = (
        seen[:5], seen[5:9], seen[9:])
    assert torch.equal(t0, u0) and not torch.equal(t0, t1)
    assert torch.equal(e0, e0b) and torch.equal(e0, f0)
    assert not torch.equal(e0, e1) and not torch.equal(e0, t0)
    assert not torch.equal(v0, t0)


# -- (d) interop ---------------------------------------------------------------


def test_flax_round_trip_is_bit_exact():
    model, jmodel, params = _pair()
    want = jax.tree_util.tree_structure(jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0),
                            jnp.zeros((1, SEQ), jnp.int32))["params"]))
    assert jax.tree_util.tree_structure(params) == want
    assert params["pos_embed"].shape == (1, KW["max_len"], KW["model_dim"])
    other = BertBase(**KW, device="cpu", seed=3)
    interop.params_from_flax(other, params)
    back = _np(interop.params_to_flax(other))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


# -- (e) lamb against optax.lamb ---------------------------------------------


LAMB_CASES = {
    "plain": {},
    "weight-decay": dict(weight_decay=0.01),
    "cosine-warmup-clip": dict(weight_decay=0.01, schedule="cosine",
                               warmup_steps=2, total_steps=8,
                               grad_clip_norm=1.0),
}


@pytest.mark.parametrize("case", sorted(LAMB_CASES))
def test_lamb_matches_optax_lamb(case):
    """Six steps on three leaves, one of them all zeros (its parameter
    norm is 0, so its trust ratio is 1); also the optax state tree."""
    kw = LAMB_CASES[case]
    rng = np.random.default_rng(0)
    shapes = {"a": (6, 5), "b": (5,), "zero": (4,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    params["zero"][:] = 0
    tx = jax_opt.make_optimizer("lamb", 1e-2, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = make_optimizer(list(tp.values()), "lamb", 1e-2, **kw)
    for _ in range(6):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        updates, jstate = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        assert opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=LAMB_TOL, rtol=0, err_msg=k)
    assert not np.array_equal(np.asarray(jp["zero"]), params["zero"])


# -- (f) checkpoints across the packages -------------------------------------


def _port_state(opt, pad=None):
    model = BertBase(**KW, logits_mode="hidden", pad_token_id=pad,
                     device="cpu", seed=0)
    return TrainState(step=0, model=model, optimizer=make_optimizer(
        model.parameters(), opt, LR, weight_decay=0.01 if opt == "lamb"
        else 0.0))


def _jax_state(opt, params):
    tx = jax_opt.make_optimizer(opt, LR, weight_decay=0.01 if opt == "lamb"
                                else 0.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return JaxState(step=jnp.zeros((), jnp.int32), params=jp,
                    opt_state=tx.init(jp), model_state={},
                    rng=jax.random.key(0)), tx


def _trained_jax_state(opt):
    """Two JAX train steps of the tiny BERT's MLM (JAX's own draws)."""
    from distributed_pytorch_example_tpu.train import step as jax_step

    _, jmodel, params = _pair("float32", "hidden", pad=0)
    state, tx = _jax_state(opt, params)
    task = jax_tasks.MLMTask(KW["vocab_size"], MASK_ID, pad_token_id=0)
    step = jax_step.build_train_step(jmodel, task, tx, sentinels=False)
    for seed in (0, 1):
        state, _ = step(state, {"tokens": jnp.asarray(_tokens(0, seed))})
    return state


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[jax.tree_util.keystr(path)] = np.asarray(leaf)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        assert got[key].dtype == leaf.dtype, key
        np.testing.assert_array_equal(got[key], leaf, err_msg=key)


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_jax_bert_checkpoint_loads_in_the_port(opt, tmp_path):
    jstate = _trained_jax_state(opt)
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, jstate, 1, 2.5, {"best_accuracy": 1.0})
    state = _port_state(opt, pad=0)
    _, epoch, extra = ckpt.load_checkpoint(path, state)
    assert epoch == 1 and extra["best_accuracy"] == 1.0
    assert state.step == 2 and state.optimizer.updates == 2
    want = flax_ser.to_state_dict(jax_ckpt._gather_to_host(jstate))
    _assert_trees_equal(train_state_to_flax(state), want)


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_port_bert_checkpoint_loads_in_jax(opt, tmp_path):
    state = _port_state(opt, pad=0)
    step = build_train_step(MLMTask(KW["vocab_size"], MASK_ID,
                                    pad_token_id=0))
    for seed in (0, 1):
        step(state, {"tokens": torch.from_numpy(_tokens(0, seed)).long()})
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, state, 1, 2.5, {"best_accuracy": 1.0})
    template, _ = _jax_state(opt, _np(interop.params_to_flax(
        BertBase(**KW, device="cpu", seed=9))))
    loaded, epoch, _ = jax_ckpt.load_checkpoint(path, template)
    assert epoch == 1 and int(loaded.step) == 2
    _assert_trees_equal(
        flax_ser.to_state_dict(jax_ckpt._gather_to_host(loaded)),
        train_state_to_flax(state))


# -- (h) the CLI -------------------------------------------------------------


def test_cli_builds_bert_base_and_its_mlm_task(monkeypatch):
    """The CLI's model and task at BERT-base (built on the meta device:
    no weights are drawn on the CPU)."""
    monkeypatch.setattr(BertBase, "reset_parameters", lambda self, g: None)
    args = cli.build_parser().parse_args(
        ["--model", "bert-base", "--dataset", "synthetic-tokens",
         "--pad-token-id", "0", "--lm-loss", "fused"])
    model = cli.build_model(args, torch.device("meta"))
    assert isinstance(model, BertBase)
    assert (model.vocab_size, model.max_len, model.model_dim,
            model.num_layers) == (30522, 512, 768, 12)
    assert model.pad_token_id == 0 and model.logits_mode == "hidden"
    task = cli.build_task(args, model)
    assert isinstance(task, MLMTask)
    assert (task.vocab_size, task.mask_token_id, task.pad_token_id,
            task.mask_rate) == (30522, 103, 0, 0.15)
    ds = cli.build_dataset(args, 8, seed=0)
    assert ds.vocab_size == 30522 and ds.arrays["tokens"].shape == (8, 512)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("llama", moe_experts=4, device="meta")


@pytest.mark.parametrize("argv", [
    ["--model", "gpt2", "--dataset", "synthetic-tokens", "--pad-token-id",
     "0"],
    ["--model", "bert-base", "--dataset", "synthetic-tokens", "--seq-len",
     "513"],
    ["--model", "bert-base", "--dataset", "synthetic"],
    ["--model", "bert-base", "--dataset", "synthetic-tokens", "--optimizer",
     "adafactor", "--wire", "int8-block"],
], ids=["pad-gpt2", "seq-513", "bert-on-images", "adafactor-wire"])
def test_cli_refuses_what_bert_does_not_take(argv):
    with pytest.raises(SystemExit):
        cli.main(argv + ["--device", "cpu"])


def test_cli_reads_a_token_file_from_the_data_dir(tmp_path, monkeypatch):
    """``tokens-file`` windows ``train.bin`` / ``val.bin`` under
    ``--data-dir`` (else ``$DPX_DATA_DIR``); a flipped byte refuses."""
    from distributed_pytorch_example_tpu_torch.data import (
        intake,
        write_token_file,
    )

    ids = np.arange(1000, dtype=np.uint16) % 500
    for name in ("train.bin", "val.bin"):
        write_token_file(str(tmp_path / name), ids)
    args = cli.build_parser().parse_args(
        ["--model", "bert-base", "--dataset", "tokens-file", "--seq-len",
         "128"])
    monkeypatch.setenv("DPX_DATA_DIR", str(tmp_path))
    train = cli.build_dataset(args, 0, seed=0)
    val = cli.build_dataset(args, 0, seed=1, train=False)
    assert len(train) == len(val) == 1000 // 128
    np.testing.assert_array_equal(train.get_batch([1])["tokens"][0],
                                  ids[128:256].astype(np.int32))
    blob = bytearray((tmp_path / "val.bin").read_bytes())
    blob[7] ^= 1
    (tmp_path / "val.bin").write_bytes(bytes(blob))
    with pytest.raises(intake.ShardCorruptError):
        cli.build_dataset(args, 0, seed=1, train=False)
    args.data_dir = str(tmp_path / "elsewhere")
    with pytest.raises(FileNotFoundError, match="synthetic-tokens"):
        cli.build_dataset(args, 0, seed=0)


def test_trainer_fits_tiny_bert_with_padding(tmp_path):
    """Trainer.fit on the tiny BERT with a pad id and lamb: finite losses,
    validation scored, a checkpoint written and resumed."""
    from distributed_pytorch_example_tpu_torch.data import (
        DeviceLoader,
        TokenWindowDataset,
    )

    ids = np.random.default_rng(0).integers(1, 128, 64 * 12).astype(np.int32)
    ids[np.arange(ids.size) % 64 >= 50] = 0  # padded tails
    ds = TokenWindowDataset(ids, seq_len=SEQ)
    state = _port_state("lamb", pad=0)
    task = MLMTask(KW["vocab_size"], MASK_ID, pad_token_id=0)
    trainer = Trainer(state.model, task, state.optimizer, log_every=100,
                      checkpoint_dir=str(tmp_path))
    history = trainer.fit(DeviceLoader(ds, 4, device="cpu", seed=0),
                          DeviceLoader(ds, 4, device="cpu", shuffle=False),
                          epochs=1)
    assert np.isfinite(history[0]["train_loss"])
    assert np.isfinite(history[0]["val_loss"])
    assert os.path.exists(tmp_path / ckpt.LATEST_NAME)
    again = _port_state("lamb", pad=0)
    ckpt.load_checkpoint(str(tmp_path / ckpt.LATEST_NAME), again)
    for a, b in zip(state.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
    assert again.optimizer.updates == state.optimizer.updates == 3
