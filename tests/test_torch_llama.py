"""The port's LLaMA (RoPE, RMSNorm, SwiGLU, GQA) against the JAX package's,
on the CPU.

A small LLaMA (2 layers, width 64, 4 query heads over 2 kv heads, MLP
128, vocab 256) starts from the port's seeded weights, carried to a flax
tree by ``interop``; tokens come from a numpy seed. JAX runs with
``use_flash=False`` (XLA attention), the port on the CPU takes its plain
attention.

Tolerances. float32: RoPE 1e-6 (the same float32 angles, sin and cos of
two libraries), RMSNorm and SwiGLU 1e-6 of the largest entry, logits and hidden states 1e-5,
the loss 1e-5 and each gradient leaf 2e-5 (both sides float32, summation
order only; as ``tests/test_torch_bert.py``). bfloat16 (the frameworks
round at different places): RoPE one bf16 ulp of the largest entry
(2^-7 relative), RMSNorm and SwiGLU 2e-2 of the largest entry, logits and
hidden states 3e-2 of the largest entry, the loss 2e-2 and each gradient
leaf 3e-2 of its own largest entry (as ``tests/test_torch_train_step.py``).
The CLI's training run against JAX's Trainer: 4 Adam steps, so the
epoch's losses to 1e-4 and parameters to 1e-4 (the train-step tolerance
after several steps). That run and the checkpoints it writes (both
ways) are ``-m slow``: JAX's Trainer compiles for 15-20 s of worker
time.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.data.loader import (
    DeviceLoader as JaxLoader,
)
from distributed_pytorch_example_tpu.data.synthetic import (
    SyntheticTokenDataset as JaxTokenData,
)
from distributed_pytorch_example_tpu.models import llama as jax_llama
from distributed_pytorch_example_tpu.ops import rope as jax_rope
from distributed_pytorch_example_tpu.train import checkpoint as jax_ckpt
from distributed_pytorch_example_tpu.train import loop as jax_loop
from distributed_pytorch_example_tpu.train import optimizers as jax_opt
from distributed_pytorch_example_tpu.train import tasks as jax_tasks
from distributed_pytorch_example_tpu.train.state import TrainState as JaxState
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models import (
    Llama,
    RMSNorm,
    SwiGluMlp,
    get_model,
)
from distributed_pytorch_example_tpu_torch.ops.rope import rope
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    TrainState,
    cli,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train.state import (
    to_host,
    to_numpy,
)

torch.set_num_threads(2)

KW = dict(vocab_size=256, max_len=128, model_dim=64, num_layers=2,
          num_heads=4, num_kv_heads=2, mlp_dim=128)
SEQ, BATCH = 32, 2
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# float32: absolute; bfloat16: relative to the largest entry
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _np(tree):
    return to_numpy(to_host(tree))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(dtype="float32", mode="full", **kw):
    tdt, jdt = DTYPES[dtype]
    model = Llama(**{**KW, **kw}, dtype=tdt, logits_mode=mode, device="cpu",
                  seed=0)
    jmodel = jax_llama.Llama(**{**KW, **kw}, dtype=jdt, logits_mode=mode,
                             use_flash=False)
    return model, jmodel, _np(interop.params_to_flax(model))


def _tokens(seed=0, n=BATCH, seq=SEQ, vocab=KW["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab,
                                                (n, seq)).astype(np.int32)


def _close(got, want, dtype, what="", tol=TOL, relative=False):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = relative or dtype == "bfloat16"
    atol = tol[dtype] * (np.abs(want).max() if scale else 1)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


# -- (a) the pieces ----------------------------------------------------------


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("form", ["shared", "per-row"])
def test_rope_matches_jax(form, dtype, theta):
    """(S,) positions shared across the batch, and (B, S) per-row offsets
    (the paged path's ``row_lens + arange(seq)``), at LLaMA's theta and at
    a long-context one."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, 4, 64)).astype(np.float32)
    if form == "shared":
        pos = np.arange(100, 116)
    else:
        pos = np.array([0, 37, 1000])[:, None] + np.arange(16)
    want = np.asarray(jax_rope.rope(jnp.asarray(x, jdt), jnp.asarray(pos),
                                    theta=theta), np.float32)
    got = rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), theta)
    assert got.dtype == tdt
    tol = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
    _close(got, want, dtype, form, tol)
    if form == "shared":  # positions=None is arange(S)
        want0 = jax_rope.rope(jnp.asarray(x, jdt), theta=theta)
        _close(rope(torch.from_numpy(x).to(tdt), theta=theta), want0, dtype,
               "default", tol)


PIECE_TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _piece_input():
    rng = np.random.default_rng(2)
    return (3 * rng.standard_normal((2, 8, 64))).astype(np.float32), rng


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_matches_flax(dtype):
    tdt, jdt = DTYPES[dtype]
    x, rng = _piece_input()
    norm = RMSNorm(64, dtype=tdt)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(
            rng.standard_normal(64).astype(np.float32)))
    want = jax_llama.RMSNorm(1e-5, jdt).apply(
        {"params": {"scale": norm.scale.detach().numpy()}},
        jnp.asarray(x, jdt))
    with torch.no_grad():
        got = norm(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _close(got, want, dtype, "RMSNorm", PIECE_TOL, relative=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_swiglu_matches_flax(dtype):
    tdt, jdt = DTYPES[dtype]
    x, _ = _piece_input()
    mlp = SwiGluMlp(128, 64, tdt)
    mlp.reset_parameters(torch.Generator().manual_seed(3))
    params = {name: {"kernel": lin.weight.detach().numpy().T}
              for name, lin in (("gate", mlp.gate), ("up", mlp.up),
                                ("down", mlp.down))}
    want = jax_llama.SwiGluMlp(128, 64, jdt).apply({"params": params},
                                                   jnp.asarray(x, jdt))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _close(got, want, dtype, "SwiGLU", PIECE_TOL, relative=True)


# -- (b) the model -----------------------------------------------------------


def test_param_tree_is_flax_and_round_trips_bit_exactly():
    model, jmodel, params = _pair()
    want = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape
    # GQA: k and v project to 2 of 4 heads; the head is untied (D, V)
    assert params["layer_0"]["attn"]["k"]["kernel"].shape == (64, 32)
    assert params["lm_head"].shape == (64, 256)
    other = Llama(**KW, device="cpu", seed=3)
    interop.params_from_flax(other, params)
    back = _np(interop.params_to_flax(other))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_logits_and_hidden_states_match_jax(dtype):
    tokens = _tokens()
    for mode in ("full", "hidden"):
        model, jmodel, params = _pair(dtype, mode)
        want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(tokens))
        with torch.no_grad():
            got = model(torch.from_numpy(tokens).long())
        assert got.dtype == (torch.float32 if mode == "full"
                             else DTYPES[dtype][0])
        assert got.shape == want.shape
        _close(got, want, dtype, mode)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunked_loss_and_gradients_match_jax(dtype):
    """The fused loss (chunked CE against the untied, bias-free head) and
    every gradient leaf against ``jax.grad`` of JAX's CausalLMTask."""
    model, jmodel, params = _pair(dtype, "hidden")
    tokens = _tokens(4)
    jtask = jax_tasks.CausalLMTask()
    batch = {"tokens": jnp.asarray(tokens)}
    (jl, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtask.compute_loss(jmodel, p, {}, batch, jax.random.key(0),
                                     train=True)[:2], has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    loss, _ = CausalLMTask().compute_loss(
        model, {"tokens": torch.from_numpy(tokens)}, train=True)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_TOL[dtype]
    got = _leaves(_np(interop.params_to_flax(model, interop.grads_of(model))))
    want = _leaves(jgrads)
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        scale = (max(float(np.abs(want[key]).max()), 1e-3)
                 if dtype == "bfloat16" else 1.0)
        err = float(np.abs(leaf - want[key]).max())
        assert err <= GRAD_TOL[dtype] * scale, f"grad{key}: off by {err:.3e}"


@pytest.mark.parametrize("kw", [
    dict(moe_experts=4), dict(pipe_axis="pipe"),
    dict(paged_verify=True, decode=True)], ids=["moe", "pipe", "verify"])
def test_refused_options_point_at_the_roadmap(kw):
    if kw.get("paged_verify"):
        # the verify chunk is ported; a verify call without the paged pool
        # it writes to is refused
        model = Llama(**KW, **kw, device="cpu")
        model.init_cache(1, 8)
        with pytest.raises(ValueError, match="paged pool"):
            model(torch.zeros((1, 4), dtype=torch.long))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Llama(**KW, **kw, device="cpu")


# -- (c) the CLI: a short fit against JAX's Trainer, checkpoints both ways ---

# the CLI's LLaMA at a small width and one layer (JAX compiles each layer:
# the tests above hold two), with LLaMA's own vocabulary (32000: the CLI's
# synthetic tokens) and the CLI's defaults otherwise
CLI_KW = dict(model_dim=64, num_layers=1, num_heads=4, num_kv_heads=2,
              mlp_dim=128)
CLI_ARGS = ["--model", "llama", "--dataset", "synthetic-tokens",
            "--seq-len", "32", "--num-samples", "16", "--batch-size", "4",
            "--log-every", "100", "--device", "cpu"]
FIT_TOL = 1e-4


def _small_llama(monkeypatch):
    def small(name, **kw):
        return get_model(name, **{**kw, **CLI_KW})
    monkeypatch.setattr(cli, "get_model", small)


def _epochs(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _jax_trainer(params, ckdir):
    jmodel = jax_llama.Llama(vocab_size=32000, **CLI_KW,
                             logits_mode="hidden")
    jt = jax_loop.Trainer(jmodel, jax_tasks.CausalLMTask(),
                          jax_opt.make_optimizer("adam", 1e-3),
                          telemetry=False, log_every=100,
                          checkpoint_dir=ckdir)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jt.state = JaxState(step=jnp.zeros((), jnp.int32), params=jp,
                        opt_state=jt.optimizer.init(jp), model_state={},
                        rng=jax.random.key(0))
    return jt


def _jax_loaders():
    data = dict(seq_len=32, vocab_size=32000)
    return (JaxLoader(JaxTokenData(seed=0, num_samples=16, **data), 4,
                      seed=0),
            JaxLoader(JaxTokenData(seed=1, num_samples=4, **data), 4,
                      shuffle=False, seed=0))


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The port's CLI trains one epoch; JAX's Trainer trains the same
    epoch from the same weights; each package then resumes the other's
    file for a second epoch."""
    root = tmp_path_factory.mktemp("llama")
    mp = pytest.MonkeyPatch()
    _small_llama(mp)
    try:
        port_dir = str(root / "port")
        assert cli.main(CLI_ARGS + ["--epochs", "1",
                                    "--checkpoint-dir", port_dir]) == 0
        port_file = str(root / "port_epoch1.ckpt")
        shutil.copy(os.path.join(port_dir, ckpt.LATEST_NAME), port_file)
        port_epochs = _epochs(os.path.join(port_dir, "metrics.jsonl"))

        start = Llama(vocab_size=32000, **CLI_KW, device="cpu", seed=0)
        jt = _jax_trainer(_np(interop.params_to_flax(start)),
                          str(root / "jax"))
        jhist = jt.fit(*_jax_loaders(), epochs=1)
        jax_file = str(root / "jax_epoch1.ckpt")
        shutil.copy(root / "jax" / ckpt.LATEST_NAME, jax_file)
        jax_params = jax.tree_util.tree_map(np.asarray, jt.state.params)

        # JAX resumes the port's file; the port's CLI resumes JAX's
        jt.checkpoint_dir = str(root / "jax2")
        jhist2 = jt.fit(*_jax_loaders(), epochs=2, resume=port_file)
        resumed_dir = str(root / "port2")
        assert cli.main(CLI_ARGS + ["--epochs", "2", "--checkpoint-dir",
                                    resumed_dir, "--resume", jax_file]) == 0
        port_epochs2 = _epochs(os.path.join(resumed_dir, "metrics.jsonl"))
    finally:
        mp.undo()
    return dict(port_file=port_file, port_epochs=port_epochs, jhist=jhist,
                jax_params=jax_params, jhist2=jhist2,
                port_epochs2=port_epochs2)


def _port_state(seed):
    model = Llama(vocab_size=32000, **CLI_KW, device="cpu", seed=seed)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model, "adam", 1e-3))


def _assert_close_to_jax(params, want, what):
    got, want = _leaves(params), _leaves(want)
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        err = float(np.abs(leaf - want[key]).max())
        assert err <= FIT_TOL, f"{what}{key}: off by {err:.3e}"


@pytest.mark.slow  # JAX's Trainer compiles: ~15-20 s of worker time
def test_cli_fit_matches_jax_trainer(cross):
    """One epoch of 4 steps and a validation pass through the CLI against
    JAX's Trainer on the same weights and batches: the epoch's losses, and
    the parameters in the port's checkpoint, leaf by leaf."""
    (port,), (jax_epoch,) = cross["port_epochs"], cross["jhist"]
    assert abs(port["train_loss"] - jax_epoch["train_loss"]) <= FIT_TOL
    assert abs(port["val_loss"] - jax_epoch["val_loss"]) <= FIT_TOL
    state = _port_state(5)  # other weights: the file must win
    _, epoch, _ = ckpt.load_checkpoint(cross["port_file"], state)
    assert epoch == 1 and state.step == 4
    _assert_close_to_jax(_np(interop.params_to_flax(state.model)),
                         cross["jax_params"], "param")


@pytest.mark.slow  # shares the fixture above
def test_checkpoints_resume_across_the_packages(cross):
    """JAX's file resumed by the port's CLI, and the port's by JAX's
    Trainer: the second epochs follow each other (the two files differ
    only by the first epoch's rounding); JAX's load_checkpoint takes the
    port's file whole, optax state included."""
    (port2,), (jax2,) = cross["port_epochs2"], cross["jhist2"]
    assert port2["epoch"] == jax2["epoch"] == 1
    assert abs(port2["train_loss"] - jax2["train_loss"]) <= FIT_TOL
    assert abs(port2["val_loss"] - jax2["val_loss"]) <= FIT_TOL
    other = _np(interop.params_to_flax(_port_state(9).model))
    state, epoch, _ = jax_ckpt.load_checkpoint(
        cross["port_file"], _jax_trainer(other, None).state)
    assert epoch == 1 and int(state.step) == 4
    _assert_close_to_jax(jax.tree_util.tree_map(np.asarray, state.params),
                         cross["jax_params"], "param")
    mu = state.opt_state[0].mu
    assert mu["lm_head"].shape == (64, 32000)


def test_cli_builds_the_jax_packages_llama(monkeypatch):
    """``--model llama-tiny`` (the JAX CLI's other name for ``llama``) at
    the JAX defaults (built on the meta device: no weights are drawn): the
    same parameter count as JAX's, vocab 32000, the fused loss's hidden
    states, sequence lengths up to 2048."""
    name = "llama-tiny"
    monkeypatch.setattr(Llama, "reset_parameters", lambda self, g: None)
    args = cli.build_parser().parse_args(
        ["--model", name, "--dataset", "synthetic-tokens", "--seq-len",
         "2048", "--remat"])
    model = cli.build_model(args, torch.device("meta"))
    assert isinstance(model, Llama) and model.remat
    assert (model.vocab_size, model.max_len, model.num_kv_heads,
            model.logits_mode) == (32000, 2048, 4, "hidden")
    want = jax.eval_shape(lambda: jax_llama.Llama().init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))
    assert model.layers[0].attn.k.weight.shape == (256, 768)
    assert isinstance(cli.build_task(args, model), CausalLMTask)
    assert cli.build_dataset(args, 2, seed=0).vocab_size == 32000
    with pytest.raises(SystemExit):
        cli.main(["--model", name, "--dataset", "synthetic-tokens",
                  "--seq-len", "2049", "--device", "cpu"])
