"""The port's ZeRO-1 / wire train step at world 2 on the CPU, against the
port's replicated step and the JAX package's replicated step on the same
global batch.

One pair of gloo processes serves the whole module: a module-scoped fixture
runs every case in it and returns numpy results, and the tests below
compare them case by case. Each case starts from the same seed-0 GPT-2 (2
layers, width 32; the ZeRO-1 floor lowered to 256 elements so that both
sharded and replicated leaves occur) and takes its steps on the global
batches of 4 rows, 2 per rank.

Tolerances:

- SGD (momentum 0.9), 2 steps, parameters to 1e-6 of both replicated
  steps: the runs differ only in how the gradient mean is rounded (two
  local means summed against one mean over all rows; with two ranks the
  sum itself is exact in either order), and SGD is linear in the gradient.
- Adam, 2 steps: 1e-6 too, except entries whose reference gradient is
  below 1e-5 at either step, where Adam's normalised update may follow
  rounding noise: 2 * lr per step (the bound of test_torch_train_step.py).
- ``grad_accum_steps=2`` against one batch of the same rows: 1e-6 (the
  microbatch means are summed, then scaled by 1 / (D * N)).
- int8-block wire: each synced gradient within the JAX wire tests' bound,
  ``n_reduce * amax * 1.02 / 127`` for a reduce-scattered leaf and twice
  that for an all-reduced one (a second quantized pass), times the 1 / D
  mean, with ``amax`` the largest local gradient of either rank.
- A bf16 parameter gather on top: after one step, exactly the float32
  gather's parameters rounded to bf16.

The pair also runs the checkpoint cases of ``tests/test_torch_resume.py``
(:func:`_checkpoint_cases`): a gathered ZeRO-1 save, and resumes that flip
the mode between replicated and ZeRO-1.
"""

import functools
import multiprocessing
import os
import pickle
import shutil
import socket
import tempfile

import filelock
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu.train import optimizers as jax_opt
from distributed_pytorch_example_tpu.train import step as jax_step
from distributed_pytorch_example_tpu.train import tasks as jax_tasks
from distributed_pytorch_example_tpu.train.state import TrainState as JaxState
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.models import GPT2
from distributed_pytorch_example_tpu_torch.parallel import (
    WireConfig,
    data_parallel,
)
from distributed_pytorch_example_tpu_torch.parallel.wire import (
    _scatter_parts,
    _unscatter,
)
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    Trainer,
    TrainState,
    build_train_step,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train.state import to_host, to_numpy

torch.set_num_threads(2)

WORLD = 2
TIMEOUT_S = 120
KW = dict(vocab_size=97, max_len=16, model_dim=32, num_layers=2,
          num_heads=2, mlp_dim=64)
SEQ, GLOBAL_BATCH, STEPS = 16, 4, 2
LR = {"sgd": 0.1, "adam": 1e-3}
MIN_SHARD = 256  # the ZeRO-1 floor at this width
INT8 = dict(compress="int8-block", block_size=64, min_size=1)
STEP_BOUND = 1.02 / 127.0

# case -> (optimizer, grad_accum_steps, WireConfig kwargs)
CASES = {
    "sgd-inline": ("sgd", 1, {}),
    "sgd-bucketed": ("sgd", 1, dict(bucket_bytes=2048)),
    "adam-inline": ("adam", 1, {}),
    "adam-bucketed": ("adam", 1, dict(bucket_bytes=2048)),
    "sgd-accum2": ("sgd", 2, dict(bucket_bytes=2048)),
    "sgd-int8": ("sgd", 1, dict(bucket_bytes=2048, **INT8)),
    "sgd-int8-bf16": ("sgd", 1, dict(bucket_bytes=2048, param_gather="bf16",
                                     **INT8)),
    "sgd-int8-inline": ("sgd", 1, INT8),
    # optax.MultiSteps (the CLI's --grad-accum): the update every 2nd step,
    # with the accumulated mean clipped by its global norm across ranks
    "sgd-every2-clip": ("sgd", 1, dict(bucket_bytes=2048)),
}
# optimizer options beyond the name and learning rate, by case
OPT_KW = {"sgd-every2-clip": dict(every_k=2, grad_clip_norm=0.05)}


def _batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, KW["vocab_size"], (GLOBAL_BATCH, SEQ)).astype(
        np.int32) for _ in range(STEPS)]


def _local(tokens, rank, world):
    per = tokens.shape[0] // world
    return {"tokens": torch.from_numpy(tokens[rank * per:(rank + 1) * per])}


def _params(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _run_case(name, rank, world, partitioned=True):
    """Steps of one case; parameters after each step, and the first step's
    synced gradients by JAX path (this rank's tile for a sharded leaf)."""
    opt, accum, wire_kw = CASES[name]
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    optimizer = make_optimizer(model.parameters(), opt, LR[opt],
                               **OPT_KW.get(name, {}))
    part = None
    if partitioned:
        part = data_parallel(world, dp_shard_opt_state=True,
                             opt_shard_min_size=MIN_SHARD,
                             wire=WireConfig(**wire_kw))
    step = build_train_step(CausalLMTask(), partitioner=part,
                            grad_accum_steps=accum)
    state = TrainState(step=0, model=model, optimizer=optimizer)
    params, losses, synced = [], [], {}
    for i, tokens in enumerate(_batches()):
        metrics = step(state, _local(tokens, rank, world))
        losses.append(float(metrics["loss"]))
        params.append(_params(model))
        if i == 0 and partitioned:
            update = step.sharded(state)
            for leaf, p, tile in zip(update.leaves, update.params,
                                     update.tiles):
                g = tile.grad if tile is not None else leaf.to_jax(p.grad)
                synced[leaf.key] = g.detach().numpy().copy()
    return {"params": params, "losses": losses, "synced": synced,
            "dims": step.sharded(state).dims if partitioned else None}


def _fit(rank, world):
    """Trainer.fit, one epoch of 2 steps over a loader sharded across the
    processes: ZeRO-1, bucketed, 2 microbatches per step at world 2; the
    replicated step at world 1."""
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    part = data_parallel(world, dp_shard_opt_state=True,
                         opt_shard_min_size=MIN_SHARD,
                         wire=WireConfig(bucket_bytes=2048))
    trainer = Trainer(model, CausalLMTask(),
                      make_optimizer(model.parameters(), "sgd", LR["sgd"]),
                      partitioner=part if world > 1 else None, log_every=1,
                      grad_accum_steps=2 if world > 1 else 1)
    loader = DeviceLoader(SyntheticTokenDataset(8, seq_len=SEQ,
                                                vocab_size=KW["vocab_size"],
                                                seed=0),
                          GLOBAL_BATCH, device="cpu", num_shards=world,
                          shard_id=rank, prefetch=0)
    history = trainer.fit(loader, None, epochs=1)
    return {"train_loss": history[0]["train_loss"], "params": _params(model)}


def _nan_on_rank_1(rank, world):
    """One bucketed ZeRO-1 step in which rank 1 alone adds NaN to one
    gradient element of a sharded leaf, inside its own tile: each rank's
    bad_step, whether its own tile saw the NaN, and whether its parameters
    stayed as they were."""
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    part = data_parallel(world, dp_shard_opt_state=True,
                         opt_shard_min_size=MIN_SHARD,
                         wire=WireConfig(bucket_bytes=2048))
    step = build_train_step(CausalLMTask(), partitioner=part)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters(), "sgd",
                                                LR["sgd"]))
    update = step.sharded(state)
    i = next(i for i, d in enumerate(update.dims) if d is not None)
    leaf, param, dim = update.leaves[i], update.params[i], update.dims[i]
    rows, chunk_shape = _scatter_parts(torch.zeros(leaf.to_jax(param).shape),
                                       dim, world)
    rows = rows.clone()
    rows[1, 0] = float("nan")
    poison = leaf.from_jax(_unscatter(rows, dim, chunk_shape))
    if rank == 1:
        param.register_hook(lambda g: g + poison)
    before = _params(model)
    metrics = step(state, _local(_batches()[0], rank, world))
    after = _params(model)
    return {"bad_step": float(metrics["bad_step"]),
            "tile_has_nan": bool(update.tiles[i].grad.isnan().any()),
            "unchanged": all(np.array_equal(after[k], v)
                             for k, v in before.items())}


CKPT_EPOCHS = 3


def _ckpt_trainer(zero1, checkpoint_dir, world):
    """Adam on the seed-0 GPT-2 through Trainer.fit, ZeRO-1 or replicated
    across the processes, recording each step's loss."""
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    part = (data_parallel(world, dp_shard_opt_state=True,
                          opt_shard_min_size=MIN_SHARD) if zero1 else None)
    trainer = Trainer(model, CausalLMTask(),
                      make_optimizer(model.parameters(), "adam", LR["adam"]),
                      partitioner=part, checkpoint_dir=checkpoint_dir,
                      log_every=1)
    losses, step_fn = [], trainer.train_step

    def step(state, batch):
        metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        return metrics

    trainer.train_step = step
    return trainer, losses


def ckpt_loader(rank, world):
    """8 sequences, global batch 4: 2 steps an epoch, sharded by rank."""
    return DeviceLoader(SyntheticTokenDataset(8, seq_len=SEQ,
                                              vocab_size=KW["vocab_size"],
                                              seed=0),
                        GLOBAL_BATCH, device="cpu", num_shards=world,
                        shard_id=rank, prefetch=0)


def _checkpoint_cases(rank, world, port):
    """A ZeRO-1 epoch saved gathered (rank 0 returns the file's bytes); an
    uninterrupted replicated run of CKPT_EPOCHS epochs; and the same run
    resumed twice with the mode flipped: replicated epoch 0, ZeRO-1 epoch
    1, replicated epoch 2."""
    root = os.path.join(tempfile.gettempdir(), f"test_torch_zero1_{port}")
    latest = "latest_model.ckpt"
    zero1, _ = _ckpt_trainer(True, os.path.join(root, "zero1"), world)
    zero1.fit(ckpt_loader(rank, world), None, epochs=1)
    blob = None
    if rank == 0:
        with open(os.path.join(root, "zero1", latest), "rb") as f:
            blob = f.read()
    ref, ref_losses = _ckpt_trainer(False, None, world)
    ref.fit(ckpt_loader(rank, world), None, epochs=CKPT_EPOCHS)
    first, _ = _ckpt_trainer(False, os.path.join(root, "rep"), world)
    first.fit(ckpt_loader(rank, world), None, epochs=1)
    flip, flip_losses = _ckpt_trainer(True, os.path.join(root, "flip"),
                                      world)
    flip.fit(ckpt_loader(rank, world), None, epochs=2,
             resume=os.path.join(root, "rep", latest))
    back, back_losses = _ckpt_trainer(False, os.path.join(root, "back"),
                                      world)
    back.fit(ckpt_loader(rank, world), None, epochs=CKPT_EPOCHS,
             resume=os.path.join(root, "flip", latest))
    distributed.barrier()
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    return {"zero1_file": blob, "replicated_epoch0": _params(first.model),
            "ref_losses": ref_losses, "ref_params": _params(ref.model),
            "flip_losses": flip_losses + back_losses,
            "flip_steps": [flip.state.step, back.state.step],
            "flip_params": _params(back.model)}


def _worker(rank, port, results):
    torch.set_num_threads(1)
    config = distributed.DistributedConfig(WORLD, rank, f"localhost:{port}")
    distributed.initialize(config, device="cpu", max_attempts=2)
    try:
        out = {name: _run_case(name, rank, WORLD) for name in CASES}
        out["fit"] = _fit(rank, WORLD)
        out["nan-on-rank-1"] = _nan_on_rank_1(rank, WORLD)
        out["checkpoint"] = _checkpoint_cases(rank, WORLD, port)
        results.put((rank, out))
    finally:
        distributed.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_pair():
    """Every case in one pair of gloo processes; numpy results by rank."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, out = results.get(timeout=TIMEOUT_S)
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=TIMEOUT_S)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return got


@pytest.fixture(scope="module")
def zero1_results(tmp_path_factory):
    """The pair runs once per test run: under pytest-xdist the first worker
    to get here spawns it and leaves the results for the others, in the
    run's shared temporary directory."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _spawn_pair()
    path = tmp_path_factory.getbasetemp().parent / "test_torch_zero1.pkl"
    with filelock.FileLock(f"{path}.lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        got = _spawn_pair()
        path.write_bytes(pickle.dumps(got))
        return got


@functools.lru_cache(maxsize=None)
def _replicated(opt, **opt_kw):
    """The port's replicated step, one process on the global batches:
    parameters after each step and each step's gradients."""
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters(), opt,
                                                LR[opt], **opt_kw))
    step = build_train_step(CausalLMTask())
    params, grads = [], []
    for tokens in _batches():
        step(state, {"tokens": torch.from_numpy(tokens)})
        params.append(_params(model))
        grads.append({k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()})
    return params, grads


def _np(tree):
    """A flax tree of tensor views (``interop.params_to_flax``) as numpy
    copies."""
    return to_numpy(to_host(tree))


@functools.lru_cache(maxsize=None)
def _jax_replicated(opt, **opt_kw):
    """The JAX package's replicated step on the same weights and global
    batches: parameters after each step, under the port's names."""
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    jmodel = JaxGPT2(**KW, logits_mode="hidden")
    joptim = jax_opt.make_optimizer(opt, LR[opt], **opt_kw)
    jparams = jax.tree_util.tree_map(
        jnp.asarray, _np(interop.params_to_flax(model)))
    state = JaxState(step=jnp.zeros((), jnp.int32), params=jparams,
                     opt_state=joptim.init(jparams), model_state={},
                     rng=jax.random.key(0))
    step = jax_step.build_train_step(jmodel, jax_tasks.CausalLMTask(), joptim,
                                     sentinels=False)
    params = []
    for tokens in _batches():
        state, _ = step(state, {"tokens": jnp.asarray(tokens)})
        interop.params_from_flax(
            model, jax.tree_util.tree_map(np.asarray, state.params))
        params.append({k: v.detach().numpy().copy()
                       for k, v in model.named_parameters()})
    return params


def _assert_params_close(got, want, atol, what, grads=None, lr=0.0):
    for key, value in want.items():
        tol = np.full(value.shape, atol, np.float32)
        if grads is not None:  # Adam on a noise-level gradient
            small = np.zeros(value.shape, bool)
            for g in grads:
                small |= np.abs(g[key]) < 1e-5
            tol[small] = max(atol, 2 * lr * len(grads))
        err = np.abs(got[key] - value)
        assert (err <= tol).all(), (
            f"{what} {key}: off by up to {err.max():.3e}")


@pytest.mark.parametrize("name", ["sgd-inline", "sgd-bucketed",
                                  "adam-inline", "adam-bucketed",
                                  "sgd-every2-clip"])
@pytest.mark.parametrize("reference", ["port", "jax"])
def test_zero1_step_matches_the_replicated_step(zero1_results, name,
                                                reference):
    opt = CASES[name][0]
    ref_params, ref_grads = _replicated(opt, **OPT_KW.get(name, {}))
    if reference == "jax":
        ref_params = _jax_replicated(opt, **OPT_KW.get(name, {}))
    small = ref_grads if opt == "adam" else None
    for rank in range(WORLD):
        got = zero1_results[rank][name]
        for i in range(STEPS):
            _assert_params_close(got["params"][i], ref_params[i], 1e-6,
                                 f"{name} rank {rank} step {i + 1} vs "
                                 f"{reference}", grads=small and
                                 ref_grads[:i + 1], lr=LR[opt])


def test_zero1_shards_some_leaves_and_replicates_the_rest(zero1_results):
    dims = zero1_results[0]["sgd-inline"]["dims"]
    assert any(d is not None for d in dims) and None in dims
    # every rank's tile of a sharded leaf is 1 / WORLD of it
    synced = [zero1_results[r]["sgd-inline"]["synced"] for r in range(WORLD)]
    model = GPT2(**KW, device="cpu", seed=0)
    named = dict(model.named_parameters())
    for leaf, dim in zip(interop.flax_leaves(model), dims):
        full = leaf.to_jax(named[leaf.name]).numel()
        for s in synced:
            assert s[leaf.key].size == (full // WORLD if dim is not None
                                        else full), leaf.key


@pytest.mark.parametrize("rank", range(WORLD))
def test_grad_accum_two_microbatches_equal_one_batch(zero1_results, rank):
    got = zero1_results[rank]["sgd-accum2"]
    want = zero1_results[rank]["sgd-bucketed"]
    for i in range(STEPS):
        _assert_params_close(got["params"][i], want["params"][i], 1e-6,
                             f"accum2 rank {rank} step {i + 1}")
        assert abs(got["losses"][i] - want["losses"][i]) <= 1e-6


def _local_amax():
    """The largest local gradient entry of either rank, first step."""
    amax = 0.0
    tokens = _batches()[0]
    for rank in range(WORLD):
        model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
        loss, _ = CausalLMTask().compute_loss(
            model, _local(tokens, rank, WORLD), train=True)
        loss.backward()
        amax = max(amax, max(p.grad.abs().max().item()
                             for p in model.parameters()))
    return amax


@pytest.mark.parametrize("name,fp32", [("sgd-int8", "sgd-bucketed"),
                                       ("sgd-int8-inline", "sgd-inline")])
def test_int8_wire_gradients_within_the_quantization_bound(zero1_results,
                                                           name, fp32):
    amax = _local_amax()
    dims = zero1_results[0][fp32]["dims"]
    worst = 0.0
    for rank in range(WORLD):
        got = zero1_results[rank][name]["synced"]
        want = zero1_results[rank][fp32]["synced"]
        for dim, key in zip(dims, want):
            passes = 1 if dim is not None else 2
            bound = passes * WORLD * amax * STEP_BOUND / WORLD
            err = np.abs(got[key] - want[key]).max()
            assert err <= bound, (name, rank, key, err, bound)
            worst = max(worst, err)
    assert worst > 0.0  # it really quantized


def test_bf16_parameter_gather_rounds_only_the_gathered_leaves(
        zero1_results):
    """After one step (same gradients) the bf16 gather's parameters are the
    float32 gather's rounded to bf16 on the sharded leaves and equal to
    them on the replicated ones, bit for bit; from then on the rounded
    parameters are the master weights, as in JAX, so the runs part."""
    model = GPT2(**KW, device="cpu", seed=0)
    dims = zero1_results[0]["sgd-int8"]["dims"]
    sharded = {leaf.name: dim is not None
               for leaf, dim in zip(interop.flax_leaves(model), dims)}
    assert any(sharded.values()) and not all(sharded.values())
    for rank in range(WORLD):
        got = zero1_results[rank]["sgd-int8-bf16"]["params"][0]
        want = zero1_results[rank]["sgd-int8"]["params"][0]
        for key, value in want.items():
            if sharded[key]:
                value = torch.from_numpy(value).to(torch.bfloat16).float()
                value = value.numpy()
            np.testing.assert_array_equal(got[key], value,
                                          err_msg=f"rank {rank} {key}")


def test_trainer_fit_zero1_with_accumulation_matches_one_process(
        zero1_results):
    want = _fit(0, 1)
    for rank in range(WORLD):
        got = zero1_results[rank]["fit"]
        assert abs(got["train_loss"] - want["train_loss"]) <= 1e-6
        _assert_params_close(got["params"], want["params"], 1e-6,
                             f"fit rank {rank}")


def test_a_nan_on_one_rank_skips_the_step_on_every_rank(zero1_results):
    """The non-finite count is summed across ranks: rank 0's own tile is
    finite, yet it skips with rank 1, and neither changes a parameter."""
    got = [zero1_results[r]["nan-on-rank-1"] for r in range(WORLD)]
    assert [g["tile_has_nan"] for g in got] == [False, True]
    for rank, g in enumerate(got):
        assert g["bad_step"] == 1.0 and g["unchanged"], (rank, g)


@pytest.mark.parametrize("env,cards,backend", [
    ({}, 1, "gloo"),                          # two ranks share one card
    ({}, 2, "nccl"),                          # a card each
    ({"LOCAL_WORLD_SIZE": "4"}, 2, "gloo"),   # four ranks, two cards
    ({"LOCAL_WORLD_SIZE": "1"}, 1, "nccl"),   # one rank per host
])
def test_backend_is_nccl_only_when_every_rank_has_its_own_card(
        monkeypatch, env, cards, backend):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    config = distributed.DistributedConfig(2, 0, "127.0.0.1:29500")
    assert distributed.choose_backend(torch.device("cuda"), config,
                                      env) == backend
    assert distributed.choose_backend(torch.device("cpu"), config,
                                      env) == "gloo"


def test_every_k_holds_the_update_until_the_kth_step(zero1_results):
    """With every_k=2 the first step changes no parameter (on any rank);
    the second applies the clipped mean of both steps' gradients, taken at
    the unchanged parameters: SGD's first update is lr * g, and clipping
    scales g to the clip norm, so ||delta p|| = lr * 0.05 (the mean's norm
    is above 0.05, so clipping was active)."""
    start = _params(GPT2(**KW, logits_mode="hidden", device="cpu", seed=0))
    clip = OPT_KW["sgd-every2-clip"]["grad_clip_norm"]
    mean_sq = 0.0
    grads = []
    for tokens in _batches():
        model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
        loss, _ = CausalLMTask().compute_loss(
            model, {"tokens": torch.from_numpy(tokens)}, train=True)
        loss.backward()
        grads.append([p.grad for p in model.parameters()])
    mean_sq = sum(float(((a + b) / 2).square().sum())
                  for a, b in zip(*grads))
    assert mean_sq ** 0.5 > clip
    for rank in range(WORLD):
        got = zero1_results[rank]["sgd-every2-clip"]["params"]
        for key, value in start.items():
            np.testing.assert_array_equal(got[0][key], value)
        moved = sum(float(np.square(got[1][k] - v, dtype=np.float64).sum())
                    for k, v in start.items()) ** 0.5
        assert abs(moved - LR["sgd"] * clip) <= 1e-4 * LR["sgd"] * clip
