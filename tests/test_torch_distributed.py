"""The port's data parallelism on the CPU: two gloo processes, each on its
half of the global batch, against one process on the whole batch; and the
topology contract of runtime/distributed.py.

After one SGD step the parameters agree to 1e-6: the two runs differ only
in how the gradient sum is ordered (an all-reduce of two local means
against one mean over all rows). SGD, not Adam, keeps the update linear
in the gradient, so rounding is not amplified.
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.models import GPT2
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    TrainState,
    build_train_step,
    make_optimizer,
)

KW = dict(vocab_size=97, max_len=16, model_dim=32, num_layers=1,
          num_heads=2, mlp_dim=64)
GLOBAL_BATCH = 4
TIMEOUT_S = 120


def _one_step(world: int, rank: int):
    torch.set_num_threads(1)
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    optimizer = make_optimizer(model.parameters(), "sgd", 0.1)
    loader = DeviceLoader(SyntheticTokenDataset(8, seq_len=16, vocab_size=97,
                                                seed=0),
                          GLOBAL_BATCH, device="cpu", num_shards=world,
                          shard_id=rank, prefetch=0)
    batch = next(iter(loader))
    state = TrainState(step=0, model=model, optimizer=optimizer)
    metrics = build_train_step(CausalLMTask())(state, batch)
    # numpy, not tensors: a tensor sent through a queue shares memory with
    # a process that exits right after
    return ({k: v.numpy().copy() for k, v in model.state_dict().items()},
            float(metrics["loss"]))


def _worker(rank: int, world: int, port: int, results) -> None:
    config = distributed.DistributedConfig(world, rank, f"localhost:{port}")
    distributed.initialize(config, device="cpu", max_attempts=2)
    try:
        assert distributed.process_count() == world
        assert distributed.process_index() == rank
        results.put((rank, _one_step(world, rank)))
    finally:
        distributed.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_equal_one_process_on_the_global_batch():
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, 2, port, results))
             for r in range(2)]
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
    want_params, want_loss = _one_step(1, 0)
    for rank in (0, 1):
        params, loss = got[rank]
        assert abs(loss - want_loss) <= 1e-6
        for key, value in want_params.items():
            np.testing.assert_allclose(params[key], value, atol=1e-6, rtol=0,
                                       err_msg=f"rank {rank} {key}")


def test_topology_from_the_environment():
    assert distributed.resolve_config({}) == distributed.DistributedConfig(
        1, 0, None)
    cfg = distributed.resolve_config({"REPLICAS": "4", "HOSTNAME": "job-3",
                                      "NF_DISCOVERY_SERVICE": "svc"})
    assert cfg == distributed.DistributedConfig(4, 3, "job-0.svc:29500")
    cfg = distributed.resolve_config({"REPLICAS": "2", "PROCESS_ID": "1",
                                      "COORDINATOR_ADDRESS": "localhost",
                                      "COORDINATOR_PORT": "1234"})
    assert cfg == distributed.DistributedConfig(2, 1, "localhost:1234")
    assert distributed.derive_process_id("worker") == 0
    # one process: no rendezvous, no process group
    assert not distributed.initialize(device="cpu").is_distributed
    assert distributed.process_count() == 1 and distributed.is_coordinator()


def test_rendezvous_gives_up_after_bounded_retries(monkeypatch):
    calls = []

    def refuse(**kw):
        calls.append(kw)
        raise RuntimeError("connection refused")

    monkeypatch.setattr(distributed.dist, "init_process_group", refuse)
    monkeypatch.setenv("DPX_RENDEZVOUS_BACKOFF", "0")
    config = distributed.DistributedConfig(2, 0, "localhost:1")
    with pytest.raises(RuntimeError, match="refused"):
        distributed.initialize(config, device="cpu", max_attempts=3)
    assert len(calls) == 3
    assert calls[0]["init_method"] == "tcp://localhost:1"


# ---------------------------------------------------------------------------
# BatchNorm state and the masked LM's weighting at world 2
# ---------------------------------------------------------------------------
#
# One pair of gloo processes serves the cases below (a module-scoped
# fixture, shared across xdist workers through a file lock, as
# tests/test_torch_zero1.py does); each case starts from seed-0 weights and
# takes one SGD step (lr 0.1, so parameters move by 0.1 x the synced
# gradient) on its rank's half of a global batch of 4.
#
# Tolerances, float32 throughout:
# - global-batch BatchNorm against one process on the global batch: loss
#   1e-6, gradients and running statistics 1e-5 absolute (the statistics
#   are two partial sums all-reduced against one sum over all rows, and
#   batch normalisation divides by a standard deviation);
# - the manual path's averaged statistics against the mean of the halves'
#   one-process statistics: 1e-6 (one mean of two values apart);
# - the masked LM against JAX's replicated step on the global batch: loss
#   1e-5, accuracy 1e-4, gradients 2e-5 (tests/test_torch_bert.py's);
#   under ZeRO-1 parameters to 1e-6 of the per-shard mean's step;
# - GPT-2 and SimpleNet: bit for bit against the step as it was before
#   the masked LM's count was taken across processes.

import functools  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402

import filelock  # noqa: E402

from distributed_pytorch_example_tpu_torch import interop  # noqa: E402
from distributed_pytorch_example_tpu_torch.models import (  # noqa: E402
    BasicBlock,
    BertBase,
    ResNet,
    SimpleNet,
)
from distributed_pytorch_example_tpu_torch.models.batchnorm import (  # noqa: E402,E501
    running_stats,
)
from distributed_pytorch_example_tpu_torch.parallel import (  # noqa: E402
    data_parallel,
)
from distributed_pytorch_example_tpu_torch.train import (  # noqa: E402
    ClassificationTask,
)
from distributed_pytorch_example_tpu_torch.train.tasks import (  # noqa: E402
    MLMTask,
)

LR = 0.1
RESNET = dict(stage_sizes=(1, 1), block_cls=BasicBlock, num_classes=5,
              num_filters=8, small_inputs=True)
BERT = dict(vocab_size=128, max_len=16, model_dim=32, num_layers=2,
            num_heads=2, mlp_dim=64)
MASK_ID, MASK_RATE, PAD = 103, 0.5, 0


class GivenDraws(MLMTask):
    """The masked LM with this rank's draws given (JAX's own, made in the
    test process): ``corrupt`` ignores the generator."""

    def __init__(self, inputs, selected):
        super().__init__(BERT["vocab_size"], MASK_ID, MASK_RATE,
                         pad_token_id=PAD)
        self.inputs = torch.from_numpy(inputs).long()
        self.selected = torch.from_numpy(selected)

    def corrupt(self, tokens, generator):
        return self.inputs, self.selected


def _half(x, rank, world):
    per = x.shape[0] // world
    return x[rank * per:(rank + 1) * per]


def _grads(model):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()
            if p.grad is not None}


def _state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _resnet_step(data, rank, world, partitioner=None):
    model = ResNet(**RESNET, device="cpu", seed=0)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters(), "sgd", LR))
    batch = {"x": torch.from_numpy(_half(data["x"], rank, world)),
             "y": torch.from_numpy(_half(data["y"], rank, world))}
    metrics = build_train_step(ClassificationTask(),
                               partitioner=partitioner)(state, batch)
    return {"loss": float(metrics["loss"]), "grads": _grads(model),
            "state": _state(model)}


def _mlm_step(data, rank, world, partitioner=None):
    model = BertBase(**BERT, logits_mode="hidden", pad_token_id=PAD,
                     device="cpu", seed=0)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters(), "sgd", LR))
    task = GivenDraws(_half(data["inputs"], rank, world),
                      _half(data["selected"], rank, world))
    tokens = torch.from_numpy(_half(data["tokens"], rank, world))
    metrics = build_train_step(task, partitioner=partitioner)(
        state, {"tokens": tokens})
    return {"loss": float(metrics["loss"]),
            "accuracy": float(metrics["accuracy"]),
            "grads": _np_flax(interop.params_to_flax(
                model, interop.grads_of(model))),
            "params": _np_flax(interop.params_to_flax(model))}


def _np_flax(tree):
    if isinstance(tree, dict):
        return {k: _np_flax(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _old_step_grads(model, task, batch, world):
    """The replicated step's gradients as they were before the masked LM's
    count went across processes: the local loss's backward, then one flat
    all-reduce mean."""
    model.train()
    loss, _ = task.compute_loss(model, batch, train=True)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    distributed.all_reduce_sum_(flat)
    flat.div_(world)
    return float(loss), flat


def _unchanged(rank, world, data):
    """GPT-2 and SimpleNet (no dropout) steps against the old step, bit
    for bit: gradients and the loss of this rank."""
    out = {}
    cases = {
        "gpt2": (lambda: GPT2(**KW, logits_mode="hidden", device="cpu",
                              seed=0), CausalLMTask(),
                 {"tokens": torch.from_numpy(_half(data["lm"], rank, world))}),
        "simplenet": (lambda: SimpleNet(input_size=12, hidden_size=16,
                                        num_classes=3, dropout_rate=0.0,
                                        device="cpu", seed=0),
                      ClassificationTask(),
                      {"x": torch.from_numpy(_half(data["mlp_x"], rank, world)),
                       "y": torch.from_numpy(_half(data["mlp_y"], rank,
                                                   world))}),
    }
    for name, (build, task, batch) in cases.items():
        model = build()
        state = TrainState(step=0, model=model, optimizer=make_optimizer(
            model.parameters(), "sgd", LR))
        metrics = build_train_step(task)(state, batch)
        got = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
        ref = build()
        ref_loss, want = _old_step_grads(ref, task, batch, world)
        mean_loss = torch.tensor([ref_loss])
        distributed.all_reduce_mean_(mean_loss)
        out[name] = {"grads_equal": torch.equal(got, want),
                     "loss_equal": float(metrics["loss"])
                     == float(mean_loss[0])}
    return out


def _pair_worker(rank, port, data, results):
    torch.set_num_threads(1)
    world = 2
    config = distributed.DistributedConfig(world, rank, f"localhost:{port}")
    distributed.initialize(config, device="cpu", max_attempts=2)
    try:
        zero1 = data_parallel(world, dp_shard_opt_state=True,
                              opt_shard_min_size=64)
        out = {
            "bn-replicated": _resnet_step(data, rank, world),
            "bn-manual": _resnet_step(data, rank, world, zero1),
            "mlm-replicated": _mlm_step(data, rank, world),
            "mlm-zero1": _mlm_step(data, rank, world, zero1),
            "unchanged": _unchanged(rank, world, data),
        }
        results.put((rank, out))
    finally:
        distributed.shutdown()


def _jax_draws(tokens, rng):
    """JAX MLMTask's ``selected`` and ``masked_inputs`` for these tokens
    and this key: the same jax.random calls as its compute_loss."""
    import jax
    import jax.numpy as jnp

    rng_sel, rng_kind, rng_rand, _ = jax.random.split(
        jax.random.fold_in(rng, 1), 4)
    tokens = jnp.asarray(tokens)
    selected = (jax.random.uniform(rng_sel, tokens.shape) < MASK_RATE) & (
        tokens != PAD)
    kind = jax.random.uniform(rng_kind, tokens.shape)
    r = jax.random.randint(rng_rand, tokens.shape, 0,
                           BERT["vocab_size"] - 1, dtype=tokens.dtype)
    random_tokens = jnp.where(r >= PAD, r + 1, r)
    inputs = jnp.where(selected & (kind < 0.8),
                       jnp.asarray(MASK_ID, tokens.dtype),
                       jnp.where(selected & (kind >= 0.9), random_tokens,
                                 tokens))
    return np.array(inputs), np.array(selected)


@functools.lru_cache(maxsize=None)
def _pair_data():
    """The global batches; the masked LM's rows 2-3 (rank 1's) are mostly
    pad, so the ranks score very different counts."""
    import jax

    rng = np.random.default_rng(0)
    tokens = rng.integers(1, BERT["vocab_size"], (4, 16)).astype(np.int32)
    tokens[2, 5:] = PAD
    tokens[3, 2:] = PAD
    inputs, selected = _jax_draws(tokens, jax.random.fold_in(
        jax.random.key(0), 0))
    return {
        "x": rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
        "y": rng.integers(0, 5, (4,)).astype(np.int32),
        "tokens": tokens, "inputs": inputs, "selected": selected,
        "lm": rng.integers(0, KW["vocab_size"], (4, 16)).astype(np.int32),
        "mlp_x": rng.standard_normal((4, 12)).astype(np.float32),
        "mlp_y": rng.integers(0, 3, (4,)).astype(np.int32),
    }


def _spawn_state_pair():
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_pair_worker,
                         args=(r, port, _pair_data(), results))
             for r in range(2)]
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
def pair(tmp_path_factory):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _spawn_state_pair()
    path = tmp_path_factory.getbasetemp().parent / "test_torch_dist_bn.pkl"
    with filelock.FileLock(f"{path}.lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        got = _spawn_state_pair()
        path.write_bytes(pickle.dumps(got))
        return got


def _close(got, want, tol, what):
    assert got.keys() == want.keys(), what
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=tol, rtol=0,
                                   err_msg=f"{what} {key}")


def test_global_batch_batchnorm_equals_one_process_on_the_global_batch(pair):
    data = _pair_data()
    want = _resnet_step(data, 0, 1)
    for rank in (0, 1):
        got = pair[rank]["bn-replicated"]
        assert abs(got["loss"] - want["loss"]) <= 1e-6
        _close(got["grads"], want["grads"], 1e-5, f"rank {rank} grad")
        _close(got["state"], want["state"], 1e-5, f"rank {rank} state")
    stats = [k for k in want["state"] if k.endswith(("running_mean",
                                                     "running_var"))]
    assert stats and all(
        not np.array_equal(want["state"][k],
                           _state(ResNet(**RESNET, device="cpu"))[k])
        for k in stats)  # the statistics did move


def test_manual_path_averages_the_halves_running_statistics(pair):
    """ZeRO-1: per-shard statistics, then their cross-process mean; the
    gradients the mean of the halves' (each normalised by its own
    statistics)."""
    data = _pair_data()
    halves = [_resnet_step(data, r, 2) for r in (0, 1)]
    model = ResNet(**RESNET, device="cpu", seed=0)
    names = {id(t): n for n, t in model.named_buffers()}
    stat_names = [names[id(t)] for t in running_stats(model)]
    assert len(stat_names) == 2 * 6  # stem, 2 + 2 in blocks, 1 shortcut
    for rank in (0, 1):
        got = pair[rank]["bn-manual"]["state"]
        for key in stat_names:
            np.testing.assert_allclose(
                got[key], (halves[0]["state"][key] + halves[1]["state"][key])
                / 2, atol=1e-6, rtol=0, err_msg=f"rank {rank} {key}")
        for key, p0 in _state(model).items():
            if key in stat_names:
                continue
            g = (halves[0]["grads"][key] + halves[1]["grads"][key]) / 2
            np.testing.assert_allclose(got[key], p0 - LR * g, atol=1e-6,
                                       rtol=0, err_msg=f"rank {rank} {key}")


def _flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tree(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def test_mlm_replicated_step_weighs_positions_as_jax_on_the_global_batch(
        pair):
    """JAX's replicated step runs the loss on the global batch: every
    scored position weighs 1 / (global count), whichever rank holds it."""
    import jax
    import jax.numpy as jnp

    from distributed_pytorch_example_tpu.models.bert import BertBase as JBert
    from distributed_pytorch_example_tpu.train import tasks as jax_tasks

    data = _pair_data()
    counts = [int(_half(data["selected"], r, 2).sum()) for r in (0, 1)]
    assert counts[0] > 2 * counts[1] > 0  # the fault needs unequal counts
    model = BertBase(**BERT, logits_mode="hidden", pad_token_id=PAD,
                     device="cpu", seed=0)
    params = jax.tree_util.tree_map(
        jnp.asarray, _np_flax(interop.params_to_flax(model)))
    jmodel = JBert(**BERT, logits_mode="hidden", pad_token_id=PAD,
                   use_flash=False)
    jtask = jax_tasks.MLMTask(BERT["vocab_size"], MASK_ID, MASK_RATE,
                              pad_token_id=PAD)
    rng = jax.random.fold_in(jax.random.key(0), 0)

    def loss(p):
        return jtask.compute_loss(jmodel, p, {},
                                  {"tokens": jnp.asarray(data["tokens"])},
                                  rng, train=True)[:2]

    (jl, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    want = _flat_tree(jax.device_get(jgrads))
    for rank in (0, 1):
        got = pair[rank]["mlm-replicated"]
        assert abs(got["loss"] - float(jl)) <= 1e-5
        assert abs(got["accuracy"] - float(jmetrics["accuracy"])) <= 1e-4
        _close(_flat_tree(got["grads"]), want, 2e-5, f"rank {rank} grad")


def test_mlm_under_zero1_takes_the_per_shard_mean(pair):
    """JAX's manual path (and so the port's under ZeRO-1) averages the
    shards' own means."""
    data = _pair_data()
    halves = []
    for r in (0, 1):
        model = BertBase(**BERT, logits_mode="hidden", pad_token_id=PAD,
                         device="cpu", seed=0)
        task = MLMTask(BERT["vocab_size"], MASK_ID, MASK_RATE,
                       pad_token_id=PAD)
        inputs = torch.tensor(_half(data["inputs"], r, 2)).long()
        loss, _ = task.loss(model, model(inputs),
                            torch.from_numpy(_half(data["tokens"], r, 2))
                            .long(),
                            torch.from_numpy(_half(data["selected"], r, 2)))
        loss.backward()
        halves.append(_flat_tree(_np_flax(interop.params_to_flax(
            model, interop.grads_of(model)))))
    p0 = _flat_tree(_np_flax(interop.params_to_flax(model)))
    want = {k: v - LR * (halves[0][k] + halves[1][k]) / 2
            for k, v in p0.items()}
    for rank in (0, 1):
        _close(_flat_tree(pair[rank]["mlm-zero1"]["params"]), want, 1e-6,
               f"rank {rank} param")


def test_gpt2_and_simplenet_steps_are_unchanged_bit_for_bit(pair):
    for rank in (0, 1):
        for name, got in pair[rank]["unchanged"].items():
            assert got == {"grads_equal": True, "loss_equal": True}, (
                rank, name)
