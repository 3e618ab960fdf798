"""Adafactor under ZeRO-1 and the int8 wire, at world 2 on the CPU, and
the telemetry cases that need two processes.

One pair of gloo processes serves this file and
``tests/test_torch_telemetry.py``: a module-scoped fixture runs every case
and returns numpy results (shared across xdist workers through a file
lock, as ``tests/test_torch_zero1.py`` shares its pair). The adafactor
cases start from the same seed-0 GPT-2 (1 layer, width 128, MLP 256,
vocab 257, the ZeRO-1 floor lowered to 256 elements) and take 3 steps on
global batches of 4 rows, 2 per rank. At these widths ZeRO-1 cuts the
token embedding (257 x 128, factored) along its second largest axis d1,
the MLP kernels (128 x 256 and 256 x 128, factored) along their largest
axis d0, and the position table and attention kernels (unfactored: a
tiled ``v``) along their largest even axis.

The reference is the port's replicated ``Adafactor``, which
``tests/test_torch_item7.py`` holds to ``optax.adafactor``. Tolerances:

- ZeRO-1 against the replicated step at world 2, 3 steps, parameters to
  1e-6: both sync the same float32 gradient sums (two ranks: the sum is
  exact in any order), so only the statistics' and the RMS sums' order
  differs (whole-leaf means against tiles' sums summed across ranks).
  The k-projection bias, whose gradient is rounding noise, is bounded by
  what adafactor can do with noise (the test says how);
- int8-block wire: the quantized gradients differ from float32 ones by
  design, so the reference is ``Adafactor`` on whole leaves fed the
  step's own synced gradients (the tiles gathered), 3 steps, 1e-6;
- the world-2 sharded checkpoint loaded in one process: bit-equal.
"""

import multiprocessing
import os
import pickle
import re
import shutil
import socket

import filelock
import numpy as np
import pytest
import torch

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
from distributed_pytorch_example_tpu_torch.telemetry import (
    CostRegistry,
    exchange_step_times,
)
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    Trainer,
    TrainState,
    build_train_step,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train.optimizers import (
    Adafactor,
    Tile,
    _factored_dims,
)
from distributed_pytorch_example_tpu_torch.train.state import (
    state_tree,
    to_host,
    to_numpy,
)
from distributed_pytorch_example_tpu_torch.utils import msgpack
from distributed_pytorch_example_tpu_torch.robustness.integrity import (
    read_verified,
)

torch.set_num_threads(2)

WORLD = 2
TIMEOUT_S = 120
KW = dict(vocab_size=257, max_len=16, model_dim=128, num_layers=1,
          num_heads=2, mlp_dim=256)
SEQ, GLOBAL_BATCH, STEPS = 16, 4, 3
LR = 1e-2
MIN_SHARD = 256  # the ZeRO-1 floor at this width
TOL = 1e-6
INT8 = dict(compress="int8-block", block_size=64, min_size=1,
            bucket_bytes=2048)
# the sentinel cases: the small GPT-2 of tests/test_torch_zero1.py
SMALL = dict(vocab_size=97, max_len=16, model_dim=32, num_layers=2,
             num_heads=2, mlp_dim=64)


def _batches(vocab=KW["vocab_size"]):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (GLOBAL_BATCH, SEQ)).astype(np.int64)
            for _ in range(STEPS)]


def _local(tokens, rank, world):
    per = tokens.shape[0] // world
    return {"tokens": torch.from_numpy(tokens[rank * per:(rank + 1) * per])}


def _params(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _partitioner(world, zero1=True, **wire_kw):
    return data_parallel(world, dp_shard_opt_state=zero1,
                         opt_shard_min_size=MIN_SHARD,
                         wire=WireConfig(**wire_kw))


def _whole(update, i, tile_grad):
    """The whole leaf of a tile's synced gradient (a collective)."""
    rows = distributed.all_gather_tiled(tile_grad.reshape(1, -1))
    return _unscatter(rows, update.dims[i], update.chunk_shapes[i])


def _adafactor_case(rank, world, part, whole_leaf_ref=False, name="adafactor"):
    """3 steps; parameters after each; with ``whole_leaf_ref`` the largest
    gap to Adafactor on whole leaves fed the same synced gradients."""
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model, name, LR))
    step = build_train_step(CausalLMTask(), partitioner=part)
    ref = None
    if whole_leaf_ref:
        update = step.sharded(state)
        ref = [leaf.to_jax(p).detach().clone().requires_grad_()
               for leaf, p in zip(update.leaves, update.params)]
        ref_opt = Adafactor(ref, lr=LR)
    params, gaps, tallies = [], [], []
    for tokens in _batches():
        with distributed.count_collectives() as tally:
            step(state, _local(tokens, rank, world))
        tallies.append({k: dict(v) for k, v in tally.items()})
        params.append(_params(model))
        if ref is None:
            continue
        for i, (leaf, p, tile) in enumerate(zip(update.leaves, update.params,
                                                update.tiles)):
            ref[i].grad = (leaf.to_jax(p.grad).float() if tile is None
                           else _whole(update, i, tile.grad))
        ref_opt.step()
        gaps.append(max(
            (leaf.to_jax(p).detach() - r.detach()).abs().max().item()
            for leaf, p, r in zip(update.leaves, update.params, ref)))
    out = {"params": params, "gaps": gaps, "tally": tallies[0]}
    if part is not None:
        update = step.sharded(state)
        out["dims"] = {leaf.key: (d, tuple(leaf.to_jax(p).shape))
                       for leaf, p, d in zip(update.leaves, update.params,
                                             update.dims)}
    return out


def _sharded_fit(rank, world, root):
    """Adafactor under ZeRO-1 through Trainer.fit, one epoch of 2 steps,
    saved sharded; the final parameters and the gathered optimizer state
    (a collective)."""
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    trainer = Trainer(model, CausalLMTask(), make_optimizer(model, "adafactor",
                                                            LR),
                      partitioner=_partitioner(world),
                      checkpoint_dir=os.path.join(root, "ada"),
                      checkpoint_format="sharded", telemetry=False)
    loader = DeviceLoader(SyntheticTokenDataset(8, seq_len=SEQ,
                                                vocab_size=KW["vocab_size"],
                                                seed=0),
                          GLOBAL_BATCH, device="cpu", num_shards=world,
                          shard_id=rank, prefetch=0)
    trainer.fit(loader, None, epochs=1)
    tree = to_numpy(to_host(state_tree(trainer.state, trainer.layout())))
    return {"params": _params(model), "opt_state": tree["opt_state"]}


def _sentinel_steps(rank, world, zero1, skip_nonfinite=True, nan=False):
    """Two steps of the small GPT-2 (adam): each step's sentinels and
    bad_step. ``nan``: rank 1 adds NaN to one element of the token
    embedding's gradient (a leaf ZeRO-1 shards) at the first step."""
    model = GPT2(**SMALL, logits_mode="hidden", device="cpu", seed=0)
    part = data_parallel(world, dp_shard_opt_state=zero1,
                         opt_shard_min_size=MIN_SHARD,
                         wire=WireConfig(bucket_bytes=2048))
    step = build_train_step(CausalLMTask(), partitioner=part,
                            skip_nonfinite=skip_nonfinite)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters(), "adam",
                                                1e-3))
    if nan:  # one NaN in the token embedding's gradient, rank 1 only
        wte = model.wte.weight
        poison = torch.zeros_like(wte)
        poison[0, 0] = float("nan")
        if rank == 1:
            wte.register_hook(lambda g: g + poison if state.step == 0 else g)
    out = []
    for tokens in _batches(SMALL["vocab_size"])[:2]:
        metrics = step(state, _local(tokens, rank, world))
        out.append({k: float(v) for k, v in metrics.items()
                    if k in ("grad_norm", "param_norm", "nonfinite_grads",
                             "bad_step")})
    return out


def _cost_record(rank, world):
    """The cost record of one ZeRO-1 step with int8 wire buckets."""
    model = GPT2(**SMALL, logits_mode="hidden", device="cpu", seed=0)
    step = build_train_step(CausalLMTask(),
                            partitioner=_partitioner(world, **INT8))
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters(), "adam",
                                                1e-3))
    costs = CostRegistry()
    with costs.measure("train_step", "cpu"):
        step(state, _local(_batches(SMALL["vocab_size"])[0], rank, world))
    return costs.get("train_step")


def _worker(rank, port, root, results):
    torch.set_num_threads(1)
    config = distributed.DistributedConfig(WORLD, rank, f"localhost:{port}")
    distributed.initialize(config, device="cpu", max_attempts=2)
    try:
        out = {
            "replicated": _adafactor_case(rank, WORLD, None),
            "zero1": _adafactor_case(rank, WORLD, _partitioner(WORLD)),
            "zero1-int8": _adafactor_case(rank, WORLD,
                                          _partitioner(WORLD, **INT8),
                                          whole_leaf_ref=True),
            "sgd-zero1": _adafactor_case(rank, WORLD, _partitioner(WORLD),
                                         name="sgd"),
            "sharded": _sharded_fit(rank, WORLD, root),
            "exchange": exchange_step_times(10.0 + 5.0 * rank),
            "exchange-none": exchange_step_times(None),
            "sentinels": {
                "replicated": _sentinel_steps(rank, WORLD, False),
                "zero1": _sentinel_steps(rank, WORLD, True),
                "zero1-noskip": _sentinel_steps(rank, WORLD, True,
                                                skip_nonfinite=False),
                "replicated-nan": _sentinel_steps(rank, WORLD, False,
                                                  nan=True),
                "zero1-nan": _sentinel_steps(rank, WORLD, True, nan=True),
                "zero1-noskip-nan": _sentinel_steps(
                    rank, WORLD, True, skip_nonfinite=False, nan=True),
            },
            "cost": _cost_record(rank, WORLD),
        }
        results.put((rank, out))
    finally:
        distributed.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_pair(root):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, root, results))
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
    return {"root": root, "ranks": got}


@pytest.fixture(scope="module")
def adafactor_pair(tmp_path_factory):
    """The pair runs once per test run: under pytest-xdist the first worker
    here runs it and leaves the results (and the checkpoint files) in the
    run's shared temporary directory."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _spawn_pair(str(tmp_path_factory.mktemp("adafactor_pair")))
    base = tmp_path_factory.getbasetemp().parent
    path = base / "test_torch_adafactor_zero1.pkl"
    with filelock.FileLock(f"{path}.lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        root = base / "test_torch_adafactor_pair"
        shutil.rmtree(root, ignore_errors=True)
        got = _spawn_pair(str(root))
        path.write_bytes(pickle.dumps(got))
        return got


def _assert_params_close(got, want, tol, what):
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=tol, rtol=0,
                                   err_msg=f"{what} {key}")


def test_tiles_cut_along_each_factored_axis(adafactor_pair):
    """The case covers what the tile arithmetic must: a factored leaf cut
    along d1, one cut along d0, and an unfactored leaf (a tiled ``v``)."""
    kinds = set()
    for key, (dim, shape) in adafactor_pair["ranks"][0]["zero1"][
            "dims"].items():
        if dim is None:
            continue
        dims = _factored_dims(shape)
        kinds.add("unfactored" if dims is None
                  else "d1" if dim == dims[0] else "d0")
    assert kinds == {"d0", "d1", "unfactored"}


@pytest.mark.parametrize("rank", range(WORLD))
def test_zero1_adafactor_matches_the_replicated_step(adafactor_pair, rank):
    got = adafactor_pair["ranks"][rank]
    for i in range(STEPS):
        zero1 = dict(got["zero1"]["params"][i])
        replicated = dict(got["replicated"]["params"][i])
        # the k-projection bias's gradient is zero in exact arithmetic
        # (a softmax ignores a shift shared by a row of logits): from step
        # 2 on it is rounding noise of slightly different parameters, and
        # adafactor's update of noise is lr * 1e-3 * u / max(1, rms(u)),
        # each entry at most lr * 1e-3 * sqrt(n) a step on either side
        key = "decoder.layers.0.attn.k.bias"
        bias, want = zero1.pop(key), replicated.pop(key)
        bound = 2 * (i + 1) * LR * 1e-3 * np.sqrt(bias.size)
        np.testing.assert_allclose(bias, want, atol=bound, rtol=0)
        _assert_params_close(zero1, replicated, TOL, f"step {i + 1}")


def test_int8_wire_adafactor_is_adafactor_on_whole_leaves(adafactor_pair):
    for rank, got in adafactor_pair["ranks"].items():
        gaps = got["zero1-int8"]["gaps"]
        assert len(gaps) == STEPS and max(gaps) <= TOL, (rank, gaps)
        # the wire did quantize: the run is not the float32 run
        assert not np.allclose(got["zero1-int8"]["params"][0]["wte.weight"],
                               got["zero1"]["params"][0]["wte.weight"],
                               atol=1e-7, rtol=0)


def test_adafactor_adds_two_all_reduces_a_step(adafactor_pair):
    """The statistics (with the tiles' sums of p²) and the block clip's
    sums of u²: one all-reduce each, whatever the number of leaves."""
    for got in adafactor_pair["ranks"].values():
        ada = got["zero1"]["tally"]
        sgd = got["sgd-zero1"]["tally"]
        assert ada["all-reduce"]["count"] == sgd["all-reduce"]["count"] + 2
        assert {k: v for k, v in ada.items() if k != "all-reduce"} == {
            k: v for k, v in sgd.items() if k != "all-reduce"}


def _manifest(root):
    step_dir = ckpt._pointed_version_dir(
        os.path.join(root, "ada", ckpt.LATEST_NAME))
    return msgpack.msgpack_restore(read_verified(
        os.path.join(step_dir, "manifest.msgpack")))


def test_sharded_checkpoint_places_statistics_as_jax_does(adafactor_pair):
    """Each optimizer-state leaf is cut by ``zero1_dim`` of its own shape
    (the JAX partitioner's rule for opt_state leaves): a tiled ``v``
    follows its parameter, a ``v_row`` / ``v_col`` of 256 is cut though
    every rank keeps it whole, smaller ones are written whole."""
    part = _partitioner(WORLD)
    leaves = _manifest(adafactor_pair["root"])["leaves"]
    stats = {p: m for p, m in leaves.items()
             if re.match(r"opt_state/(\d+/)+(v|v_row|v_col)/", p)}
    assert stats
    seen = set()
    for path, meta in stats.items():
        want = 2 if part.zero1_dim(tuple(meta["shape"])) is not None else 1
        assert int(meta["chunks"]) == want, path
        seen.add(want)
    assert seen == {1, 2}


def test_world2_sharded_checkpoint_loads_at_world1(adafactor_pair):
    root = adafactor_pair["root"]
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=5)
    trainer = Trainer(model, CausalLMTask(), make_optimizer(model,
                                                            "adafactor", LR),
                      telemetry=False)
    epoch, _ = trainer.load(os.path.join(root, "ada", ckpt.LATEST_NAME))
    want = adafactor_pair["ranks"][0]["sharded"]
    assert epoch == 1 and trainer.state.step == 2
    _assert_params_close(_params(model), want["params"], 0.0, "loaded")
    got = to_numpy(to_host(state_tree(trainer.state)))["opt_state"]

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(tree)

    got, want = dict(leaves(got)), dict(leaves(want["opt_state"]))
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    # and it trains on at world 1
    step = build_train_step(CausalLMTask())
    metrics = step(trainer.state, {"tokens": torch.from_numpy(_batches()[0])})
    assert np.isfinite(float(metrics["loss"]))


def test_world2_sharded_checkpoint_loads_in_jax(adafactor_pair):
    """The world-2 adafactor file, cut by ZeRO-1 (tiled ``v`` s and the
    statistics JAX would shard), loads in the JAX package, in one process,
    leaf for leaf equal to the state the pair gathered and to the port's
    own world-1 load of it. JAX is imported here only: the pair's spawned
    processes import this module and run no JAX."""
    import flax.serialization as flax_ser
    import jax
    import jax.numpy as jnp

    from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
    from distributed_pytorch_example_tpu.train import checkpoint as jax_ckpt
    from distributed_pytorch_example_tpu.train import optimizers as jax_opt
    from distributed_pytorch_example_tpu.train.state import (
        TrainState as JaxState,
    )

    path = os.path.join(adafactor_pair["root"], "ada", ckpt.LATEST_NAME)
    params = JaxGPT2(**KW, logits_mode="hidden").init(
        jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    tx = jax_opt.make_optimizer("adafactor", LR)
    template = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=tx.init(params), model_state={},
                        rng=jax.random.key(5))
    loaded, epoch, _ = jax_ckpt.load_checkpoint(path, template)
    loaded = loaded.replace(rng=jax.random.key_data(loaded.rng))
    got = flax_ser.to_state_dict(jax.device_get(loaded))
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=5)
    trainer = Trainer(model, CausalLMTask(), make_optimizer(model,
                                                            "adafactor", LR),
                      telemetry=False)
    trainer.load(path)
    mine = to_numpy(to_host(state_tree(trainer.state)))
    want = adafactor_pair["ranks"][0]["sharded"]["opt_state"]
    assert epoch == 1 and int(got["step"]) == 2

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(tree)

    for ref, what in ((mine, "the port's world-1 load"),
                      ({"opt_state": want}, "the pair's gathered state")):
        ref = dict(leaves(ref))
        jax_leaves = {k: v for k, v in leaves(got) if k in ref}
        assert jax_leaves.keys() == ref.keys(), what
        for key, value in ref.items():
            assert jax_leaves[key].dtype == value.dtype, (what, key)
            np.testing.assert_array_equal(jax_leaves[key], value,
                                          err_msg=f"{what}: {key}")


@pytest.mark.parametrize("shape,dim", [
    ((257, 128), 1), ((128, 256), 0), ((128, 256), 1), ((130, 4, 128), 0),
    ((130, 4, 128), 1), ((130, 4, 128), 2)])
def test_tile_sums_and_cuts_make_the_whole_leaf(shape, dim):
    """Tile.place summed over the ranks' tiles is the whole leaf's sum
    over each axis, and Tile.cut gives each tile its part (exact in
    float64 here), for a leaf cut along each of its even axes."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape))
    rows, cs = _scatter_parts(x, dim, 2)
    tiles = [Tile(shape, dim, r, 2) for r in range(2)]
    for axis in range(len(shape)):
        total = sum(t.place(rows[r].reshape(cs).sum(dim=axis), axis)
                    for r, t in enumerate(tiles))
        torch.testing.assert_close(total, x.sum(dim=axis), rtol=1e-12,
                                   atol=1e-12)
        factor = x.sum(dim=axis)
        for r, t in enumerate(tiles):
            if dim == axis:  # broadcasts over the tile's part
                assert t.cut(factor, axis) is factor
            else:
                torch.testing.assert_close(
                    t.cut(factor, axis), rows[r].reshape(cs).sum(dim=axis))
