"""The port's FSDP (``PlanSpec(family="fsdp")``) against the JAX package's
``fsdp(mesh)``, on the CPU.

- Specs: every leaf of a tiny GPT-2's train state (params and Adam
  moments) gets the spec JAX's ``fsdp(mesh).tree_specs`` gives it, on a
  ``data=1 x fsdp=2`` mesh over 2 of the 8 virtual CPU devices and on
  ``data=2 x fsdp=2`` over 4; the ZeRO-1 overlay's specs equal JAX's too.
- Training: the port's FSDP Trainer at world 2 (two gloo processes) and at
  world 4 (``data=2 x fsdp=2``) on a tiny GPT-2 (2 layers, width 64) and,
  at world 2, SimpleNet: 3 steps and a validation batch, SGD (momentum
  0.9, lr 0.1), against JAX's Trainer under ``fsdp`` on a 2-device mesh
  and against the port's replicated world-1 run, on the same weights and
  batches. Tolerances: losses 2e-6, parameters after 3 steps 2e-6. The
  runs differ only in the order float32 sums are taken (JAX's program,
  the port's two local means summed by the reduce-scatter, one mean over
  all rows), which moves the last bits of the loss and the gradients
  (about 1e-7 here); SGD is linear in the gradient, so 3 steps at lr 0.1
  with momentum carry that to a few 1e-7. Adam is not used: its
  normalised update follows the k-projection bias's rounding noise to
  +-lr (``tests/test_torch_train_step.py``).
- Checkpoints, bit for bit (a load reassembles saved bytes): the port's
  world-2 sharded file splits every leaf into the chunks JAX's own FSDP
  manifest has, loads in JAX under ``fsdp=2`` and in the port at world 1
  equal to the gathered state; JAX's FSDP file loads into the port's
  world-2 FSDP run equal to JAX's own load; at world 4 only the ranks of
  data index 0 write tiles; the gathered format's state equals the
  replicated run's encoding of the same state.
- The CLI: ``--partition fsdp --mesh-fsdp 2`` runs at world 2; the
  combinations the port does not serve are refused.
- ``hbm_peak_bytes`` (``telemetry/cost.py``) with a fake allocator
  counter: a 1 GiB tensor alive beside the state does not change it, and
  the second train step's figure counts Adam's moments.

The processes (``tests/_torch_fsdp_worker.py``, which imports no JAX)
are spawned once per test run, and their results are shared across
xdist workers through a file lock. Every check runs inside one tier-1
item, :func:`test_fsdp_matches_jax`, which names each check that failed.
"""

import os
import pickle

import filelock
import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import distributed_pytorch_example_tpu as jdpx
from distributed_pytorch_example_tpu.data.loader import (
    DeviceLoader as JaxLoader,
)
from distributed_pytorch_example_tpu.data.synthetic import (
    SyntheticClassificationDataset as JaxClassData,
    SyntheticTokenDataset as JaxTokenData,
)
from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu.models.mlp import SimpleNet as JaxSimpleNet
from distributed_pytorch_example_tpu.parallel.api import _path_str
from distributed_pytorch_example_tpu.robustness import (
    integrity as jax_integrity,
)
from distributed_pytorch_example_tpu.runtime import MeshSpec as JaxMeshSpec
from distributed_pytorch_example_tpu.runtime import make_mesh as jax_make_mesh
from distributed_pytorch_example_tpu.train import checkpoint as jax_ckpt
from distributed_pytorch_example_tpu.train import loop as jax_loop
from distributed_pytorch_example_tpu.train import optimizers as jax_opt
from distributed_pytorch_example_tpu.train import tasks as jax_tasks
from distributed_pytorch_example_tpu.train.state import TrainState as JaxState
from distributed_pytorch_example_tpu.train.step import (
    init_state as jax_init_state,
)
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models import GPT2, SimpleNet
from distributed_pytorch_example_tpu_torch.parallel import (
    PlanSpec,
    data_parallel,
    fsdp,
)
from distributed_pytorch_example_tpu_torch.robustness.integrity import (
    read_verified,
)
from distributed_pytorch_example_tpu_torch.runtime import MeshSpec, make_mesh
from distributed_pytorch_example_tpu_torch.telemetry import cost as cost_lib
from distributed_pytorch_example_tpu_torch.train import (
    ClassificationTask,
    Trainer,
    TrainState,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train.cli import main as train_main
from distributed_pytorch_example_tpu_torch.train.optimizers import FSDPUpdate
from distributed_pytorch_example_tpu_torch.train.state import (
    state_tree,
    to_host,
    to_numpy,
    train_state_to_flax,
)
from distributed_pytorch_example_tpu_torch.utils import msgpack

import _torch_fsdp_worker as W

torch.set_num_threads(2)

TOL = 2e-6


def _np(tree):
    return to_numpy(to_host(tree))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _assert_trees_equal(got, want, what=""):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), (what, sorted(set(got) ^ set(want)))
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}{k}")


def _jax_tree(state):
    state = state.replace(rng=jax.random.key_data(state.rng))
    return flax_ser.to_state_dict(jax.device_get(state))


# ---------------------------------------------------------------------------
# specs, against JAX's partitioner (no process)
# ---------------------------------------------------------------------------


def _port_state(model):
    """A replicated Adam state of ``model`` as the flax tree (the moments
    zero before the first step: only shapes matter)."""
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        model.parameters(), "adam", 1e-3))
    return state_tree(state)


def _jax_state(params):
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return JaxState(step=jnp.zeros((), jnp.int32), params=params,
                    opt_state=optax.adam(1e-3).init(params), model_state={},
                    rng=jax.random.key(0))


SPEC_MESHES = [(1, 2, False), (2, 2, False), (2, 1, True), (4, 1, True)]


def _check_specs_of_every_state_leaf_match_jax(data, fsdp_size, zero1):
    model = GPT2(**W.GPT, logits_mode="hidden", device="cpu", seed=0)
    tree = _port_state(model)
    n = data * fsdp_size
    jmesh = jax_make_mesh(JaxMeshSpec(data=data, fsdp=fsdp_size),
                          devices=jax.devices()[:n])
    mesh = make_mesh(MeshSpec(data=data, fsdp=fsdp_size), world=n,
                     groups=False)
    if zero1:  # the floor lowered so that both kinds of leaf occur
        jpart = jdpx.parallel.data_parallel(jmesh, dp_shard_opt_state=True,
                                            opt_shard_min_size=256)
        part = data_parallel(mesh, dp_shard_opt_state=True,
                             opt_shard_min_size=256)
    else:
        jpart, part = jdpx.parallel.fsdp(jmesh), fsdp(mesh)
    jstate = _jax_state(_np(interop.params_to_flax(model)))
    want = {_path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jpart.tree_specs(jstate),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    got = {k: tuple(v) for k, v in _flat(part.tree_specs(tree)).items()}
    # JAX's rng is a key of shape (); the port keeps its (2,) key data
    assert want.pop("rng") == () and "rng" in got
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    assert sum(any(e is not None for e in s) for s in want.values()) > 10
    assert tuple(part.batch_spec()) == tuple(jpart.batch_spec())


def _check_shard_largest_axis_breaks_ties_to_the_last_dim():
    mesh = make_mesh(MeshSpec(data=1, fsdp=2), world=2, groups=False)
    jmesh = jax_make_mesh(JaxMeshSpec(data=1, fsdp=2),
                          devices=jax.devices()[:2])
    spec = fsdp(mesh).spec_for
    jspec = jdpx.parallel.fsdp(jmesh).spec_for
    for shape in [(), (3,), (4,), (64, 64), (97, 64), (64, 97), (6, 4, 6),
                  (5, 3), (1024, 768), (50257, 768)]:
        assert tuple(spec("params/x/kernel", shape)) == tuple(
            jspec("params/x/kernel", shape)), shape


def _check_plan_lowers_only_the_served_families():
    mesh = make_mesh(MeshSpec(data=1, fsdp=2), world=2, groups=False)
    for plan in (PlanSpec(family="transformer", zero1=True),
                 PlanSpec(family="fsdp", fsdp_rest=True)):
        with pytest.raises(NotImplementedError, match="item 11"):
            plan.lower(mesh)
    with pytest.raises(ValueError, match="redundant"):
        PlanSpec(family="fsdp", zero1=True).lower(mesh)
    plan = PlanSpec(mesh=MeshSpec(data=1, fsdp=2), family="fsdp",
                    bucket_bytes=1 << 20)
    jplan = jdpx.parallel.plan.PlanSpec(
        mesh=JaxMeshSpec(data=1, fsdp=2), family="fsdp",
        bucket_bytes=1 << 20)
    assert plan.name() == jplan.name() == "fsdp:fsdp2+overlap"
    assert plan.to_json() == jplan.to_json()
    assert PlanSpec.from_json(plan.to_json()) == plan
    part = plan.lower(mesh)
    assert part.wire.bucket_bytes == 1 << 20 and part.fsdp_axis == "fsdp"


def _check_fsdp_update_refuses_what_it_does_not_serve():
    mesh = make_mesh(MeshSpec(data=1, fsdp=1), world=1, groups=False)
    model = SimpleNet(**W.NET, device="cpu", seed=0)
    for name in ("lamb", "adafactor"):
        with pytest.raises(NotImplementedError, match="item 11"):
            FSDPUpdate(model, make_optimizer(model, name, 1e-3), fsdp(mesh))


# ---------------------------------------------------------------------------
# the processes, once per test run
# ---------------------------------------------------------------------------


def _jax_fit(kind, n, ckpt_dir=None):
    """JAX's Trainer under fsdp on an n-device (data=1, fsdp=n) mesh from
    the port's seed-0 weights: per-step losses, validation loss, the final
    state as numpy."""
    jmesh = jax_make_mesh(JaxMeshSpec(data=1, fsdp=n),
                          devices=jax.devices()[:n])
    if kind == "gpt2":
        model = GPT2(**W.GPT, logits_mode="hidden", device="cpu", seed=0)
        jmodel, task = JaxGPT2(**W.GPT, logits_mode="hidden"), \
            jax_tasks.CausalLMTask()
        data = lambda k, seed: JaxTokenData(  # noqa: E731
            seed=seed, num_samples=k, seq_len=W.SEQ,
            vocab_size=W.GPT["vocab_size"])
    else:
        model = SimpleNet(**W.NET, dropout_rate=0.0, device="cpu", seed=0)
        jmodel, task = JaxSimpleNet(**W.NET, dropout_rate=0.0), \
            jax_tasks.ClassificationTask()
        data = lambda k, seed: JaxClassData(  # noqa: E731
            num_samples=k, input_size=W.NET["input_size"],
            num_classes=W.NET["num_classes"], seed=seed)
    tx = jax_opt.make_optimizer("sgd", W.LR)
    jt = jax_loop.Trainer(jmodel, task, tx,
                          partitioner=jdpx.parallel.fsdp(jmesh),
                          telemetry=False, checkpoint_dir=ckpt_dir,
                          checkpoint_format="sharded", log_every=100)
    loaders = [JaxLoader(data(W.GLOBAL_BATCH * k, seed), W.GLOBAL_BATCH,
                         mesh=jmesh, shuffle=False, prefetch=0)
               for k, seed in ((W.STEPS, 0), (1, 1))]
    jt.init(jt._sample_inputs_from(loaders[0]))
    params = jax.tree_util.tree_map(
        jnp.asarray, _np(interop.params_to_flax(model)))
    jt.state = jax.device_put(
        jt.state.replace(params=params, opt_state=tx.init(params)),
        jt.state_shardings)
    losses, step = [], jt.train_step

    def recording(state, batch):
        out = step(state, batch)
        losses.append(float(out[1]["loss"]))
        return out

    jt.train_step = recording
    hist = jt.fit(*loaders, epochs=1)
    return {"losses": losses, "val_loss": hist[0]["val_loss"],
            "tree": _jax_tree(jt.state), "state": jt.state,
            "shardings": jt.state_shardings}


def _jax_fsdp_checkpoint(path):
    """A JAX SimpleNet + SGD state under the 2-device FSDP mesh, every
    leaf drawn from a seed, saved sharded; JAX's own load of it."""
    jmesh = jax_make_mesh(JaxMeshSpec(data=1, fsdp=2),
                          devices=jax.devices()[:2])
    state, shardings = jax_init_state(
        JaxSimpleNet(**W.NET), jax_opt.make_optimizer("sgd", W.LR),
        jnp.zeros((8, W.NET["input_size"]), jnp.float32),
        jax.random.key(0), jdpx.parallel.fsdp(jmesh))
    rng = np.random.default_rng(0)

    def draw(x, sh):
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            return x
        if jnp.issubdtype(x.dtype, jnp.floating):
            return jax.device_put(
                rng.standard_normal(x.shape).astype(x.dtype), sh)
        return jax.device_put(np.asarray(rng.integers(1, 9, x.shape),
                                         x.dtype), sh)

    state = jax.tree_util.tree_map(draw, state, shardings)
    jax_ckpt.save_checkpoint(path, state, 4, 0.25, {"k": 2.0}, sharded=True)
    loaded, _, _ = jax_ckpt.load_checkpoint(path, state, shardings)
    return _jax_tree(loaded)


def _prepare_and_spawn(root):
    os.makedirs(root, exist_ok=True)
    out = {"root": root}
    out["jax_mlp_file"] = _jax_fsdp_checkpoint(
        os.path.join(root, "jax_mlp", ckpt.LATEST_NAME))
    jax_runs = {kind: _jax_fit(kind, 2, os.path.join(root, f"jax_{kind}")
                               if kind == "gpt2" else None)
                for kind in ("gpt2", "mlp")}
    # the JAX state template of the GPT-2 run loads the port's file below
    out["jax"] = {k: {key: v[key] for key in ("losses", "val_loss", "tree")}
                  for k, v in jax_runs.items()}
    out["port_w1"] = {kind: W.replicated(kind) for kind in ("gpt2", "mlp")}
    out["w2"] = W.spawn(2, root)
    out["w4"] = W.spawn(4, root)
    # JAX's loads of the port's world-2 file, with the fit's template
    run = jax_runs["gpt2"]
    loaded, epoch, _ = jax_ckpt.load_checkpoint(
        os.path.join(root, "gpt2", ckpt.LATEST_NAME), run["state"],
        run["shardings"])
    out["jax_loads_port"] = (_jax_tree(loaded), epoch)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _prepare_and_spawn(str(tmp_path_factory.mktemp("fsdp")))
    base = tmp_path_factory.getbasetemp().parent
    path = base / "test_torch_fsdp.pkl"
    with filelock.FileLock(f"{path}.lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        got = _prepare_and_spawn(str(base / "test_torch_fsdp_runs"))
        path.write_bytes(pickle.dumps(got))
        return got


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _check_world2_fsdp_fit_matches_jax_and_replicated(runs, kind):
    jax_run, w1 = runs["jax"][kind], runs["port_w1"][kind]
    for rank in (0, 1):
        got = runs["w2"][rank][kind]
        assert len(got["losses"]) == W.STEPS
        for want in (jax_run, w1):
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       atol=TOL, rtol=0)
            assert abs(got["val_loss"] - want["val_loss"]) <= TOL
        assert W.params_close(got["tree"]["params"],
                              jax_run["tree"]["params"]) <= TOL
        assert W.params_close(got["tree"]["params"],
                              w1["tree"]["params"]) <= TOL
        assert W.params_close(got["tree"]["opt_state"],
                              w1["tree"]["opt_state"]) <= TOL


def _check_world2_ranks_hold_only_their_tiles_between_steps(runs):
    for rank in (0, 1):
        assert runs["w2"][rank]["tiles"] > 10
        assert runs["w2"][rank]["freed"]


def _check_world4_data2_fsdp2_matches_world1(runs):
    w1 = runs["port_w1"]["gpt2"]
    coords = {runs["w4"][r]["coords"] for r in range(4)}
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}  # row-major ranks
    assert runs["w4"][2]["coords"] == (1, 0)
    for rank in range(4):
        got = runs["w4"][rank]
        np.testing.assert_allclose(got["losses"], w1["losses"], atol=TOL,
                                   rtol=0)
        assert W.params_close(got["tree"]["params"],
                              w1["tree"]["params"]) <= TOL


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _manifest(step_dir):
    return msgpack.msgpack_restore(read_verified(
        os.path.join(step_dir, "manifest.msgpack")))


def _shards(step_dir, n):
    return [msgpack.msgpack_restore(read_verified(os.path.join(
        step_dir, f"shard_{r:05d}.msgpack"))) for r in range(n)]


def _check_world2_file_splits_leaves_as_jax_manifest(runs):
    """Each rank's shard file holds its tiles of the parameters and the
    moments at rows ``rank * chunk``, rank 0 also the whole leaves; every
    leaf has the chunk count and the chunk starts of JAX's own FSDP save
    of the same model (one JAX process holds both devices, so its one
    shard file holds both chunks)."""
    root = runs["root"]
    mine = ckpt._pointed_version_dir(os.path.join(root, "gpt2",
                                                  ckpt.LATEST_NAME))
    theirs = jax_ckpt._pointed_version_dir(os.path.join(
        root, "jax_gpt2", ckpt.LATEST_NAME))
    got = _manifest(mine)
    with open(os.path.join(theirs, "manifest.msgpack"), "rb") as f:
        want = flax_ser.msgpack_restore(jax_integrity.unseal(f.read()))
    assert got["mesh_manifest"]["axes"] == {"data": 1, "fsdp": 2}
    assert got["nproc"] == 2 and want["nproc"] == 1
    want_leaves = {p: m for p, m in want["leaves"].items() if p != "rng"}
    got_leaves = {p: m for p, m in got["leaves"].items() if p != "rng"}
    assert got_leaves.keys() == want_leaves.keys()
    for p, meta in want_leaves.items():
        assert got_leaves[p]["shape"] == list(meta["shape"]), p
        assert got_leaves[p]["chunks"] == meta["chunks"], p
    assert sum(m["chunks"] == 2 for m in got_leaves.values()) > 10
    with open(os.path.join(theirs, "shard_00000.msgpack"), "rb") as f:
        jshard = flax_ser.msgpack_restore(jax_integrity.unseal(f.read()))
    shards = _shards(mine, 2)
    for p, meta in got_leaves.items():
        starts = sorted(e["start"] for shard in shards
                        for e in shard.get(p, []))
        assert starts == sorted(list(e["start"]) for e in jshard[p]), p
        if meta["chunks"] == 2:  # rank r holds chunk r
            dim = [i for i, s in enumerate(starts[1]) if s][0]
            for r, shard in enumerate(shards):
                (entry,) = shard[p]
                assert entry["start"][dim] == r * meta["shape"][dim] // 2
        else:
            assert p in shards[0] and p not in shards[1], p


def _check_world2_file_loads_in_jax_and_at_world1(runs):
    want = runs["w2"][0]["gpt2"]["tree"]
    jtree, epoch = runs["jax_loads_port"]
    assert epoch == 1
    jtree = dict(jtree)
    jtree.pop("rng")
    _assert_trees_equal({k: v for k, v in jtree.items()},
                        {k: v for k, v in want.items() if k != "rng"})
    tr, _ = W.trainer("gpt2")
    tr.load(os.path.join(runs["root"], "gpt2", ckpt.LATEST_NAME))
    _assert_trees_equal(train_state_to_flax(tr.state), want)


def _check_jax_fsdp_file_loads_into_the_world2_fsdp_run(runs):
    for rank in (0, 1):
        _assert_trees_equal(runs["w2"][rank]["jax_loaded"],
                            runs["jax_mlp_file"], f"rank {rank}")


def _check_world4_tiles_are_written_once(runs):
    """At data=2 x fsdp=2 the ranks of data index 1 hold the same tiles
    as those of data index 0 and write none; the file loads at world 1."""
    root = runs["root"]
    step_dir = ckpt._pointed_version_dir(os.path.join(root, "gpt2_w4",
                                                      ckpt.LATEST_NAME))
    assert _manifest(step_dir)["mesh_manifest"]["axes"] == {"data": 2,
                                                             "fsdp": 2}
    shards = _shards(step_dir, 4)
    assert shards[1] and not shards[2] and not shards[3]
    tr, _ = W.trainer("gpt2")
    tr.load(os.path.join(root, "gpt2_w4", ckpt.LATEST_NAME))
    _assert_trees_equal(train_state_to_flax(tr.state),
                        runs["w4"][0]["tree"])


def _check_gathered_fsdp_file_holds_the_replicated_state(runs, tmp_path):
    """The gathered format gathers the tiles: its state encodes byte for
    byte as a replicated run's save of the same state does."""
    path = os.path.join(runs["root"], "gpt2_gathered.ckpt")
    tr, _ = W.trainer("gpt2")
    tr.load(path)
    again = str(tmp_path / "again.ckpt")
    ckpt.save_checkpoint(again, tr.state, 1, 0.0)
    a = msgpack.msgpack_restore(read_verified(path))
    b = msgpack.msgpack_restore(read_verified(again))
    assert a["mesh_manifest"]["axes"] == {"data": 1, "fsdp": 2}
    assert (b"".join(bytes(x) for x in msgpack.msgpack_pieces(a["state"]))
            == b"".join(bytes(x) for x in msgpack.msgpack_pieces(b["state"])))
    _assert_trees_equal(b["state"], runs["w2"][0]["gpt2"]["tree"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _check_cli_trains_under_fsdp_at_world2(runs):
    assert runs["w2"][0]["cli_rc"] == runs["w2"][1]["cli_rc"] == 0


CLI_REFUSALS = [
    (["--partition", "tp"], "item 11"),
    (["--partition", "fsdp", "--zero1"], "redundant under --partition fsdp"),
    (["--mesh-fsdp", "2"], "needs --partition fsdp"),
    (["--partition", "fsdp", "--model", "bert-base", "--dataset",
      "synthetic-tokens"], "item 11"),
    (["--partition", "fsdp", "--optimizer", "adafactor"], "item 11"),
    (["--partition", "fsdp", "--mesh-fsdp", "2"], "not divisible"),
    (["--mesh-tensor", "2"], "item 11"),
    (["--mesh-pipe", "2"], "item 15"),
]


def _check_cli_refuses_what_fsdp_does_not_serve(argv, words, capsys):
    with pytest.raises(SystemExit):
        train_main(argv + ["--device", "cpu", "--epochs", "0"])
    assert words in capsys.readouterr().err


# ---------------------------------------------------------------------------
# hbm_peak_bytes (telemetry/cost.py)
# ---------------------------------------------------------------------------


class FakeMemory:
    """An allocator counter over a ledger the test sets: ``live`` bytes
    allocated now (unrelated tensors included), ``growth`` bytes the step
    adds at its peak."""

    live, growth = 0, 1000

    def __init__(self, device):
        self.device = device

    def synchronize(self):
        pass

    def reset_peak(self):
        FakeMemory.start = FakeMemory.live

    def allocated(self):
        return FakeMemory.live

    def peak(self):
        return FakeMemory.start + FakeMemory.growth


def _fit_hbm(unrelated_bytes):
    """A SimpleNet + Adam fit of 3 steps with telemetry on, on the CPU,
    ``unrelated_bytes`` live beside it (a real tensor, and on the fake
    counter); the train step's ``hbm_peak_bytes``, the model and one
    batch's bytes."""
    from distributed_pytorch_example_tpu_torch.data import DeviceLoader

    big = torch.empty(unrelated_bytes, dtype=torch.uint8)
    FakeMemory.live = 10_000 + big.numel()
    model = SimpleNet(**W.NET, dropout_rate=0.0, device="cpu", seed=0)
    tr = Trainer(model, ClassificationTask(),
                 make_optimizer(model.parameters(), "adam", 1e-3))
    loader = DeviceLoader(W.datasets("mlp")[0], W.GLOBAL_BATCH, device="cpu",
                          shuffle=False, prefetch=0)
    batch = sum(t.nbytes for t in next(iter(loader)).values())
    tr.fit(loader, None, epochs=1)
    del big
    return (tr.telemetry_summary["compiles"]["train_step"]["hbm_peak_bytes"],
            model, batch)


def _check_hbm_peak_counts_the_moments_and_not_unrelated_tensors(monkeypatch):
    """Taken on the second train step: the parameters, their gradients of
    step 1 (alive at the step's start), Adam's two moments (and its step
    counts, 4 bytes a parameter tensor), the batch and the step's growth;
    a 1 GiB tensor alive beside them changes nothing. A figure from the
    first step, before torch makes the moments, would fall below
    ``4 * params``."""
    monkeypatch.setattr(cost_lib, "_card_memory", FakeMemory)
    got = [_fit_hbm(unrelated) for unrelated in (0, 1 << 30)]
    (a, model, batch), (b, _, _) = got
    params = sum(p.numel() * 4 for p in model.parameters())
    tensors = len(list(model.parameters()))
    assert a == b
    assert a == 4 * params + batch + FakeMemory.growth + 4 * tensors
    # and the registry alone: resident + peak - start, whatever is live
    costs = cost_lib.CostRegistry(memory=FakeMemory)
    FakeMemory.live = 5 << 30
    with costs.measure("x", "cpu", resident=lambda: 777):
        pass
    assert costs.get("x")["hbm_peak_bytes"] == 777 + FakeMemory.growth


# ---------------------------------------------------------------------------
# the test: one item runs every check (each check still runs and reports)
# ---------------------------------------------------------------------------


def _run_checks(checks):
    """Run every ``(name, fn)`` check; fail once, naming each that failed
    and why."""
    failed = []
    for name, fn in checks:
        try:
            fn()
        except Exception as err:  # every check reports, not only the first
            failed.append(f"{name}: {type(err).__name__}: {err}")
    assert not failed, f"{len(failed)} of {len(checks)} checks failed:\n" \
        + "\n".join(failed)


def test_fsdp_matches_jax(runs, tmp_path, monkeypatch, capsys):
    """Every check of this file (module docstring), as one tier-1 item:
    the tier-1 run's wall time hangs on how many items collect after
    ``test_stacked.py`` (``scripts/xdist_replay.py``), and three new items
    in all keep it where it was."""
    checks = [(f"specs data={d} fsdp={f} zero1={z}",
               lambda d=d, f=f, z=z:
               _check_specs_of_every_state_leaf_match_jax(d, f, z))
              for d, f, z in SPEC_MESHES]
    checks += [(fn.__name__, fn) for fn in (
        _check_shard_largest_axis_breaks_ties_to_the_last_dim,
        _check_plan_lowers_only_the_served_families,
        _check_fsdp_update_refuses_what_it_does_not_serve)]
    checks += [(f"world-2 fit {kind}", lambda kind=kind:
                _check_world2_fsdp_fit_matches_jax_and_replicated(runs, kind))
               for kind in ("gpt2", "mlp")]
    checks += [(fn.__name__, lambda fn=fn: fn(runs)) for fn in (
        _check_world2_ranks_hold_only_their_tiles_between_steps,
        _check_world4_data2_fsdp2_matches_world1,
        _check_world2_file_splits_leaves_as_jax_manifest,
        _check_world2_file_loads_in_jax_and_at_world1,
        _check_jax_fsdp_file_loads_into_the_world2_fsdp_run,
        _check_world4_tiles_are_written_once,
        _check_cli_trains_under_fsdp_at_world2)]
    checks.append(("gathered file", lambda:
                   _check_gathered_fsdp_file_holds_the_replicated_state(
                       runs, tmp_path)))
    checks += [(f"cli refuses {' '.join(argv)}", lambda argv=argv, w=w:
                _check_cli_refuses_what_fsdp_does_not_serve(argv, w, capsys))
               for argv, w in CLI_REFUSALS]
    checks.append(("hbm_peak_bytes", lambda:
                   _check_hbm_peak_counts_the_moments_and_not_unrelated_tensors(
                       monkeypatch)))
    _run_checks(checks)
