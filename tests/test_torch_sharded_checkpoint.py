"""The port's sharded checkpoint format against the JAX package's, on the
CPU.

The cases of ``tests/test_sharded_checkpoint.py`` run on the port (round
trip, no replicated duplicates, GC, ``Trainer.fit`` resume, a bad format,
a crashed save's dir cleaned, the pointer flipped last, a format switch,
best and latest apart), and the two packages cross-load:

- at world 1 the port's shard file holds the JAX package's bytes for the
  same state (a single-device JAX save), and its manifest the same
  fields bar the mesh stamp (JAX stamps no mesh there);
- the JAX package writes sharded under its 8-device CPU FSDP mesh (the
  leaves it cuts in 8 chunks, one from each device); the port loads it at
  world 1 and at world 2 under ZeRO-1, equal to JAX's own load of it;
- the port writes sharded at world 1 and at world 2 under ZeRO-1 (a gloo
  pair: rank 0 writes the replicated leaves and its tiles, rank 1 only its
  tiles); the JAX package, in one process, loads each equal to the
  gathered checkpoint of the same state, and so does the port at world 1.

The pair (a small GPT-2, the ZeRO-1 floor lowered so that both sharded and
replicated leaves occur, as in ``tests/test_torch_zero1.py``) runs once per
test run and shares its results and files across xdist workers through a
file lock; ``tests/test_torch_elastic.py`` reads them too.

Tolerances: none. Every comparison is bit for bit: a load reassembles the
saved bytes, and the layout only slices them.
"""

import multiprocessing
import os
import pickle
import socket
import time

import filelock
import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import distributed_pytorch_example_tpu as jdpx
from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu.models.mlp import SimpleNet as JaxSimpleNet
from distributed_pytorch_example_tpu.robustness import (
    integrity as jax_integrity,
)
from distributed_pytorch_example_tpu.runtime import MeshSpec, make_mesh
from distributed_pytorch_example_tpu.train import checkpoint as jax_ckpt
from distributed_pytorch_example_tpu.train import optimizers as jax_opt
from distributed_pytorch_example_tpu.train.state import TrainState as JaxState
from distributed_pytorch_example_tpu.train.step import (
    init_state as jax_init_state,
)
from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticClassificationDataset,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.models import GPT2, SimpleNet
from distributed_pytorch_example_tpu_torch.parallel import data_parallel
from distributed_pytorch_example_tpu_torch.robustness import (
    BadStepBudgetExceeded,
    chaos,
    elastic,
)
from distributed_pytorch_example_tpu_torch.robustness.integrity import (
    read_verified,
)
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    ClassificationTask,
    Trainer,
    TrainState,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train.optimizers import (
    Chunk,
    ShardedUpdate,
)
from distributed_pytorch_example_tpu_torch.train.state import (
    state_tree,
    train_state_to_flax,
)
from distributed_pytorch_example_tpu_torch.utils import msgpack

torch.set_num_threads(2)

WORLD = 2
TIMEOUT_S = 120
# the GPT-2 of tests/test_torch_zero1.py: 2 layers of width 32; leaves of
# 256 elements and more shard under ZeRO-1
KW = dict(vocab_size=97, max_len=16, model_dim=32, num_layers=2,
          num_heads=2, mlp_dim=64)
SEQ, GLOBAL_BATCH, LR, MIN_SHARD = 16, 4, 1e-3, 256
# 8 sequences at a global batch of 4: 2 steps an epoch
EPOCHS = 3
NET = dict(input_size=16, hidden_size=32, num_classes=4)


def _fsdp_mesh():
    return make_mesh(MeshSpec(data=1, fsdp=8))


def _jax_tree(state):
    """A JAX TrainState as numpy ``to_state_dict`` form, rng as key data."""
    state = state.replace(rng=jax.random.key_data(state.rng))
    return flax_ser.to_state_dict(jax.device_get(state))


def _assert_trees_equal(got, want, what=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            what, sorted(got) if isinstance(got, dict) else got, sorted(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{what}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# the port's own cases (tests/test_sharded_checkpoint.py)
# ---------------------------------------------------------------------------


def _simplenet_state(seed=0, steps=2):
    """A small SimpleNet with Adam after ``steps`` steps (nonzero moments,
    count and step)."""
    model = SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=seed)
    trainer = Trainer(model, ClassificationTask(),
                      make_optimizer(model.parameters(), "adam", 1e-2))
    loader = DeviceLoader(SyntheticClassificationDataset(
        num_samples=8 * steps, input_size=NET["input_size"],
        num_classes=NET["num_classes"], seed=0), 8, device="cpu", seed=0)
    for batch in loader:
        trainer.train_step(trainer.state, batch)
    return trainer.state


def _fresh_state(seed=1):
    model = SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=seed)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model.parameters(), "adam",
                                               1e-2))


def test_sharded_roundtrip(tmp_path):
    state = _simplenet_state()
    path = str(tmp_path / "latest_model.ckpt")
    ckpt.save_checkpoint(path, state, 3, 0.5, {"k": 1.0}, sharded=True)
    with open(path, "rb") as f:
        assert f.read() == ckpt.SHARDED_MAGIC + b"00000003"
    step_dir = os.path.join(f"{path}.shards", "00000003")
    assert sorted(os.listdir(step_dir)) == ["manifest.msgpack",
                                            "shard_00000.msgpack"]
    fresh = _fresh_state()
    _, epoch, extra = ckpt.load_checkpoint(path, fresh)
    assert epoch == 3 and extra == {"k": 1.0}
    _assert_trees_equal(train_state_to_flax(fresh), train_state_to_flax(state))
    assert fresh.step == state.step == 2


def test_sharded_save_writes_no_replicated_duplicates(tmp_path):
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, _simplenet_state(), 1, 0.0, sharded=True)
    chunks = msgpack.msgpack_restore(read_verified(os.path.join(
        f"{path}.shards", "00000001", "shard_00000.msgpack")))
    assert "params/Dense_0/kernel" in chunks
    for p, entries in chunks.items():
        assert len(entries) == 1, f"{p} saved {len(entries)} copies"


def test_sharded_load_keeps_only_this_ranks_tiles(tmp_path, monkeypatch):
    """A load streams per leaf: of a leaf the ZeRO-1 layout shards, rank 1
    of 2 keeps only its tile (rows ``chunk`` on), and the restored tiles
    are those rows of the saved leaf."""
    path = str(tmp_path / "ck")
    state = _simplenet_state()
    ckpt.save_checkpoint(path, state, 1, 0.0, sharded=True)
    want = dict(elastic.tree_leaves(train_state_to_flax(state)))
    fresh = _fresh_state()
    layout = ShardedUpdate(fresh.model, fresh.optimizer,
                           data_parallel(WORLD, dp_shard_opt_state=True,
                                         opt_shard_min_size=MIN_SHARD),
                           rank=1, world=WORLD).layout()
    kept, place = [], ckpt._place

    def spy(full, mine):
        out = place(full, mine)
        if isinstance(out, Chunk):
            kept.append(out.data.numel() * WORLD == full.size)
        return out

    monkeypatch.setattr(ckpt, "_place", spy)
    ckpt.load_checkpoint(path, fresh, layout)
    tiles = {p: leaf for p, leaf in elastic.tree_leaves(
        state_tree(fresh, layout, gather=False)) if isinstance(leaf, Chunk)}
    assert tiles and len(kept) == len(tiles) and all(kept)
    for p, tile in tiles.items():
        assert tile.start != [0] * len(tile.start), p
        idx = tuple(slice(s, s + d)
                    for s, d in zip(tile.start, tile.data.shape))
        np.testing.assert_array_equal(tile.data.numpy(), want[p][idx],
                                      err_msg=p)


def test_sharded_gc_keeps_only_live_version(tmp_path):
    state = _simplenet_state()
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, state, 1, 0.0, sharded=True, retain=1)
    ckpt.save_checkpoint(path, state, 2, 0.0, sharded=True, retain=1)
    assert sorted(os.listdir(f"{path}.shards")) == ["00000002"]
    # the default keeps the live version and two ancestors; a mid-epoch
    # version sorts between the epochs around it
    for epoch, batch in ((3, None), (3, 1), (4, None), (5, None)):
        ckpt.save_checkpoint(path, state, epoch, 0.0,
                             {"batch_in_epoch": batch} if batch else None,
                             sharded=True)
    assert sorted(os.listdir(f"{path}.shards")) == [
        "00000003.00000001", "00000004", "00000005"]


def test_trainer_fit_resume_with_sharded_format(tmp_path):
    ckdir = str(tmp_path / "ck")

    def trainer():
        model = SimpleNet(**NET, device="cpu", seed=0)
        return Trainer(model, ClassificationTask(),
                       make_optimizer(model.parameters(), "adam", 1e-2),
                       checkpoint_dir=ckdir, checkpoint_format="sharded")

    def loader():
        return DeviceLoader(SyntheticClassificationDataset(
            num_samples=64, input_size=NET["input_size"],
            num_classes=NET["num_classes"], seed=0), 16, device="cpu",
            seed=0)

    trainer().fit(loader(), loader(), epochs=2)
    latest = os.path.join(ckdir, ckpt.LATEST_NAME)
    with open(latest, "rb") as f:
        assert f.read().startswith(ckpt.SHARDED_MAGIC)
    t2 = trainer()
    history = t2.fit(loader(), loader(), epochs=4, resume=latest)
    assert [r["epoch"] for r in history] == [2, 3]
    assert t2.state.step == 16
    # the saver ran every save, each holding the step loop only for the
    # copy (and the begin barrier, a no-op here)
    records = t2._saver.records
    assert records and all(r["write_s"] is not None and r["bytes"] > 0
                           for r in records)


def test_bad_checkpoint_format_rejected():
    model = SimpleNet(**NET, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_format"):
        Trainer(model, ClassificationTask(),
                make_optimizer(model.parameters()), checkpoint_format="bogus")


def test_stale_crashed_save_dir_is_cleaned_not_committed(tmp_path):
    """Shard files a killed save of the same version left behind (even more
    of them than this job has processes) are removed before anyone
    writes, so the rendezvous never commits them."""
    state = _simplenet_state()
    path = str(tmp_path / "ck")
    stale_dir = os.path.join(f"{path}.shards", "00000005")
    os.makedirs(stale_dir)
    for i in range(3):
        with open(os.path.join(stale_dir, f"shard_{i:05d}.msgpack"),
                  "wb") as f:
            f.write(b"".join(msgpack.msgpack_pieces({"garbage":
                                                     np.zeros(3)})))
    ckpt.save_checkpoint(path, state, 5, 0.0, sharded=True)
    assert sorted(os.listdir(stale_dir)) == ["manifest.msgpack",
                                             "shard_00000.msgpack"]
    fresh = _fresh_state()
    _, epoch, _ = ckpt.load_checkpoint(path, fresh)
    assert epoch == 5
    _assert_trees_equal(train_state_to_flax(fresh), train_state_to_flax(state))


def test_pointer_flips_only_after_manifest_commit(tmp_path, monkeypatch):
    order = []
    real = ckpt._atomic_write

    def spy(path, pieces):
        order.append(os.path.basename(path))
        return real(path, pieces)

    monkeypatch.setattr(ckpt, "_atomic_write", spy)
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, _simplenet_state(), 1, 0.0, sharded=True)
    assert order == ["shard_00000.msgpack", "manifest.msgpack", "ck"]


def test_format_switch_gcs_stale_shard_root(tmp_path):
    state = _simplenet_state()
    path = str(tmp_path / "latest_model.ckpt")
    ckpt.save_checkpoint(path, state, 1, 0.9, sharded=True)
    assert os.path.isdir(path + ".shards")
    ckpt.save_checkpoint(path, state, 2, 0.8, sharded=False)
    assert not os.path.exists(path + ".shards")
    fresh = _fresh_state()
    _, epoch, _ = ckpt.load_checkpoint(path, fresh)
    assert epoch == 2
    _assert_trees_equal(train_state_to_flax(fresh), train_state_to_flax(state))


def test_best_and_latest_shard_roots_are_independent(tmp_path):
    state = _simplenet_state()
    best = str(tmp_path / "best_model.ckpt")
    latest = str(tmp_path / "latest_model.ckpt")
    ckpt.save_checkpoint(best, state, 3, 0.5, sharded=True, retain=1)
    for epoch in (3, 4, 5):
        ckpt.save_checkpoint(latest, state, epoch, 0.4, sharded=True,
                             retain=1)
    _, best_epoch, _ = ckpt.load_checkpoint(best, _fresh_state())
    _, latest_epoch, _ = ckpt.load_checkpoint(latest, _fresh_state())
    assert (best_epoch, latest_epoch) == (3, 5)
    assert len(os.listdir(latest + ".shards")) == 1
    assert len(os.listdir(best + ".shards")) == 1


def test_another_optimizer_configuration_is_refused_unchanged(tmp_path):
    """The leaves must be this state's: an sgd state does not take an
    Adam checkpoint, and nothing changes before the refusal."""
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, _simplenet_state(), 1, 0.0, sharded=True)
    model = SimpleNet(**NET, device="cpu", seed=1)
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        model.parameters(), "sgd", 0.1))
    before = train_state_to_flax(state)
    with pytest.raises(ckpt.CheckpointCorruptError, match="leaves differ"):
        ckpt.load_checkpoint(path, state)
    _assert_trees_equal(train_state_to_flax(state), before)


# ---------------------------------------------------------------------------
# against the JAX package, one process
# ---------------------------------------------------------------------------


def _jax_state_of(state):
    """The JAX TrainState holding the port state's values (single device,
    no mesh)."""
    tree = train_state_to_flax(state)
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    tx = optax.adam(1e-2)
    opt_state = flax_ser.from_state_dict(tx.init(params), tree["opt_state"])
    return JaxState(step=jnp.asarray(tree["step"]), params=params,
                    opt_state=jax.tree_util.tree_map(jnp.asarray, opt_state),
                    model_state={},
                    rng=jax.random.wrap_key_data(jnp.asarray(tree["rng"])))


def test_world1_shard_file_holds_jax_bytes(tmp_path):
    state = _simplenet_state()
    mine, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    extra = {"best_accuracy": 0.25, "batch_in_epoch": 3}
    ckpt.save_checkpoint(mine, state, 2, 0.75, extra, sharded=True)
    jax_ckpt.save_checkpoint(theirs, _jax_state_of(state), 2, 0.75, extra,
                             sharded=True)
    version = "00000002.00000003"
    for name in ("shard_00000.msgpack", "manifest.msgpack"):
        with open(os.path.join(f"{mine}.shards", version, name), "rb") as f:
            got = f.read()
        with open(os.path.join(f"{theirs}.shards", version, name), "rb") as f:
            want = f.read()
        if name.startswith("shard"):
            assert got == want
            continue
        got = flax_ser.msgpack_restore(jax_integrity.unseal(got))
        want = flax_ser.msgpack_restore(jax_integrity.unseal(want))
        stamp = got.pop("mesh_manifest")
        assert stamp["axes"] == {"data": 1} and "mesh_manifest" not in want
        assert (flax_ser.msgpack_serialize(got)
                == flax_ser.msgpack_serialize(want))
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def _jax_fsdp_checkpoint(path):
    """A JAX SimpleNet + Adam state under the 8-device FSDP mesh, every
    leaf drawn from a seed, saved sharded; returns JAX's own load of it
    as a numpy tree."""
    mesh = _fsdp_mesh()
    state, shardings = jax_init_state(
        JaxSimpleNet(input_size=NET["input_size"],
                     hidden_size=NET["hidden_size"] * 4,
                     num_classes=NET["num_classes"]),
        optax.adam(1e-2), jnp.zeros((8, NET["input_size"]), jnp.float32),
        jax.random.key(0), jdpx.parallel.fsdp(mesh))
    rng = np.random.default_rng(0)

    def draw(x, sh):
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            return x
        if jnp.issubdtype(x.dtype, jnp.floating):
            value = rng.standard_normal(x.shape).astype(x.dtype)
        else:
            value = np.asarray(rng.integers(1, 9, x.shape), x.dtype)
        return jax.device_put(value, sh)

    state = jax.tree_util.tree_map(draw, state, shardings)
    chunked = [leaf for leaf in jax.tree_util.tree_leaves(state.opt_state)
               if len(leaf.addressable_shards) == 8
               and leaf.addressable_shards[1].index != leaf.addressable_shards[
                   0].index]
    assert chunked  # the mesh really cuts leaves into chunks
    jax_ckpt.save_checkpoint(path, state, 4, 0.25, {"k": 2.0}, sharded=True)
    loaded, epoch, _ = jax_ckpt.load_checkpoint(path, state, shardings)
    assert epoch == 4
    return _jax_tree(loaded)


def _port_simplenet(seed=3, zero1=False, world=1, rank=0):
    """A port SimpleNet (JAX's hidden width x4) with Adam; under ZeRO-1 at
    ``world`` its trainer's layout."""
    model = SimpleNet(input_size=NET["input_size"],
                      hidden_size=NET["hidden_size"] * 4,
                      num_classes=NET["num_classes"], device="cpu", seed=seed)
    part = (data_parallel(world, dp_shard_opt_state=True,
                          opt_shard_min_size=MIN_SHARD) if zero1 else None)
    return Trainer(model, ClassificationTask(),
                   make_optimizer(model.parameters(), "adam", 1e-2),
                   partitioner=part)


def test_jax_fsdp_sharded_loads_in_port_at_world1(tmp_path):
    path = str(tmp_path / "jax.ckpt")
    want = _jax_fsdp_checkpoint(path)
    trainer = _port_simplenet()
    epoch, extra = trainer.load(path)
    assert epoch == 4 and extra == {"k": 2.0}
    _assert_trees_equal(train_state_to_flax(trainer.state), want)


def test_port_world1_sharded_loads_in_jax_like_gathered(tmp_path):
    state = _simplenet_state()
    sharded, gathered = str(tmp_path / "s.ckpt"), str(tmp_path / "g.ckpt")
    ckpt.save_checkpoint(sharded, state, 1, 0.0, sharded=True)
    ckpt.save_checkpoint(gathered, state, 1, 0.0)
    template = _jax_state_of(_fresh_state())
    a, _, _ = jax_ckpt.load_checkpoint(sharded, template)
    b, _, _ = jax_ckpt.load_checkpoint(gathered, template)
    _assert_trees_equal(_jax_tree(a), _jax_tree(b))
    _assert_trees_equal(_jax_tree(a), train_state_to_flax(state))


# ---------------------------------------------------------------------------
# world 2: one pair of gloo processes, shared with test_torch_elastic.py
# ---------------------------------------------------------------------------


def gpt2_trainer(zero1, checkpoint_dir, world, **kw):
    """Adam on the seed-0 GPT-2 through Trainer.fit, ZeRO-1 or replicated,
    recording each step's loss."""
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    part = (data_parallel(world, dp_shard_opt_state=True,
                          opt_shard_min_size=MIN_SHARD) if zero1 else None)
    trainer = Trainer(model, CausalLMTask(),
                      make_optimizer(model.parameters(), "adam", LR),
                      partitioner=part, checkpoint_dir=checkpoint_dir,
                      log_every=1, **kw)
    losses, step_fn = [], trainer.train_step

    def step(state, batch):
        metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        return metrics

    trainer.train_step = step
    return trainer, losses


def gpt2_loader(rank=0, world=1):
    """8 sequences at a global batch of 4, this rank's shard."""
    return DeviceLoader(SyntheticTokenDataset(8, seq_len=SEQ,
                                              vocab_size=KW["vocab_size"],
                                              seed=0),
                        GLOBAL_BATCH, device="cpu", num_shards=world,
                        shard_id=rank, prefetch=0)


def _rollback_under_a_held_commit(rank, checkpoint_dir, slow_commit):
    """The recovery counters of the run, or the error that ended it."""
    model = SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=0)
    part = data_parallel(WORLD, dp_shard_opt_state=True,
                         opt_shard_min_size=MIN_SHARD)
    trainer = Trainer(model, ClassificationTask(),
                      make_optimizer(model.parameters(), "adam", 1e-2),
                      partitioner=part, checkpoint_dir=checkpoint_dir,
                      log_every=1, save_every_steps=1, max_bad_steps=1)
    loader = DeviceLoader(SyntheticClassificationDataset(
        num_samples=16, input_size=NET["input_size"],
        num_classes=NET["num_classes"], seed=0), 8, device="cpu",
        num_shards=WORLD, shard_id=rank, prefetch=0)
    write = ckpt._atomic_write
    chaos.install(chaos.ChaosPlan([chaos.Fault("nan-batch", step=0,
                                               count=2)]))
    ckpt._atomic_write = slow_commit
    try:
        trainer.fit(loader, None, epochs=1)
    except BadStepBudgetExceeded as err:
        return str(err)
    finally:
        ckpt._atomic_write = write
        chaos.uninstall()
    return dict(trainer.recovery)


def _worker(rank, port, root, results):
    torch.set_num_threads(1)
    config = distributed.DistributedConfig(WORLD, rank, f"localhost:{port}")
    distributed.initialize(config, device="cpu", max_attempts=2)
    try:
        out = {}
        # one ZeRO-1 epoch in auto's format (sharded at world 2), `latest`
        # after every step; then the same state gathered
        w2, losses = gpt2_trainer(True, os.path.join(root, "w2"), WORLD,
                                  save_every_steps=1)
        w2.fit(gpt2_loader(rank, WORLD), None, epochs=1)
        out["w2_losses"] = losses
        out["w2_records"] = [{k: r[k] for k in ("hold_s", "bytes")}
                             for r in w2._saver.records]
        ckpt.save_checkpoint(os.path.join(root, "w2g", ckpt.LATEST_NAME),
                             w2.state, 1, 0.0, layout=w2.layout())
        # rank 0's commit held back: fit returns on no rank before the
        # pointer names the epoch's version
        write = ckpt._atomic_write

        def slow_commit(path, pieces):
            if rank == 0 and path.endswith(ckpt.LATEST_NAME):
                time.sleep(1.0)
            return write(path, pieces)

        ckpt._atomic_write = slow_commit
        slow, _ = gpt2_trainer(True, os.path.join(root, "slow"), WORLD)
        slow.fit(gpt2_loader(rank, WORLD), None, epochs=1)
        ckpt._atomic_write = write
        with open(os.path.join(root, "slow", ckpt.LATEST_NAME), "rb") as f:
            out["pointer_after_fit"] = f.read()
        # every rank exceeds its bad-step budget while the first sharded
        # save's commit is still held back on rank 0 (ZeRO-1 SimpleNet,
        # steps 0 and 1 poisoned, `latest` after step 0): each rank waits
        # for the save and meets the others before it looks for `latest`
        out["rollback"] = _rollback_under_a_held_commit(
            rank, os.path.join(root, "rollback"), slow_commit)
        # the world-1 sharded checkpoint (the parent's) resumed at world 2
        up, up_losses = gpt2_trainer(True, None, WORLD)
        up.fit(gpt2_loader(rank, WORLD), None, epochs=EPOCHS,
               resume=os.path.join(root, "w1", ckpt.LATEST_NAME))
        out["w1_to_w2_losses"] = up_losses
        out["w1_to_w2_step"] = up.state.step
        # JAX's FSDP checkpoint loaded under ZeRO-1 at world 2
        jt = _port_simplenet(zero1=True, world=WORLD, rank=rank)
        jt.load(os.path.join(root, "jax", ckpt.LATEST_NAME))
        out["jax_fsdp_tree"] = train_state_to_flax(jt.state, jt.layout())
        out["jax_fsdp_tiles"] = sum(
            t is not None for t in jt._step.sharded(jt.state).tiles)
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
    return got


def _prepare_and_spawn(root):
    """The parent's part (JAX's FSDP checkpoint, the world-1 runs), then
    the pair; every result as numpy."""
    os.makedirs(root, exist_ok=True)
    jax_tree = _jax_fsdp_checkpoint(
        os.path.join(root, "jax", ckpt.LATEST_NAME))
    # world 1, replicated: the uninterrupted run, and one epoch saved
    # sharded after every step
    ref, ref_losses = gpt2_trainer(False, None, 1)
    ref.fit(gpt2_loader(), None, epochs=EPOCHS)
    w1, _ = gpt2_trainer(False, os.path.join(root, "w1"), 1,
                         checkpoint_format="sharded", save_every_steps=1)
    w1.fit(gpt2_loader(), None, epochs=1)
    got = _spawn_pair(root)
    return {"root": root, "jax_tree": jax_tree, "w1_ref_losses": ref_losses,
            "w1_ref_step": ref.state.step, "pair": got}


@pytest.fixture(scope="module")
def sharded_pair(tmp_path_factory):
    """Runs once per test run: under pytest-xdist the first worker here
    runs it and leaves the results (and the checkpoint files) in the run's
    shared temporary directory."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _prepare_and_spawn(str(tmp_path_factory.mktemp("sharded")))
    base = tmp_path_factory.getbasetemp().parent
    path = base / "test_torch_sharded_checkpoint.pkl"
    with filelock.FileLock(f"{path}.lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        got = _prepare_and_spawn(str(base / "test_torch_sharded_pair"))
        path.write_bytes(pickle.dumps(got))
        return got


def _manifest(step_dir):
    return msgpack.msgpack_restore(read_verified(
        os.path.join(step_dir, "manifest.msgpack")))


def test_world2_zero1_shards_split_as_jax_does(sharded_pair):
    """Rank 1's file holds only its ZeRO-1 tiles, each at rows ``chunk``
    on; rank 0's holds every replicated leaf and its own tiles; the
    manifest counts two chunks for a sharded leaf, one otherwise."""
    path = os.path.join(sharded_pair["root"], "w2", ckpt.LATEST_NAME)
    step_dir = ckpt._pointed_version_dir(path)
    assert os.path.basename(step_dir) == "00000001"
    manifest = _manifest(step_dir)
    assert manifest["nproc"] == WORLD and manifest["host_leaves"] == {}
    assert manifest["mesh_manifest"]["axes"] == {"data": WORLD}
    dims = manifest["mesh_manifest"]["zero1_dims"]
    assert dims and all(p.startswith("opt_state/") for p in dims)
    shards = [msgpack.msgpack_restore(read_verified(os.path.join(
        step_dir, f"shard_{r:05d}.msgpack"))) for r in range(WORLD)]
    assert set(shards[1]) == set(dims)
    assert set(shards[0]) == set(manifest["leaves"])
    for p, meta in manifest["leaves"].items():
        assert meta["chunks"] == (WORLD if p in dims else 1), p
        for rank, shard in enumerate(shards):
            if p not in shard:
                continue
            (entry,) = shard[p]
            chunk = meta["shape"][dims[p]] // WORLD if p in dims else 0
            want = [0] * len(meta["shape"])
            if p in dims:
                want[dims[p]] = rank * chunk
            assert entry["start"] == want, p
    # every save, mid-epoch ones included, ran on the saver's thread
    for rank in range(WORLD):
        records = sharded_pair["pair"][rank]["w2_records"]
        assert len(records) == 2 and all(r["bytes"] for r in records)


def test_fit_returns_after_the_last_sharded_save_commits(sharded_pair):
    """Rank 0 flips the pointer after every rank's file lands (here held
    back a second); fit returns on no rank before that, so the next fit
    of any rank resumes from the same version."""
    for rank in range(WORLD):
        assert (sharded_pair["pair"][rank]["pointer_after_fit"]
                == ckpt.SHARDED_MAGIC + b"00000001")


def test_every_rank_rolls_back_while_a_sharded_save_is_in_flight(
        sharded_pair):
    """No rank decides on the rollback before rank 0 has flipped the
    pointer of the save in flight: every rank rolls back to it."""
    for rank in range(WORLD):
        assert sharded_pair["pair"][rank]["rollback"] == {
            "bad_steps": 2, "rollbacks": 1, "checkpoint_fallbacks": 0}, rank


def test_port_world2_sharded_loads_in_jax_like_gathered(sharded_pair):
    root = sharded_pair["root"]
    jmodel = JaxGPT2(**KW, logits_mode="hidden")
    tx = jax_opt.make_optimizer("adam", LR)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, SEQ), jnp.int32))["params"]
    template = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=tx.init(params), model_state={},
                        rng=jax.random.key(5))
    a, ea, _ = jax_ckpt.load_checkpoint(
        os.path.join(root, "w2", ckpt.LATEST_NAME), template)
    b, eb, _ = jax_ckpt.load_checkpoint(
        os.path.join(root, "w2g", ckpt.LATEST_NAME), template)
    assert ea == eb == 1 and int(a.step) == 2
    _assert_trees_equal(_jax_tree(a), _jax_tree(b))


def test_port_world2_sharded_loads_at_world1_like_gathered(sharded_pair):
    root = sharded_pair["root"]
    a, _ = gpt2_trainer(False, None, 1)
    a.load(os.path.join(root, "w2", ckpt.LATEST_NAME))
    b, _ = gpt2_trainer(False, None, 1)
    b.load(os.path.join(root, "w2g", ckpt.LATEST_NAME))
    _assert_trees_equal(train_state_to_flax(a.state),
                        train_state_to_flax(b.state))
    assert a.state.step == 2


def test_jax_fsdp_sharded_loads_in_port_at_world2(sharded_pair):
    for rank in range(WORLD):
        out = sharded_pair["pair"][rank]
        assert out["jax_fsdp_tiles"] > 0  # ZeRO-1 really slices tiles
        _assert_trees_equal(out["jax_fsdp_tree"], sharded_pair["jax_tree"],
                            f"rank {rank}")
