"""The port's tensor parallelism (``PlanSpec(family="transformer")``,
``--partition tp``) against the JAX package's ``transformer_partitioner``,
on the CPU.

- Specs: every leaf of a tiny GPT-2's and a tiny LLaMA's train state
  (params and Adam moments) gets the spec JAX's
  ``transformer_partitioner(mesh).tree_specs`` gives it, on a
  ``tensor=2`` mesh over 2 of the 8 virtual CPU devices and on
  ``data=2 x tensor=2`` over 4; the dims the port's layers cut equal
  ``Partitioner.tensor_dim`` of every leaf (LLaMA's vocab of 128 is cut,
  GPT-2's 97 is not, as JAX's vocab rules decide).
- Forward: the port's world-2 TP forward (two gloo processes, ``full``
  logits) equals JAX's jitted forward under the TP shardings on the same
  weights, as ``tests/test_models.py`` and ``tests/test_llama.py`` hold
  JAX's own, and the port's replicated one.
- Training: the port's TP Trainer at world 2 (``tensor=2``) and at world 4
  (``data=2 x tensor=2``), GPT-2 and LLaMA (2 layers, width 64): 3 steps
  and a validation batch, SGD (momentum 0.9, lr 0.1), against JAX's
  Trainer under ``transformer_partitioner`` on a 2-device ``tensor=2``
  mesh and against the port's replicated world-1 run, on the same weights
  and batches. The tensor group's collectives are counted: 2 a layer in
  each forward and 2 in each backward, and LLaMA's vocab-parallel
  embedding, loss and head add 2 forward and 1 backward.
- Tolerances, from FSDP's 2e-6 (``tests/test_torch_fsdp.py``): the
  forward's logits, the losses, the validation loss and the parameters
  after 3 steps within 2e-6, the ``grad_norm`` and ``param_norm``
  sentinels within 1e-6 of their value. The runs differ in the order
  float32 sums are taken: a row-parallel product sums two half
  products, a column-parallel one runs narrower products, the world-4
  mean is the mean of two 2-row means, and JAX's XLA program orders its
  own; measured here up to 5.2e-7 on the logits, 9.5e-7 on the losses,
  1.2e-7 on the parameters and 1.2e-7 of the norms' values.
- The vocab-parallel chunked CE equals the whole-vocab one in loss
  (1e-6), argmax (exactly) and gradients (the table's 1e-6; the hidden
  states' 1e-5 of a gradient of norm about 40: two partial products
  summed across ranks).
- Checkpoints, bit for bit (a load reassembles saved bytes): the port's
  world-2 sharded file has the chunks and mesh specs of JAX's own TP save
  of the same model, loads in JAX and in the port at world 1 equal to the
  gathered state; JAX's TP file loads into the port's world-2 run equal
  to JAX's own load; at world 4 only the ranks of data index 0 write
  slices; the gathered file's state encodes as a replicated run's.
- The CLI: ``--partition tp --mesh-tensor 2`` trains at world 2; the
  combinations the port does not serve are refused, naming ROADMAP.md
  item 11.

The processes (``tests/_torch_tp_worker.py``, which imports no JAX) are
spawned once per test run, and their results are shared across xdist
workers through a file lock. Every check runs inside one tier-1 item,
:func:`test_tp_matches_jax`, which names each check that failed.
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
    SyntheticTokenDataset as JaxTokenData,
)
from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu.models.llama import Llama as JaxLlama
from distributed_pytorch_example_tpu.parallel.api import _path_str
from distributed_pytorch_example_tpu.parallel.partition import (
    transformer_partitioner as jax_transformer_partitioner,
)
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
from distributed_pytorch_example_tpu_torch.models import GPT2, Llama
from distributed_pytorch_example_tpu_torch.parallel import (
    PlanSpec,
    TensorParallel,
    transformer_partitioner,
)
from distributed_pytorch_example_tpu_torch.robustness.integrity import (
    read_verified,
)
from distributed_pytorch_example_tpu_torch.runtime import MeshSpec, make_mesh
from distributed_pytorch_example_tpu_torch.train import (
    TrainState,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train.cli import main as train_main
from distributed_pytorch_example_tpu_torch.train.optimizers import (
    TensorUpdate,
)
from distributed_pytorch_example_tpu_torch.train.state import (
    state_tree,
    to_host,
    to_numpy,
    train_state_to_flax,
)
from distributed_pytorch_example_tpu_torch.utils import msgpack

import _torch_tp_worker as W

torch.set_num_threads(2)

TOL = 2e-6
NORM_RTOL = 1e-6
JAX_MODELS = {"gpt2": JaxGPT2, "llama": JaxLlama}


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


def _jax_mesh(data, tensor):
    return jax_make_mesh(JaxMeshSpec(data=data, tensor=tensor),
                         devices=jax.devices()[:data * tensor])


def _seed_params(kind):
    """The seed-0 weights of the replicated port model, as numpy."""
    return _np(interop.params_to_flax(W.model_of(kind)))


# ---------------------------------------------------------------------------
# specs, against JAX's partitioner (no process)
# ---------------------------------------------------------------------------


SPEC_MESHES = [(1, 2), (2, 2)]


def _check_specs_of_every_state_leaf_match_jax(kind, data, tensor):
    model = W.model_of(kind)
    tree = state_tree(TrainState(step=0, model=model, optimizer=make_optimizer(
        model.parameters(), "adam", 1e-3)))
    params = jax.tree_util.tree_map(jnp.asarray, _seed_params(kind))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=optax.adam(1e-3).init(params),
                      model_state={}, rng=jax.random.key(0))
    jpart = jax_transformer_partitioner(_jax_mesh(data, tensor))
    part = transformer_partitioner(make_mesh(
        MeshSpec(data=data, tensor=tensor), world=data * tensor,
        groups=False))
    want = {_path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jpart.tree_specs(jstate),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    got = {k: tuple(v) for k, v in _flat(part.tree_specs(tree)).items()}
    assert want.pop("rng") == () and "rng" in got
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    cut = {k for k, s in want.items() if any(e is not None for e in s)}
    assert len(cut) >= 8 * 3  # every block's q/k/v/o/mlp, params + moments
    vocab = {f"params/{p}" for p in ("tok_embed/embedding", "lm_head")}
    assert (vocab <= cut) == (kind == "llama")
    assert "params/wte/embedding" not in cut
    assert tuple(part.batch_spec()) == tuple(jpart.batch_spec())
    # the dims the port's layers cut are the rules' dims
    tp_model = W.model_of(kind, tensor_parallel=TensorParallel(tensor, 1))
    leaves = interop.flax_leaves(model)
    for leaf, dim in zip(leaves, interop.tensor_dims(tp_model, leaves)):
        shape = leaf.jax_shape(dict(model.named_parameters())[
            leaf.name].shape)
        assert part.tensor_dim("params/" + leaf.key, shape) == dim, leaf.key


def _check_plan_lowers_the_transformer_family_as_jax():
    mesh = make_mesh(MeshSpec(data=1, tensor=2), world=2, groups=False)
    for plan in (PlanSpec(family="transformer", zero1=True),
                 PlanSpec(family="transformer", fsdp_rest=True)):
        with pytest.raises(NotImplementedError, match="item 11"):
            plan.lower(mesh)
    plan = PlanSpec(mesh=MeshSpec(data=2, tensor=2), family="transformer")
    jplan = jdpx.parallel.plan.PlanSpec(
        mesh=JaxMeshSpec(data=2, tensor=2), family="transformer")
    assert plan.name() == jplan.name() == "tf:data2,tensor2"
    assert plan.to_json() == jplan.to_json()
    part = plan.lower(mesh)
    assert part.tensor_axis == "tensor" and part.fsdp_axis is None
    assert part.mesh_shape == {"data": 1, "tensor": 2}


def _check_refusals_name_item_11():
    tp = TensorParallel(2, 0)
    for make in (lambda: GPT2(**W.GPT, dropout_rate=0.1, device="cpu",
                              tensor_parallel=tp),
                 lambda: GPT2(**W.GPT, remat=True, device="cpu",
                              tensor_parallel=tp),
                 lambda: GPT2(**W.GPT, decode=True, device="cpu",
                              tensor_parallel=tp),
                 lambda: GPT2(**{**W.GPT, "vocab_size": 96}, device="cpu",
                              tensor_parallel=tp),
                 lambda: Llama(**W.LLAMA, remat=True, device="cpu",
                               tensor_parallel=tp)):
        with pytest.raises(NotImplementedError, match="item 11"):
            make()
    with pytest.raises(ValueError, match="num_heads"):
        GPT2(**{**W.GPT, "num_heads": 1}, device="cpu", tensor_parallel=tp)
    with pytest.raises(ValueError, match="num_kv_heads"):
        Llama(**{**W.LLAMA, "num_kv_heads": 1}, device="cpu",
              tensor_parallel=tp)
    mesh = make_mesh(MeshSpec(data=1, tensor=1), world=1, groups=False)
    model = W.model_of("gpt2")
    for name in ("lamb", "adafactor"):
        with pytest.raises(NotImplementedError, match="item 11"):
            TensorUpdate(model, make_optimizer(model, name, 1e-3),
                         transformer_partitioner(mesh))


# ---------------------------------------------------------------------------
# the processes, once per test run
# ---------------------------------------------------------------------------


def _jax_loaders(kind, jmesh):
    vocab = W.KINDS[kind][1]["vocab_size"]
    return [JaxLoader(JaxTokenData(seed=seed, num_samples=W.GLOBAL_BATCH * k,
                                   seq_len=W.SEQ, vocab_size=vocab),
                      W.GLOBAL_BATCH, mesh=jmesh, shuffle=False, prefetch=0)
            for k, seed in ((W.STEPS, 0), (1, 1))]


def _jax_fit(kind, ckpt_dir):
    """JAX's Trainer under transformer_partitioner on a 2-device tensor=2
    mesh from the port's seed-0 weights: per-step losses and sentinels,
    validation loss, the final state as numpy; it saves sharded."""
    jmesh = _jax_mesh(1, 2)
    jmodel = JAX_MODELS[kind](**W.KINDS[kind][1], logits_mode="hidden")
    tx = jax_opt.make_optimizer("sgd", W.LR)
    jt = jax_loop.Trainer(jmodel, jax_tasks.CausalLMTask(), tx,
                          partitioner=jax_transformer_partitioner(jmesh),
                          telemetry=False, checkpoint_dir=ckpt_dir,
                          checkpoint_format="sharded", log_every=100)
    loaders = _jax_loaders(kind, jmesh)
    jt.init(jt._sample_inputs_from(loaders[0]))
    params = jax.tree_util.tree_map(jnp.asarray, _seed_params(kind))
    jt.state = jax.device_put(
        jt.state.replace(params=params, opt_state=tx.init(params)),
        jt.state_shardings)
    steps, step = [], jt.train_step

    def recording(state, batch):
        out = step(state, batch)
        steps.append({k: float(out[1][k]) for k in ("loss", "grad_norm",
                                                    "param_norm")})
        return out

    jt.train_step = recording
    hist = jt.fit(*loaders, epochs=1)
    return {"losses": [s["loss"] for s in steps],
            "grad_norms": [s["grad_norm"] for s in steps],
            "param_norms": [s["param_norm"] for s in steps],
            "val_loss": hist[0]["val_loss"], "tree": _jax_tree(jt.state),
            "state": jt.state, "shardings": jt.state_shardings}


def _jax_forward(kind):
    """JAX's jitted forward (``full`` logits) under the TP shardings of a
    2-device tensor=2 mesh, from the port's seed-0 weights."""
    jmodel = JAX_MODELS[kind](**W.KINDS[kind][1])
    variables = {"params": jax.tree_util.tree_map(jnp.asarray,
                                                  _seed_params(kind))}
    part = jax_transformer_partitioner(_jax_mesh(1, 2))
    sharded = jax.device_put(variables, part.tree_shardings(variables))
    tokens = jnp.asarray(np.random.default_rng(7).integers(
        0, W.KINDS[kind][1]["vocab_size"], (2, W.SEQ)), jnp.int32)
    out = jax.jit(lambda v, t: jmodel.apply(v, t, train=False))(sharded,
                                                                tokens)
    return np.asarray(out)


def _jax_tp_checkpoint(path):
    """A JAX LLaMA + SGD state under the 2-device TP mesh, every leaf
    drawn from a seed, saved sharded; JAX's own load of it."""
    state, shardings = jax_init_state(
        JaxLlama(**W.LLAMA), jax_opt.make_optimizer("sgd", W.LR),
        jnp.zeros((8, W.SEQ), jnp.int32), jax.random.key(0),
        jax_transformer_partitioner(_jax_mesh(1, 2)))
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
    out["jax_llama_file"] = _jax_tp_checkpoint(
        os.path.join(root, "jax_llama", ckpt.LATEST_NAME))
    jax_runs = {kind: _jax_fit(kind, os.path.join(root, f"jax_{kind}_fit"))
                for kind in W.KINDS}
    out["jax"] = {k: {key: v[key] for key in (
        "losses", "grad_norms", "param_norms", "val_loss", "tree")}
        for k, v in jax_runs.items()}
    out["jax_forward"] = {kind: _jax_forward(kind) for kind in W.KINDS}
    out["port_w1"] = {kind: W.replicated(kind) for kind in W.KINDS}
    out["w2"] = W.spawn(2, root)
    out["w4"] = W.spawn(4, root)
    # JAX's loads of the port's world-2 files, with the fits' templates
    out["jax_loads_port"] = {}
    for kind, run in jax_runs.items():
        loaded, epoch, _ = jax_ckpt.load_checkpoint(
            os.path.join(root, kind, ckpt.LATEST_NAME), run["state"],
            run["shardings"])
        out["jax_loads_port"][kind] = (_jax_tree(loaded), epoch)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _prepare_and_spawn(str(tmp_path_factory.mktemp("tp")))
    base = tmp_path_factory.getbasetemp().parent
    path = base / "test_torch_tp.pkl"
    with filelock.FileLock(f"{path}.lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        got = _prepare_and_spawn(str(base / "test_torch_tp_runs"))
        path.write_bytes(pickle.dumps(got))
        return got


# ---------------------------------------------------------------------------
# forward and training
# ---------------------------------------------------------------------------


def _check_world2_forward_matches_jax_and_replicated(runs, kind):
    want = runs["jax_forward"][kind]
    w1 = runs["port_w1"][kind]["forward"]
    for rank in (0, 1):
        got = runs["w2"][rank][kind]["forward"]
        assert got.shape == want.shape == w1.shape
        assert float(np.abs(got - want).max()) <= TOL, rank
        assert float(np.abs(got - w1).max()) <= TOL, rank


def _check_close_runs(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL,
                               rtol=0, err_msg=what)
    assert abs(got["val_loss"] - want["val_loss"]) <= TOL, what
    for key in ("grad_norms", "param_norms"):
        np.testing.assert_allclose(got[key], want[key], rtol=NORM_RTOL,
                                   atol=0, err_msg=f"{what} {key}")
    assert W.params_close(got["tree"]["params"],
                          want["tree"]["params"]) <= TOL, what


def _check_fit_matches_jax_and_replicated(runs, world, kind):
    jax_run, w1 = runs["jax"][kind], runs["port_w1"][kind]
    for rank, out in runs[f"w{world}"].items():
        got = out[kind]
        assert len(got["losses"]) == W.STEPS
        _check_close_runs(got, jax_run, f"rank {rank} vs JAX")
        _check_close_runs(got, w1, f"rank {rank} vs world 1")
        assert W.params_close(got["tree"]["opt_state"],
                              w1["tree"]["opt_state"]) <= TOL


def _check_tensor_collectives_counted(runs):
    """2 a layer in each forward (3 steps + 1 validation batch) and each
    backward (3 steps); LLaMA adds the embedding's and the loss's forward
    collectives and the loss's backward one."""
    layers = W.GPT["num_layers"]
    want = {"gpt2": {"forward": 2 * layers * (W.STEPS + 1),
                     "backward": 2 * layers * W.STEPS},
            "llama": {"forward": (2 * layers + 2) * (W.STEPS + 1),
                      "backward": (2 * layers + 1) * W.STEPS}}
    for world in (2, 4):
        for rank, out in runs[f"w{world}"].items():
            for kind in W.KINDS:
                assert out[kind]["counts"] == want[kind], (world, rank, kind)


def _check_ranks_hold_only_their_slices(runs):
    full = {kind: {n: tuple(p.shape) for n, p in
                   W.model_of(kind).named_parameters()} for kind in W.KINDS}
    for rank in (0, 1):
        for kind in W.KINDS:
            got = runs["w2"][rank][kind]
            cut = got["cut"]
            assert ("tok_embed.weight" in cut) == (kind == "llama")
            assert "wte.weight" not in cut
            assert len(cut) >= 7 * W.GPT["num_layers"] - 1
            for name, shape in got["shapes"].items():
                want = list(full[kind][name])
                if name in cut:
                    want[cut[name]] //= 2
                assert shape == tuple(want), (kind, name)


def _check_vocab_parallel_ce_matches_whole_vocab(runs):
    for rank in (0, 1):
        ce = runs["w2"][rank]["ce"]
        assert ce["argmax_equal"], rank
        assert ce["loss"] <= 1e-6 and ce["de"] <= 1e-6, (rank, ce)
        assert ce["dx"] <= 1e-5, (rank, ce)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _manifest(step_dir):
    return msgpack.msgpack_restore(read_verified(
        os.path.join(step_dir, "manifest.msgpack")))


def _shards(step_dir, n):
    return [msgpack.msgpack_restore(read_verified(os.path.join(
        step_dir, f"shard_{r:05d}.msgpack"))) for r in range(n)]


def _jax_unseal(path):
    with open(path, "rb") as f:
        return flax_ser.msgpack_restore(jax_integrity.unseal(f.read()))


def _canonical(spec):
    """A stamped spec without its trailing replicated dims (JAX's jitted
    step hands back ``P("tensor")`` where its rule says ``P("tensor",
    None)``; the two place a leaf alike)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return spec


def _check_world2_file_splits_leaves_as_jax_manifest(runs, kind):
    """Each rank's shard file holds its slices of the parameters and the
    moments at ``rank * width``, rank 0 also the whole leaves; every leaf
    has the chunk count, the chunk starts and the mesh spec of JAX's own
    TP save of the same model."""
    root = runs["root"]
    mine = ckpt._pointed_version_dir(os.path.join(root, kind,
                                                  ckpt.LATEST_NAME))
    theirs = jax_ckpt._pointed_version_dir(os.path.join(
        root, f"jax_{kind}_fit", ckpt.LATEST_NAME))
    got = _manifest(mine)
    want = _jax_unseal(os.path.join(theirs, "manifest.msgpack"))
    assert got["mesh_manifest"]["axes"] == {"data": 1, "tensor": 2}
    assert {k: v for k, v in want["mesh_manifest"]["axes"].items()
            if v != 1} == {"tensor": 2}
    assert got["nproc"] == 2 and want["nproc"] == 1
    want_leaves = {p: m for p, m in want["leaves"].items() if p != "rng"}
    got_leaves = {p: m for p, m in got["leaves"].items() if p != "rng"}
    assert got_leaves.keys() == want_leaves.keys()
    for p, meta in want_leaves.items():
        assert got_leaves[p]["shape"] == list(meta["shape"]), p
        assert got_leaves[p]["chunks"] == meta["chunks"], p
        assert (_canonical(got["mesh_manifest"]["specs"][p])
                == _canonical(want["mesh_manifest"]["specs"][p])), p
    assert sum(m["chunks"] == 2 for m in got_leaves.values()) > 10
    jshard = _jax_unseal(os.path.join(theirs, "shard_00000.msgpack"))
    shards = _shards(mine, 2)
    for p, meta in got_leaves.items():
        starts = sorted(e["start"] for shard in shards
                        for e in shard.get(p, []))
        assert starts == sorted(list(e["start"]) for e in jshard[p]), p
        if meta["chunks"] == 1:
            assert p in shards[0] and p not in shards[1], p


def _check_world2_file_loads_in_jax_and_at_world1(runs, kind):
    want = runs["w2"][0][kind]["tree"]
    jtree, epoch = runs["jax_loads_port"][kind]
    assert epoch == 1
    jtree = dict(jtree)
    jtree.pop("rng")
    _assert_trees_equal(jtree, {k: v for k, v in want.items() if k != "rng"})
    tr, _ = W.trainer(kind)
    tr.load(os.path.join(runs["root"], kind, ckpt.LATEST_NAME))
    _assert_trees_equal(train_state_to_flax(tr.state), want)


def _check_jax_tp_file_loads_into_the_world2_run(runs):
    for rank in (0, 1):
        _assert_trees_equal(runs["w2"][rank]["jax_loaded"],
                            runs["jax_llama_file"], f"rank {rank}")


def _check_world4_slices_are_written_once(runs, kind):
    """At data=2 x tensor=2 the ranks of data index 1 hold the same slices
    as those of data index 0 and write none; the file loads at world 1."""
    root = runs["root"]
    assert [runs["w4"][r]["coords"] for r in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    step_dir = ckpt._pointed_version_dir(os.path.join(root, f"{kind}_w4",
                                                      ckpt.LATEST_NAME))
    assert _manifest(step_dir)["mesh_manifest"]["axes"] == {"data": 2,
                                                             "tensor": 2}
    shards = _shards(step_dir, 4)
    assert shards[1] and not shards[2] and not shards[3]
    tr, _ = W.trainer(kind)
    tr.load(os.path.join(root, f"{kind}_w4", ckpt.LATEST_NAME))
    _assert_trees_equal(train_state_to_flax(tr.state),
                        runs["w4"][0][kind]["tree"])


def _check_gathered_tp_file_holds_the_replicated_state(runs, tmp_path):
    """The gathered format gathers the slices: its state encodes byte for
    byte as a replicated run's save of the same state does."""
    path = os.path.join(runs["root"], "gpt2_gathered.ckpt")
    tr, _ = W.trainer("gpt2")
    tr.load(path)
    again = str(tmp_path / "again.ckpt")
    ckpt.save_checkpoint(again, tr.state, 1, 0.0)
    a = msgpack.msgpack_restore(read_verified(path))
    b = msgpack.msgpack_restore(read_verified(again))
    assert a["mesh_manifest"]["axes"] == {"data": 1, "tensor": 2}
    assert (b"".join(bytes(x) for x in msgpack.msgpack_pieces(a["state"]))
            == b"".join(bytes(x) for x in msgpack.msgpack_pieces(b["state"])))
    _assert_trees_equal(b["state"], runs["w2"][0]["gpt2"]["tree"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _check_cli_trains_under_tp_at_world2(runs):
    assert runs["w2"][0]["cli_rc"] == runs["w2"][1]["cli_rc"] == 0


_LM = ["--model", "gpt2", "--dataset", "synthetic-tokens", "--partition",
       "tp"]
CLI_REFUSALS = [
    (["--partition", "tp"], "item 11"),
    (["--partition", "tp", "--model", "bert-base", "--dataset",
      "synthetic-tokens"], "item 11"),
    (["--partition", "tp", "--model", "vit-b16", "--dataset",
      "synthetic-image"], "item 11"),
    (["--partition", "tp", "--model", "resnet18", "--dataset",
      "synthetic-image"], "item 11"),
    (_LM + ["--zero1"], "item 11"),
    (_LM + ["--optimizer", "lamb"], "item 11"),
    (_LM + ["--optimizer", "adafactor"], "item 11"),
    (_LM + ["--wire", "int8-block"], "item 11"),
    (_LM + ["--overlap-buckets", "-1"], "item 11"),
    (_LM + ["--remat"], "item 11"),
    (["--mesh-tensor", "2"], "needs --partition tp"),
    (_LM + ["--mesh-tensor", "2"], "not divisible"),
]


def _check_cli_refuses_what_tp_does_not_serve(argv, words, capsys):
    with pytest.raises(SystemExit):
        train_main(argv + ["--device", "cpu", "--epochs", "0"])
    assert words in capsys.readouterr().err


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


def test_tp_matches_jax(runs, tmp_path, capsys):
    """Every check of this file (module docstring), as one tier-1 item:
    the tier-1 run's wall time hangs on how many items collect after
    ``test_stacked.py`` (``scripts/xdist_replay.py``)."""
    checks = [(f"specs {kind} data={d} tensor={t}",
               lambda kind=kind, d=d, t=t:
               _check_specs_of_every_state_leaf_match_jax(kind, d, t))
              for kind in W.KINDS for d, t in SPEC_MESHES]
    checks += [(fn.__name__, fn) for fn in (
        _check_plan_lowers_the_transformer_family_as_jax,
        _check_refusals_name_item_11)]
    for kind in W.KINDS:
        checks += [
            (f"world-2 forward {kind}", lambda kind=kind:
             _check_world2_forward_matches_jax_and_replicated(runs, kind)),
            (f"world-2 fit {kind}", lambda kind=kind:
             _check_fit_matches_jax_and_replicated(runs, 2, kind)),
            (f"world-4 fit {kind}", lambda kind=kind:
             _check_fit_matches_jax_and_replicated(runs, 4, kind)),
            (f"world-2 file {kind}", lambda kind=kind:
             _check_world2_file_splits_leaves_as_jax_manifest(runs, kind)),
            (f"world-2 file loads {kind}", lambda kind=kind:
             _check_world2_file_loads_in_jax_and_at_world1(runs, kind)),
            (f"world-4 file {kind}", lambda kind=kind:
             _check_world4_slices_are_written_once(runs, kind))]
    checks += [(fn.__name__, lambda fn=fn: fn(runs)) for fn in (
        _check_tensor_collectives_counted,
        _check_ranks_hold_only_their_slices,
        _check_vocab_parallel_ce_matches_whole_vocab,
        _check_jax_tp_file_loads_into_the_world2_run,
        _check_cli_trains_under_tp_at_world2)]
    checks.append(("gathered file", lambda:
                   _check_gathered_tp_file_holds_the_replicated_state(
                       runs, tmp_path)))
    checks += [(f"cli refuses {' '.join(argv)}", lambda argv=argv, w=w:
                _check_cli_refuses_what_tp_does_not_serve(argv, w, capsys))
               for argv, w in CLI_REFUSALS]
    _run_checks(checks)
