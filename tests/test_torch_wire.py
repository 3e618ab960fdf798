"""The port's wire layer (parallel/wire.py) against the JAX package's, on
the CPU.

- The block quantizer is bit-equal to JAX's: int8 values, bf16 scales
  (their bits), round-half-to-even ties and all-zero blocks.
- Stochastic rounding is unbiased on the integer lattice
  (tests/test_wire.py's test, with a torch.Generator).
- ``plan_buckets`` and ``grad_wire_report`` over a small GPT-2's leaves
  (``interop.flax_leaves``: JAX order and layout) equal JAX's over the
  same tree, bucket by bucket.
- ``wire_psum_scatter`` / ``wire_psum`` / ``wire_all_gather``, float32 and
  int8-block: two gloo processes (one pair for the module, every case run
  in it) against the JAX functions under shard_map on a 2-device slice of
  the fake CPU mesh, on the same numpy inputs. With two ranks every sum
  has two terms, which float32 adds exactly in either order, and the
  quantizer is bit-equal, so the results are held exactly. The same
  pair checks the library collectives the port falls back to.
"""

import multiprocessing
import os
import pickle
import socket

import filelock
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from distributed_pytorch_example_tpu.parallel import wire as jwire
from distributed_pytorch_example_tpu.parallel.api import (
    data_parallel as jax_data_parallel,
)
from distributed_pytorch_example_tpu.runtime import jax_compat
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models import GPT2
from distributed_pytorch_example_tpu_torch.parallel import (
    data_parallel,
    wire,
)
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.train.state import to_host, to_numpy

torch.set_num_threads(2)

WORLD = 2
TIMEOUT_S = 120
INT8 = dict(compress="int8-block", block_size=64, min_size=1)
KW = dict(vocab_size=97, max_len=16, model_dim=32, num_layers=2,
          num_heads=2, mlp_dim=64)


# -- the quantizer ----------------------------------------------------------


def _quantizer_rows(seed):
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((3, 640)) * rng.uniform(0.1, 10)).astype(
        np.float32)
    rows[1, 64:128] = 0.0  # an all-zero block
    # a block with amax 127: the inverse scale is exactly 1, so these are
    # the scaled values themselves, ties included (half to even)
    rows[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    return rows


@pytest.mark.parametrize("block_size", [32, 64, 128])
def test_quantizer_is_bit_equal_to_jax(block_size):
    rows = _quantizer_rows(block_size)
    jq, js = jwire._quantize_rows(jnp.asarray(rows), block_size)
    q, s = wire._quantize_rows(torch.from_numpy(rows), block_size)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        s.view(torch.int16).numpy(),
        np.asarray(js).view(np.int16))
    got = wire._dequantize_rows(q, s, 600)
    want = jwire._dequantize_rows(jq, js, 600)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the tie block: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
    assert q[2].reshape(-1)[:8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    # whole-tensor form: tail block zero-pads and slices back off
    x = rows.reshape(-1)[:1000]
    jq1, js1 = jwire.quantize_blocks(jnp.asarray(x), block_size)
    q1, s1 = wire.quantize_blocks(torch.from_numpy(x.copy()), block_size)
    np.testing.assert_array_equal(q1.numpy(), np.asarray(jq1))
    np.testing.assert_array_equal(
        wire.dequantize_blocks(q1, s1, x.shape).numpy(),
        np.asarray(jwire.dequantize_blocks(jq1, js1, x.shape)))


def test_stochastic_rounding_is_unbiased():
    """On the integer lattice, before the bf16 scale multiplies back in:
    E[q] converges to the exact scaled value, which round-to-nearest
    cannot do (the JAX test's bounds)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-1.0, 1.0, 256).astype(np.float32)
    blocks = x.reshape(-1, 64)
    amax = np.abs(blocks).max(axis=1, keepdims=True)
    scaled = (blocks * (127.0 / amax)).reshape(-1)
    rows = torch.from_numpy(x)[None]
    gen = torch.Generator().manual_seed(0)
    acc = np.zeros(x.shape, np.float64)
    n = 200
    for _ in range(n):
        q, _ = wire._quantize_rows(rows, 64, generator=gen)
        draw = q[0].numpy().astype(np.float64).reshape(-1)
        assert (np.abs(draw - scaled) < 1.0 + 1e-5).all()
        acc += draw
    mean_err = np.abs(acc / n - scaled).max()
    assert mean_err < 0.2, mean_err
    q_det, _ = wire._quantize_rows(rows, 64)
    det_err = np.abs(q_det[0].numpy().astype(np.float64).reshape(-1)
                     - scaled).max()
    assert det_err > mean_err


@pytest.mark.parametrize("kw,error", [
    (dict(compress="fp8"), "compress"), (dict(param_gather="fp16"),
                                         "param_gather"),
    (dict(ring="always"), "ring"), (dict(block_size=0), "block_size"),
    (dict(bucket_bytes=-1), "bucket_bytes")])
def test_wireconfig_validation(kw, error):
    with pytest.raises(ValueError, match=error):
        wire.WireConfig(**kw)
    with pytest.raises(ValueError, match=error):
        jwire.WireConfig(**kw)


# -- the plan and the report, against JAX's over the same tree --------------


def _np(tree):
    """A flax tree of tensor views (``interop.params_to_flax``) as numpy
    copies."""
    return to_numpy(to_host(tree))


def _trees(world, min_size):
    model = GPT2(**KW, device="cpu", seed=0)
    leaves = interop.flax_leaves(model)
    named = dict(model.named_parameters())
    shapes = {leaf.key: tuple(leaf.to_jax(named[leaf.name]).shape)
              for leaf in leaves}
    params = _np(interop.params_to_flax(model))
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    jpart = jax_data_parallel(mesh, dp_shard_opt_state=True,
                              opt_shard_min_size=min_size)
    part = data_parallel(world, dp_shard_opt_state=True,
                         opt_shard_min_size=min_size)
    return shapes, params, jpart, part


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("bucket_bytes", [2048, 16384])
@pytest.mark.parametrize("compress", ["none", "int8-block"])
def test_plan_and_report_equal_jax(world, bucket_bytes, compress):
    shapes, params, jpart, part = _trees(world, min_size=256)
    # the JAX leaf order is the sorted flax paths
    jleaves = jax.tree_util.tree_flatten_with_path(params)[0]
    jpaths = ["/".join(k.key for k in path) for path, _ in jleaves]
    assert jpaths == list(shapes)
    jdims = jax.tree_util.tree_leaves(jpart.zero1_dims(params),
                                      is_leaf=lambda d: d is None)
    dims = part.zero1_dims(shapes)
    assert list(dims.values()) == jdims
    assert any(d is not None for d in jdims) and None in jdims
    cfg = dict(compress=compress, min_size=512, bucket_bytes=bucket_bytes)
    jplan = jwire.plan_buckets(jpart.zero1_dims(params), params,
                               jwire.WireConfig(**cfg), world)
    plan = wire.plan_buckets(list(dims.values()), list(shapes.values()),
                             wire.WireConfig(**cfg), world)
    assert plan.to_json() == jplan.to_json()
    assert [b.leaves for b in plan.buckets] == [b.leaves
                                                for b in jplan.buckets]
    jpart.wire = jwire.WireConfig(**cfg)
    part.wire = wire.WireConfig(**cfg)
    assert wire.grad_wire_report(shapes, part) == jwire.grad_wire_report(
        params, jpart)


# -- the collectives: two gloo processes against JAX under shard_map -------


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "scatter": rng.standard_normal((WORLD, 256)).astype(np.float32),
        "psum": rng.standard_normal((WORLD, 300)).astype(np.float32),
        "gather": rng.standard_normal((WORLD, 64)).astype(np.float32),
        "rows": rng.standard_normal((WORLD, WORLD, 96)).astype(np.float32),
        "bf16": rng.standard_normal((WORLD, 5, 64)).astype(np.float32),
    }


def _port_cases(rank):
    """Every wire case on this rank; numpy results by name."""
    x = {k: torch.from_numpy(v[rank].copy()) for k, v in _inputs().items()}
    out = {}
    for label, kw in (("fp32", {}), ("int8", INT8)):
        cfg = wire.WireConfig(**kw)
        out[f"psum_scatter_{label}"] = wire.wire_psum_scatter(
            x["scatter"][None], scatter_dimension=1, config=cfg)
        out[f"psum_{label}"] = wire.wire_psum(x["psum"][None], config=cfg)
        out[f"all_gather_{label}"] = wire.wire_all_gather(
            x["gather"][None], gather_dimension=0, config=cfg)
    # the library fallbacks the wire layer rides on
    out["all_to_all"] = distributed.all_to_all_rows(x["rows"])
    out["gather_dim1_bf16"] = distributed.all_gather_tiled(
        x["bf16"].to(torch.bfloat16), dim=1).float()
    out["reduce_scatter"] = distributed.reduce_scatter_tiled(x["rows"])
    # a CPU tensor in a process group: the K3 wrappers' plain version
    from distributed_pytorch_example_tpu_torch.ops import collectives

    out["ring_all_gather_cpu"] = collectives.ring_all_gather(x["gather"][None])
    out["ring_reduce_scatter_cpu"] = collectives.ring_reduce_scatter(
        x["rows"])
    return {k: v.numpy().copy() for k, v in out.items()}


def _worker(rank, port, results):
    torch.set_num_threads(1)
    config = distributed.DistributedConfig(WORLD, rank, f"localhost:{port}")
    distributed.initialize(config, device="cpu", max_attempts=2)
    try:
        results.put((rank, _port_cases(rank)))
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
def port_results(tmp_path_factory):
    """The pair runs once per test run: under pytest-xdist the first worker
    to get here spawns it and leaves the results for the others, in the
    run's shared temporary directory."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _spawn_pair()
    path = tmp_path_factory.getbasetemp().parent / "test_torch_wire.pkl"
    with filelock.FileLock(f"{path}.lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        got = _spawn_pair()
        path.write_bytes(pickle.dumps(got))
        return got


def _jax_case(name):
    """The JAX function on the 2-device mesh slice: one row per device;
    returns each device's result."""
    x = _inputs()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    kind, _, label = name.rpartition("_")
    cfg = jwire.WireConfig(**(INT8 if label == "int8" else {}))
    if kind == "psum_scatter":
        fn, arg = (lambda v: jwire.wire_psum_scatter(
            v, "data", scatter_dimension=1, config=cfg)), x["scatter"]
    elif kind == "psum":
        fn, arg = (lambda v: jwire.wire_psum(v, "data", config=cfg)), x["psum"]
    else:
        fn, arg = (lambda v: jwire.wire_all_gather(
            v, "data", gather_dimension=0, config=cfg)), x["gather"]
    # stack every device's own result: out_specs P("data") over a leading
    # axis added per device
    mapped = jax_compat.shard_map(
        lambda v: fn(v)[None], mesh, in_specs=(P("data"),),
        out_specs=P("data"), axis_names={"data"}, check_vma=False)
    with mesh:
        return np.asarray(mapped(arg))


@pytest.mark.parametrize("name", [
    f"{kind}_{label}" for kind in ("psum_scatter", "psum", "all_gather")
    for label in ("fp32", "int8")])
def test_wire_collectives_equal_jax(port_results, name):
    want = _jax_case(name)
    for rank in range(WORLD):
        got = port_results[rank][name]
        assert got.shape == want[rank].shape, (got.shape, want[rank].shape)
        np.testing.assert_array_equal(got, want[rank], err_msg=f"rank {rank}")
    if name.endswith("int8"):  # it really quantized
        fp32 = port_results[0][name.replace("int8", "fp32")]
        assert np.abs(port_results[0][name] - fp32).max() > 0


@pytest.mark.parametrize("name", ["all_to_all", "gather_dim1_bf16",
                                  "reduce_scatter", "ring_all_gather_cpu",
                                  "ring_reduce_scatter_cpu"])
def test_library_collectives_across_two_processes(port_results, name):
    x = _inputs()
    for rank in range(WORLD):
        got = port_results[rank][name]
        if name == "all_to_all":
            want = x["rows"][:, rank]
        elif name == "gather_dim1_bf16":
            bf = torch.from_numpy(x["bf16"]).to(torch.bfloat16).float()
            want = torch.cat(list(bf.unbind(0)), dim=1).numpy()
        elif name == "ring_all_gather_cpu":
            want = x["gather"]
        else:  # a tiled reduce-scatter of (2, 2, 96) rows over 2 ranks
            want = x["rows"].sum(axis=0)[rank:rank + 1]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
