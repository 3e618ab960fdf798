"""The ring collectives' plain versions (K3, ops/collectives.py) against the
JAX package's ring entry points, on the CPU.

On the fake CPU mesh the JAX ``ring_all_gather`` / ``ring_reduce_scatter``
take their exact XLA fallback (the Pallas kernels lower only on a TPU), so
they are the tiled all-gather and reduce-scatter the port's plain versions
must compute. Each case runs them under shard_map on a 2- and a 4-device
slice of the mesh, with the same numpy inputs, one row per device.

Tolerances: the gather moves bytes, so it is exact. The reduce-scatter
sums 2 or 4 float32 terms: with 2 the sum is exact whatever the order;
with 4, XLA and the plain version may add in other orders, 1e-6 for unit
normal inputs (a few ulps of sums below 8). bfloat16 outputs round those
float32 sums to bf16, which may then lie one bf16 ulp apart (2^-7 of the
largest |sum|).

The plain gather, which K3a must equal byte for byte on the card, and the
plain sum in the ring's order (``ring_reduce_scatter_ring_order``), which
K3b must equal bit for bit, are held bit for bit against the TPU kernels
themselves: ``_ag_kernel`` and ``_rs_kernel`` run in Pallas's TPU
interpret mode on the fake CPU mesh (remote copies and semaphores
emulated), with their off-TPU fallback switched off for the test. The
ring-order sum is also within chip_smoke.py's ``ring_rs_bound`` of the
plain version, and equal to it at D = 2, where two terms commute exactly.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as P

import chip_smoke

from distributed_pytorch_example_tpu.ops.pallas import collectives as jring
from distributed_pytorch_example_tpu.runtime import jax_compat
from distributed_pytorch_example_tpu_torch.ops import collectives

WORLDS = [2, 4]


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


def _smap(mesh, fn, out_spec):
    # the gather's output is the same on every device; jax 0.9 cannot
    # infer that through the ring entry point's fallback, so say it
    return jax_compat.shard_map(fn, mesh, in_specs=(P("data"),),
                                out_specs=out_spec, axis_names={"data"},
                                check_vma=False)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_all_gather_reference_matches_jax_ring(world, dtype):
    rng = np.random.default_rng(world)
    x = rng.standard_normal((world, 2, 128)).astype(np.float32)
    if dtype == "int8":
        x = rng.integers(-127, 128, (world, 2, 128)).astype(np.int8)
    mesh = _mesh(world)
    with mesh:
        jx = jax.numpy.asarray(x, dtype=dtype)
        want = _smap(mesh, lambda v: jring.ring_all_gather(v, "data"),
                     P())(jx)
    want = np.asarray(want.astype(jax.numpy.float32))
    tdt = getattr(torch, dtype)
    xs = [torch.from_numpy(x[r:r + 1].astype(np.float32)).to(tdt)
          for r in range(world)]
    got = collectives.ring_all_gather_reference(xs)
    assert len(got) == world
    for out in got:
        assert out.dtype == tdt and out.shape == (world, 2, 128)
        np.testing.assert_array_equal(out.float().numpy(), want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduce_scatter_reference_matches_jax_ring(world, dtype):
    rng = np.random.default_rng(10 + world)
    x = rng.standard_normal((world, world * 256)).astype(np.float32)
    mesh = _mesh(world)
    with mesh:
        jx = jax.numpy.asarray(x, dtype=dtype)
        want = _smap(mesh, lambda v: jring.ring_reduce_scatter(
            v, "data", scatter_dimension=1), P("data"))(jx)
    want = np.asarray(want.astype(jax.numpy.float32))  # (world, 256)
    tdt = getattr(torch, dtype)
    xs = [torch.from_numpy(x[r]).to(tdt) for r in range(world)]
    got = collectives.ring_reduce_scatter_reference(xs)
    assert len(got) == world
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    for r, tile in enumerate(got):
        assert tile.dtype == tdt and tile.shape == (256,)
        np.testing.assert_allclose(tile.float().numpy(), want[r], rtol=0,
                                   atol=tol)


@pytest.fixture
def tpu_ring_interpreted(monkeypatch):
    """The JAX ring entry points take the Pallas kernels, run by the TPU
    interpreter, instead of their off-TPU XLA fallback. jax 0.9 names the
    kernels' compiler parameters ``CompilerParams``. Returns the kernel
    bodies that ``pallas_call`` was given."""
    pallas_call = jring.pl.pallas_call
    bodies = []

    def interpreted(body, *args, **kwargs):
        bodies.append(getattr(body, "func", body))
        return pallas_call(body, *args, interpret=pltpu.InterpretParams(),
                           **kwargs)

    monkeypatch.setattr(jring, "ring_supported", lambda: True)
    monkeypatch.setattr(jring.pl, "pallas_call", interpreted)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    return bodies


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_all_gather_reference_is_the_tpu_kernels_byte_for_byte(
        tpu_ring_interpreted, world, dtype):
    rng = np.random.default_rng(30 + world)
    x = rng.standard_normal((world, 4, 128)).astype(np.float32)
    if dtype == "int8":
        x = rng.integers(-128, 128, (world, 4, 128)).astype(np.int8)
    mesh = _mesh(world)
    with mesh:
        jx = jax.numpy.asarray(x, dtype=dtype)
        want = _smap(mesh, lambda v: jring.ring_all_gather(v, "data"),
                     P())(jx)
    assert tpu_ring_interpreted == [jring._ag_kernel]
    # compare bytes: bf16 through its 16-bit pattern
    bits, tbits = ((np.int16, torch.int16) if dtype == "bfloat16"
                   else (x.dtype, getattr(torch, dtype)))
    want = np.asarray(want).view(bits)  # (world, 4, 128)
    tdt = getattr(torch, dtype)
    xs = [torch.from_numpy(np.array(jx[r:r + 1]).view(bits)).view(tdt)
          for r in range(world)]
    for out in collectives.ring_all_gather_reference(xs):
        assert out.dtype == tdt and out.shape == (world, 4, 128)
        np.testing.assert_array_equal(out.view(tbits).numpy(), want)


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_order_sum_is_the_tpu_kernels_bit_for_bit(tpu_ring_interpreted,
                                                       world, dtype):
    rng = np.random.default_rng(20 + world)
    x = rng.standard_normal((world, world * 512)).astype(np.float32)
    mesh = _mesh(world)
    with mesh:
        jx = jax.numpy.asarray(x, dtype=dtype)
        want = _smap(mesh, lambda v: jring.ring_reduce_scatter(
            v[0], "data")[None], P("data"))(jx)
    want = np.asarray(want.astype(jax.numpy.float32))  # (world, 512)
    tdt = getattr(torch, dtype)
    xs = [torch.from_numpy(x[r]).to(tdt) for r in range(world)]
    got = collectives.ring_reduce_scatter_ring_order(xs)
    for r, tile in enumerate(got):
        assert tile.dtype == tdt and tile.shape == (512,)
        np.testing.assert_array_equal(tile.float().numpy(), want[r])


@pytest.mark.parametrize("world", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_order_sum_is_within_the_bound_of_the_plain_version(world,
                                                                 dtype):
    gen = torch.Generator().manual_seed(world)
    xs = [torch.randn(world * 1024, generator=gen).to(dtype)
          for _ in range(world)]
    got = collectives.ring_reduce_scatter_ring_order(xs)
    want = collectives.ring_reduce_scatter_reference(xs)
    tols = chip_smoke.ring_rs_bound(torch, xs, world)
    for g, w, t in zip(got, want, tols):
        assert g.dtype == dtype and g.shape == w.shape
        if world == 2:
            assert torch.equal(g, w)
        assert bool(((g.float() - w.float()).abs() <= t).all())
    if world == 4 and dtype == torch.float32:  # the orders do differ
        assert any(not torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [0, 128, 255, 256, 300, 512, 768, 1 << 20])
def test_eligibility_rule_is_the_tpu_kernels(n):
    assert collectives.half_rows(n) == jring._half_rows(n)
    # the kernels take only tensors on the card, with a peer to talk to
    x = torch.zeros(n)
    assert not collectives.ring_eligible(x, world=2)


def test_stream_ids_pick_independent_sets():
    """Gathers take the even collective ids, reduce-scatters the odd (the
    TPU kernels' collective_id), streams equal modulo MAX_STREAMS share."""
    ids = {(s, k): collectives._set_index(s, k)
           for s in range(collectives.MAX_STREAMS) for k in (0, 1)}
    assert len(set(ids.values())) == 2 * collectives.MAX_STREAMS
    assert all(v % 2 == k for (s, k), v in ids.items())
    assert collectives._set_index(collectives.MAX_STREAMS + 1, 0) == ids[1, 0]


def test_wrappers_take_cpu_tensors_through_the_plain_version():
    """One process and a CPU tensor: the library collective over a world
    of one, which is the identity, and no kernel launch."""
    x = torch.arange(512, dtype=torch.float32)
    before = (collectives.ring_all_gather.launches,
              collectives.ring_reduce_scatter.launches)
    assert torch.equal(collectives.ring_all_gather(x), x)
    assert torch.equal(collectives.ring_reduce_scatter(x), x)
    assert (collectives.ring_all_gather.launches,
            collectives.ring_reduce_scatter.launches) == before
