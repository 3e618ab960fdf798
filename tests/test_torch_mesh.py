"""The port's process mesh (``runtime/mesh.py``) against the JAX package's
device mesh, on the CPU: ``MeshSpec.resolve`` and its errors for a table
of cases, the row-major layout of the ranks (JAX's layout of a device
subset over the same axes), and the batch axes. Plain Python: no process
group is made, and no tolerance applies (exact equality).
"""

import jax
import numpy as np
import pytest

from distributed_pytorch_example_tpu.runtime import mesh as jax_mesh
from distributed_pytorch_example_tpu_torch.runtime import mesh

CASES = [
    (dict(), 1), (dict(), 8), (dict(fsdp=2), 8), (dict(data=1, fsdp=2), 2),
    (dict(data=2, fsdp=2), 4), (dict(data=-1, fsdp=4), 8),
    (dict(data=2, fsdp=-1), 8), (dict(data=2, tensor=2, pipe=2), 8),
    (dict(fsdp=3), 8), (dict(data=-1, fsdp=-1), 8), (dict(data=2, fsdp=2), 8),
    (dict(data=4, fsdp=2), 4), (dict(fsdp=1, data=3), 3),
]


def _resolve(module, kw, n):
    try:
        return tuple(module.MeshSpec(**kw).resolve(n).axis_sizes())
    except ValueError as err:
        return f"ValueError: {err}"


def _check_resolve_matches_jax():
    for kw, n in CASES:
        assert _resolve(mesh, kw, n) == _resolve(jax_mesh, kw, n), (kw, n)
    got = [_resolve(mesh, kw, n) for kw, n in CASES]
    assert sum(isinstance(g, str) for g in got) == 4
    assert mesh.MeshSpec().axis_names == jax_mesh.MeshSpec().axis_names


LAYOUTS = [(dict(data=1, fsdp=2), 2), (dict(data=2, fsdp=2), 4),
           (dict(data=2, fsdp=2, pipe=2), 8)]


def _check_ranks_lie_as_jax_lays_out_a_device_subset(kw, n):
    """Rank r of the port's mesh sits where JAX puts device r of a subset
    it reshapes row-major; every rank's coordinates and axis peers
    follow."""
    devices = jax.devices()[:n]
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(**kw), devices=devices)
    ids = np.vectorize(lambda d: devices.index(d))(jmesh.devices)
    for rank in range(n):
        m = mesh.make_mesh(mesh.MeshSpec(**kw), world=n, rank=rank,
                           groups=False)
        np.testing.assert_array_equal(m.devices, ids)
        assert dict(m.shape) == dict(jmesh.shape)
        where = np.argwhere(ids == rank)[0]
        assert tuple(m.coords[a] for a in m.axis_names) == tuple(where)
        assert rank in m.axis_ranks("fsdp") and rank in m.axis_ranks("data")
        assert len(m.axis_ranks("fsdp")) == m.shape["fsdp"]
        assert mesh.data_axes(m) == jax_mesh.data_axes(jmesh)
        assert (mesh.data_parallel_size(m)
                == jax_mesh.data_parallel_size(jmesh))


def _check_groups_and_the_mesh_context():
    m = mesh.make_mesh(mesh.MeshSpec(data=2, fsdp=2), world=4, rank=3,
                       groups=False)
    assert m.axis_ranks("data") == [1, 3] and m.axis_ranks("fsdp") == [2, 3]
    assert m.group("tensor") is None  # size 1: nothing to reduce over
    with pytest.raises(RuntimeError, match="without process groups"):
        m.group("fsdp")
    whole = mesh.make_mesh(mesh.MeshSpec(fsdp=4, data=1), world=4,
                           groups=False)
    assert whole.group("fsdp") is None  # spans every rank: the world
    assert mesh.current_mesh() is None
    with m:
        assert mesh.current_mesh() is m
    assert mesh.current_mesh() is None
    one = mesh.make_mesh()  # one process: every rank on data
    assert one.size == 1 and one.shape["data"] == 1


def test_mesh_matches_jax():
    """Every check of this file as one tier-1 item (the tier-1 run's wall
    time hangs on how many items collect after ``test_stacked.py``; see
    ``tests/test_torch_fsdp.py``); each check runs and reports."""
    checks = [("resolve", _check_resolve_matches_jax),
              ("groups", _check_groups_and_the_mesh_context)]
    checks += [(f"layout {kw}", lambda kw=kw, n=n:
                _check_ranks_lie_as_jax_lays_out_a_device_subset(kw, n))
               for kw, n in LAYOUTS]
    failed = []
    for name, fn in checks:
        try:
            fn()
        except Exception as err:  # every check reports, not only the first
            failed.append(f"{name}: {type(err).__name__}: {err}")
    assert not failed, "\n".join(failed)
