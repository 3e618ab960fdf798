"""The port's paged decode attention against the JAX package's.

The port's plain version (``paged_attention_reference``) is held against
JAX's gather reference and against JAX's Pallas ``paged_flash_decode`` run
in interpret mode, on the same numpy inputs. The CUDA kernel itself runs
only on the card (chip_smoke.py holds it against the plain version there);
here the tests pin the dispatch rules around it: CPU tensors take the
plain version bit for bit, the kernel wrapper refuses anything that is not
on a CUDA device, and a missing ``nvcc`` makes the build raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.ops.pallas import (
    paged_attention as jax_paged,
)
from distributed_pytorch_example_tpu_torch.ops import _build
from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
    paged_attention_reference,
    paged_decode_attention,
    paged_flash_decode,
)

torch.set_num_threads(2)

BLOCK_SIZE = 4
# float32 on both sides; the two frameworks sum in different orders
TOL = 2e-5


def make_case(batch=3, num_heads=4, kv_heads=4, head_dim=16, num_blocks=16,
              max_blocks=5, seed=0):
    """Random pool + a permuted block table with dead tails -> scratch 0
    (the shape of tests/test_paged_attention.py ``make_case``): row
    lengths straddle block boundaries — first/last position of a block and
    single-block rows — so the mask and the live-block sweep are exercised
    off the easy aligned cases."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, num_heads, head_dim)).astype(np.float32)
    shape = (num_blocks, BLOCK_SIZE, kv_heads, head_dim)
    pages_k = rng.standard_normal(shape).astype(np.float32)
    pages_v = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_blocks))
    lens = np.asarray([2, BLOCK_SIZE - 1, 4 * BLOCK_SIZE], np.int32)[:batch]
    table = np.zeros((batch, max_blocks), np.int32)
    k = 0
    for b in range(batch):
        live = int(lens[b]) // BLOCK_SIZE + 1
        for j in range(min(live, max_blocks)):
            table[b, j] = perm[k]
            k += 1
    return q, pages_k, pages_v, table, lens


def _port(q, pk, pv, table, lens):
    t = torch.from_numpy
    return paged_attention_reference(
        t(q)[:, None], t(pk), t(pv), t(table), t(lens)[:, None].long()
    )[:, 0].numpy()


@pytest.mark.parametrize(
    "num_heads,kv_heads", [(4, 4), (4, 2)], ids=["mha", "gqa"]
)
def test_reference_matches_jax_reference_and_kernel(num_heads, kv_heads):
    q, pk, pv, table, lens = make_case(num_heads=num_heads, kv_heads=kv_heads)
    got = _port(q, pk, pv, table, lens)
    j = jnp.asarray
    jax_ref = jax_paged.paged_attention_reference(
        j(q)[:, None], j(pk), j(pv), j(table), j(lens)[:, None]
    )[:, 0]
    jax_kernel = jax_paged.paged_flash_decode(
        j(q), j(pk), j(pv), j(table), j(lens), interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(jax_ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_kernel), atol=TOL, rtol=0)


def test_poisoned_scratch_block_does_not_move_output():
    """Dead table entries point at the scratch block; filling it (and so
    every dead key) with 1e4 must not change any row's output."""
    q, pk, pv, table, lens = make_case(seed=1)
    base = _port(q, pk, pv, table, lens)
    pk2, pv2 = pk.copy(), pv.copy()
    pk2[0] = 1e4
    pv2[0] = 1e4
    np.testing.assert_array_equal(_port(q, pk2, pv2, table, lens), base)


def test_seq_gt_one_matches_jax_reference():
    """A multi-query chunk (per-position masks) takes the plain version on
    every device, as in JAX."""
    q, pk, pv, table, lens = make_case(seed=3)
    qw = np.stack([q, q * 0.5], axis=1)
    pos = np.stack([lens, lens + 1], axis=1)
    t, j = torch.from_numpy, jnp.asarray
    got = paged_decode_attention(t(qw), t(pk), t(pv), t(table), t(pos).long())
    ref = jax_paged.paged_attention_reference(
        j(qw), j(pk), j(pv), j(table), j(pos)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_dispatcher_on_cpu_is_reference_bitwise():
    q, pk, pv, table, lens = make_case(seed=2)
    t = torch.from_numpy
    args = (t(q)[:, None], t(pk), t(pv), t(table), t(lens)[:, None].long())
    before = paged_flash_decode.launches
    got = paged_decode_attention(*args)
    assert torch.equal(got, paged_attention_reference(*args))
    assert paged_flash_decode.launches == before  # no kernel on the CPU


def test_kernel_wrapper_refuses_cpu_and_meta_tensors():
    """The kernel runs on the card only: the wrapper raises on a CPU
    tensor, and the dispatcher sends a non-CPU, non-CUDA tensor to the
    wrapper (which raises) rather than to the plain version."""
    q, pk, pv, table, lens = make_case()
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_decode(t(q), t(pk), t(pv), t(table), t(lens))
    meta = [t(a).to("meta") for a in (q, pk, pv, table, lens)]
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(
            meta[0][:, None], meta[1], meta[2], meta[3], meta[4][:, None]
        )


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises; nothing returns the plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("paged_decode")
    assert _build.sources() == ["flash_attention", "paged_decode",
                                "ring_collectives"]


def test_find_nvcc_looks_at_cuda_home(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(fake)
