"""The port's paged decode attention against the JAX package's.

The port's plain version (``paged_attention_reference``) is held against
JAX's gather reference and against JAX's Pallas ``paged_flash_decode`` run
in interpret mode, on the same numpy inputs, and so is the kernel's split
arithmetic (``paged_decode_split_reference``: the per-split softmax states
over ``split_blocks``' ranges, merged in split order), with the split count
rule ``decode_splits`` beside it. The CUDA kernel itself runs
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
    decode_splits,
    paged_attention_reference,
    paged_decode_attention,
    paged_decode_split_reference,
    paged_flash_decode,
    split_blocks,
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


# a table of 8 blocks of 4 (keys 0..31): one-block rows whose other splits
# are all empty, the last/first position of a block, a full table, and a
# position past the table (its keys stop at 31)
SPLIT_LENS = (0, 3, 4, 17, 31, 45)
SPLIT_MAX_BLOCKS = 8


@pytest.fixture(scope="module", params=[(4, 4), (4, 2)], ids=["mha", "gqa"])
def split_case(request):
    """Inputs with ``SPLIT_LENS`` and JAX's interpret-mode kernel on them."""
    num_heads, kv_heads = request.param
    rng = np.random.default_rng(7)
    batch, head_dim, num_blocks = len(SPLIT_LENS), 16, 32
    q = rng.standard_normal((batch, num_heads, head_dim)).astype(np.float32)
    shape = (num_blocks, BLOCK_SIZE, kv_heads, head_dim)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    pk[0] = pv[0] = 1e4  # the scratch block: unreachable
    perm = rng.permutation(np.arange(1, num_blocks))
    table = np.zeros((batch, SPLIT_MAX_BLOCKS), np.int32)
    k = 0
    for b, pos in enumerate(SPLIT_LENS):
        live = min(pos // BLOCK_SIZE + 1, SPLIT_MAX_BLOCKS)
        table[b, :live] = perm[k:k + live]
        k += live
    lens = np.asarray(SPLIT_LENS, np.int32)
    j = jnp.asarray
    want = jax_paged.paged_flash_decode(
        j(q), j(pk), j(pv), j(table), j(lens), interpret=True
    )
    return (q, pk, pv, table, lens), np.asarray(want)


@pytest.mark.parametrize("num_splits", [1, 2, 3, 7, SPLIT_MAX_BLOCKS])
def test_split_reference_matches_jax_kernel(split_case, num_splits):
    """The kernel's split arithmetic on the CPU against JAX's Pallas kernel
    (interpret mode), at split counts from one to one per block."""
    (q, pk, pv, table, lens), want = split_case
    t = torch.from_numpy
    got = paged_decode_split_reference(
        t(q), t(pk), t(pv), t(table), t(lens), num_splits
    )
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_split_blocks_cover_each_live_block_once():
    """Every live block of a row falls in exactly one split, no split
    reaches past the row's last live block, and the live splits are a
    prefix (the kernel's empty-split exit relies on begin >= end)."""
    bs, mb = BLOCK_SIZE, SPLIT_MAX_BLOCKS
    for num_splits in range(1, mb + 1):
        for pos in range(-2, mb * bs + 6):
            live = 0 if pos < 0 else min(pos, mb * bs - 1) // bs + 1
            seen = []
            ranges = [tuple(int(x) for x in split_blocks(
                pos, s, num_splits, bs, mb)) for s in range(num_splits)]
            for begin, end in ranges:
                seen.extend(range(begin, end))
                assert end <= live
            assert seen == list(range(live)), (pos, num_splits, ranges)
            empty = [end <= begin for begin, end in ranges]
            assert empty == sorted(empty), (pos, num_splits, ranges)
    # the tensor form gives the same ranges as the int form, row by row
    pos = torch.arange(-2, mb * bs + 6)
    begin, end = split_blocks(pos, 2, 3, bs, mb)
    for i, p in enumerate(pos.tolist()):
        assert (int(begin[i]), int(end[i])) == tuple(
            int(x) for x in split_blocks(p, 2, 3, bs, mb))


@pytest.mark.parametrize(
    "batch,kv_heads,max_blocks,block_size,want",
    [(8, 12, 64, 16, 11),   # serving: 8 slots x 12 heads, 1,024 keys
     (1, 12, 64, 16, 64),   # one long row: one block per CTA
     (4, 4, 16, 8, 8),      # the serve CLI's default: 16-key splits
     (256, 12, 64, 16, 1),  # a grid that fills the card unsplit
     (8, 12, 1, 16, 1),     # a one-block table
     (1, 1, 2048, 16, 1024)],  # the combine's cap
    ids=["serving", "single", "cli", "wide", "one-block", "capped"],
)
def test_decode_splits_rule(batch, kv_heads, max_blocks, block_size, want):
    """The split count is a function of shapes only (132 SMs, an H100 SXM):
    the serving shape gets at least two CTAs per (row, kv head), and no
    split count leaves the table's range."""
    got = decode_splits(batch, kv_heads, max_blocks, block_size, 132)
    assert got == want
    assert 1 <= got <= max_blocks
    if (batch, kv_heads, max_blocks) == (8, 12, 64):
        assert batch * kv_heads * got >= batch * kv_heads * 2


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
