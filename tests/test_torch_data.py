"""The port's data path against the JAX package's: sampler shards,
synthetic datasets and loader batches, element for element (exact: both
sides run the same integer and numpy code)."""

import numpy as np
import pytest

from distributed_pytorch_example_tpu.data.loader import (
    DeviceLoader as JaxLoader,
)
from distributed_pytorch_example_tpu.data.sampler import (
    ShardedSampler as JaxSampler,
    _permutation_numpy,
)
from distributed_pytorch_example_tpu.data.synthetic import (
    SyntheticClassificationDataset as JaxClassData,
    SyntheticTokenDataset as JaxTokenData,
)
from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    ShardedSampler,
    SyntheticClassificationDataset,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.data.sampler import permutation


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 5), (97, 1), (1000, 123)])
def test_permutation_is_the_jax_splitmix_fisher_yates(n, seed):
    np.testing.assert_array_equal(permutation(n, seed),
                                  _permutation_numpy(n, seed))


@pytest.mark.parametrize("seed,epoch,world,drop_last", [
    (0, 0, 1, False), (0, 3, 2, False), (7, 1, 3, False), (11, 2, 4, True),
])
def test_sampler_shards_match_jax(seed, epoch, world, drop_last):
    for rank in range(world):
        kw = dict(num_shards=world, shard_id=rank, seed=seed,
                  drop_last=drop_last)
        ours, theirs = ShardedSampler(103, **kw), JaxSampler(103, **kw)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert len(ours) == len(theirs)
        np.testing.assert_array_equal(ours.shard_indices(),
                                      theirs.shard_indices())


def test_synthetic_datasets_match_jax():
    for ours, theirs in (
        (SyntheticClassificationDataset(50, seed=3), JaxClassData(50, seed=3)),
        (SyntheticTokenDataset(20, seq_len=16, vocab_size=97, seed=4),
         JaxTokenData(20, seq_len=16, vocab_size=97, seed=4)),
    ):
        assert ours.arrays.keys() == theirs.arrays.keys()
        for key in ours.arrays:
            assert ours.arrays[key].dtype == theirs.arrays[key].dtype
            np.testing.assert_array_equal(ours.arrays[key],
                                          theirs.arrays[key])


@pytest.mark.parametrize("world,prefetch", [(1, 2), (2, 0), (3, 2)])
def test_loader_batches_match_jax(world, prefetch):
    """Every rank's batches, in order, over two epochs, including the
    wrap-padded final batch (50 samples, global batch 12)."""
    ours_ds = SyntheticClassificationDataset(50, input_size=8, seed=1)
    jax_ds = JaxClassData(50, input_size=8, seed=1)
    for rank in range(world):
        kw = dict(num_shards=world, shard_id=rank, seed=9)
        ours = DeviceLoader(ours_ds, 12 if world != 3 else 9, device="cpu",
                            prefetch=prefetch, **kw)
        theirs = JaxLoader(jax_ds, 12 if world != 3 else 9, prefetch=0, **kw)
        assert len(ours) == len(theirs)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == len(ours)
            for a, b in zip(got, want):
                for key in ("x", "y"):
                    assert a[key].device.type == "cpu"
                    np.testing.assert_array_equal(a[key].numpy(),
                                                  np.asarray(b[key]))


def test_loader_stops_its_thread_when_abandoned():
    loader = DeviceLoader(SyntheticTokenDataset(40, seq_len=8, seed=0), 4,
                          device="cpu", prefetch=2, num_shards=1, shard_id=0)
    it = iter(loader)
    next(it)
    it.close()  # runs the generator's cleanup: stop, drain, join
    import threading

    assert not [t for t in threading.enumerate()
                if t.name.startswith("loader-shard") and t.is_alive()]
