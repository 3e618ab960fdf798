"""Elastic resume and the shrink to survivors in the port, on the CPU
(after ``tests/test_elastic.py``).

- ``runtime/distributed.py``: peer addresses from the coordinator's, the
  survivors' world, the probe sweep with a stub probe; ``initialize``
  shrinks only under ``DPX_ELASTIC=1`` and only when a probed peer is
  dead (a monkeypatched join), and a lone rank's real join times out
  and goes on as the only survivor;
- ``robustness/elastic.py``: ``resume_gap_steps`` for both formats; both
  formats carry the mesh stamp, and an unstamped checkpoint loads with
  the variable unset and raises ``MissingMeshManifestError`` under it;
- the fallback walk prefers a same-mesh ancestor unless ``DPX_ELASTIC=1``
  asks for the newest intact one; ``Trainer.load`` waits for every rank's
  save (its saver, then a barrier) before it reads;
- across a world change (the gloo pair of
  ``tests/test_torch_sharded_checkpoint.py``, a small GPT-2 with Adam): a
  world-2 ZeRO-1 sharded checkpoint resumed at world 1, at its epoch's end
  and mid-epoch, and a world-1 one resumed at world 2 under ZeRO-1, each
  continue the uninterrupted world-1 run. The loader cursor counts global
  batches, as in the JAX package: at one global batch size a step covers
  the same samples at any world, so no sample repeats and none is
  skipped.

Tolerance across a world change: losses within 1e-6 and parameters within
1e-6 of the uninterrupted run (the same arithmetic but for where the
gradient mean is rounded: two local means summed against one mean over
all rows, ``tests/test_torch_zero1.py``); bit-equal within one world.
"""

import os
import shutil
import socket
from datetime import timedelta

import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticClassificationDataset,
)
from distributed_pytorch_example_tpu_torch.models import SimpleNet
from distributed_pytorch_example_tpu_torch.robustness import chaos, elastic
from distributed_pytorch_example_tpu_torch.robustness.integrity import (
    read_verified,
)
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.runtime.distributed import (
    DistributedConfig,
)
from distributed_pytorch_example_tpu_torch.train import (
    ClassificationTask,
    Trainer,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.utils import msgpack
from test_torch_sharded_checkpoint import (  # noqa: F401  (the shared pair)
    EPOCHS,
    WORLD,
    gpt2_loader,
    gpt2_trainer,
    sharded_pair,
)

torch.set_num_threads(2)

NET = dict(input_size=16, hidden_size=32, num_classes=4)
CROSS_WORLD_TOL = 1e-6


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    chaos.uninstall()


# ---------------------------------------------------------------------------
# shrink to survivors (stub probes)
# ---------------------------------------------------------------------------


def test_peer_address():
    cfg = DistributedConfig(4, 1, "myjob-0.svc.cluster.local:29500")
    assert distributed.peer_address(cfg, 3) == (
        "myjob-3.svc.cluster.local:29500")
    bare = DistributedConfig(4, 0, "node-0:29")
    assert distributed.peer_address(bare, 2) == "node-2:29"
    with pytest.raises(ValueError):
        distributed.peer_address(DistributedConfig(1, 0, None), 0)


def test_compute_survivor_config():
    cfg = DistributedConfig(8, 5, "w-0.svc:29500")
    shrunk = distributed.compute_survivor_config(cfg, [0, 1, 6])
    assert shrunk == DistributedConfig(4, 2, "w-0.svc:29500")
    # the coordinator itself was lost: the lowest survivor takes over
    cfg = DistributedConfig(8, 6, "w-0.svc:29500")
    shrunk = distributed.compute_survivor_config(cfg, [5, 7])
    assert shrunk == DistributedConfig(3, 1, "w-5.svc:29500")


def test_shrink_to_survivors_probes_peers():
    cfg = DistributedConfig(4, 0, "job-0.svc:29500")
    probed = []

    def probe(address):
        probed.append(address)
        return "job-2" not in address

    shrunk = distributed.shrink_to_survivors(cfg, probe=probe)
    assert probed == ["job-1.svc:29500", "job-2.svc:29500",
                      "job-3.svc:29500"]
    assert shrunk == DistributedConfig(3, 0, "job-0.svc:29500")


def test_initialize_shrinks_only_under_elastic(monkeypatch):
    calls = []

    def fake_join(config, max_attempts, backend):
        calls.append(config)
        if config.num_processes == 4:
            raise RuntimeError("rendezvous exhausted")

    monkeypatch.setattr(distributed, "_attempt_join", fake_join)
    cfg = DistributedConfig(4, 0, "job-0.svc:29500")

    def lossy(address):
        return "job-3" not in address

    monkeypatch.delenv(elastic.ELASTIC_ENV, raising=False)
    with pytest.raises(RuntimeError, match="exhausted"):
        distributed.initialize(cfg, device="cpu", probe=lossy)

    monkeypatch.setenv(elastic.ELASTIC_ENV, "1")
    joined = distributed.initialize(cfg, device="cpu", probe=lossy)
    assert joined == DistributedConfig(3, 0, "job-0.svc:29500")
    assert calls[-1] == joined

    # every peer answered: not a lost peer, so the error stands
    with pytest.raises(RuntimeError, match="exhausted"):
        distributed.initialize(cfg, device="cpu", probe=lambda address: True)


def test_lone_rank_times_out_and_goes_on_alone(monkeypatch):
    """A real join whose peer never comes: the rendezvous ends at the
    process group's timeout (one second here), and under DPX_ELASTIC=1
    the probe's verdict leaves a world of one."""
    monkeypatch.setattr(distributed, "_PROCESS_GROUP_TIMEOUT",
                        timedelta(seconds=1))
    monkeypatch.setenv(elastic.ELASTIC_ENV, "1")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cfg = DistributedConfig(2, 0, f"localhost:{port}")
    joined = distributed.initialize(cfg, device="cpu", max_attempts=1,
                                    probe=lambda address: False)
    assert joined.num_processes == 1 and joined.process_id == 0
    assert distributed.process_count() == 1


# ---------------------------------------------------------------------------
# the stamp, resume_gap_steps and the fallback order (one process)
# ---------------------------------------------------------------------------


def _trainer(seed=0, checkpoint_dir=None, fmt="auto"):
    model = SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=seed)
    return Trainer(model, ClassificationTask(),
                   make_optimizer(model.parameters(), "adam", 1e-2),
                   checkpoint_dir=checkpoint_dir, checkpoint_format=fmt)


def _loader():
    return DeviceLoader(SyntheticClassificationDataset(
        64, input_size=NET["input_size"], num_classes=NET["num_classes"],
        seed=0), 16, device="cpu", seed=0, prefetch=0)


def _stamp_of(path):
    if ckpt._is_sharded(path):
        blob = read_verified(os.path.join(ckpt._pointed_version_dir(path),
                                          "manifest.msgpack"))
    else:
        blob = read_verified(path)
    return msgpack.msgpack_restore(blob).get(elastic.MANIFEST_KEY)


def _save(trainer, path, epoch, sharded, **kw):
    return ckpt.save_checkpoint(path, trainer.state, epoch, 0.0,
                                sharded=sharded, **kw)


def test_resume_gap_steps(tmp_path):
    path = str(tmp_path / "ck")
    shards = f"{path}.shards"
    os.makedirs(os.path.join(shards, "00000002.00000001"))
    os.makedirs(os.path.join(shards, "00000002.00000003"))
    assert elastic.resume_gap_steps(path, 2, {"batch_in_epoch": 1}) == 2
    assert elastic.resume_gap_steps(path, 2, {"batch_in_epoch": 3}) == 0
    assert elastic.resume_gap_steps(path, 1, {}) is None  # epoch boundary

    g_path = str(tmp_path / "g.ckpt")
    with open(g_path, "w") as f:
        f.write("x")
    assert elastic.resume_gap_steps(g_path, 1) == 0  # a single file
    hist = f"{g_path}.history"
    os.makedirs(hist)
    os.link(g_path, os.path.join(hist, "00000001.ckpt"))
    assert elastic.resume_gap_steps(g_path, 1) == 0  # newest entry IS path
    with open(os.path.join(hist, "00000002.ckpt"), "w") as f:
        f.write("y")
    assert elastic.resume_gap_steps(g_path, 1) is None  # a newer torn save


def test_resume_gap_steps_after_a_sharded_fallback(tmp_path):
    """Three mid-epoch versions written by the saver, the newest torn: the
    load walks back one, and the gap counts the step lost."""
    trainer = _trainer()
    path = str(tmp_path / "ck")
    for batch in (1, 2, 3):
        _save(trainer, path, 1, True, extra={"batch_in_epoch": batch},
              saver=trainer._saver)
    trainer._saver.wait()
    chaos.corrupt_file(os.path.join(f"{path}.shards", "00000001.00000003",
                                    "shard_00000.msgpack"))
    _, epoch, extra = ckpt.load_checkpoint(path, _trainer(seed=1).state)
    assert (epoch, extra["batch_in_epoch"]) == (1, 2)
    assert elastic.resume_gap_steps(path, epoch, extra) == 1


def test_fit_logs_the_steps_a_fallback_resume_lost(tmp_path, caplog):
    """Trainer.fit resuming past a torn newest version says how many
    steps behind it restarts."""
    trainer = _trainer()
    path = str(tmp_path / "ck")
    for batch in (1, 2):
        _save(trainer, path, 0, True, extra={"batch_in_epoch": batch},
              saver=trainer._saver)
    trainer._saver.wait()
    chaos.corrupt_file(os.path.join(f"{path}.shards", "00000000.00000002",
                                    "shard_00000.msgpack"))
    resumed = _trainer(seed=1)
    with caplog.at_level("WARNING"):
        resumed.fit(_loader(), None, epochs=1, resume=path)
    assert "Resumed 1 step(s) behind the newest save attempt" in caplog.text
    assert resumed.recovery["checkpoint_fallbacks"] == 1


@pytest.mark.parametrize("fmt", ["gathered", "sharded"])
def test_both_formats_carry_the_stamp(tmp_path, fmt):
    trainer = _trainer()
    path = str(tmp_path / "ck")
    _save(trainer, path, 1, fmt == "sharded")
    stamp = _stamp_of(path)
    assert stamp["format"] == elastic.MANIFEST_FORMAT
    assert stamp["axes"] == {"data": 1} and stamp["zero1_dims"] == {}
    assert "params/Dense_0/kernel" in stamp["specs"]


@pytest.mark.parametrize("fmt", ["gathered", "sharded"])
def test_unstamped_checkpoint_loads_unless_elastic(tmp_path, monkeypatch,
                                                   fmt):
    trainer = _trainer()
    path = str(tmp_path / "ck")
    monkeypatch.setattr(elastic, "mesh_manifest", lambda *a, **k: None)
    _save(trainer, path, 1, fmt == "sharded")
    monkeypatch.undo()
    assert _stamp_of(path) is None

    monkeypatch.delenv(elastic.ELASTIC_ENV, raising=False)
    epoch, _ = _trainer(seed=1).load(path)
    assert epoch == 1

    monkeypatch.setenv(elastic.ELASTIC_ENV, "1")
    with pytest.raises(elastic.MissingMeshManifestError,
                       match=elastic.MANIFEST_KEY):
        _trainer(seed=1).load(path)


def test_fallback_ordering_elastic_vs_conservative(tmp_path, monkeypatch):
    """The newest version torn, the one before it stamped with another
    world: with DPX_ELASTIC unset the older same-mesh ancestor restores;
    under DPX_ELASTIC=1 the newest intact one does."""
    trainer = _trainer()
    path = str(tmp_path / "ck")
    real = elastic.mesh_manifest
    _save(trainer, path, 1, True)                        # this world
    monkeypatch.setattr(elastic, "mesh_manifest",
                        lambda tree, partitioner=None, world=1:
                        real(tree, None, world=4))
    _save(trainer, path, 2, True)                        # stamped data=4
    monkeypatch.undo()
    _save(trainer, path, 3, True)                        # this world, torn
    chaos.corrupt_file(os.path.join(f"{path}.shards", "00000003",
                                    "shard_00000.msgpack"))
    monkeypatch.delenv(elastic.ELASTIC_ENV, raising=False)
    epoch, _ = _trainer(seed=1).load(path)
    assert epoch == 1
    monkeypatch.setenv(elastic.ELASTIC_ENV, "1")
    epoch, _ = _trainer(seed=1).load(path)
    assert epoch == 2


def test_load_waits_for_every_ranks_save_before_it_reads(tmp_path,
                                                         monkeypatch):
    """Trainer.load (resume, rollback) drains this rank's saver, then
    meets every rank at a barrier, then reads: rank 0 flips a sharded
    pointer only after the other ranks' shard files land, so a rank that
    read right after its own saver's wait could restore an older version
    than rank 0 (ROADMAP.md queue 3)."""
    trainer = _trainer()
    path = str(tmp_path / "ck")
    _save(trainer, path, 1, True)
    order = []
    wait = trainer._saver.wait
    monkeypatch.setattr(trainer._saver, "wait",
                        lambda: (order.append("wait"), wait())[1])
    monkeypatch.setattr(distributed, "barrier",
                        lambda: order.append("barrier"))
    load = ckpt.load_checkpoint
    monkeypatch.setattr(ckpt, "load_checkpoint",
                        lambda *a, **k: (order.append("read"),
                                         load(*a, **k))[1])
    assert trainer.load(path)[0] == 1
    assert order == ["wait", "barrier", "read"]


# ---------------------------------------------------------------------------
# across a world change (the pair)
# ---------------------------------------------------------------------------


def test_cursor_counts_global_batches_across_world():
    """Step s at world 2 (both shards together) covers the samples of step
    s at world 1: a resume at either world repeats none and skips none."""
    for epoch in (0, 1):
        one = gpt2_loader()
        one.set_epoch(epoch)
        pair = [gpt2_loader(r, WORLD) for r in range(WORLD)]
        for loader in pair:
            loader.set_epoch(epoch)
        for s in range(len(one)):
            want = {tuple(row) for row in
                    next(iter(one.iter_from(s)))["tokens"].tolist()}
            got = set()
            for loader in pair:
                got |= {tuple(row) for row in
                        next(iter(loader.iter_from(s)))["tokens"].tolist()}
            assert got == want, (epoch, s)


def _resume_at_world1(sharded_pair, version, tmp_path):
    """A copy of the world-2 run's checkpoint dir with its pointer at
    ``version``, resumed by a one-process replicated run to the end."""
    src = os.path.join(sharded_pair["root"], "w2")
    dst = str(tmp_path / "w2")
    shutil.copytree(src, dst)
    path = os.path.join(dst, ckpt.LATEST_NAME)
    with open(path, "wb") as f:
        f.write(ckpt.SHARDED_MAGIC + version.encode())
    trainer, losses = gpt2_trainer(False, None, 1)
    trainer.fit(gpt2_loader(), None, epochs=EPOCHS, resume=path)
    return trainer, losses


@pytest.mark.parametrize("version, done", [("00000001", 2),
                                           ("00000000.00000001", 1)])
def test_world2_sharded_resumes_at_world1(sharded_pair, tmp_path, version,
                                          done):
    ref = sharded_pair["w1_ref_losses"]
    for rank in range(WORLD):  # the world-2 steps themselves
        np.testing.assert_allclose(sharded_pair["pair"][rank]["w2_losses"],
                                   ref[:2], atol=CROSS_WORLD_TOL, rtol=0)
    trainer, losses = _resume_at_world1(sharded_pair, version, tmp_path)
    assert trainer.state.step == sharded_pair["w1_ref_step"]
    assert len(losses) == len(ref) - done
    np.testing.assert_allclose(losses, ref[done:], atol=CROSS_WORLD_TOL,
                               rtol=0)


def test_world1_sharded_resumes_at_world2(sharded_pair):
    ref = sharded_pair["w1_ref_losses"]
    for rank in range(WORLD):
        out = sharded_pair["pair"][rank]
        assert out["w1_to_w2_step"] == sharded_pair["w1_ref_step"]
        np.testing.assert_allclose(out["w1_to_w2_losses"], ref[2:],
                                   atol=CROSS_WORLD_TOL, rtol=0)
