"""Resume, preemption and recovery through the port's ``Trainer.fit``, on
the CPU.

A small SimpleNet (16 -> 32 -> 4, dropout 0.2 unless stated) on seeded
synthetic data; the counterparts of the JAX package's
``tests/test_train.py`` resume cases, ``tests/test_step_resume.py`` and
``tests/test_chaos.py``:

- resume continues after the finished epoch, ``best`` follows validation
  accuracy, a missing ``--resume`` path trains from scratch, and
  ``metrics.jsonl`` is truncated by a fresh run and appended by a resumed
  one;
- a ``save_every_steps`` checkpoint resumes mid-epoch and the rest of the
  run is bit-identical to the uninterrupted run (every loss, and the final
  state); the training CLI in a subprocess, sent SIGTERM mid-epoch, exits
  143 leaving ``latest`` with its cursor, and its resume ends in the
  uninterrupted run's final state bit for bit;
- a corrupted ``latest`` falls back to its ancestor in the history trail;
  ``io-flake`` write errors are retried away; a persistent NaN spends the
  bad-step budget, rolls back once, then fails;
- ZeRO-1 at world 2 over gloo (the process pair of
  ``tests/test_torch_zero1.py``): the gathered save holds the replicated
  run's parameters, its moments are within the step tolerance of the JAX
  package's replicated-path payload, its mesh stamp is the one JAX writes
  for the same world and mode, and resumes that flip the mode continue the
  run.

Tolerances: bit-equal wherever the same code runs on the same state and
data (resume, fallback). ZeRO-1 against the replicated step: the same
2-rank sums in another grouping, 1e-6 (``tests/test_torch_zero1.py``);
against JAX, the float32 train-step tolerance 1e-5 for Adam's moments.
"""

import json
import os
import re
import signal
import subprocess
import sys

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.data import intake as jax_intake
from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu.parallel.api import (
    data_parallel as jax_data_parallel,
)
from distributed_pytorch_example_tpu.robustness import elastic as jax_elastic
from distributed_pytorch_example_tpu.robustness import (
    integrity as jax_integrity,
)
from distributed_pytorch_example_tpu.runtime import MeshSpec, make_mesh
from distributed_pytorch_example_tpu.train import checkpoint as jax_ckpt
from distributed_pytorch_example_tpu.train import optimizers as jax_opt
from distributed_pytorch_example_tpu.train import step as jax_step
from distributed_pytorch_example_tpu.train import tasks as jax_tasks
from distributed_pytorch_example_tpu.train.state import TrainState as JaxState
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticClassificationDataset,
    intake,
)
from distributed_pytorch_example_tpu_torch.models import GPT2, SimpleNet
from distributed_pytorch_example_tpu_torch.robustness import (
    BadStepBudgetExceeded,
    chaos,
)
from distributed_pytorch_example_tpu_torch.robustness.integrity import (
    read_verified,
    unseal,
)
from distributed_pytorch_example_tpu_torch.train import (
    ClassificationTask,
    Trainer,
    load_checkpoint,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train.cli import main as train_main
from distributed_pytorch_example_tpu_torch.train.state import (
    to_host,
    to_numpy,
    train_state_to_flax,
)
from distributed_pytorch_example_tpu_torch.utils import msgpack
from test_torch_zero1 import (  # noqa: F401  (the shared process pair)
    KW as ZKW,
    LR as ZLR,
    MIN_SHARD,
    WORLD,
    _assert_params_close,
    ckpt_loader,
    zero1_results,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = dict(input_size=16, hidden_size=32, num_classes=4)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test leaves the process chaos-free (module-global plan)."""
    yield
    chaos.uninstall()


def _trainer(checkpoint_dir=None, dropout=0.2, **kw):
    """A SimpleNet Trainer whose steps record their losses."""
    model = SimpleNet(**NET, dropout_rate=dropout, device="cpu", seed=0)
    trainer = Trainer(model, ClassificationTask(),
                      make_optimizer(model.parameters(), "adam", 1e-2),
                      checkpoint_dir=checkpoint_dir,
                      log_every=kw.pop("log_every", 2), **kw)
    losses, step_fn = [], trainer.train_step

    def step(state, batch):
        metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        return metrics

    trainer.train_step = step
    return trainer, losses


def _loader():
    return DeviceLoader(SyntheticClassificationDataset(
        256, input_size=NET["input_size"], num_classes=NET["num_classes"],
        seed=0), 32, device="cpu", seed=0, prefetch=0)


def _val():
    return DeviceLoader(SyntheticClassificationDataset(
        64, input_size=NET["input_size"], num_classes=NET["num_classes"],
        seed=1), 32, device="cpu", shuffle=False, prefetch=0)


def _payload(path):
    return msgpack.msgpack_restore(read_verified(path))


def _assert_same_state(got, want):
    """Two flax state trees, leaf for leaf, bit for bit."""
    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, tree

    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(value), err_msg=key)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def test_resume_continues_after_the_finished_epoch(tmp_path):
    """The epoch-end save of epoch N is stamped N + 1, and a resumed fit's
    first epoch is N + 1: the finished epoch is not run again, and the
    resumed epochs take the uninterrupted run's steps bit for bit."""
    ckdir = str(tmp_path / "ck")
    full, full_losses = _trainer()
    full.fit(_loader(), _val(), epochs=5)
    first, _ = _trainer(ckdir)
    first.fit(_loader(), _val(), epochs=3)
    latest = os.path.join(ckdir, ckpt.LATEST_NAME)
    probe, _ = _trainer()
    _, saved_epoch, _ = load_checkpoint(latest, probe.state)
    assert saved_epoch == 3
    second, losses = _trainer(ckdir)
    history = second.fit(_loader(), _val(), epochs=5, resume=latest)
    assert [r["epoch"] for r in history] == [3, 4]
    assert losses == full_losses[3 * 8:]
    _assert_same_state(train_state_to_flax(second.state),
                       train_state_to_flax(full.state))


def test_best_checkpoint_tracks_validation_accuracy(tmp_path):
    """best is rewritten only when validation accuracy improves; it and
    latest carry the best accuracy so far."""
    ckdir = str(tmp_path / "ck")
    trainer, _ = _trainer(ckdir)
    history = trainer.fit(_loader(), _val(), epochs=4)
    accs = [r["val_accuracy"] for r in history]
    best = _payload(os.path.join(ckdir, ckpt.BEST_NAME))
    latest = _payload(os.path.join(ckdir, ckpt.LATEST_NAME))
    assert best["extra"]["best_accuracy"] == max(accs)
    assert best["epoch"] == accs.index(max(accs)) + 1
    assert latest["epoch"] == 4
    assert latest["extra"]["best_accuracy"] == max(accs)
    saves = len(ckpt._gathered_history_paths(
        os.path.join(ckdir, ckpt.BEST_NAME)))
    improved = sum(a > max([0.0] + accs[:i]) for i, a in enumerate(accs))
    assert saves == min(improved, ckpt.DEFAULT_RETAIN)


def test_missing_resume_path_trains_from_scratch(tmp_path):
    trainer, losses = _trainer()
    history = trainer.fit(_loader(), None, epochs=2,
                          resume=str(tmp_path / "missing.ckpt"))
    fresh, fresh_losses = _trainer()
    fresh.fit(_loader(), None, epochs=2)
    assert [r["epoch"] for r in history] == [0, 1]
    assert losses == fresh_losses


def test_metrics_jsonl_truncated_fresh_appended_on_resume(tmp_path):
    ckdir = str(tmp_path / "ck")
    metrics = os.path.join(ckdir, "metrics.jsonl")

    def epochs():
        with open(metrics) as f:
            return [json.loads(line)["epoch"] for line in f]

    _trainer(ckdir)[0].fit(_loader(), _val(), epochs=2)
    assert epochs() == [0, 1]
    _trainer(ckdir)[0].fit(_loader(), _val(), epochs=4,
                           resume=os.path.join(ckdir, ckpt.LATEST_NAME))
    assert epochs() == [0, 1, 2, 3]
    _trainer(ckdir)[0].fit(_loader(), _val(), epochs=1)
    assert epochs() == [0]


# ---------------------------------------------------------------------------
# step resume and preemption
# ---------------------------------------------------------------------------


def test_save_every_steps_resumes_mid_epoch_bit_identically(tmp_path):
    """8 steps an epoch, saves at batches 3 and 6 and at each epoch's end;
    resuming from the epoch-0, batch-6 entry of the trail repeats the
    uninterrupted run's remaining 10 losses and ends in its state, bit for
    bit (dropout on: its masks come from (seed, step))."""
    ckdir = str(tmp_path / "ck")
    full, full_losses = _trainer(ckdir, save_every_steps=3,
                                 checkpoint_retain=10)
    full_history = full.fit(_loader(), _val(), epochs=2)
    trail = ckpt._gathered_history_paths(
        os.path.join(ckdir, ckpt.LATEST_NAME))[::-1]  # oldest first
    cursors = [(_payload(p)["epoch"],
                _payload(p)["extra"].get("batch_in_epoch")) for p in trail]
    assert cursors == [(0, 3), (0, 6), (1, None), (1, 3), (1, 6), (2, None)]
    manifest = _payload(trail[1])["extra"]["loader_manifest"]
    assert manifest["batch_in_epoch"] == 6 and manifest["seed"] == 0
    resumed, losses = _trainer()
    history = resumed.fit(_loader(), _val(), epochs=2, resume=trail[1])
    assert [r["epoch"] for r in history] == [0, 1]
    assert losses == full_losses[6:]
    _assert_same_state(train_state_to_flax(resumed.state),
                       train_state_to_flax(full.state))
    assert history[-1]["val_loss"] == full_history[-1]["val_loss"]


def test_loader_stamp_checks_the_seed_and_refuses_a_quarantine():
    """The stamp's digest is the JAX package's; resuming on another seed or
    with quarantined shards (no port loader quarantines yet) raises."""
    for shards in ([], [3], [7, 2, 2]):
        assert intake.quarantine_digest(shards) == \
            jax_intake.quarantine_digest(shards)
    loader = _loader()
    stamp = intake.loader_manifest(loader, 1, 5)
    assert stamp["quarantine"] == [] and stamp["quarantine_digest"] == 0
    assert intake.restore_loader_state(loader, stamp) == 5
    with pytest.raises(ValueError, match="seed"):
        intake.restore_loader_state(loader, {**stamp, "seed": 1})
    with pytest.raises(NotImplementedError, match="item 13"):
        intake.restore_loader_state(loader, {**stamp, "quarantine": [2]})


CLI = ["--device", "cpu", "--epochs", "1", "--num-samples", "4000",
       "--batch-size", "2", "--seed", "3"]
LOSS_RE = re.compile(r"Epoch (\d+), Batch (\d+)/\d+, Loss: ([0-9.]+)")


def test_sigterm_mid_epoch_exits_143_and_resumes_bit_identically(tmp_path):
    """SimpleNet's CLI at its widths, 2000 batches: SIGTERM after the first
    progress line finishes the step in flight, writes `latest` with the
    cursor and exits 143; ``--resume`` logs the cursor and ends in the
    uninterrupted run's final state and validation loss, bit for bit."""
    victim_dir, ctrl_dir = str(tmp_path / "victim"), str(tmp_path / "ctrl")
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": REPO}
    victim = subprocess.Popen(
        [sys.executable, "-m", "distributed_pytorch_example_tpu_torch.train",
         *CLI, "--log-every", "1", "--checkpoint-dir", victim_dir],
        cwd=REPO, env=env, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True)
    seen = []
    try:
        for line in victim.stderr:
            seen.append(line)
            if LOSS_RE.search(line):
                victim.send_signal(signal.SIGTERM)
                break
        seen += victim.stderr.readlines()
        rc = victim.wait(timeout=120)
    finally:
        if victim.poll() is None:
            victim.kill()
            victim.wait()
    log = "".join(seen)
    assert rc == 143, log[-2000:]
    assert "Preemption checkpoint complete" in log
    latest = os.path.join(victim_dir, ckpt.LATEST_NAME)
    cursor = _payload(latest)["extra"]["batch_in_epoch"]
    assert 0 < cursor < 2000

    assert train_main([*CLI, "--log-every", "1000", "--checkpoint-dir",
                       victim_dir, "--resume", latest]) == 0
    assert train_main([*CLI, "--log-every", "1000", "--checkpoint-dir",
                       ctrl_dir]) == 0
    _assert_same_state(
        _payload(os.path.join(victim_dir, ckpt.LATEST_NAME))["state"],
        _payload(os.path.join(ctrl_dir, ckpt.LATEST_NAME))["state"])

    def last(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f][-1]

    assert last(victim_dir)["val_loss"] == last(ctrl_dir)["val_loss"]


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------


def test_corrupt_latest_falls_back_to_its_ancestor(tmp_path):
    ckdir = str(tmp_path / "ck")
    _trainer(ckdir)[0].fit(_loader(), None, epochs=3)
    latest = os.path.join(ckdir, ckpt.LATEST_NAME)
    assert len(ckpt._gathered_history_paths(latest)) == ckpt.DEFAULT_RETAIN
    chaos.corrupt_file(latest, mode="bitflip", seed=1)
    events = []
    probe, _ = _trainer()
    _, epoch, _ = load_checkpoint(
        latest, probe.state,
        on_event=lambda kind, **f: events.append({"event": kind, **f}))
    assert epoch == 2  # the newest intact ancestor
    assert len(events) == 1 and len(events[0]["skipped"]) == 1
    assert "checksum mismatch" in events[0]["skipped"][0]["reason"]
    resumed, _ = _trainer(ckdir)
    history = resumed.fit(_loader(), None, epochs=4, resume=latest)
    assert resumed.recovery["checkpoint_fallbacks"] == 1
    assert [r["epoch"] for r in history] == [2, 3]


def test_io_flake_write_errors_are_retried_away(tmp_path):
    chaos.install(chaos.preset("io-flake"))
    ckdir = str(tmp_path / "ck")
    trainer, _ = _trainer(ckdir, save_every_steps=2)
    trainer.fit(_loader(), None, epochs=2)
    assert trainer._saver.io_retries_used == 2
    probe, _ = _trainer()
    assert load_checkpoint(os.path.join(ckdir, ckpt.LATEST_NAME),
                           probe.state)[1] == 2


def test_persistent_nan_rolls_back_once_then_fails(tmp_path):
    chaos.install(chaos.ChaosPlan(
        faults=[chaos.Fault("nan-batch", step=2, count=10_000)]))
    trainer, _ = _trainer(str(tmp_path / "ck"), log_every=1,
                          max_bad_steps=1, save_every_steps=1)
    with pytest.raises(BadStepBudgetExceeded, match="again after a rollback"):
        trainer.fit(_loader(), None, epochs=3)
    assert trainer.recovery["rollbacks"] == 1
    assert trainer.recovery["bad_steps"] >= 2


def test_budget_without_a_checkpoint_fails_without_rollback():
    chaos.install(chaos.ChaosPlan(
        faults=[chaos.Fault("nan-batch", step=0, count=10_000)]))
    trainer, _ = _trainer(log_every=1, max_bad_steps=1)
    with pytest.raises(BadStepBudgetExceeded,
                       match="no checkpoint to roll back to"):
        trainer.fit(_loader(), None, epochs=1)
    assert trainer.recovery["rollbacks"] == 0


def test_nan_step_preset_from_the_environment_skips_one_step(monkeypatch):
    """``DPX_CHAOS=nan-step`` poisons global step 3: that step is skipped
    (its loss is NaN, the parameters stay), and training continues."""
    monkeypatch.setenv(chaos.ENV_VAR, "nan-step")
    chaos.uninstall()  # re-read the environment
    trainer, losses = _trainer(log_every=1)
    history = trainer.fit(_loader(), None, epochs=1)
    assert trainer.recovery == {"bad_steps": 1, "rollbacks": 0,
                                "checkpoint_fallbacks": 0}
    assert np.isnan(losses[3]) and np.isfinite(losses[4:]).all()
    assert history[0]["train_bad_step"] == 1 / 8


# ---------------------------------------------------------------------------
# ZeRO-1 at world 2 (the process pair of test_torch_zero1.py)
# ---------------------------------------------------------------------------


def _np(tree):
    """A flax tree of tensor views (``interop.params_to_flax``) as numpy
    copies."""
    return to_numpy(to_host(tree))


def _zero1_payload(zero1_results):
    blob = zero1_results[0]["checkpoint"]["zero1_file"]
    return msgpack.msgpack_restore(unseal(memoryview(bytearray(blob))))


def test_zero1_gathered_save_holds_the_replicated_runs_parameters(
        zero1_results):
    payload = _zero1_payload(zero1_results)
    assert payload["epoch"] == 1 and int(payload["state"]["step"]) == 2
    model = GPT2(**ZKW, logits_mode="hidden", device="cpu", seed=0)
    interop.params_from_flax(model, payload["state"]["params"])
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for rank in range(WORLD):
        want = zero1_results[rank]["checkpoint"]["replicated_epoch0"]
        _assert_params_close(got, want, 1e-6, f"gathered vs rank {rank}")


def _jax_replicated_payload(tmp_path):
    """The JAX package's replicated step, one process, on the pair's global
    batches (the same rows per step), saved by its own save_checkpoint:
    the decoded payload."""
    model = GPT2(**ZKW, logits_mode="hidden", device="cpu", seed=0)
    jmodel = JaxGPT2(**ZKW, logits_mode="hidden")
    tx = jax_opt.make_optimizer("adam", ZLR["adam"])
    params = jax.tree_util.tree_map(
        jnp.asarray, _np(interop.params_to_flax(model)))
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     opt_state=tx.init(params), model_state={},
                     rng=jax.random.key(0))
    step = jax_step.build_train_step(jmodel, jax_tasks.CausalLMTask(), tx,
                                     sentinels=False)
    loader = ckpt_loader(0, 1)
    loader.set_epoch(0)
    for batch in loader:
        state, _ = step(state, {"tokens": jnp.asarray(batch["tokens"].numpy())})
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, state, 1, 0.0, retain=0)
    return flax_ser.msgpack_restore(jax_integrity.read_verified(path))


def test_zero1_gathered_moments_match_jax_replicated_payload(zero1_results,
                                                              tmp_path):
    got = _zero1_payload(zero1_results)["state"]["opt_state"]
    want = _jax_replicated_payload(tmp_path)["state"]["opt_state"]

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(tree)

    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        if value.dtype.kind in "iu":
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            err = np.abs(got[key] - value).max()
            assert err <= 1e-5, f"{key}: off by {err:.3e}"


def test_zero1_stamp_is_the_one_jax_writes(zero1_results):
    """The JAX package's mesh_manifest of the same state under ZeRO-1 on
    a 2-device data mesh: the same canonical axes, specs and scatter dims."""
    stamp = _zero1_payload(zero1_results)["mesh_manifest"]
    mesh = make_mesh(MeshSpec(data=WORLD), devices=jax.devices()[:WORLD])
    part = jax_data_parallel(mesh, dp_shard_opt_state=True,
                             opt_shard_min_size=MIN_SHARD)
    state, _ = jax_step.init_state(
        JaxGPT2(**ZKW, logits_mode="hidden"),
        jax_opt.make_optimizer("adam", ZLR["adam"]),
        jnp.zeros((2, 16), jnp.int32), jax.random.key(0), part)
    want = jax_elastic.mesh_manifest(state)
    assert stamp["format"] == want["format"] == 3
    assert (jax_elastic.canonical_axes(stamp["axes"])
            == jax_elastic.canonical_axes(want["axes"]) == {"data": WORLD})
    assert stamp["specs"] == want["specs"]
    assert stamp["zero1_dims"] == want["zero1_dims"]
    assert stamp["zero1_dims"]  # some leaves really are sharded


def test_resume_flipping_replicated_and_zero1_continues_the_run(
        zero1_results):
    """Replicated epoch 0 -> ZeRO-1 epoch 1 -> replicated epoch 2, each
    resumed from the other mode's gathered checkpoint, against the
    uninterrupted replicated run of 3 epochs."""
    for rank in range(WORLD):
        got = zero1_results[rank]["checkpoint"]
        steps = len(got["ref_losses"]) // 3
        assert got["flip_steps"] == [2 * steps, 3 * steps]
        np.testing.assert_allclose(got["flip_losses"],
                                   got["ref_losses"][steps:], atol=1e-6,
                                   rtol=0)
        _assert_params_close(got["flip_params"], got["ref_params"], 1e-6,
                             f"flipped run rank {rank}")
