"""The port's checkpoint format against the JAX package's, on the CPU.

- The codec (``utils/msgpack.py``) writes the bytes of
  ``flax.serialization.msgpack_serialize`` and reads flax's bytes to equal
  values, chunking included (``MAX_CHUNK_SIZE`` lowered on both sides).
- The ``DPX-CRC1`` envelope (``robustness/integrity.py``) seals to the JAX
  package's bytes; one flipped byte raises, an unsealed blob passes.
- The train state (``train/state.py``): after 3 steps from the same
  weights on the same batches, ``train_state_to_flax`` has the keys,
  shapes and dtypes of ``to_state_dict`` of JAX's ``TrainState`` exactly,
  for adam, adamw and sgd, adam with clipping and a cosine schedule with
  warmup, and adam with ``every_k=2`` (adafactor's tree:
  ``tests/test_torch_item7.py``). Values within the float32
  train-step tolerance of ``tests/test_torch_train_step.py``: parameters
  and moments 1e-5, except parameter entries whose gradient is below 1e-5
  at some step, where Adam's normalised update may follow rounding noise
  (2 * lr per step); counts exactly.
- Cross-loading (ROADMAP item 4's gate), a small GPT-2 (2 layers, width
  64), one epoch of 4 steps: a JAX-written ``latest_model.ckpt`` resumes in
  the port's ``Trainer.fit`` and the next epoch's losses match JAX's own
  resumed epoch, and a port-written one resumes in JAX's
  ``load_checkpoint`` / ``Trainer.fit`` against the port's own resumed
  epoch; 4 Adam steps, so losses to 1e-4 (the train-step tolerance after
  several steps).
"""

import os
import shutil

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.data.loader import (
    DeviceLoader as JaxLoader,
)
from distributed_pytorch_example_tpu.data.synthetic import (
    SyntheticTokenDataset as JaxTokenData,
)
from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu.models.mlp import SimpleNet as JaxSimpleNet
from distributed_pytorch_example_tpu.robustness import integrity as jax_integrity
from distributed_pytorch_example_tpu.train import checkpoint as jax_ckpt
from distributed_pytorch_example_tpu.train import loop as jax_loop
from distributed_pytorch_example_tpu.train import optimizers as jax_opt
from distributed_pytorch_example_tpu.train import step as jax_step
from distributed_pytorch_example_tpu.train import tasks as jax_tasks
from distributed_pytorch_example_tpu.train.state import TrainState as JaxState
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.models import GPT2, SimpleNet
from distributed_pytorch_example_tpu_torch.robustness import integrity
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    ClassificationTask,
    Trainer,
    TrainState,
    build_train_step,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train.state import (
    to_host,
    to_numpy,
    train_state_from_flax,
    train_state_to_flax,
)
from distributed_pytorch_example_tpu_torch.utils import msgpack

torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        if not tree:
            out[prefix] = "{}"
        return out
    return {prefix: tree}


def _assert_same_values(got, want):
    got, want = _leaves(got), _leaves(want)
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert isinstance(got[key], np.ndarray), key
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert type(got[key]) is type(value) and got[key] == value, key


def _codec_tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "i32": rng.integers(-9, 9, (4,)).astype(np.int32),
        "u32": np.array([0, 7], dtype=np.uint32),
        "bool": np.array([True, False, True]),
        "f64": rng.standard_normal(300),
        "zero_d": np.asarray(3, dtype=np.int32),
        "np_scalar": np.float32(2.5),
        "nested": {"empty": {}, "big_int": 2**40, "neg": -70000,
                   "small": 5, "float": 0.125, "str": "latest" * 8,
                   "none": None, "flag": True, "list": [1, "a", 2.5]},
        "empty_array": np.zeros((0, 3), np.float32),
    }


def _np(tree):
    """A flax tree of tensor views (``interop.params_to_flax``) as numpy
    copies."""
    return to_numpy(to_host(tree))


def _serialize(tree) -> bytes:
    return b"".join(msgpack.msgpack_pieces(tree))


def test_codec_matches_flax_bytes_both_ways():
    tree = _codec_tree()
    blob = flax_ser.msgpack_serialize(tree)
    assert _serialize(tree) == blob
    _assert_same_values(msgpack.msgpack_restore(blob),
                        flax_ser.msgpack_restore(blob))


def test_codec_chunks_arrays_as_flax_does(monkeypatch):
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    tree = _codec_tree()
    blob = flax_ser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert _serialize(tree) == blob
    _assert_same_values(msgpack.msgpack_restore(blob),
                        flax_ser.msgpack_restore(blob))


def test_codec_carries_bfloat16_as_torch():
    bits = jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3
    blob = flax_ser.msgpack_serialize({"w": bits})
    got = msgpack.msgpack_restore(blob)["w"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(bits).view(np.int16))
    assert _serialize({"w": got}) == blob


def test_envelope_matches_jax_and_catches_a_flipped_byte(tmp_path):
    body = flax_ser.msgpack_serialize(_codec_tree())
    sealed = integrity.seal_header([body]) + body
    assert sealed == jax_integrity.seal(body)
    assert integrity.is_sealed(sealed) and bytes(integrity.unseal(sealed)) == body
    assert integrity.unseal(body) is body  # unsealed: passes unverified
    flipped = bytearray(sealed)
    flipped[len(sealed) // 2] ^= 0x40
    with pytest.raises(integrity.CheckpointCorruptError, match="checksum"):
        integrity.unseal(bytes(flipped))
    with pytest.raises(integrity.CheckpointCorruptError, match="truncated"):
        integrity.unseal(sealed[:11])
    path = tmp_path / "blob"
    path.write_bytes(sealed)
    assert bytes(integrity.read_verified(str(path))) == body
    assert jax_integrity.read_verified(str(path)) == body


# ---------------------------------------------------------------------------
# the train state
# ---------------------------------------------------------------------------

NET = dict(input_size=16, hidden_size=32, num_classes=4)
STATE_LR, STATE_STEPS = 1e-3, 3
OPT_CASES = {
    "adam": ("adam", {}),
    "adamw": ("adamw", dict(weight_decay=1e-2)),
    "sgd": ("sgd", {}),
    "adam-clip-cosine": ("adam", dict(grad_clip_norm=1.0, schedule="cosine",
                                      warmup_steps=2, total_steps=10)),
    "adam-every2": ("adam", dict(every_k=2)),
}


def _batches(n=STATE_STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((8, NET["input_size"])).astype(np.float32),
             rng.integers(0, NET["num_classes"], 8).astype(np.int32))
            for _ in range(n)]


def _jax_state(name, kw, params, batches):
    """JAX's TrainState after the batches, as to_state_dict gives it (host
    numpy), and the gradients of each step."""
    model = JaxSimpleNet(**NET, dropout_rate=0.0)
    tx = jax_opt.make_optimizer(name, STATE_LR, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=jparams,
                     opt_state=tx.init(jparams), model_state={},
                     rng=jax.random.key(0))
    task = jax_tasks.ClassificationTask()
    step = jax_step.build_train_step(model, task, tx, sentinels=False)
    grads = []
    for x, y in batches:
        batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        grads.append(jax.grad(lambda p: task.compute_loss(
            model, p, {}, batch, jax.random.key(1), train=True)[0])(
                state.params))
        state, _ = step(state, batch)
    return (flax_ser.to_state_dict(jax_ckpt._gather_to_host(state)),
            [jax.tree_util.tree_map(np.asarray, g) for g in grads])


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_train_state_tree_matches_jax_after_three_steps(case):
    name, kw = OPT_CASES[case]
    model = SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=0)
    params = _np(interop.params_to_flax(model))
    batches = _batches()
    want, grads = _jax_state(name, kw, params, batches)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model, name, STATE_LR, **kw))
    step = build_train_step(ClassificationTask())
    for x, y in batches:
        step(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()})
    got = train_state_to_flax(state)

    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert list(got_leaves) == list(want_leaves)  # keys and their order
    tiny = {}  # param path -> entries whose gradient was < 1e-5 at a step
    for g in grads:
        for key, leaf in _leaves(g).items():
            tiny[key] = tiny.get(key, False) | (np.abs(leaf) < 1e-5)
    for key, w in want_leaves.items():
        g = got_leaves[key]
        if isinstance(w, str):
            assert g == w, key
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (key, g.dtype,
                                                           g.shape)
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=key)
            continue
        tol = np.full(w.shape, 1e-5, np.float32)
        if key.startswith("/params"):
            tol[tiny[key[len("/params"):]]] = 2 * STATE_LR * STATE_STEPS
        err = np.abs(g - w)
        assert (err <= tol).all(), f"{key}: off by up to {err.max():.3e}"
    assert int(got["step"]) == STATE_STEPS


def test_train_state_round_trips_into_a_fresh_model_exactly():
    """to_flax -> from_flax into another model and optimizer: every
    parameter, moment and count equal; another configuration is refused
    before anything changes."""
    model = SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=0)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters(), "adam",
                                                STATE_LR, every_k=2))
    step = build_train_step(ClassificationTask())
    for x, y in _batches():
        step(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()})
    tree = train_state_to_flax(state)
    other = SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=5)
    fresh = TrainState(step=0, model=other,
                       optimizer=make_optimizer(other.parameters(), "adam",
                                                STATE_LR, every_k=2))
    train_state_from_flax(fresh, tree)
    _assert_same_values(train_state_to_flax(fresh), tree)
    third = SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=7)
    sgd = TrainState(step=0, model=third,
                     optimizer=make_optimizer(third.parameters(), "sgd", 0.1))
    before = train_state_to_flax(sgd)
    with pytest.raises(ValueError, match="opt_state"):
        train_state_from_flax(sgd, tree)
    assert sgd.step == 0 and not sgd.optimizer.optimizer.state
    _assert_same_values(train_state_to_flax(sgd), before)


def test_payload_blob_is_the_jax_packages_bytes():
    """The sealed payload of the same state, epoch, loss, extra and stamp:
    the JAX package's _payload_blob writes the same bytes."""
    model = SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=0)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters(), "adamw",
                                                STATE_LR, grad_clip_norm=1.0))
    step = build_train_step(ClassificationTask())
    for x, y in _batches():
        step(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()})
    tree = train_state_to_flax(state)
    extra = {"best_accuracy": 37.5, "batch_in_epoch": 3,
             "loader_manifest": {"format": 1, "seed": 0, "quarantine": []}}
    stamp = {"format": 3, "axes": {"data": 1}, "specs": {"step": []},
             "zero1_dims": {}}
    blob = b"".join(ckpt._payload_blob(tree, 2, 1.25, extra, stamp))
    assert blob == jax_ckpt._payload_blob(tree, 2, 1.25, extra, stamp)
    payload = msgpack.msgpack_restore(integrity.unseal(memoryview(blob)))
    assert payload["epoch"] == 2 and payload["extra"] == extra


# ---------------------------------------------------------------------------
# cross-loading: a JAX checkpoint resumes in the port, and the other way
# ---------------------------------------------------------------------------

KW = dict(vocab_size=256, max_len=32, model_dim=64, num_layers=2,
          num_heads=2, mlp_dim=256)
SEQ, BATCH, LR = 32, 4, 1e-3
DATA = dict(num_samples=16, seq_len=SEQ, vocab_size=KW["vocab_size"])
LOSS_TOL = 1e-4


def _recording(trainer):
    seen, step_fn = [], trainer.train_step

    def step(state, batch):
        out = step_fn(state, batch)
        seen.append(float((out[1] if isinstance(out, tuple) else out)["loss"]))
        return out

    trainer.train_step = step
    return seen


def _port_trainer(seed, checkpoint_dir=None):
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=seed)
    trainer = Trainer(model, CausalLMTask(),
                      make_optimizer(model.parameters(), "adam", LR),
                      log_every=100, checkpoint_dir=checkpoint_dir)
    return trainer, _recording(trainer)


def _port_loader():
    return DeviceLoader(SyntheticTokenDataset(seed=0, **DATA), BATCH,
                        device="cpu", seed=0)


def _jax_loader():
    return JaxLoader(JaxTokenData(seed=0, **DATA), BATCH, seed=0)


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """One JAX Trainer (one compile) drives every JAX side: epoch 0 from
    the port's seed-0 weights, written; its own resumed epoch 1; and
    epoch 1 resumed from the port's file."""
    root = tmp_path_factory.mktemp("cross")
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    params = jax.tree_util.tree_map(
        jnp.asarray, _np(interop.params_to_flax(model)))
    jt = jax_loop.Trainer(JaxGPT2(**KW, logits_mode="hidden"),
                          jax_tasks.CausalLMTask(),
                          jax_opt.make_optimizer("adam", LR), telemetry=False,
                          log_every=100, checkpoint_dir=str(root / "jax"))
    jt.state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=jt.optimizer.init(params), model_state={},
                        rng=jax.random.key(0))
    jseen = _recording(jt)
    jt.fit(_jax_loader(), None, epochs=1)
    jax_file = str(root / "jax_epoch1.ckpt")
    shutil.copy(root / "jax" / ckpt.LATEST_NAME, jax_file)
    jseen.clear()
    jt.fit(_jax_loader(), None, epochs=2, resume=jax_file)
    jax_epoch1 = list(jseen)

    pt, pseen = _port_trainer(0, str(root / "port"))
    pt.fit(_port_loader(), None, epochs=1)
    port_file = str(root / "port_epoch1.ckpt")
    shutil.copy(root / "port" / ckpt.LATEST_NAME, port_file)
    pseen.clear()
    pt.fit(_port_loader(), None, epochs=2, resume=port_file)
    port_epoch1 = list(pseen)
    jseen.clear()
    jt.fit(_jax_loader(), None, epochs=2, resume=port_file)
    return {"jax_file": jax_file, "jax_epoch1": jax_epoch1,
            "port_file": port_file, "port_epoch1": port_epoch1,
            "jax_from_port": list(jseen), "jax_trainer": jt}


def test_jax_checkpoint_resumes_in_the_port(cross):
    trainer, seen = _port_trainer(1)  # other weights: the file must win
    history = trainer.fit(_port_loader(), None, epochs=2,
                          resume=cross["jax_file"])
    assert [r["epoch"] for r in history] == [1]
    assert len(seen) == len(cross["jax_epoch1"]) == 4
    np.testing.assert_allclose(seen, cross["jax_epoch1"], atol=LOSS_TOL,
                               rtol=0)
    assert trainer.state.step == 8 and trainer.optimizer.updates == 8


def test_port_checkpoint_resumes_in_jax(cross):
    jt = cross["jax_trainer"]
    state, epoch, extra = jax_ckpt.load_checkpoint(cross["port_file"],
                                                   jt.state)
    assert epoch == 1 and extra["best_accuracy"] == 0.0
    assert extra["loader_manifest"]["epoch"] == 1
    assert len(cross["jax_from_port"]) == 4
    np.testing.assert_allclose(cross["jax_from_port"], cross["port_epoch1"],
                               atol=LOSS_TOL, rtol=0)


def test_port_payload_is_stamped_like_jax(cross):
    """The port's payload carries JAX's keys: epoch, loss, state, extra
    and a format-3 mesh stamp with every state leaf's spec."""
    payload = msgpack.msgpack_restore(
        integrity.read_verified(cross["port_file"]))
    assert list(payload) == ["epoch", "extra", "loss", "mesh_manifest",
                             "state"]  # sorted, as flax writes them
    stamp = payload["mesh_manifest"]
    assert stamp["format"] == 3 and stamp["axes"] == {"data": 1}
    assert stamp["zero1_dims"] == {}
    assert set(stamp["specs"]) == set(
        k.lstrip("/") for k, v in _leaves(payload["state"]).items()
        if not isinstance(v, str))
    assert os.path.samefile(
        os.path.join(os.path.dirname(cross["port_file"]), "port",
                     ckpt.LATEST_NAME),
        ckpt._gathered_history_paths(os.path.join(
            os.path.dirname(cross["port_file"]), "port",
            ckpt.LATEST_NAME))[0])
