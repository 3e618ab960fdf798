"""The spawned processes of ``tests/test_torch_fsdp.py``: the port's FSDP
Trainer at world 2 (mesh data=1 x fsdp=2) and at world 4 (data=2 x
fsdp=2) over gloo on the CPU. This module imports no JAX, so a spawned
process starts in a few seconds; the parent holds the results against
the JAX package.

Every run starts from the seed-0 weights the parent also uses and trains
on the same synthetic datasets, global batch :data:`GLOBAL_BATCH` split
over the ranks by flat rank, 3 steps and one validation batch, SGD
(momentum 0.9).
"""

import multiprocessing
import os
import socket

import numpy as np
import torch

from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticClassificationDataset,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.models import GPT2, SimpleNet
from distributed_pytorch_example_tpu_torch.parallel import fsdp
from distributed_pytorch_example_tpu_torch.runtime import (
    MeshSpec,
    distributed,
    make_mesh,
)
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    ClassificationTask,
    Trainer,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train.cli import main as train_main
from distributed_pytorch_example_tpu_torch.train.state import (
    train_state_to_flax,
)

TIMEOUT_S = 120
GPT = dict(vocab_size=97, max_len=16, model_dim=64, num_layers=2,
           num_heads=2, mlp_dim=128)
NET = dict(input_size=16, hidden_size=32, num_classes=4)
SEQ, GLOBAL_BATCH, STEPS, LR = 16, 4, 3, 0.1


def datasets(kind):
    """(train, val) datasets of one case: 3 global batches and one."""
    if kind == "gpt2":
        make = lambda n, seed: SyntheticTokenDataset(  # noqa: E731
            n, seq_len=SEQ, vocab_size=GPT["vocab_size"], seed=seed)
    else:
        make = lambda n, seed: SyntheticClassificationDataset(  # noqa: E731
            num_samples=n, input_size=NET["input_size"],
            num_classes=NET["num_classes"], seed=seed)
    return make(GLOBAL_BATCH * STEPS, 0), make(GLOBAL_BATCH, 1)


def trainer(kind, partitioner=None, **kw):
    """The case's Trainer (seed-0 weights, SGD) and its per-step losses,
    recorded as the step returns them."""
    if kind == "gpt2":
        model = GPT2(**GPT, logits_mode="hidden", device="cpu", seed=0)
        task = CausalLMTask()
    else:
        model = SimpleNet(**NET, dropout_rate=0.0, device="cpu", seed=0)
        task = ClassificationTask()
    tr = Trainer(model, task, make_optimizer(model.parameters(), "sgd", LR),
                 partitioner=partitioner, telemetry=False, **kw)
    losses, step = [], tr.train_step

    def recording(state, batch):
        out = step(state, batch)
        losses.append(float(out["loss"]))
        return out

    tr.train_step = recording
    return tr, losses


def fit(kind, partitioner=None, rank=0, world=1, **kw):
    """One epoch: ``(trainer, {losses, val_loss, tree})``, the tree the
    gathered state as numpy (a collective under FSDP)."""
    tr, losses = trainer(kind, partitioner, **kw)
    train, val = datasets(kind)
    loaders = [DeviceLoader(ds, GLOBAL_BATCH, device="cpu",
                            shuffle=False, num_shards=world, shard_id=rank,
                            prefetch=0) for ds in (train, val)]
    hist = tr.fit(*loaders, epochs=1)
    return tr, {"losses": losses, "val_loss": hist[0]["val_loss"],
                "tree": train_state_to_flax(tr.state, tr.layout())}


def _world2(rank, root):
    part = fsdp(make_mesh(MeshSpec(data=1, fsdp=2)))
    out = {}
    tr, out["gpt2"] = fit("gpt2", part, rank, 2,
                          checkpoint_dir=os.path.join(root, "gpt2"),
                          checkpoint_format="sharded")
    update = tr._step.sharded(tr.state)
    # between steps the sharded parameters hold no storage
    out["tiles"] = sum(t is not None for t in update.tiles)
    out["freed"] = all(p.untyped_storage().nbytes() == 0
                       for p, t in zip(update.params, update.tiles)
                       if t is not None)
    ckpt.save_checkpoint(os.path.join(root, "gpt2_gathered.ckpt"), tr.state,
                         1, 0.0, layout=tr.layout())
    _, out["mlp"] = fit("mlp", part, rank, 2)
    # JAX's FSDP checkpoint (the parent's) loaded into an FSDP run
    jt, _ = trainer("mlp", part)
    jt.load(os.path.join(root, "jax_mlp", ckpt.LATEST_NAME))
    out["jax_loaded"] = train_state_to_flax(jt.state, jt.layout())
    out["cli_rc"] = train_main([
        "--device", "cpu", "--partition", "fsdp", "--mesh-fsdp", "2",
        "--epochs", "1", "--num-samples", "64", "--batch-size", "8",
        "--checkpoint-dir", "", "--log-every", "100"])
    return out


def _world4(rank, root):
    mesh = make_mesh(MeshSpec(data=2, fsdp=2))
    _, out = fit("gpt2", fsdp(mesh), rank, 4,
                 checkpoint_dir=os.path.join(root, "gpt2_w4"),
                 checkpoint_format="sharded")
    out["coords"] = (mesh.axis_index("data"), mesh.axis_index("fsdp"))
    return out


def _worker(rank, world, port, root, results):
    torch.set_num_threads(1)
    config = distributed.DistributedConfig(world, rank, f"localhost:{port}")
    distributed.initialize(config, device="cpu", max_attempts=2)
    try:
        results.put((rank, (_world2 if world == 2 else _world4)(rank, root)))
    finally:
        distributed.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world, root):
    """Run the world's case in ``world`` spawned processes; every rank's
    results. Each process is joined within TIMEOUT_S, else killed, and
    the run fails."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, root, results))
             for r in range(world)]
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


def replicated(kind):
    """The port's replicated world-1 run of a case."""
    _, out = fit(kind)
    return out


def params_close(a, b):
    """The largest gap between two numpy trees' leaves."""
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max([params_close(a[k], b[k]) for k in a] or [0.0])
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max()) if a.size else 0.0
