"""The spawned processes of ``tests/test_torch_tp.py``: the port's
tensor-parallel Trainer at world 2 (mesh data=1 x tensor=2) and at world 4
(data=2 x tensor=2) over gloo on the CPU. This module imports no JAX, so a
spawned process starts in a few seconds; the parent holds the results
against the JAX package.

Every run starts from the seed-0 weights the parent also uses (each rank
keeps its slices of them) and trains on the same synthetic datasets:
global batch :data:`GLOBAL_BATCH` split over the data axis only (a tensor
group's ranks read the same rows), 3 steps and one validation batch, SGD
(momentum 0.9).
"""

import multiprocessing
import os
import socket

import numpy as np
import torch

from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.models import GPT2, Llama
from distributed_pytorch_example_tpu_torch.ops.chunked_ce import (
    chunked_softmax_xent,
)
from distributed_pytorch_example_tpu_torch.parallel import (
    TensorParallel,
    tensor_parallel,
    transformer_partitioner,
)
from distributed_pytorch_example_tpu_torch.runtime import (
    MeshSpec,
    distributed,
    make_mesh,
)
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    Trainer,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train import cli
from distributed_pytorch_example_tpu_torch.train.state import (
    train_state_to_flax,
)

TIMEOUT_S = 120
GPT = dict(vocab_size=97, max_len=16, model_dim=64, num_layers=2,
           num_heads=2, mlp_dim=128)
# LLaMA's vocab divides the tensor size: the embedding and head are
# vocab-parallel, as at its real 32000
LLAMA = dict(vocab_size=128, max_len=16, model_dim=64, num_layers=2,
             num_heads=4, num_kv_heads=2, mlp_dim=128)
KINDS = {"gpt2": (GPT2, GPT), "llama": (Llama, LLAMA)}
SEQ, GLOBAL_BATCH, STEPS, LR = 16, 4, 3, 0.1


def datasets(kind):
    """(train, val) datasets of one case: 3 global batches and one."""
    vocab = KINDS[kind][1]["vocab_size"]
    return (SyntheticTokenDataset(GLOBAL_BATCH * STEPS, seq_len=SEQ,
                                  vocab_size=vocab, seed=0),
            SyntheticTokenDataset(GLOBAL_BATCH, seq_len=SEQ,
                                  vocab_size=vocab, seed=1))


def model_of(kind, mesh=None, **kw):
    """The case's seed-0 model, cut over the mesh's tensor axis."""
    cls, cfg = KINDS[kind]
    if mesh is not None:
        kw["tensor_parallel"] = TensorParallel.from_mesh(mesh)
    return cls(**cfg, device="cpu", seed=0,
               **{"logits_mode": "hidden", **kw})


def trainer(kind, mesh=None, **kw):
    """The case's Trainer (seed-0 weights, SGD, under
    ``transformer_partitioner(mesh)``) and its per-step metrics, recorded
    as the step returns them."""
    model = model_of(kind, mesh)
    part = None if mesh is None else transformer_partitioner(mesh)
    tr = Trainer(model, CausalLMTask(),
                 make_optimizer(model.parameters(), "sgd", LR),
                 partitioner=part, telemetry=False, **kw)
    steps, step = [], tr.train_step

    def recording(state, batch):
        out = step(state, batch)
        steps.append({k: float(out[k]) for k in ("loss", "grad_norm",
                                                  "param_norm")})
        return out

    tr.train_step = recording
    return tr, steps


def fit(kind, mesh=None, **kw):
    """One epoch: ``(trainer, {losses, grad_norms, param_norms, val_loss,
    tree, counts})``, the tree the gathered state as numpy (a collective
    under tensor parallelism), the counts the tensor group's
    collectives."""
    tr, steps = trainer(kind, mesh, **kw)
    loaders = [DeviceLoader(ds, GLOBAL_BATCH, device="cpu", shuffle=False,
                            prefetch=0, mesh=mesh,
                            **({} if mesh else {"num_shards": 1,
                                                "shard_id": 0}))
               for ds in datasets(kind)]
    tensor_parallel.reset_counts()
    hist = tr.fit(*loaders, epochs=1)
    counts = dict(tensor_parallel.counts)
    return tr, {"losses": [s["loss"] for s in steps],
                "grad_norms": [s["grad_norm"] for s in steps],
                "param_norms": [s["param_norm"] for s in steps],
                "val_loss": hist[0]["val_loss"], "counts": counts,
                "tree": train_state_to_flax(tr.state, tr.layout())}


def forward(kind, mesh=None):
    """The seed-0 model's float32 logits (``full`` mode) on fixed tokens."""
    model = model_of(kind, mesh, logits_mode="full")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, KINDS[kind][1]["vocab_size"], (2, SEQ)))
    with torch.no_grad():
        return model(tokens).numpy()


def vocab_parallel_ce(tp):
    """Largest gaps of the vocab-parallel chunked CE to the whole-vocab
    one on the same inputs (this rank's rows of the table): loss, argmax,
    the hidden states' gradient, this rank's rows of the table's."""
    rng = np.random.default_rng(3)
    vocab, dim, n = 96, 16, 12
    hidden = torch.from_numpy(rng.standard_normal((n, dim), np.float32))
    table = torch.from_numpy(rng.standard_normal((vocab, dim), np.float32))
    targets = torch.from_numpy(rng.integers(0, vocab, n))
    width = vocab // tp.size
    start = tp.index * width
    out = {}
    grads = []
    for mine in (False, True):
        x = hidden.clone().requires_grad_()
        e = (table[start:start + width] if mine else table).clone()
        e.requires_grad_()
        kw = dict(tensor_parallel=tp, vocab_start=start) if mine else {}
        loss, argmax = chunked_softmax_xent(x, e, targets, dtype=torch.float32,
                                            block_size=20, **kw)
        (loss * torch.arange(1.0, n + 1)).sum().backward()
        de = e.grad if mine else e.grad[start:start + width]
        grads.append((loss.detach(), argmax, x.grad, de))
    (l0, a0, x0, e0), (l1, a1, x1, e1) = grads
    out["loss"] = float((l0 - l1).abs().max())
    out["argmax_equal"] = bool(torch.equal(a0, a1))
    out["dx"] = float((x0 - x1).abs().max())
    out["de"] = float((e0 - e1).abs().max())
    return out


def _cli_run():
    """The CLI under ``--partition tp --mesh-tensor 2`` on GPT-2 at the
    tiny widths and its real vocab (the registry shrunk for the call)."""
    real = cli.get_model

    def small(name, **kw):
        return real(name, **{**kw, **GPT, "vocab_size": 50257})

    cli.get_model = small
    try:
        return cli.main([
            "--device", "cpu", "--model", "gpt2", "--dataset",
            "synthetic-tokens", "--partition", "tp", "--mesh-tensor", "2",
            "--seq-len", str(SEQ), "--epochs", "1", "--num-samples", "8",
            "--batch-size", "4", "--checkpoint-dir", "", "--log-every",
            "100", "--optimizer", "sgd"])
    finally:
        cli.get_model = real


def _world2(rank, root):
    mesh = make_mesh(MeshSpec(data=1, tensor=2))
    out = {}
    for kind in KINDS:
        tr, out[kind] = fit(kind, mesh,
                            checkpoint_dir=os.path.join(root, kind),
                            checkpoint_format="sharded")
        out[kind]["forward"] = forward(kind, mesh)
        # between steps a rank holds only its slices
        out[kind]["shapes"] = {n: tuple(p.shape) for n, p in
                               tr.model.named_parameters()}
        out[kind]["cut"] = tensor_parallel.sharded_params(tr.model)
        if kind == "gpt2":
            ckpt.save_checkpoint(os.path.join(root, "gpt2_gathered.ckpt"),
                                 tr.state, 1, 0.0, layout=tr.layout())
    # JAX's TP checkpoint (the parent's) loaded into a TP run
    jt, _ = trainer("llama", mesh)
    jt.load(os.path.join(root, "jax_llama", ckpt.LATEST_NAME))
    out["jax_loaded"] = train_state_to_flax(jt.state, jt.layout())
    out["ce"] = vocab_parallel_ce(TensorParallel.from_mesh(mesh))
    out["cli_rc"] = _cli_run()
    return out


def _world4(rank, root):
    mesh = make_mesh(MeshSpec(data=2, tensor=2))
    out = {"coords": (mesh.axis_index("data"), mesh.axis_index("tensor"))}
    for kind in KINDS:
        _, out[kind] = fit(kind, mesh,
                           checkpoint_dir=os.path.join(root, f"{kind}_w4"),
                           checkpoint_format="sharded")
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
    """The port's replicated world-1 run of a case, and its forward."""
    _, out = fit(kind)
    out["forward"] = forward(kind)
    return out


def params_close(a, b):
    """The largest gap between two numpy trees' leaves."""
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max([params_close(a[k], b[k]) for k in a] or [0.0])
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max()) if a.size else 0.0
