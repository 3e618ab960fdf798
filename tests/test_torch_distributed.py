"""The port's data parallelism on the CPU: two gloo processes, each on its
half of the global batch, against one process on the whole batch; and the
topology contract of runtime/distributed.py.

After one SGD step the parameters agree to 1e-6: the two runs differ only
in how the gradient sum is ordered (an all-reduce of two local means
against one mean over all rows). SGD, not Adam, keeps the update linear
in the gradient, so rounding is not amplified.
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.models import GPT2
from distributed_pytorch_example_tpu_torch.runtime import distributed
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    TrainState,
    build_train_step,
    make_optimizer,
)

KW = dict(vocab_size=97, max_len=16, model_dim=32, num_layers=1,
          num_heads=2, mlp_dim=64)
GLOBAL_BATCH = 4
TIMEOUT_S = 120


def _one_step(world: int, rank: int):
    torch.set_num_threads(1)
    model = GPT2(**KW, logits_mode="hidden", device="cpu", seed=0)
    optimizer = make_optimizer(model.parameters(), "sgd", 0.1)
    loader = DeviceLoader(SyntheticTokenDataset(8, seq_len=16, vocab_size=97,
                                                seed=0),
                          GLOBAL_BATCH, device="cpu", num_shards=world,
                          shard_id=rank, prefetch=0)
    batch = next(iter(loader))
    state = TrainState(step=0, model=model, optimizer=optimizer)
    metrics = build_train_step(CausalLMTask())(state, batch)
    # numpy, not tensors: a tensor sent through a queue shares memory with
    # a process that exits right after
    return ({k: v.numpy().copy() for k, v in model.state_dict().items()},
            float(metrics["loss"]))


def _worker(rank: int, world: int, port: int, results) -> None:
    config = distributed.DistributedConfig(world, rank, f"localhost:{port}")
    distributed.initialize(config, device="cpu", max_attempts=2)
    try:
        assert distributed.process_count() == world
        assert distributed.process_index() == rank
        results.put((rank, _one_step(world, rank)))
    finally:
        distributed.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_equal_one_process_on_the_global_batch():
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, 2, port, results))
             for r in range(2)]
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
    want_params, want_loss = _one_step(1, 0)
    for rank in (0, 1):
        params, loss = got[rank]
        assert abs(loss - want_loss) <= 1e-6
        for key, value in want_params.items():
            np.testing.assert_allclose(params[key], value, atol=1e-6, rtol=0,
                                       err_msg=f"rank {rank} {key}")


def test_topology_from_the_environment():
    assert distributed.resolve_config({}) == distributed.DistributedConfig(
        1, 0, None)
    cfg = distributed.resolve_config({"REPLICAS": "4", "HOSTNAME": "job-3",
                                      "NF_DISCOVERY_SERVICE": "svc"})
    assert cfg == distributed.DistributedConfig(4, 3, "job-0.svc:29500")
    cfg = distributed.resolve_config({"REPLICAS": "2", "PROCESS_ID": "1",
                                      "COORDINATOR_ADDRESS": "localhost",
                                      "COORDINATOR_PORT": "1234"})
    assert cfg == distributed.DistributedConfig(2, 1, "localhost:1234")
    assert distributed.derive_process_id("worker") == 0
    # one process: no rendezvous, no process group
    assert not distributed.initialize(device="cpu").is_distributed
    assert distributed.process_count() == 1 and distributed.is_coordinator()


def test_rendezvous_gives_up_after_bounded_retries(monkeypatch):
    calls = []

    def refuse(**kw):
        calls.append(kw)
        raise RuntimeError("connection refused")

    monkeypatch.setattr(distributed.dist, "init_process_group", refuse)
    monkeypatch.setenv("DPX_RENDEZVOUS_BACKOFF", "0")
    config = distributed.DistributedConfig(2, 0, "localhost:1")
    with pytest.raises(RuntimeError, match="refused"):
        distributed.initialize(config, device="cpu", max_attempts=3)
    assert len(calls) == 3
    assert calls[0]["init_method"] == "tcp://localhost:1"
