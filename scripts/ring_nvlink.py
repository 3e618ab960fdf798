#!/usr/bin/env python3
"""The ring collectives (K3) across cards, against NCCL.

One process per visible card (two at least), joined with nccl through the
environment contract (``REPLICAS``, ``PROCESS_ID``, ``MASTER_ADDR``,
``MASTER_PORT``). Each process opens its peers' ring workspaces with CUDA
IPC, so the kernels' stores cross NVLink. Three parts (``--parts``, all
by default):

1. kernels: K3a and K3b at the ZeRO-1 path's shapes (one 4 MiB float32
   gradient bucket, and the GPT-2 124M gradient padded to 256 x world),
   held against NCCL's ``all_gather_into_tensor`` (exactly: a gather
   moves bytes) and ``reduce_scatter_tensor`` (float32 sums in another
   order: within 2 (D-1) 2^-24 sum|x| elementwise), and K3b bit for bit
   against the plain sum in the TPU ring's order (float32 at both sizes,
   bf16 at the bucket; every rank regenerates every rank's input from its
   seed), then timed cold (L2 flushed, ranks aligned by a barrier before
   each launch) beside NCCL and the NVLink bound: each rank sends out
   and takes in (D-1) parts of the payload, at 450 GB/s each way. At the
   GPT-2 size the gather is also checked and timed in bf16, the dtype of
   run (ii)'s parameter gather. One JSON line, ``ring_nvlink {...}``;
2. path: chip_smoke.py's ZeRO-1 phase at world = the card count, one
   process per card over nccl, held against the one-process replicated
   run (chip_smoke.py's train phase) on card 0;
3. profile: the ZeRO-1 steps of chip_smoke.py's runs (i) (bucketed
   float32 sync: K3b) and (ii) (int8-block wire and bf16 parameter
   gather: K3a), GPT-2 124M bf16, 16 / world rows per rank, 4 MiB
   buckets, Adam: 3 warm-up steps, 5 timed with CUDA events, 3 under
   ``torch.profiler``, per run; one JSON line, ``ring_nvlink_profile
   {...}``, with each rank's step time, device busy and idle share, and
   the device time, share of the profiled wall time and launches per
   step of K3a, K3b and NCCL.

``--root DIR`` imports the port and chip_smoke.py from another tree (a
``git archive`` of another commit) and builds its kernels there, so that
two trees can be compared in one call.

    python3 scripts/ring_nvlink.py [--root DIR] [--parts kernels,path,profile]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

NVLINK = 450e9  # bytes/s each way per H100 SXM card (NVIDIA data sheet)
BUCKET = 1 << 20  # elements of one 4 MiB float32 bucket
GPT2_PARAMS = 124_439_808
PARTS = ("kernels", "path", "profile")
WARMUP, TIMED, PROFILED = 3, 5, 3


def parse_args(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--parts", default=",".join(PARTS))
    parser.add_argument("--worker", choices=("kernels", "profile"))
    args = parser.parse_args(argv)
    args.root = os.path.abspath(args.root)
    args.parts = [p for p in args.parts.split(",") if p]
    unknown = set(args.parts) - set(PARTS)
    if unknown:
        parser.error(f"unknown parts {sorted(unknown)}")
    return args


ARGS = parse_args(sys.argv[1:])
sys.path.insert(0, ARGS.root)


def timed(torch, dist, fn, flush, iters):
    """Mean ms of ``fn`` on this rank, L2 flushed and ranks aligned before
    each launch; events bracket only fn."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda.synchronize()
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def inputs(torch, dev, rank, n, world):
    """Rank ``rank``'s gather payload and scatter buffer, from its seed."""
    gen = torch.Generator(device=dev).manual_seed(rank)
    x = torch.randn(n // world, generator=gen, device=dev)
    return x, torch.randn(n, generator=gen, device=dev)


def ring_order_equal(torch, collectives, dev, rank, world, n, dtype):
    """K3b's tile on this rank equals the ring-order sum bit for bit (None
    when the tree has no ring-order helper)."""
    exact = getattr(collectives, "ring_reduce_scatter_ring_order", None)
    if exact is None:
        return None
    bufs = [inputs(torch, dev, r, n, world)[1].to(dtype) for r in range(world)]
    tile = collectives.ring_reduce_scatter(bufs[rank])
    want = exact(bufs)[rank]
    return bool(torch.equal(tile, want))


def gather_case(torch, dist, collectives, x):
    """(x, K3a's gather of x, NCCL's gather of x) on this rank."""
    want = torch.empty(dist.get_world_size() * x.numel(), dtype=x.dtype,
                       device=x.device)
    dist.all_gather_into_tensor(want, x)
    return x, collectives.ring_all_gather(x), want


def kernels_worker() -> int:
    import torch
    import torch.distributed as dist

    from distributed_pytorch_example_tpu_torch.ops import collectives
    from distributed_pytorch_example_tpu_torch.runtime import distributed

    distributed.initialize(device="cuda")
    rank, world = distributed.process_index(), distributed.process_count()
    dev = torch.device("cuda", torch.cuda.current_device())
    ring = collectives.process_ring(dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    pad = 256 * world
    cases = (("bucket", BUCKET), ("gpt2", -(-GPT2_PARAMS // pad) * pad))
    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": torch.cuda.get_device_name(dev)}
    for label, n in cases:
        x, buf = inputs(torch, dev, rank, n, world)
        gathers = {"float32": gather_case(torch, dist, collectives, x)}
        if label == "gpt2":
            gathers["bfloat16"] = gather_case(torch, dist, collectives,
                                              x.to(torch.bfloat16))
        tile = collectives.ring_reduce_scatter(buf)
        ref = torch.empty(n // world, device=dev)
        dist.reduce_scatter_tensor(ref, buf)
        absum = buf.abs()
        dist.all_reduce(absum)
        tol = 2 * (world - 1) * 2.0 ** -24 * absum.chunk(world)[rank]
        torch.cuda.synchronize()
        ring.check()
        err = (tile - ref).abs()
        exact = {"float32": ring_order_equal(torch, collectives, dev, rank,
                                             world, n, torch.float32)}
        if label == "bucket":
            exact["bfloat16"] = ring_order_equal(
                torch, collectives, dev, rank, world, n, torch.bfloat16)
        torch.cuda.synchronize()
        ring.check()
        torch.cuda.empty_cache()
        iters = 5 if label == "gpt2" else 30
        ms = {}
        for name, (xg, _, wantg) in gathers.items():
            suffix = "" if name == "float32" else "_bf16"
            ms["k3a" + suffix] = timed(
                torch, dist, lambda: collectives.ring_all_gather(xg), flush,
                iters)
            ms["nccl_ag" + suffix] = timed(
                torch, dist, lambda: dist.all_gather_into_tensor(wantg, xg),
                flush, iters)
        ms["k3b"] = timed(torch, dist,
                          lambda: collectives.ring_reduce_scatter(buf),
                          flush, iters)
        ms["nccl_rs"] = timed(torch, dist,
                              lambda: dist.reduce_scatter_tensor(ref, buf),
                              flush, iters)
        ring.check()
        part = n // world * 4  # bytes of one rank's float32 part
        out[label] = {
            "elements": n,
            "k3a_equal": {name: bool(torch.equal(g, w))
                          for name, (_, g, w) in gathers.items()},
            "k3b_max_abs_err": err.max().item(),
            "k3b_within_bound": bool((err <= tol).all()),
            "k3b_ring_order_equal": exact,
            "ms": ms, "bound_ms": (world - 1) * part / NVLINK * 1e3,
        }
        if "bfloat16" in gathers:  # the gather moves half the bytes
            out[label]["bound_bf16_ms"] = out[label]["bound_ms"] / 2
        del x, buf, gathers, tile, ref, absum, tol, err
        torch.cuda.empty_cache()
    gathered = [None] * world
    dist.all_gather_object(gathered, out)
    if rank == 0:
        print("ring_nvlink " + json.dumps(gathered), flush=True)
    distributed.shutdown()
    ok = all(all(r[label]["k3a_equal"].values())
             and r[label]["k3b_within_bound"]
             and all(v is not False
                     for v in r[label]["k3b_ring_order_equal"].values())
             for r in gathered for label, _ in cases)
    return 0 if ok else 1


def device_ms(prof, *keys):
    """Device time (ms) of the kernels whose name holds one of ``keys``,
    and of every kernel (keys empty)."""
    total = 0.0
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        if getattr(evt, "is_user_annotation", False):
            continue
        if not keys or any(k in evt.key for k in keys):
            total += getattr(evt, "self_device_time_total", 0.0)
    return total / 1e3


def profile_worker() -> int:
    import torch
    import torch.distributed as dist

    import chip_smoke
    from distributed_pytorch_example_tpu_torch.runtime import distributed

    distributed.initialize(device="cuda")
    rank, world = distributed.process_index(), distributed.process_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": rank, "world": world}
    for run in chip_smoke.ZERO1_RUNS:
        out[run] = profile_run(torch, dist, chip_smoke, run, world)
        torch.cuda.empty_cache()
    gathered = [None] * world
    dist.all_gather_object(gathered, out)
    if rank == 0:
        print("ring_nvlink_profile " + json.dumps(gathered), flush=True)
    distributed.shutdown()
    return 0


def profile_run(torch, dist, chip_smoke, run, world):
    """One rank's numbers for ZeRO-1 run ``run`` of chip_smoke.py."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_pytorch_example_tpu_torch.data import (
        DeviceLoader,
        SyntheticTokenDataset,
    )
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_all_gather,
        ring_reduce_scatter,
    )
    from distributed_pytorch_example_tpu_torch.parallel import (
        WireConfig,
        data_parallel,
    )
    from distributed_pytorch_example_tpu_torch.parallel.wire import (
        DEFAULT_BUCKET_BYTES,
    )
    from distributed_pytorch_example_tpu_torch.train import (
        CausalLMTask,
        TrainState,
        build_train_step,
        make_optimizer,
    )

    cfg = chip_smoke.ZERO1_RUNS[run]
    model = GPT2(dtype=torch.bfloat16, logits_mode="hidden", device="cuda",
                 seed=0)
    part = data_parallel(world, dp_shard_opt_state=cfg["zero1"],
                         wire=WireConfig(compress=cfg["wire"],
                                         param_gather=cfg["param_gather"],
                                         bucket_bytes=DEFAULT_BUCKET_BYTES))
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        model.parameters(), "adam", 1e-3))
    step = build_train_step(CausalLMTask(), partitioner=part)
    steps = WARMUP + TIMED + PROFILED
    loader = DeviceLoader(SyntheticTokenDataset(
        steps * chip_smoke.TRAIN_BATCH, seq_len=chip_smoke.TRAIN_SEQ, seed=0),
        chip_smoke.TRAIN_BATCH, device="cuda", seed=0)
    batches = list(loader)
    for batch in batches[:WARMUP]:
        step(state, batch)
    torch.cuda.synchronize()
    events = []
    for batch in batches[WARMUP:WARMUP + TIMED]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    dist.barrier()
    launches = (ring_all_gather.launches, ring_reduce_scatter.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[WARMUP + TIMED:]:
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_ms(prof)
    kernels = {"k3a": device_ms(prof, "all_gather_kernel"),
               "k3b": device_ms(prof, "reduce_scatter_kernel"),
               "nccl": device_ms(prof, "nccl")}
    return {
        "rows": batches[0]["tokens"].shape[0],
        "step_ms_unprofiled": step_ms, "median_step_ms":
            step_ms[len(step_ms) // 2],
        "profiled_steps": PROFILED, "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall_ms,
        **{f"{k}_ms": v for k, v in kernels.items()},
        **{f"{k}_share": v / wall_ms for k, v in kernels.items()},
        "k3a_launches_per_step":
            (ring_all_gather.launches - launches[0]) / PROFILED,
        "k3b_launches_per_step":
            (ring_reduce_scatter.launches - launches[1]) / PROFILED,
    }


def spawn(world: int, worker: str, prefix: str) -> bool:
    """``world`` worker processes on this tree; prints rank 0's line."""
    import chip_smoke

    port = chip_smoke.free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "REPLICAS": str(world), "PROCESS_ID": str(rank),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--root", ARGS.root,
             "--worker", worker], cwd=ARGS.root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            print(f"ring_nvlink: {worker} rank {rank} exit {proc.returncode}:"
                  f"\n{log[-3000:]}", flush=True)
    line = [ln for ln in outs[0].splitlines() if ln.startswith(prefix + " ")]
    if line:
        print(line[-1], flush=True)
    return bool(line) and all(proc.returncode == 0 for proc in procs)


def main() -> int:
    import torch

    import chip_smoke

    world = torch.cuda.device_count()
    if world < 2:
        print(f"ring_nvlink: {world} card(s) visible; needs 2 or more",
              file=sys.stderr)
        return 2
    print(f"ring_nvlink: tree {ARGS.root}, parts {ARGS.parts}", flush=True)
    chip_smoke.probe(torch)
    chip_smoke.build()
    for worker, prefix in (("kernels", "ring_nvlink"),
                           ("profile", "ring_nvlink_profile")):
        if worker in ARGS.parts:
            t0 = time.perf_counter()
            if not spawn(world, worker, prefix):
                return 1
            print(f"ring_nvlink: {worker} in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    if "path" in ARGS.parts:
        losses, _, _, _, grads = chip_smoke.train_run(torch, use_flash=None)
        chip_smoke.zero1_path(torch, losses, grads, world=world)
    return 0


if __name__ == "__main__":
    if ARGS.worker == "kernels":
        sys.exit(kernels_worker())
    if ARGS.worker == "profile":
        sys.exit(profile_worker())
    sys.exit(main())
