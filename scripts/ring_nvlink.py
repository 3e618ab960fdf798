#!/usr/bin/env python3
"""The ring collectives (K3) across cards, against NCCL.

One process per visible card (two at least), joined with nccl through the
environment contract (``REPLICAS``, ``PROCESS_ID``, ``MASTER_ADDR``,
``MASTER_PORT``). Each process opens its neighbours' ring workspaces with
CUDA IPC, so the kernels' stores cross NVLink. Two parts:

1. kernels: K3a and K3b at the ZeRO-1 path's shapes (one 4 MiB float32
   gradient bucket, and the GPT-2 124M gradient padded to 256 x world),
   held against NCCL's ``all_gather_into_tensor`` (exactly: a gather
   moves bytes) and ``reduce_scatter_tensor`` (float32 sums in another
   order: within 2 (D-1) 2^-24 sum|x| elementwise), then timed cold (L2
   flushed, ranks aligned by a barrier before each launch) beside NCCL
   and the NVLink bound: each rank takes in (D-1) parts of the payload,
   at 450 GB/s each way. One JSON line, ``ring_nvlink {...}``;
2. path: chip_smoke.py's ZeRO-1 phase at world = the card count, one
   process per card over nccl, held against the one-process replicated
   run (chip_smoke.py's train phase) on card 0.

    python3 scripts/ring_nvlink.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NVLINK = 450e9  # bytes/s each way per H100 SXM card (NVIDIA data sheet)
BUCKET = 1 << 20  # elements of one 4 MiB float32 bucket
GPT2_PARAMS = 124_439_808


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


def worker() -> int:
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
        gen = torch.Generator(device=dev).manual_seed(rank)
        x = torch.randn(n // world, generator=gen, device=dev)
        buf = torch.randn(n, generator=gen, device=dev)
        got = collectives.ring_all_gather(x)
        want = torch.empty(n, device=dev)
        dist.all_gather_into_tensor(want, x)
        tile = collectives.ring_reduce_scatter(buf)
        ref = torch.empty(n // world, device=dev)
        dist.reduce_scatter_tensor(ref, buf)
        absum = buf.abs()
        dist.all_reduce(absum)
        tol = 2 * (world - 1) * 2.0 ** -24 * absum.chunk(world)[rank]
        torch.cuda.synchronize()
        ring.check()
        err = (tile - ref).abs()
        iters = 5 if label == "gpt2" else 30
        ms = {
            "k3a": timed(torch, dist, lambda: collectives.ring_all_gather(x),
                         flush, iters),
            "nccl_ag": timed(torch, dist,
                             lambda: dist.all_gather_into_tensor(want, x),
                             flush, iters),
            "k3b": timed(torch, dist,
                         lambda: collectives.ring_reduce_scatter(buf),
                         flush, iters),
            "nccl_rs": timed(torch, dist,
                             lambda: dist.reduce_scatter_tensor(ref, buf),
                             flush, iters),
        }
        ring.check()
        part = n // world * 4  # bytes of one rank's part
        out[label] = {
            "elements": n, "k3a_equal": bool(torch.equal(got, want)),
            "k3b_max_abs_err": err.max().item(),
            "k3b_within_bound": bool((err <= tol).all()),
            "ms": ms, "bound_ms": (world - 1) * part / NVLINK * 1e3,
        }
    gathered = [None] * world
    dist.all_gather_object(gathered, out)
    if rank == 0:
        print("ring_nvlink " + json.dumps(gathered), flush=True)
    distributed.shutdown()
    ok = all(r[label]["k3a_equal"] and r[label]["k3b_within_bound"]
             for r in gathered for label, _ in cases)
    return 0 if ok else 1


def kernels(world: int) -> bool:
    import chip_smoke

    port = chip_smoke.free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "REPLICAS": str(world), "PROCESS_ID": str(rank),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
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
            print(f"ring_nvlink: rank {rank} exit {proc.returncode}:\n"
                  f"{log[-3000:]}", flush=True)
    line = [ln for ln in outs[0].splitlines() if ln.startswith("ring_nvlink ")]
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
    chip_smoke.probe(torch)
    chip_smoke.build()
    t0 = time.perf_counter()
    if not kernels(world):
        return 1
    print(f"ring_nvlink: kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)
    losses, _, _, _, grads = chip_smoke.train_run(torch, use_flash=None)
    chip_smoke.zero1_path(torch, losses, grads, world=world)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker())
    sys.exit(main())
