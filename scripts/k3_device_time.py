#!/usr/bin/env python3
"""K3 with in-process ranks on one card: the kernels' own device time.

``chip_smoke.py`` phase 3 times K3a and K3b with R in-process ranks, each
on its own CUDA stream, with CUDA events around all R launches. That
window holds the host's R launches too: the first rank's kernel starts
and waits for the last one's. This script runs the same calls (R = 2, 4
and 8; float32 at phase 3's sizes: a 4 MiB payload per rank, and the
GPT-2 124M gradient, gathered from R parts or reduce-scattered from a
whole one per rank) and prints, per kernel, size and R, beside the event
time:

- ``kernel_us``: each kernel's device duration from ``torch.profiler``
  over 20 calls (5 at the GPT-2 size; L2 flushed before each), least /
  median / most. The least is a kernel whose peers were already running
  when it started: the nearest to the kernel's own time;
- ``span_us``: per call, from the first rank's kernel start to the last
  one's end (median).

``--root DIR`` imports the port from another tree (a ``git archive`` of
another commit) and builds its kernels there, so that two trees can be
compared in one call, in turns. ``--ptxas`` also prints ``nvcc -Xptxas
-v``'s registers, stack and spills for every kernel of
``csrc/ring_collectives.cu``.

    python3 scripts/k3_device_time.py [--root DIR] [--ptxas]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def print_ptxas(_build) -> None:
    """One line per kernel: its registers, stack and spills."""
    with tempfile.TemporaryDirectory() as tmp:
        log = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"),
             str(_build.CSRC_DIR / "ring_collectives.cu")],
            capture_output=True, text=True, timeout=600,
        )
    entry = None
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            print(f"ptxas {entry}: {line.split(':')[-1].strip()}",
                  flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO,
                        help="tree whose distributed_pytorch_example_tpu_torch "
                             "is timed (default: this checkout)")
    parser.add_argument("--ptxas", action="store_true")
    args = parser.parse_args()
    root = os.path.abspath(args.root)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("k3_device_time: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke  # this checkout's timer and inputs, for every tree

    sys.path.insert(0, root)
    from distributed_pytorch_example_tpu_torch.ops import _build
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        PeerRing,
        ring_all_gather,
        ring_reduce_scatter,
    )

    if not os.path.samefile(os.path.dirname(_build.PACKAGE_DIR), root):
        print(f"k3_device_time: imported the port from {_build.PACKAGE_DIR}, "
              f"not from {root}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all(["ring_collectives"])
    if args.ptxas:
        print_ptxas(_build)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {"root": args.root}
    for world in chip_smoke.RING_WORLDS:
        rings = PeerRing.local_group(world, "cuda")
        streams = [torch.cuda.Stream() for _ in range(world)]
        pad = 256 * world
        gpt2 = -(-chip_smoke.GPT2_PARAMS // pad) * pad
        for name, fn, size, n, calls in (
                ("k3a", ring_all_gather, "bucket", chip_smoke.BUCKET_ELEMS,
                 20),
                ("k3b", ring_reduce_scatter, "bucket",
                 chip_smoke.BUCKET_ELEMS, 20),
                ("k3a", ring_all_gather, "gpt2", gpt2 // world, 5),
                ("k3b", ring_reduce_scatter, "gpt2", gpt2, 5)):
            xs = chip_smoke.ring_inputs(torch, world, n, torch.float32,
                                        seed=world)

            def run():
                return chip_smoke.ring_run(torch, fn, rings, xs, streams)

            event_ms = chip_smoke.time_cold(torch, run, iters=calls)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    flush.zero_()
                    run()
                torch.cuda.synchronize()
            for ring in rings:
                ring.check()
            spans = sorted(
                (e.time_range.start, e.time_range.end) for e in prof.events()
                if "gather_kernel" in e.name or "scatter_kernel" in e.name)
            if len(spans) != calls * world:
                print(f"k3_device_time: {len(spans)} kernels traced, want "
                      f"{calls * world}", file=sys.stderr)
                return 1
            durations = [b - a for a, b in spans]
            groups = [spans[i:i + world] for i in range(0, len(spans), world)]
            out[f"{name}_{size}_R{world}"] = {
                "elements_per_rank": n, "event_ms": event_ms,
                "kernel_us": [min(durations), statistics.median(durations),
                              max(durations)],
                "span_us": statistics.median(
                    max(b for _, b in g) - min(a for a, _ in g)
                    for g in groups),
            }
            del xs
        torch.cuda.synchronize()
        for ring in rings:
            ring.close()
    print("k3_device_time " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
