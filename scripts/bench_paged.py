#!/usr/bin/env python3
"""Time the paged-decode kernel (K2) of one source tree on the card.

Imports the port package from ``--root`` (a checkout, or a ``git archive``
copy of another commit), builds its kernels there, and times K2 with
``chip_smoke.time_paged`` (plain, kernel, kernel, plain, then SDPA on
pre-gathered KV; L2 flushed before every launch) at the serving geometry
(fp32, 12 heads, head_dim 64, blocks of 16, 64 per row, pool 513) and
four row mixes:

- ``mixed``: ``chip_smoke.KERNEL_LENS``, rows of 1 to 1,024 keys
  (``chip_smoke.py`` phase 3's timing case);
- ``long``: 8 rows, all at position 1023;
- ``single``: one row at position 1023;
- ``serving``: the first 8 requests of ``chip_smoke.py`` phase 4's
  workload halfway through their decode (positions 32-320).

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per mix with the times (ms), the kernel's time when the flush leaves the
L2 clean (``clean_ms``: ``time_cold`` flushes by writing 256 MB, whose
dirty lines the timed loads must write back), each of the tree's kernels'
own device time and the span of a call from the first kernel's start to
the last one's end (us, ``torch.profiler``, median of 20 calls with the L2
flushed), the host's time to issue one call (us, no synchronisation), the
kernel's max error against its plain version, and the bound. To compare two commits on one card, run it for each tree in
one command, in turns (parent, change, change, parent)::

    python3 scripts/bench_paged.py --root .archive_check/base
    python3 scripts/bench_paged.py --root .

``--ptxas`` also prints each kernel's registers, shared memory and spills
from ``nvcc -Xptxas -v``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report_ptxas(_build) -> None:
    """``nvcc -Xptxas -v``'s register, shared-memory and spill lines for
    every kernel of ``csrc/paged_decode.cu``, one line per kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        log = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"),
             str(_build.CSRC_DIR / "paged_decode.cu")],
            capture_output=True, text=True, timeout=600,
        )
    entry, info = None, {}
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "spill" in line:
            info.setdefault(entry, []).append(line.strip())
        elif entry and "registers" in line:
            info.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    names = list(info)
    demangle = subprocess.run(["c++filt"], input="\n".join(names),
                              capture_output=True, text=True)
    if demangle.returncode == 0:
        names = demangle.stdout.splitlines()
    for name, lines in zip(names, info.values()):
        print(f"ptxas {name}: {'; '.join(lines)}", flush=True)


def host_us(torch, fn, calls=200) -> float:
    """Mean host time (us) to issue one call, without synchronising."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def device_us(torch, fn, calls=20):
    """Median device time (us) of each K2 kernel that ``fn`` launches, and
    of the span from a call's first kernel start to its last kernel end,
    over ``calls`` calls with the L2 flushed (written) before each."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    names = ("paged_decode_split_kernel", "paged_decode_combine_kernel",
             "paged_decode_kernel")
    spans = sorted((e.time_range.start, e.time_range.end, name)
                   for e in prof.events() for name in names
                   if name in e.name)
    per_call = len(spans) // calls
    if per_call == 0 or len(spans) != per_call * calls:
        raise RuntimeError(f"bench_paged: {len(spans)} K2 kernels traced "
                           f"over {calls} calls")
    out = {}
    for _, _, name in spans[:per_call]:
        out[name] = statistics.median(
            b - a for a, b, n in spans if n == name)
    out["span"] = statistics.median(
        spans[i + per_call - 1][1] - spans[i][0]
        for i in range(0, len(spans), per_call))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO,
                        help="tree whose distributed_pytorch_example_tpu_torch "
                             "is timed (default: this checkout)")
    parser.add_argument("--ptxas", action="store_true",
                        help="also print nvcc -Xptxas -v's registers, shared "
                             "memory and spills for each kernel")
    args = parser.parse_args()
    root = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        print("bench_paged: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke  # this checkout's cases, timer and bounds, every tree

    sys.path.insert(0, root)
    from distributed_pytorch_example_tpu_torch.ops import _build
    from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
        paged_attention_reference,
        paged_flash_decode,
    )
    from distributed_pytorch_example_tpu_torch.serving import Request

    if not os.path.samefile(os.path.dirname(_build.PACKAGE_DIR), root):
        print(f"bench_paged: imported the port from {_build.PACKAGE_DIR}, "
              f"not from {root}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    bandwidth = next((bw for key, bw in chip_smoke._BANDWIDTH if key in smi),
                     3.35e12)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["paged_decode"])
    if args.ptxas:
        report_ptxas(_build)
    serving = tuple(len(r.prompt) + r.max_new_tokens // 2
                    for r in chip_smoke.workload(Request)[:chip_smoke.SLOTS])
    mixes = {**chip_smoke.PAGED_TIMING, "serving": serving}
    for name, lens in mixes.items():
        q, pk, pv, table, lens_t = chip_smoke.kernel_case(
            torch, seed=0, batch=len(lens), heads=chip_smoke.HEADS,
            kv_heads=chip_smoke.HEADS, head_dim=chip_smoke.HEAD_DIM,
            block_size=chip_smoke.BLOCK_SIZE,
            max_blocks=chip_smoke.MAX_BLOCKS,
            num_blocks=chip_smoke.NUM_BLOCKS, lens=lens, dtype=torch.float32,
        )
        got = paged_flash_decode(q, pk, pv, table, lens_t)
        ref = paged_attention_reference(q[:, None], pk, pv, table,
                                        lens_t[:, None])[:, 0]
        err = (got - ref).abs().max().item()
        def kernel():
            return paged_flash_decode(q, pk, pv, table, lens_t)

        issue_us = host_us(torch, kernel)
        ms = chip_smoke.time_paged(torch, bandwidth, name, lens)
        clean_ms = chip_smoke.time_cold(torch, kernel, clean=True)
        print(json.dumps({"root": args.root, "mix": name, "lens": list(lens),
                          "ms": ms, "clean_ms": clean_ms,
                          "device_us": device_us(torch, kernel),
                          "host_us": issue_us, "max_abs_err": err}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
