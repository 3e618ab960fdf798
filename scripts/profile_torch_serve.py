#!/usr/bin/env python3
"""Where the port's serving path spends its time on the card.

Serves chip_smoke.py's main-path workload (GPT-2 124M at full width, fp32,
8 slots, pool 513 x 16 tokens, 16 requests at rate 0, greedy) through
``InferenceEngine.run`` once to warm up, then once under
``torch.profiler`` with CPU and CUDA activities. Prints one JSON line:
wall time of the profiled run, device busy time (the sum of kernel times;
one stream, so kernels do not overlap), the device's idle share, and
device time by kernel class and by the top kernel names, and the host
ops with the most self time.

    python3 scripts/profile_torch_serve.py
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def kernel_class(name: str) -> str:
    low = name.lower()
    if "paged_decode" in low:  # the K2 kernels of any version
        return "paged_decode (K2)"
    if "gemm" in low or "cutlass" in low or "matmul" in low:
        return "matmul"
    if "softmax" in low:
        return "softmax"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "index" in low or "gather" in low or "scatter" in low:
        return "index/gather"
    if "norm" in low:
        return "layernorm"
    return "elementwise/other"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device is visible",
              file=sys.stderr)
        return 2
    import chip_smoke
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
        paged_flash_decode,
    )
    from distributed_pytorch_example_tpu_torch.serving import (
        InferenceEngine,
        Request,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = GPT2(decode=True, paged_num_blocks=chip_smoke.NUM_BLOCKS,
                 paged_block_size=chip_smoke.BLOCK_SIZE,
                 paged_max_blocks=chip_smoke.MAX_BLOCKS, device="cuda", seed=0)
    engine = InferenceEngine(model, num_slots=chip_smoke.SLOTS, device="cuda")
    engine.run(chip_smoke.workload(Request))  # warm: build, cuBLAS, caches
    torch.cuda.synchronize()
    paged_flash_decode.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = engine.run(chip_smoke.workload(Request))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev_us
    busy_ms = sum(by_name.values()) / 1e3
    by_class = {}
    for name, us in by_name.items():
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    cpu_top = sorted(
        ((evt.key, evt.self_cpu_time_total / 1e3, evt.count)
         for evt in prof.key_averages()),
        key=lambda t: -t[1],
    )[:10]
    m = report["metrics"]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "decode_steps": m["decode_steps"],
        "generated_tokens": m["generated_tokens"],
        "tokens_per_sec": m["tokens_per_sec"],
        "k2_launches": paged_flash_decode.launches,
        "device_ms_by_class": dict(sorted(by_class.items(),
                                          key=lambda kv: -kv[1])),
        "top_kernels_ms": {name[:80]: us / 1e3 for name, us in top},
        "top_host_ops_self_ms_calls": {
            name[:60]: [ms, calls] for name, ms, calls in cpu_top
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
