#!/usr/bin/env python3
"""Where the port's training step spends its time on the card.

Trains GPT-2 124M (12 layers, width 768, vocab 50257) in bf16 with the
fused loss on synthetic tokens, batch 16 x 1024, as chip_smoke.py's train
phase does; or, with ``--model resnet50|vit-b16``, phase 11's vision
cells (bf16, 224 x 224, 1000 classes, batches of 128 and 64 synthetic
images): 3 warm-up steps, 5 steps timed with CUDA events and no
profiler, then 5 steps under ``torch.profiler`` with CPU and CUDA
activities. Prints one JSON line: the unprofiled step time and tokens/s
(images/s), the profiled wall time, device busy time (the sum of kernel
times; one stream, so kernels do not overlap), the device's idle share,
and device time by class — matmul (cuBLAS and cuDNN's convolutions), K1
forward, K1 backward, chunked cross-entropy, batchnorm, layernorm,
elementwise, optimizer — with the top kernel names.

A kernel's class comes from the op that launched it: kernels under the
chunked cross-entropy's forward or backward count as "chunked CE", those
under the port's BatchNorm function (forward or backward) as
"batchnorm", those under ``Optimizer.step`` as "optimizer", the flash
kernels by name, and the rest by kernel name.

    python3 scripts/profile_torch_train.py [--model gpt2|resnet50|vit-b16]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH, SEQ, WARMUP, TIMED, PROFILED = 16, 1024, 3, 5, 5
VISION_BATCH, VISION_SIZE = {"resnet50": 128, "vit-b16": 64}, 224


def name_class(name: str) -> str:
    low = name.lower()
    # csrc/flash_attention.cu names every K1 kernel flash_<part>_<dtype>_kernel
    if "flash_fwd_" in low:
        return "K1 forward"
    if any(key in low for key in ("flash_dq_", "flash_dkv_", "flash_delta_")):
        return "K1 backward"
    # cuBLAS's Hopper GEMMs are named nvjet_*
    if any(key in low for key in ("gemm", "cutlass", "matmul", "xmma",
                                  "nvjet", "conv", "cudnn")):
        return "matmul"
    if "norm" in low:
        return "layernorm"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "elementwise/other"


def scope_class(event) -> str:
    """The class the launching op's ancestry gives, or None."""
    while event is not None:
        name = event.name
        if "chunked_ce" in name or "_ChunkedXent" in name:
            return "chunked CE"
        if "_BatchNormFn" in name:
            return "batchnorm"
        if name.startswith("Optimizer.step") or "optimizer_step" in name:
            return "optimizer"
        event = event.cpu_parent
    return None


def workload(torch, name: str, n: int):
    """(model, task, batches, items per batch, description) of a cell."""
    from distributed_pytorch_example_tpu_torch.data import (
        DeviceLoader,
        SyntheticImageDataset,
        SyntheticTokenDataset,
    )
    from distributed_pytorch_example_tpu_torch.models import GPT2, get_model
    from distributed_pytorch_example_tpu_torch.train import (
        CausalLMTask,
        ClassificationTask,
    )

    if name == "gpt2":
        model = GPT2(dtype=torch.bfloat16, logits_mode="hidden",
                     device="cuda", seed=0)
        data = SyntheticTokenDataset(n * BATCH, seq_len=SEQ, seed=0)
        return (model, CausalLMTask(), DeviceLoader(
            data, BATCH, device="cuda", prefetch=0), BATCH * SEQ,
            f"GPT-2 124M bf16 fused loss, batch {BATCH} x {SEQ}")
    batch = VISION_BATCH[name]
    kw = dict(image_size=VISION_SIZE) if name.startswith("vit") else {}
    model = get_model(name, num_classes=1000, dtype=torch.bfloat16,
                      device="cuda", seed=0, **kw)
    data = SyntheticImageDataset(n * batch, image_size=VISION_SIZE,
                                 num_classes=1000, seed=0)
    return (model, ClassificationTask(), DeviceLoader(
        data, batch, device="cuda", prefetch=0), batch,
        f"{name} bf16, batch {batch} x {VISION_SIZE}^2, 1000 classes")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device is visible",
              file=sys.stderr)
        return 2
    from distributed_pytorch_example_tpu_torch.ops._build import build_all
    from distributed_pytorch_example_tpu_torch.train import (
        TrainState,
        build_train_step,
        make_optimizer,
    )
    from distributed_pytorch_example_tpu_torch.train import tasks

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", default="gpt2",
                        choices=("gpt2", "resnet50", "vit-b16"))
    args = parser.parse_args()

    build_all()
    fused = tasks.chunked_softmax_xent

    def scoped(*args, **kwargs):  # names the fused loss's forward kernels
        with record_function("chunked_ce"):
            return fused(*args, **kwargs)

    tasks.chunked_softmax_xent = scoped
    n = WARMUP + TIMED + PROFILED
    model, task, loader, items, config = workload(torch, args.model, n)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters()))
    step = build_train_step(task)
    batches = list(loader)
    for batch in batches[:WARMUP]:
        step(state, batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for batch in batches[WARMUP:WARMUP + TIMED]:
        step(state, batch)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / TIMED
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[WARMUP + TIMED:]:
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, by_class = {}, {}
    for evt in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        if getattr(evt, "is_user_annotation", False):
            continue  # a record_function range on the device timeline
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    scoped_ms = 0.0
    for evt in prof.events():
        kernels = getattr(evt, "kernels", None) or []
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        cls = scope_class(evt)
        for kernel in kernels:
            label = cls or name_class(kernel.name)
            by_class[label] = by_class.get(label, 0.0) + kernel.duration / 1e3
            scoped_ms += kernel.duration / 1e3
    attribution = "launching op"
    if scoped_ms < 0.5 * busy_ms:  # kernels not linked to their ops
        attribution = "kernel name only (chunked CE and optimizer not split)"
        by_class = {}
        for name, us in by_name.items():
            cls = name_class(name)
            by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi.splitlines()[0] if smi else None,
        "config": config,
        "step_ms_unprofiled": step_ms,
        ("tokens_per_sec_unprofiled" if args.model == "gpt2"
         else "images_per_sec_unprofiled"): items / step_ms * 1e3,
        "profiled_steps": PROFILED,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "attribution": attribution,
        "device_ms_by_class": dict(sorted(by_class.items(),
                                          key=lambda kv: -kv[1])),
        "top_kernels_ms": {name[:90]: us / 1e3 for name, us in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
