#!/usr/bin/env python3
"""Peak device memory of GPT-2 124M's first three train steps, with and
without the telemetry cost record's counting on the first step.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/step_peak_memory.py

Each row builds a fresh GPT-2 124M (bf16 compute, fused loss, Adam 1e-3,
16 x 1024 synthetic tokens) and prints the peak of each step
(``max_memory_allocated`` after a reset before it) and the bytes
allocated when step 1 began: ``plain``; the first step under
``torch.utils.flop_counter.FlopCounterMode``; under the attention
formula's count (``ops.attention.count_flops``); under both, as
``telemetry.CostRegistry.measure`` runs it; ``plain`` again. The card's
name and power limit come first.
"""

from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_pytorch_example_tpu_torch.data import (
        SyntheticTokenDataset,
    )
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.ops import attention
    from distributed_pytorch_example_tpu_torch.train import (
        CausalLMTask,
        TrainState,
        build_train_step,
        make_optimizer,
    )

    if not torch.cuda.is_available():
        print("step_peak_memory: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    tokens = torch.from_numpy(SyntheticTokenDataset(
        48, seq_len=1024, seed=0).arrays["tokens"]).long().reshape(
            3, 16, 1024)

    @contextlib.contextmanager
    def both():
        with FlopCounterMode(display=False), attention.count_flops():
            yield

    rows = (("plain", contextlib.nullcontext),
            ("flopcounter", lambda: FlopCounterMode(display=False)),
            ("attention-count", attention.count_flops),
            ("both", both), ("plain-again", contextlib.nullcontext))
    for name, first in rows:
        model = GPT2(dtype=torch.bfloat16, logits_mode="hidden",
                     device="cuda", seed=0)
        state = TrainState(step=0, model=model, optimizer=make_optimizer(
            model.parameters(), "adam", 1e-3))
        step = build_train_step(CausalLMTask())
        peaks, base = [], None
        for i in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if base is None:
                base = torch.cuda.memory_allocated()
            with first() if i == 0 else contextlib.nullcontext():
                step(state, {"tokens": tokens[i].cuda()})
            torch.cuda.synchronize()
            peaks.append(round(torch.cuda.max_memory_allocated() / 2**30, 3))
        print(f"step_peak_memory {name}: peaks GiB {peaks}, allocated at "
              f"step 1 {base / 2**30:.3f} GiB", flush=True)
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
