#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:

1. probe  — nvidia-smi name and power limit, torch / CUDA / nvcc / Triton
   versions, device count, and both TF32 flags (set to False here, so
   float32 matmuls and convolutions run in full float32);
2. build  — compile every CUDA kernel in the port's ``csrc/`` with nvcc;
3. kernel — hold each kernel against its plain PyTorch version on the
   card at the main paths' shapes, then time kernel, plain version and one
   library call, beside the least time the card could take (the bound):
   the paged-decode kernel (K2; also against its split arithmetic, and
   timed at three row mixes: the kernel cases' lengths, every slot at the
   full table, one row alone), the flash-attention forward and backward
   (K1), then the all-gather and reduce-scatter pushes (K3a, K3b) with 2,
   4 and 8 in-process ranks, each on its own CUDA stream, at one 4 MiB
   gradient bucket and at the whole GPT-2 124M gradient (K3b also bit for
   bit against the plain sum in the TPU ring's order). K1 is also held and
   timed at BERT-base's shape (16 x 12 x 512 x 64, bf16, non-causal) with
   a key mask of padded tails and an all-pad row, and unmasked, beside
   SDPA with the same boolean mask (its backend named) and unmasked: the
   ``bert`` field of the K1 entries;
4. serve  — GPT-2 124M at full width (random weights from a seed) through
   ``InferenceEngine.run``: 16 requests greedy, then at temperature 1.0 with
   top-k 50; checks every request completes, the paged-decode kernel ran
   once per layer per decode step, and the paged logits and greedy tokens
   agree with the port's plain full-sequence forward;
5. cli    — ``python -m distributed_pytorch_example_tpu_torch.serve``
   at its defaults; its JSON line must parse;
6. train  — GPT-2 124M at full width and depth, bf16, fused loss, batch 16
   x 1024 tokens, through ``Trainer.fit`` on synthetic tokens: 10 steps and
   one validation batch. Checks every loss is finite, the flash forward ran
   12 x (steps + validation batches) times and its backward 12 x steps,
   and the same run with plain attention follows the same loss trajectory
   and takes the same first-step gradients, leaf by leaf; prints step ms,
   tokens/s and peak memory;
7. train cli — ``python -m distributed_pytorch_example_tpu_torch.train``
   for GPT-2 (bf16, 16 x 1024, 4 steps), at its defaults (SimpleNet, one
   epoch) and for ResNet-18 on 32 x 32 synthetic images with the CIFAR
   augmentation; each must log "Training completed";
8. zero1  — the same GPT-2 training at world 2: two processes on the card
   (``REPLICAS``, ``PROCESS_ID``, ``MASTER_ADDR``, ``MASTER_PORT``; gloo,
   with the gradient buckets carried by K3 through CUDA IPC memory), 8 rows
   each, 4 steps through ``Trainer.fit``: (i) ZeRO-1 with the bucketed sync
   (K3b on every eligible scatter bucket), held against phase 6's first
   steps (losses, and the first step's gradients leaf by leaf); (ii) with
   int8-block gradients and a bf16 parameter gather (K3a), held against
   (i). Each rank's K3a and K3b launch counts must be above 0. Run (i)
   also saves its gathered checkpoint; the parent loads rank 0's file into
   a one-process model on the card, whose parameters must equal both
   ranks' own bit for bit (a SHA-256 over every parameter's bytes);
9. checkpoint — GPT-2 124M at full width and depth, bf16, fused loss,
   batch 16 x 1024, in a temporary directory deleted at the end: (a)
   ``Trainer.fit``, one epoch of 10 steps with ``save_every_steps=5`` and
   ``checkpoint_retain=2`` (tokens drawn from 256 ids, so validation
   accuracy rises above 0 and ``best`` is written); ``best`` and
   ``latest`` must exist, and ``latest`` loaded into a fresh model and
   optimizer on the card must equal the live run's parameters, moments
   and step count bit for bit; prints the calling thread's hold, the whole
   save, the load and the file's bytes; (b) a fresh run resumed from the
   step-5 entry of the history trail takes steps 6-10: K1 launches 12 x 5
   forward and backward, and its losses must be within 1e-5 of (a)'s
   (bit-equal is expected); (c) the training CLI is sent SIGTERM after
   its first "Batch" line: it must exit 143 leaving ``latest`` with
   ``batch_in_epoch``, and its ``--resume`` must log "Resuming epoch 0 at
   batch k" and "Training completed".
10. bert — BERT-base masked LM at full width and depth (vocab 30522,
   512 tokens, 12 layers of 768), bf16, fused loss with ``mlm_bias``,
   Adam, batch 16 x 512 synthetic tokens through ``Trainer.fit``: 10 steps
   and one validation batch. Checks every loss is finite, K1's forward ran
   12 x (steps + validation batches) times and its backward 12 x steps,
   the same run with plain attention (same seed, so the same masks)
   follows the same losses at phase 6's tolerance, and the first step's
   gradients are held to a float32 plain-attention step leaf by leaf
   (phase 6's GRAD_TOL, or twice plain bf16 attention's own gap where
   BERT's rank collapse makes that larger: ``BERT_GRAD_SLACK``); with ``pad_token_id=0`` on batches with padded tails every
   K1 launch carries the key mask, the same number of them, and the losses
   follow plain attention's; then the CLI with ``--optimizer lamb`` (4
   steps) must log "Training completed". Prints step ms, tokens/s and peak
   memory beside the card's name and power limit.
11. vision — (a) ResNet-50 and (b) ViT-B/16 at full width and depth
   (224 x 224, 1000 classes), bf16 compute with float32 parameters, Adam
   at lr 1e-3, batches of 128 and 64 synthetic images through
   ``Trainer.fit``: 10 steps and one validation batch each. Checks every
   loss is finite, no K1 launch (ViT's 197 tokens take the plain path, as
   in JAX), and ResNet's running statistics moved and are finite; prints
   step ms, images/s, peak memory, forward FLOPs per image from the conv
   and dense shapes and the bf16 dense peak's share, and whether
   ``cudnn.benchmark`` was on. (c) The first step's gradients against a
   float32 step on the card, per leaf (phase 10's bound, with autocast as
   the second bf16 rounding), and the
   float32 model's eval logits on the card against the CPU's
   (``VISION_FWD_TOL``). (d) The space-to-depth stem equals the plain
   stem on the card. (e) A NaN pixel: the skipped step leaves running
   statistics, parameters and moments bit-equal and reports bad_step 1.
   (f) The CLI on ResNet-18 at 32 x 32 logs "Training completed". Then,
   with no check, one ViT-B/16 attention layer timed through the plain
   path, K1's lane-padded path and SDPA.
12. llama — LLaMA at the JAX package's defaults (12 layers of 768, 12
   query heads over 4 kv heads, RoPE, RMSNorm, SwiGLU MLP 2048, vocab
   32000), random weights from seed 0: (a) K1 at its GQA shape (16 x
   1024 and 8 x 2048, bf16, causal) forward and backward against the
   plain versions, timed beside the bound and SDPA with ``enable_gqa``;
   (b) bf16 training through ``Trainer.fit`` as in phase 6 (K1 12 x 11
   forward, 12 x 10 backward), against plain attention's losses, and its
   first-step gradients against a float32 step by phase 10's bound; (c)
   the same model with ``remat`` for 3 steps: the same losses, less peak
   memory; (d) the CLI with ``--optimizer adafactor --remat``, lamb
   under ZeRO-1 at world 2 (phase 8's two processes, LLaMA's width at
   depth 2) against lamb on whole leaves fed the same synced gradients
   and against the one-process run, and a BERT-tiny MLM step with
   dropout 0.1 with and without remat (the same gradients); (e) K2 at
   its decode shape (8 x 12 over 4 kv heads, 128 blocks of 16, RoPE'd
   keys) against its plain version and timed, then LLaMA served in
   float32 (pool 513 x 16, 8 slots, 16 requests, greedy and top-k 50),
   K2 once per layer per decode step, greedy tokens and paged logits
   against the plain forward. The ``llama`` fields of the K1 and K2
   entries carry these shapes' numbers.
13. launch — GPT-2 124M through the training CLI at world 2, two ranks on
   the card started by the port's ``launch/entrypoint.sh`` (``REPLICAS=2``,
   explicit ``PROCESS_ID`` and ``COORDINATOR_ADDRESS``, a dummy
   ``NF_DISCOVERY_SERVICE``; gloo, ZeRO-1 with K3b gradient buckets and
   K3a bf16 parameter gathers, K1), 8 rows a rank, one epoch of 8 steps,
   ``latest`` every 2 steps in ``auto``'s format (sharded at world 2):
   first uninterrupted, then (a) with ``MAX_RESTARTS=1`` and a chaos plan
   in ``DPX_CHAOS`` that SIGKILLs both ranks after step 7: both launchers
   restart their rank, which resumes from the pointer's version, and every
   step's loss must be within 1e-5 of the uninterrupted run's; prints the
   versions on disk and each rank's shard file bytes. (b) The
   uninterrupted run's final state, saved sharded and gathered at world 2,
   loaded in one process (the world a shrink leaves): bit-equal to each
   other and to the world-2 parameters, then its next epoch through
   ``Trainer.fit`` (K1 12 x 8 forward and backward). (c) The calling
   thread's hold of 3 sharded and 3 gathered saves of that state at world
   2, per rank, beside the card's name and power limit. The ``launch``
   fields of the K1 and K3 entries carry rank 0's launches after the
   restart.
14. decode — speculative decoding (self-speculation, K = 4: the draft is
   a second decode module over the target's own weight tensors and a
   pool of its own) and ``generate()`` over the contiguous KV cache:
   (a) GPT-2 124M in float32 on phase 4's workload, greedy: every request
   completes, every token within phase 4's 1e-3 logit gap of the plain
   forward's argmax, fewer decode boundaries than phase 4's greedy run,
   K2 launched K times per layer at every boundary (the draft's one-token
   steps; the verify chunk takes the plain version), each stream phase
   4's or parted from it at a near-tie; (b) the same at temperature 1.0
   and top-k 50 against phase 4's sampled streams (a parting must be a
   near-tie of the two choices' Gumbel scores under the plain forward);
   (c) LLaMA 125M greedy against the plain forward as phase 12 holds it;
   (d) ``generate()`` on GPT-2 124M, 8 workload prompts x 64 greedy
   tokens, against the plain forward and phase 4's greedy streams, no K2
   launch. Prints tokens/s, TPOT p50/p99, the accept rate and a
   boundary's draft and verify ms beside phase 4's runs, generate()'s ms
   a token, and the phase's time. The ``decode`` field of the K2 entry
   carries its launches in (a)-(c).

15. telemetry — graft-scope on GPT-2 124M through ``Trainer.fit``
   (records every 2 steps, the FLOP count against the analytic one), the
   CLI with the profiler, phase 8's runs under ``measure_overlap`` and
   adafactor under ZeRO-1 at world 2 (:func:`telemetry`).
16. fsdp — GPT-2 124M at full width and depth, bf16, in phase 8's two
   processes sharing the card, 8 rows each, 4 steps and one validation
   batch through ``Trainer.fit``: first replicated, then under
   ``fsdp(make_mesh(MeshSpec(data=1, fsdp=2)))`` (``--partition fsdp
   --mesh-fsdp 2``: tiles between steps, K3a parameter gathers, K3b
   bucketed gradient scatters, K1). The FSDP losses are held to the
   replicated run's (``FSDP_LOSS_TOL``) and to phase 8 (i)'s
   (``LOSS_TOL``); each rank's K1 launches must be 12 x 5 / 12 x 4 and
   its K3a and K3b launches above 0; each run's ``hbm_peak_bytes`` must
   lie within ``HBM_MARGIN`` of its steps 2+ peak. It prints each rank's
   step median and range, ``hbm_peak_bytes`` under FSDP against the
   replicated run, and the card's name and power limit; the FSDP run's
   sharded checkpoint, loaded in one process on the card, must hold the
   parameters the ranks gathered, bit for bit. The ``fsdp`` fields of the
   K1 and K3 entries carry rank 0's launches.
17. tp — GPT-2 124M at full width and depth, bf16, in phase 8's two
   processes sharing the card under ``--partition tp --mesh-tensor 2``
   (``transformer_partitioner(make_mesh(MeshSpec(data=1, tensor=2)))``):
   both ranks take the same 8 rows, 4 steps and one validation batch
   through ``Trainer.fit``, each rank holding its 6 of the 12 heads and
   half of every MLP; then LLaMA 125M at full width, depth
   ``LLAMA_TP_LAYERS``, 2 steps (its vocab-parallel embedding, head and
   loss). Each is held to a one-process replicated run of the same rows
   (``TP_LOSS_TOL``); each rank's K1 launches must be 12 x 5 / 12 x 4 at
   6 heads, its tensor group's all-reduces 2 a layer in each forward and
   each backward (LLaMA: 2 more forward, 1 more backward), and its
   ``hbm_peak_bytes`` below the replicated run's. It prints the ranks'
   step ms, ``hbm_peak_bytes`` and float32 state bytes against the
   replicated run's, and the card's name and power limit; the TP run's
   sharded checkpoint, loaded in one process on the card, must hold the
   parameters the ranks gathered, bit for bit. The ``tp`` fields of the
   K1 entries carry rank 0's GPT-2 launches.

Each main path (serve, train, zero1, checkpoint, bert, vision, llama's
train and serve, launch's world-1 epoch, decode's runs, fsdp's and tp's)
runs with every launch count set to 0 just before it and read just after;
launch's, fsdp's and tp's ranks count in their own processes, from 0.

The line before the last is a JSON object listing every ported kernel with
its numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# HBM bandwidth (bytes/s) by the card's reported name (NVIDIA data sheets);
# float32 peak outside the tensor cores (FLOP/s) for the H100 SXM part.
_BANDWIDTH = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
              ("H100", 3.35e12))
_F32_PEAK = 67e12
_BF16_PEAK = 989e12  # dense tensor-core rate, H100 SXM

SLOTS, HEADS, HEAD_DIM, LAYERS = 8, 12, 64, 12
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 16, 1024
# BERT-base MLM (phase 10; K1's masked, non-causal case in phase 3): the
# JAX package's defaults and its CLI's vocabulary and [MASK] id
BERT_SEQ, BERT_VOCAB, BERT_MASK_ID = 512, 30522, 103
# the key mask of phase 3's BERT case, one length per batch row: padded
# tails of every kind against the kernels' 128-key tiles (a full row, one
# key short, on and around tile edges, one key) and an all-pad row last
BERT_LENS = (512, 511, 509, 500, 448, 385, 384, 383, 257, 256, 200, 129,
             128, 64, 1, 0)
BLOCK_SIZE, MAX_BLOCKS, NUM_BLOCKS = 16, 64, 513
# row lengths straddling block edges: first/last position of a block,
# one-block rows, a full table
KERNEL_LENS = (0, 15, 16, 17, 255, 256, 511, 1023)
# K2's timing cases: the kernel cases' lens, every slot at the full table,
# one row alone at the full table
PAGED_TIMING = {"mixed": KERNEL_LENS, "long": (1023,) * SLOTS,
                "single": (1023,)}


def say(phase: str, msg: str) -> None:
    print(f"chip_smoke[{phase}]: {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# 1. probe
# ---------------------------------------------------------------------------


def probe(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)  # the card's name and power limit, verbatim
    from distributed_pytorch_example_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    nvcc_version = "missing"
    if nvcc:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        nvcc_version = out.strip().splitlines()[-1]
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "missing"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("probe", json.dumps({
        "nvidia_smi": smi_line,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": nvcc_version, "triton": triton_version,
        "device_count": torch.cuda.device_count(),
        "device_name": torch.cuda.get_device_name(0),
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
    }))
    bandwidth = next(
        (bw for key, bw in _BANDWIDTH if key in smi_line), None
    )
    if bandwidth is None:
        bandwidth = 3.35e12
        say("probe", f"unknown card {smi_line!r}: bound uses H100 SXM's "
                     "3.35 TB/s")
    return smi_line, bandwidth


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def build():
    from distributed_pytorch_example_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    say("build", f"built {built} from {_build.CSRC_DIR} in "
                 f"{time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# 3. kernel check + timing
# ---------------------------------------------------------------------------


def kernel_case(torch, *, batch, heads, kv_heads, head_dim, block_size,
                max_blocks, num_blocks, lens, dtype, seed):
    """Random pool + a permuted block table whose dead tails point at the
    scratch block 0, which is poisoned with 1e4."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(batch, heads, head_dim, generator=gen)
    shape = (num_blocks, block_size, kv_heads, head_dim)
    pk = torch.randn(shape, generator=gen)
    pv = torch.randn(shape, generator=gen)
    pk[0] = 1e4
    pv[0] = 1e4
    perm = torch.randperm(num_blocks - 1, generator=gen) + 1
    table = torch.zeros(batch, max_blocks, dtype=torch.int32)
    k = 0
    for b, pos in enumerate(lens):
        live = min(pos // block_size + 1, max_blocks)
        table[b, :live] = perm[k:k + live].to(torch.int32)
        k += live
    dev = "cuda"
    return (q.to(dev, dtype), pk.to(dev, dtype), pv.to(dev, dtype),
            table.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev))


def time_cold(torch, fn, iters=50, clean=False):
    """Mean ms of ``fn`` with the 50 MB L2 flushed before every launch (the
    serving path reads each layer's pool cold); events bracket only fn.
    The flush writes 256 MB, which leaves the L2 full of dirty lines that
    ``fn``'s loads must write back; with ``clean`` it reads them instead."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if clean:
            flush.max()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def check_kernels(torch, bandwidth):
    from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
        decode_splits,
        paged_attention_reference,
        paged_decode_split_reference,
        paged_flash_decode,
    )

    geometry = dict(batch=SLOTS, block_size=BLOCK_SIZE,
                    max_blocks=MAX_BLOCKS, num_blocks=NUM_BLOCKS,
                    lens=KERNEL_LENS)
    # (name, case kwargs, tolerance, why)
    cases = [
        ("fp32-mha", dict(heads=HEADS, kv_heads=HEADS, head_dim=HEAD_DIM,
                          dtype=torch.float32, **geometry), 2e-5,
         "float32 throughout; only the summation order differs"),
        ("bf16-mha", dict(heads=HEADS, kv_heads=HEADS, head_dim=HEAD_DIM,
                          dtype=torch.bfloat16, **geometry), 1e-2,
         "float32 math on bf16 inputs, output rounded to bf16 "
         "(half an ulp at |out| < 4 is 7.8e-3)"),
        ("fp32-gqa", dict(heads=HEADS, kv_heads=4, head_dim=HEAD_DIM,
                          dtype=torch.float32, **geometry), 2e-5,
         "float32 throughout; only the summation order differs"),
        ("fp32-cli", dict(batch=4, heads=4, kv_heads=4, head_dim=16,
                          block_size=8, max_blocks=16, num_blocks=64,
                          lens=(0, 7, 8, 127), dtype=torch.float32), 2e-5,
         "the serve CLI's default shape; float32 throughout"),
    ]
    errors = {}
    for i, (name, kw, tol, why) in enumerate(cases):
        q, pk, pv, table, lens = kernel_case(torch, seed=i, **kw)
        got = paged_flash_decode(q, pk, pv, table, lens)
        # the plain version in float32 on the same (rounded) inputs
        ref = paged_attention_reference(
            q.float()[:, None], pk.float(), pv.float(), table, lens[:, None]
        )[:, 0]
        torch.cuda.synchronize()
        err = (got.float() - ref).abs().max().item()
        check(math.isfinite(err) and err <= tol,
              f"kernel {name}: max abs err {err:.3e} > tol {tol:.0e}")
        # the scratch block is unreachable: clearing it changes nothing
        pk[0] = 0
        pv[0] = 0
        again = paged_flash_decode(q, pk, pv, table, lens)
        check(torch.equal(again, got),
              f"kernel {name}: output moved with the scratch block")
        errors[name] = err
        say("kernel", f"{name}: max abs err {err:.3e} (tol {tol:.0e}: {why})")

    # the split arithmetic at the serving shape, with the kernel's own
    # split count: same ranges and merge order, float32 throughout
    q, pk, pv, table, lens = kernel_case(
        torch, seed=0, heads=HEADS, kv_heads=HEADS, head_dim=HEAD_DIM,
        dtype=torch.float32, **geometry,
    )
    splits = decode_splits(SLOTS, HEADS, MAX_BLOCKS, BLOCK_SIZE,
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    got = paged_flash_decode(q, pk, pv, table, lens)
    ref = paged_decode_split_reference(q, pk, pv, table, lens, splits)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(math.isfinite(err) and err <= 2e-5,
          f"kernel vs split reference ({splits} splits): max abs err "
          f"{err:.3e} > tol 2e-05")
    say("kernel", f"fp32-mha vs paged_decode_split_reference ({splits} "
                  f"splits): max abs err {err:.3e} (tol 2e-05: float32 "
                  "throughout; only the summation order differs)")

    # timing at the main path's shape and dtype (fp32 MHA), then one row
    # per slot at the full table ("long") and one row alone ("single")
    timed = {label: time_paged(torch, bandwidth, label, lens)
             for label, lens in PAGED_TIMING.items()}
    ms = timed["mixed"]
    return {
        "name": "paged_flash_decode",
        "route": "cuda",
        "source": "distributed_pytorch_example_tpu_torch/csrc/paged_decode.cu",
        "replaces": "distributed_pytorch_example_tpu/ops/pallas/"
                    "paged_attention.py:148",
        "launches": None,  # filled from the main path's run
        "max_abs_err": errors["fp32-mha"],
        "ms": min(ms["kernel"], ms["kernel2"]),
        "plain_ms": min(ms["plain"], ms["plain2"]),
        "bound_ms": ms["bound_ms"],
        "bound_by": ms["bound_by"],
        "library_ms": ms["library"],
    }


def paged_bound(lens, bandwidth):
    """(bound ms, by, bytes, flops) of K2 at the serving geometry in fp32:
    each live K/V row read once, q, out, table and lens once."""
    batch = len(lens)
    live_keys = sum(min(p, MAX_BLOCKS * BLOCK_SIZE - 1) + 1 for p in lens)
    kv_bytes = 2 * live_keys * HEADS * HEAD_DIM * 4
    io_bytes = (2 * batch * HEADS * HEAD_DIM * 4 + batch * MAX_BLOCKS * 4
                + batch * 4)
    flops = 4 * live_keys * HEADS * HEAD_DIM
    bytes_ms = (kv_bytes + io_bytes) / bandwidth * 1e3
    ops_ms = flops / _F32_PEAK * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", kv_bytes + io_bytes, flops)


def time_paged(torch, bandwidth, label, lens):
    """K2, its plain version and SDPA on pre-gathered KV at the serving
    geometry (fp32, 12 heads, head_dim 64, blocks of 16, 64 per row, pool
    513), one row per entry of ``lens``, timed plain, kernel, kernel, plain
    with the L2 flushed; prints one line and returns the times and bound."""
    from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
        paged_attention_reference,
        paged_flash_decode,
    )

    batch = len(lens)
    q, pk, pv, table, lens_t = kernel_case(
        torch, seed=0, batch=batch, heads=HEADS, kv_heads=HEADS,
        head_dim=HEAD_DIM, block_size=BLOCK_SIZE, max_blocks=MAX_BLOCKS,
        num_blocks=NUM_BLOCKS, lens=lens, dtype=torch.float32,
    )
    q4, pos2 = q[:, None], lens_t[:, None]
    idx = table.long()
    gk = pk[idx].reshape(batch, -1, HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    gv = pv[idx].reshape(batch, -1, HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    key_pos = torch.arange(MAX_BLOCKS * BLOCK_SIZE, device="cuda")
    mask = (key_pos[None, :] <= lens_t[:, None])[:, None, None, :]
    qh = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = {}
    # plain, kernel, kernel, plain: keep the comparison inside one call
    for key, fn in (
        ("plain", lambda: paged_attention_reference(q4, pk, pv, table, pos2)),
        ("kernel", lambda: paged_flash_decode(q, pk, pv, table, lens_t)),
        ("kernel2", lambda: paged_flash_decode(q, pk, pv, table, lens_t)),
        ("plain2", lambda: paged_attention_reference(q4, pk, pv, table, pos2)),
        ("library", lambda: sdpa(qh, gk, gv, attn_mask=mask)),
    ):
        ms[key] = time_cold(torch, fn)
    bound, by, nbytes, flops = paged_bound(lens, bandwidth)
    ms.update(bound_ms=bound, bound_by=by)
    say("kernel", f"paged_flash_decode {label} fp32 B={batch} N={HEADS} "
                  f"H={HEAD_DIM} bs={BLOCK_SIZE} mb={MAX_BLOCKS} "
                  f"lens={list(lens)}: kernel {ms['kernel']:.4f}/"
                  f"{ms['kernel2']:.4f} ms, plain {ms['plain']:.4f}/"
                  f"{ms['plain2']:.4f} ms, library (SDPA on pre-gathered KV) "
                  f"{ms['library']:.4f} ms, bound {bound:.4f} ms ({nbytes} "
                  f"bytes, {flops} flops)")
    return ms


# ---------------------------------------------------------------------------
# 3b. K1 (flash attention) check + timing
# ---------------------------------------------------------------------------

# tolerances of K1 against its plain version on the same inputs: o and lse
# absolute, gradients relative to max |ref|. float32: both sides float32,
# only the summation order differs. bf16: float32 math on bf16 inputs, but
# p and ds are rounded to bf16 before their products (relative to the
# running max in the kernel, the global max in the plain version) and the
# outputs are rounded to bf16 (half an ulp at |o| < 2 is 7.8e-3).
FLASH_TOL = {
    "float32": {"o": 2e-5, "lse": 2e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4},
    "bfloat16": {"o": 1e-2, "lse": 1e-4, "dq": 2e-2, "dk": 2e-2, "dv": 2e-2},
}


def flash_case(torch, *, batch, heads, kv_heads, seq, head_dim, dtype,
               masked, seed, device="cuda", lens=None):
    """q/k/v/do drawn on the CPU from ``seed``; with ``masked``, a (B, S)
    float32 key mask where row 0 loses its last quarter of keys and the
    last row has none (a dead row); with ``lens``, row b keeps its first
    ``lens[b]`` keys."""
    gen = torch.Generator().manual_seed(seed)
    shape_q = (batch, seq, heads, head_dim)
    shape_kv = (batch, seq, kv_heads, head_dim)
    q, do = (torch.randn(shape_q, generator=gen) for _ in range(2))
    k, v = (torch.randn(shape_kv, generator=gen) for _ in range(2))
    mask = None
    if lens is not None:
        mask = (torch.arange(seq)[None, :]
                < torch.tensor(lens)[:, None]).float().to(device)
    elif masked:
        mask = torch.ones(batch, seq)
        mask[0, seq - seq // 4:] = 0
        mask[-1] = 0
        mask = mask.to(device)
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            do.to(device, dtype), mask)


def flash_errors(torch, got, ref):
    """Max errors of (o, lse, dq, dk, dv): o and lse absolute, gradients
    relative to max |ref|."""
    errs = {}
    for name, g, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
        diff = (g.float() - r.float()).abs().max().item()
        if name in ("dq", "dk", "dv"):
            diff /= max(r.float().abs().max().item(), 1e-30)
        errs[name] = diff
    return errs


def sdpa_backend(torch, *args, **kw):
    """The backend SDPA's dispatcher picks for ``sdpa(*args, **kw)``; its
    backward is that backend's own. (Not read from the kernels' names
    under ``torch.profiler``: on the card a short profile came back empty,
    now and then, once the card had been busy for half a minute.)"""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(*args, **kw)).name.lower()


def check_flash(torch, bandwidth):
    """K1 against its plain versions on the card, then its timing at the
    training path's shape (B=16, N=12, S=1024, H=64, bf16, causal)."""
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    B, N, S, H = TRAIN_BATCH, HEADS, TRAIN_SEQ, HEAD_DIM
    # (name, case, causal): the first is the training path's own shape,
    # whose inputs the timing below reuses
    cases = [
        ("bf16-causal-main", dict(batch=B, heads=N, kv_heads=N, seq=S,
                                  head_dim=H, dtype=bf16, masked=False),
         True),
        ("fp32-full-256", dict(batch=2, heads=4, kv_heads=4, seq=256,
                               head_dim=64, dtype=f32, masked=False), False),
        ("bf16-gqa-12/4", dict(batch=2, heads=12, kv_heads=4, seq=256,
                               head_dim=64, dtype=bf16, masked=False), True),
        ("bf16-kvmask-deadrow", dict(batch=2, heads=4, kv_heads=4, seq=256,
                                     head_dim=64, dtype=bf16, masked=True),
         False),
        ("bf16-h128", dict(batch=2, heads=4, kv_heads=4, seq=256,
                           head_dim=128, dtype=bf16, masked=False), True),
        ("bf16-h256", dict(batch=2, heads=4, kv_heads=2, seq=256,
                           head_dim=256, dtype=bf16, masked=True), False),
        ("fp32-h256", dict(batch=1, heads=2, kv_heads=2, seq=256,
                           head_dim=256, dtype=f32, masked=False), True),
        # BERT-base's attention (phase 10's shape): non-causal, every tile
        # live, padded tails of every length and an all-pad row
        ("bf16-bert-kvmask", dict(batch=B, heads=N, kv_heads=N, seq=BERT_SEQ,
                                  head_dim=H, dtype=bf16, masked=True,
                                  lens=BERT_LENS), False),
    ]
    errors, cases_out = {}, {}
    for i, (name, kw, causal) in enumerate(cases):
        q, k, v, do, mask = flash_case(torch, seed=100 + i, **kw)
        args = dict(causal=causal, kv_mask=mask,
                    softmax_scale=kw["head_dim"] ** -0.5)
        o, lse = flash_attention_fwd(q, k, v, **args)
        grads = flash_attention_bwd(q, k, v, o, lse, do, **args)
        ro, rlse = flash_attention_fwd_reference(q, k, v, **args)
        rgrads = flash_attention_bwd_reference(q, k, v, o, lse, do, **args)
        torch.cuda.synchronize()
        errs = flash_errors(torch, (o, lse, *grads), (ro, rlse, *rgrads))
        tols = FLASH_TOL[str(kw["dtype"]).split(".")[-1]]
        for key, err in errs.items():
            check(math.isfinite(err) and err <= tols[key],
                  f"K1 {name}: {key} error {err:.3e} > tol {tols[key]:.0e}")
        if mask is not None:
            check(bool((o[-1] == 0).all()) and bool((lse[-1] == -1e30).all())
                  and bool((grads[0][-1] == 0).all()),
                  f"K1 {name}: the dead row is not 0 / NEG_INF / 0")
        errors[name] = errs
        if name in ("bf16-causal-main", "bf16-bert-kvmask"):
            cases_out[name] = ((q, k, v, do, mask, o, lse), {
                "fwd": (o.float() - ro.float()).abs().max().item(),
                "bwd": max((g.float() - r.float()).abs().max().item()
                           for g, r in zip(grads, rgrads)),
            })
        say("kernel", f"K1 {name}: " + ", ".join(
            f"{key} {err:.3e} (tol {tols[key]:.0e})"
            for key, err in errs.items()))
    say("kernel", "K1 tolerances: o and lse absolute, gradients relative to "
                  "max |ref|; bf16 rounds p and ds before their products and "
                  "rounds the outputs, float32 differs in summation order")

    # timing at the training path's shape, on the main case's inputs
    (q, k, v, do, _, o, lse), max_abs = cases_out["bf16-causal-main"]
    args = dict(causal=True, kv_mask=None, softmax_scale=H ** -0.5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # SDPA's backward alone: its forward stays outside the timed window
    sdpa_out = sdpa(qt, kt, vt, is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                   retain_graph=True)

    say("kernel", "SDPA backend at the training shape: "
                  + sdpa_backend(torch, qt, kt, vt, is_causal=True))
    ms = {}
    # plain, kernel, kernel, plain: keep the comparison inside one call
    for label, fn, iters in (
        ("fwd_plain", lambda: flash_attention_fwd_reference(q, k, v, **args),
         5),
        ("fwd", lambda: flash_attention_fwd(q, k, v, **args), 20),
        ("fwd2", lambda: flash_attention_fwd(q, k, v, **args), 20),
        ("fwd_plain2", lambda: flash_attention_fwd_reference(q, k, v,
                                                             **args), 5),
        ("bwd_plain", lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, **args), 5),
        ("bwd", lambda: flash_attention_bwd(q, k, v, o, lse, do, **args),
         20),
        ("bwd2", lambda: flash_attention_bwd(q, k, v, o, lse, do, **args),
         20),
        ("bwd_plain2", lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, **args), 5),
        ("sdpa_fwd", lambda: sdpa(qt, kt, vt, is_causal=True), 20),
        ("sdpa_bwd", sdpa_bwd, 20),
    ):
        ms[label] = time_cold(torch, fn, iters=iters)
    elem = B * S * N * H * 2  # bytes of one bf16 (B, S, N, H) tensor
    row = B * N * S * 4       # bytes of one float32 (B, N, S) tensor
    # the causal triangle's q.k pairs, 2 flops per multiply-add
    tri = B * N * H * S * (S + 1)
    bounds = {
        # reads q, k, v; writes o and lse. Products: q.k^T and p.v
        "fwd": (4 * elem + row, 2 * tri),
        # reads q, k, v, o, do, lse; writes dq, dk, dv. Products: the
        # q.k^T recompute, dO.v^T, p^T.dO, ds^T.q, ds.k
        "bwd": (8 * elem + row, 5 * tri),
    }
    entries = []
    for kind, (nbytes, flops) in bounds.items():
        bytes_ms = nbytes / bandwidth * 1e3
        ops_ms = flops / _BF16_PEAK * 1e3
        kernel_ms = min(ms[kind], ms[kind + "2"])
        plain_ms = min(ms[kind + "_plain"], ms[kind + "_plain2"])
        library_ms = ms["sdpa_" + kind]
        say("kernel", f"flash_attention_{kind} bf16 causal B={B} N={N} S={S} "
                      f"H={H}: kernel {ms[kind]:.4f}/{ms[kind + '2']:.4f} ms, "
                      f"plain {ms[kind + '_plain']:.4f}/"
                      f"{ms[kind + '_plain2']:.4f} ms, library "
                      f"{library_ms:.4f} ms (SDPA "
                      f"{'forward' if kind == 'fwd' else 'backward alone'}"
                      f"), bound {max(bytes_ms, ops_ms):.4f} ms ({nbytes} "
                      f"bytes, {flops} flops)")
        entries.append({
            "name": f"flash_attention_{kind}",
            "route": "cuda",
            "source": "distributed_pytorch_example_tpu_torch/csrc/"
                      "flash_attention.cu",
            "replaces": "distributed_pytorch_example_tpu/ops/pallas/"
                        "flash_attention.py:"
                        + ("244" if kind == "fwd" else "626"),
            "launches": None,  # filled from the training path's run
            "max_abs_err": max_abs[kind],
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        })
    bert = time_bert_flash(torch, bandwidth, *cases_out["bf16-bert-kvmask"])
    for entry, kind in zip(entries, ("fwd", "bwd")):
        entry["bert"] = bert[kind]
    return entries


def time_bert_flash(torch, bandwidth, inputs, max_abs):
    """K1 at BERT-base's shape (B=16, N=12, S=512, H=64, bf16, non-causal)
    on phase 3's case with ``BERT_LENS`` as key mask, and once unmasked;
    its plain version; SDPA with the same boolean key mask and unmasked.
    Returns the ``bert`` fields of the K1 entries, the bounds counted on
    this mask's live keys (a dead row needs no products)."""
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    q, k, v, do, mask, o, lse = inputs
    B, S, N, H = q.shape
    args = dict(causal=False, kv_mask=mask, softmax_scale=H ** -0.5)
    bare = dict(args, kv_mask=None)
    o_bare, lse_bare = flash_attention_fwd(q, k, v, **bare)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    keep = (mask > 0)[:, None, None, :]  # SDPA's boolean mask: True = attend
    sdpa = torch.nn.functional.scaled_dot_product_attention
    outs = {"masked": sdpa(qt, kt, vt, attn_mask=keep),
            "unmasked": sdpa(qt, kt, vt)}

    def sdpa_bwd(which):
        return lambda: torch.autograd.grad(outs[which], (qt, kt, vt), dot,
                                           retain_graph=True)

    backends = {"masked": sdpa_backend(torch, qt, kt, vt, attn_mask=keep),
                "unmasked": sdpa_backend(torch, qt, kt, vt)}
    for which, backend in backends.items():
        say("kernel", f"SDPA {which} backend at the BERT shape: {backend}")
    ms = {}
    for label, fn, iters in (
        ("fwd_plain", lambda: flash_attention_fwd_reference(q, k, v,
                                                            **args), 5),
        ("fwd", lambda: flash_attention_fwd(q, k, v, **args), 20),
        ("fwd2", lambda: flash_attention_fwd(q, k, v, **args), 20),
        ("fwd_plain2", lambda: flash_attention_fwd_reference(q, k, v,
                                                             **args), 5),
        ("fwd_unmasked", lambda: flash_attention_fwd(q, k, v, **bare), 20),
        ("bwd_plain", lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, **args), 5),
        ("bwd", lambda: flash_attention_bwd(q, k, v, o, lse, do, **args),
         20),
        ("bwd2", lambda: flash_attention_bwd(q, k, v, o, lse, do, **args),
         20),
        ("bwd_plain2", lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, **args), 5),
        ("bwd_unmasked", lambda: flash_attention_bwd(
            q, k, v, o_bare, lse_bare, do, **bare), 20),
        ("sdpa_fwd_masked", lambda: sdpa(qt, kt, vt, attn_mask=keep), 20),
        ("sdpa_fwd_unmasked", lambda: sdpa(qt, kt, vt), 20),
        ("sdpa_bwd_masked", sdpa_bwd("masked"), 20),
        ("sdpa_bwd_unmasked", sdpa_bwd("unmasked"), 20),
    ):
        ms[label] = time_cold(torch, fn, iters=iters)
    elem = B * S * N * H * 2          # one bf16 (B, S, N, H) tensor
    row = B * N * S * 4               # one float32 (B, N, S) tensor
    live = N * H * S * int((mask > 0).sum().item())  # q.k pairs x H
    full = N * H * S * B * S
    out = {}
    # fwd: reads q, k, v, the mask; writes o, lse; q.k^T and p.v.
    # bwd: reads q, k, v, o, do, lse, the mask; writes dq, dk, dv; five
    # products (the q.k^T recompute, dO.v^T, p^T.dO, ds^T.q, ds.k)
    for kind, nbytes, products in (("fwd", 4 * elem + row, 2),
                                   ("bwd", 8 * elem + row, 5)):
        nbytes += B * S * 4
        bytes_ms = nbytes / bandwidth * 1e3
        ops_ms = 2 * products * live / _BF16_PEAK * 1e3
        full_ms = max(bytes_ms, 2 * products * full / _BF16_PEAK * 1e3)
        out[kind] = {
            "shape": f"B={B} N={N} S={S} H={H} bf16 non-causal, key mask "
                     f"lens {list(BERT_LENS)}",
            "launches": None,  # filled from phase 10's run
            "max_abs_err": max_abs[kind],
            "ms": min(ms[kind], ms[kind + "2"]),
            "plain_ms": min(ms[kind + "_plain"], ms[kind + "_plain2"]),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": ms[f"sdpa_{kind}_masked"],
            "library_backend": backends["masked"],
            "unmasked_ms": ms[kind + "_unmasked"],
            "unmasked_bound_ms": full_ms,
            "library_unmasked_ms": ms[f"sdpa_{kind}_unmasked"],
            "library_unmasked_backend": backends["unmasked"],
        }
        say("kernel", f"flash_attention_{kind} at the BERT shape "
                      f"(B={B} N={N} S={S} H={H} bf16 non-causal, key mask "
                      f"{int((mask > 0).sum().item())} of {B * S} keys): "
                      f"kernel {ms[kind]:.4f}/{ms[kind + '2']:.4f} ms, plain "
                      f"{ms[kind + '_plain']:.4f}/{ms[kind + '_plain2']:.4f} "
                      f"ms, SDPA masked {ms[f'sdpa_{kind}_masked']:.4f} ms, "
                      f"bound {max(bytes_ms, ops_ms):.4f} ms ({nbytes} bytes, "
                      f"{2 * products * live} flops); unmasked: kernel "
                      f"{ms[kind + '_unmasked']:.4f} ms, SDPA "
                      f"{ms[f'sdpa_{kind}_unmasked']:.4f} ms, bound "
                      f"{full_ms:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# 3c. K3 (ring all-gather / reduce-scatter) check + timing, in-process ranks
# ---------------------------------------------------------------------------

RING_WORLDS = (2, 4, 8)
BUCKET_ELEMS = 1 << 20          # the main path's 4 MiB float32 bucket
GPT2_PARAMS = 124_439_808       # GPT-2 124M's gradient, flattened


def ring_run(torch, fn, rings, xs, streams):
    """``fn(x_r, ring_r)`` for every in-process rank, each on its own CUDA
    stream, all launched before anything waits; returns the outputs
    (the default stream waits for every rank's stream)."""
    main = torch.cuda.current_stream()
    outs = []
    for ring, x, stream in zip(rings, xs, streams):
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            outs.append(fn(x, ring))
    for stream in streams:
        main.wait_stream(stream)
    return outs


def ring_inputs(torch, world, n, dtype, seed):
    """Every rank's payload of ``n`` elements, made on the card from a
    seed: unit normals, or int8 values in [-127, 127]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.int8:
        return [torch.randint(-127, 128, (n,), generator=gen, device="cuda",
                              dtype=torch.int8) for _ in range(world)]
    return [torch.randn(n, generator=gen, device="cuda").to(dtype)
            for _ in range(world)]


def ring_rs_bound(torch, xs, world):
    """Elementwise tolerance of K3b against its plain version: both sum
    ``world`` float32 terms in different orders, each off the exact sum by
    at most (world - 1) roundings of 2^-24 relative to sum |x_r|; bf16
    outputs round those two sums to bf16, which may then lie one bf16 ulp
    apart (2^-7 of |sum| at most)."""
    absum = torch.zeros_like(xs[0], dtype=torch.float32)
    for x in xs:
        absum += x.float().abs()
    tol = 2 * (world - 1) * 2.0 ** -24 * absum
    if xs[0].dtype == torch.bfloat16:
        tol += 2.0 ** -7 * absum
    return list(tol.chunk(world))


def check_ring(torch, bandwidth):
    """K3a / K3b with in-process ranks against their plain versions, then
    their timing (cold, L2 flushed) beside the bound."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        PeerRing,
        ring_all_gather,
        ring_all_gather_reference,
        ring_reduce_scatter,
        ring_reduce_scatter_reference,
        ring_reduce_scatter_ring_order,
    )

    entries = {}
    for world in RING_WORLDS:
        rings = PeerRing.local_group(world, "cuda")
        streams = [torch.cuda.Stream() for _ in range(world)]
        pad = 256 * world
        gpt2 = -(-GPT2_PARAMS // pad) * pad
        # (label, elements per rank in: gather = local payload, scatter =
        # the whole buffer)
        shapes = (("bucket", BUCKET_ELEMS), ("gpt2", gpt2))
        for label, n in shapes:
            for dtype in (torch.float32, torch.bfloat16, torch.int8):
                n_ag = n if label == "bucket" else n // world
                xs = ring_inputs(torch, world, n_ag, dtype, seed=world)
                torch.cuda.synchronize()
                got = ring_run(torch, ring_all_gather, rings, xs, streams)
                want = ring_all_gather_reference(xs)
                torch.cuda.synchronize()
                for ring in rings:
                    ring.check()
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"K3a R={world} {label} {dtype}: not equal to the "
                      "plain gather")
                name = str(dtype).split(".")[-1]
                say("kernel", f"K3a R={world} {label} {name}: {n_ag} "
                              "elements per rank, equal to the plain version "
                              "on every rank (a gather moves bytes)")
                if dtype == torch.float32:
                    entries[("ag", world, label)] = time_ring(
                        torch, bandwidth, "ag", rings, xs, streams, world)
                del xs, got, want
                if dtype == torch.int8:
                    continue
                xs = ring_inputs(torch, world, n, dtype, seed=100 + world)
                torch.cuda.synchronize()
                got = ring_run(torch, ring_reduce_scatter, rings, xs,
                               streams)
                want = ring_reduce_scatter_reference(xs)
                tols = ring_rs_bound(torch, xs, world)
                torch.cuda.synchronize()
                for ring in rings:
                    ring.check()
                err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got, want))
                ok = all(bool(((g.float() - w.float()).abs() <= t).all())
                         for g, w, t in zip(got, want, tols))
                check(ok and math.isfinite(err),
                      f"K3b R={world} {label} {name}: max abs err {err:.3e} "
                      "outside the float32 rounding bound")
                exact = ring_reduce_scatter_ring_order(xs)
                check(all(torch.equal(g, e) for g, e in zip(got, exact)),
                      f"K3b R={world} {label} {name}: not bit-equal to the "
                      "sum in the TPU ring's order")
                del exact
                say("kernel", f"K3b R={world} {label} {name}: {n} elements "
                              f"per rank in, max abs err {err:.3e} (within "
                              "2 (R-1) 2^-24 sum|x| elementwise"
                              + (", + 2^-7 sum|x| for the bf16 output"
                                 if dtype == torch.bfloat16 else "")
                              + "), bit-equal to the sum in the TPU ring's "
                              "order on every rank")
                if dtype == torch.float32:
                    entry = time_ring(torch, bandwidth, "rs", rings, xs,
                                      streams, world)
                    entry["max_abs_err"] = err
                    entries[("rs", world, label)] = entry
                del xs, got, want, tols
        torch.cuda.synchronize()
        for ring in rings:
            ring.close()
        torch.cuda.empty_cache()
    common = {"route": "cuda", "source": "distributed_pytorch_example_tpu_torch/"
              "csrc/ring_collectives.cu", "launches": None, "library_ms": None}
    ag = entries[("ag", 2, "bucket")]
    rs = entries[("rs", 2, "bucket")]
    return (
        {"name": "ring_all_gather", **common,
         "replaces": "distributed_pytorch_example_tpu/ops/pallas/"
                     "collectives.py:188", "max_abs_err": 0.0,
         **{k: ag[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        {"name": "ring_reduce_scatter", **common,
         "replaces": "distributed_pytorch_example_tpu/ops/pallas/"
                     "collectives.py:331", "max_abs_err": rs["max_abs_err"],
         **{k: rs[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
    )


def time_ring(torch, bandwidth, kind, rings, xs, streams, world):
    """Kernel (all ranks, one launch each) and plain version, cold, L2
    flushed, in turns; the bound counts each rank's input read once and
    its output written once at the card's memory rate (all ranks share
    the card), and the reduce-scatter's float32 adds at the float32
    peak."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_all_gather,
        ring_all_gather_reference,
        ring_reduce_scatter,
        ring_reduce_scatter_reference,
    )

    kernel = ring_all_gather if kind == "ag" else ring_reduce_scatter
    plain = (ring_all_gather_reference if kind == "ag"
             else ring_reduce_scatter_reference)
    big = xs[0].numel() * xs[0].element_size() * world > (1 << 30)
    iters = 5 if big else 30
    ms = {}
    for label, fn in (("plain", lambda: plain(xs)),
                      ("kernel", lambda: ring_run(torch, kernel, rings, xs,
                                                  streams)),
                      ("kernel2", lambda: ring_run(torch, kernel, rings, xs,
                                                   streams)),
                      ("plain2", lambda: plain(xs))):
        ms[label] = time_cold(torch, fn, iters=iters)
    for ring in rings:
        ring.check()
    size = xs[0].element_size()
    n = xs[0].numel()
    if kind == "ag":
        nbytes = world * n * size + world * world * n * size
        flops = 0
    else:
        nbytes = world * n * size + n * size
        flops = (world - 1) * n  # one float32 add per element per hop
    bytes_ms = nbytes / bandwidth * 1e3
    ops_ms = flops / _F32_PEAK * 1e3
    entry = {
        "ms": min(ms["kernel"], ms["kernel2"]),
        "plain_ms": min(ms["plain"], ms["plain2"]),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    say("kernel", f"{'ring_all_gather' if kind == 'ag' else 'ring_reduce_scatter'}"
                  f" float32 R={world}, {n} elements per rank in: kernel "
                  f"{ms['kernel']:.4f}/{ms['kernel2']:.4f} ms, plain "
                  f"{ms['plain']:.4f}/{ms['plain2']:.4f} ms, library — (no "
                  f"library collective runs between ranks on one card), "
                  f"bound {entry['bound_ms']:.4f} ms ({nbytes} bytes, {flops}"
                  " flops)")
    return entry


# ---------------------------------------------------------------------------
# 4. serve: the main path at full width
# ---------------------------------------------------------------------------


def workload(Request, seed=0, n=16, vocab=50257):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [
        Request(
            rid=f"req{i:04d}",
            prompt=[int(t) for t in rng.integers(0, vocab,
                                                 int(rng.integers(32, 257)))],
            max_new_tokens=int(rng.integers(32, 65)),
            seed=seed * 100_003 + i,
        )
        for i in range(n)
    ]


def serve(torch):
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
        paged_flash_decode,
    )
    from distributed_pytorch_example_tpu_torch.serving import (
        InferenceEngine,
        Request,
    )

    t0 = time.perf_counter()
    model = GPT2(decode=True, paged_num_blocks=NUM_BLOCKS,
                 paged_block_size=BLOCK_SIZE, paged_max_blocks=MAX_BLOCKS,
                 device="cuda", seed=0)
    pool_gb = sum(
        b.numel() * b.element_size() for n, b in model.named_buffers()
        if "pages" in n
    ) / 1e9
    say("serve", f"GPT-2 124M (12 layers, width 768, vocab 50257, fp32) on "
                 f"the card in {time.perf_counter() - t0:.1f} s; pool "
                 f"{NUM_BLOCKS}x{BLOCK_SIZE} tokens, {pool_gb:.3f} GB")
    runs = {}
    for label, kw in (("greedy", dict(temperature=0.0)),
                      ("sampled", dict(temperature=1.0, top_k=50))):
        engine = InferenceEngine(model, num_slots=SLOTS, device="cuda", **kw)
        engine.warmup()
        torch.cuda.synchronize()
        reset_counts()
        report = engine.run(workload(Request))
        torch.cuda.synchronize()
        launches = paged_flash_decode.launches
        m = report["metrics"]
        statuses = {r["status"] for r in report["results"].values()}
        check(statuses == {"done"} and m["completed"] == 16,
              f"{label}: not every request completed: {statuses}")
        check(launches > 0 and launches == m["decode_steps"] * LAYERS,
              f"{label}: paged_flash_decode launched {launches} times, "
              f"want decode_steps {m['decode_steps']} x {LAYERS}")
        say("serve", f"{label}: {m['generated_tokens']} tokens in "
                     f"{m['elapsed_s']:.3f} s = {m['tokens_per_sec']:.1f} "
                     f"tokens/s; decode {m['decode_tokens_per_sec']:.1f} "
                     f"tokens/s; TTFT p50 {m['ttft_ms']['p50']:.2f} p99 "
                     f"{m['ttft_ms']['p99']:.2f} ms; TPOT p50 "
                     f"{m['tpot_ms']['p50']:.2f} p99 {m['tpot_ms']['p99']:.2f}"
                     f" ms; decode_steps {m['decode_steps']}; K2 launches "
                     f"{launches}; preempted {m['preempted']}")
        runs[label] = (report, launches)
    check_against_plain(torch, model, runs["greedy"][0])
    return (sum(launches for _, launches in runs.values()),
            {label: report for label, (report, _) in runs.items()})


def check_against_plain(torch, model, report, plain=None, vocab=50257,
                        phase="serve"):
    """Greedy tokens and paged logits against the plain full-sequence
    forward on the card (same weights, no KV cache, no kernel); ``plain``
    is that model (default GPT-2), ``vocab`` the workload's."""
    from distributed_pytorch_example_tpu_torch.models import GPT2

    if plain is None:
        plain = GPT2(device="cuda", seed=0)
    plain.load_state_dict(model.state_dict())
    plain.eval()
    # float32 everywhere with TF32 off: paged and plain differ only in
    # reduction order over 12 layers
    logit_tol = 1e-3
    rids = sorted(report["results"])[:2]
    with torch.inference_mode():
        for rid in rids:
            r = report["results"][rid]
            prompt = workload_prompt(rid, vocab)
            seq = torch.tensor([prompt + r["tokens"]], device="cuda")
            logits = plain(seq)[0]
            plen = len(prompt)
            steps = logits[plen - 1:plen - 1 + len(r["tokens"])]
            chosen = steps.gather(1, torch.tensor(r["tokens"], device="cuda")[:, None])[:, 0]
            gap = (steps.max(dim=1).values - chosen).max().item()
            exact = (steps.argmax(dim=1).tolist() == r["tokens"])
            check(gap <= logit_tol,
                  f"{rid}: a greedy token is {gap:.2e} below the plain "
                  f"argmax logit (tol {logit_tol})")
            say(phase, f"{rid}: {len(r['tokens'])} greedy tokens are the "
                         f"plain forward's argmax (exact={exact}, worst gap "
                         f"{gap:.2e})")
        # paged prefill + 3 decode steps vs the plain forward, logit by logit
        rid = rids[0]
        prompt = workload_prompt(rid, vocab)
        gen = report["results"][rid]["tokens"][:3]
        plen = len(prompt)
        bucket = -(-plen // BLOCK_SIZE) * BLOCK_SIZE
        n_blk = -(-(plen + len(gen)) // BLOCK_SIZE)  # positions < plen+3
        table = torch.zeros(1, MAX_BLOCKS, dtype=torch.int32, device="cuda")
        table[0, :n_blk] = torch.arange(1, n_blk + 1, dtype=torch.int32)
        tokens = torch.zeros(1, bucket, dtype=torch.long, device="cuda")
        tokens[0, :plen] = torch.tensor(prompt)
        paged = [model(tokens, page_table=table,
                       row_lens=torch.zeros(1, dtype=torch.int32,
                                            device="cuda"))[0, :plen]]
        # decode step t feeds gen[t] at position plen + t
        for t, tok in enumerate(gen):
            lens = torch.tensor([plen + t], dtype=torch.int32, device="cuda")
            paged.append(model(torch.tensor([[tok]], device="cuda"),
                               page_table=table, row_lens=lens)[0])
        full = torch.tensor([prompt + gen], device="cuda")
        ref = plain(full)[0]
        got = torch.cat(paged)
        err = (got - ref).abs().max().item()
        check(err <= logit_tol,
              f"paged vs plain logits: max abs err {err:.3e} > {logit_tol}")
        say(phase, f"paged prefill + {len(gen)} decode steps vs plain "
                     f"forward: max abs logit err {err:.3e} (tol "
                     f"{logit_tol}: float32, reduction order only)")


def workload_prompt(rid, vocab=50257):
    from distributed_pytorch_example_tpu_torch.serving import Request

    return list(next(r for r in workload(Request, vocab=vocab)
                     if r.rid == rid).prompt)


# ---------------------------------------------------------------------------
# 5. cli
# ---------------------------------------------------------------------------


def cli():
    cmd = [sys.executable, "-m", "distributed_pytorch_example_tpu_torch.serve",
           "--requests", "4", "--rate", "0"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0,
          f"serve CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    check(line.get("metric") == "serve_tokens_per_sec"
          and line.get("completed") == 4,
          f"serve CLI line: {line}")
    say("cli", f"{' '.join(cmd[1:])} in {time.perf_counter() - t0:.1f} s: "
               f"{json.dumps(line)}")


# ---------------------------------------------------------------------------
# 6. train: the training path at full width
# ---------------------------------------------------------------------------

# per-step loss of the flash run against the plain-attention run: both bf16;
# they round attention differently (the plain path rounds the logits to
# bf16, the kernel keeps them float32), and 10 Adam steps carry it on
LOSS_TOL = 2e-2
# per-leaf gradients of the first step (the same weights and batch), flash
# against plain attention: ||g - g_plain|| / ||g_plain|| per leaf. Both bf16
# and rounding attention differently; a missing or wrong dq, dk or dv term
# puts the q, k or v projection's leaves at O(1). The k-projection bias is
# left out: its gradient is zero in exact arithmetic (a softmax ignores a
# shift shared by a whole row of logits), so both sides hold rounding noise.
GRAD_TOL = 5e-2


def reset_counts():
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_all_gather,
        ring_reduce_scatter,
    )
    from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
        paged_flash_decode,
    )

    for kernel in (paged_flash_decode, flash_attention_fwd,
                   flash_attention_bwd, ring_all_gather, ring_reduce_scatter):
        kernel.launches = 0


def fit_run(torch, model, task, train_ds, val_ds, batch, steps=None,
            record=None, **trainer_kw):
    """One epoch of ``Trainer.fit`` on the card, Adam at lr 1e-3, over the
    first ``steps`` batches (default all); returns (losses, step ms,
    history, peak bytes, the first step's gradients by name on the
    CPU). ``record`` (a list) gets every step's metrics; ``trainer_kw``
    goes to the Trainer."""
    from distributed_pytorch_example_tpu_torch.data import DeviceLoader
    from distributed_pytorch_example_tpu_torch.train import (
        Trainer,
        make_optimizer,
    )

    trainer = Trainer(model, task,
                      make_optimizer(model.parameters(), "adam", 1e-3),
                      log_every=5, **trainer_kw)
    step_fn, losses, events, first_grads = trainer.train_step, [], [], {}
    # the peak after every step: the Trainer's cost record of its first
    # train and eval step resets the card's peak counter before each
    peaks = []

    def timed(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step_fn(state, batch)
        end.record()
        peaks.append(torch.cuda.max_memory_allocated())
        if not events:  # copied to the host: the peak stays the run's own
            first_grads.update(
                (name, p.grad.detach().to("cpu", copy=True))
                for name, p in model.named_parameters() if p.grad is not None
            )
        losses.append(metrics["loss"])
        events.append((start, end))
        if record is not None:
            record.append(metrics)
        return metrics

    trainer.train_step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loader = DeviceLoader(train_ds, batch, device="cuda", seed=0)
    history = trainer.fit(
        loader if steps is None else Take(loader, steps),
        DeviceLoader(val_ds, batch, device="cuda", shuffle=False),
        epochs=1,
    )
    torch.cuda.synchronize()
    peak = max(peaks + [torch.cuda.max_memory_allocated()])
    step_ms = [s.elapsed_time(e) for s, e in events]
    del trainer, model
    gc.collect()  # a Trainer's cycles hold its tensors until collected
    torch.cuda.empty_cache()
    return [float(x) for x in losses], step_ms, history, peak, first_grads


def train_run(torch, use_flash, **fit_kw):
    """GPT-2 124M through Trainer.fit (see :func:`fit_run`)."""
    from distributed_pytorch_example_tpu_torch.data import (
        SyntheticTokenDataset,
    )
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.train import CausalLMTask

    model = GPT2(dtype=torch.bfloat16, logits_mode="hidden",
                 use_flash=use_flash, device="cuda", seed=0)
    train_ds = SyntheticTokenDataset(TRAIN_STEPS * TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ, seed=0)
    val_ds = SyntheticTokenDataset(TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=1)
    return fit_run(torch, model, CausalLMTask(), train_ds, val_ds,
                   TRAIN_BATCH, **fit_kw)


def gradient_gaps(grads, plain_grads):
    """||g - g_plain|| / ||g_plain|| per leaf, the k-projection biases
    left out (zero in exact arithmetic: a softmax ignores a shift shared
    by a whole row of logits, so both sides hold rounding noise)."""
    check(grads.keys() == plain_grads.keys(),
          "flash and plain runs have different gradient leaves")
    return {
        name: ((g - plain_grads[name]).norm()
               / plain_grads[name].norm().clamp_min(1e-30)).item()
        for name, g in grads.items() if not name.endswith("attn.k.bias")
    }


def train(torch):
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    reset_counts()
    losses, step_ms, history, peak, grads = train_run(torch, use_flash=None)
    torch.cuda.synchronize()
    fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"train: losses {losses}")
    check(math.isfinite(history[0]["val_loss"]),
          f"train: validation loss {history[0]['val_loss']}")
    val_batches = 1
    check(fwd == LAYERS * (TRAIN_STEPS + val_batches),
          f"train: flash forward launched {fwd} times, want {LAYERS} x "
          f"({TRAIN_STEPS} steps + {val_batches} validation batch)")
    check(bwd == LAYERS * TRAIN_STEPS,
          f"train: flash backward launched {bwd} times, want {LAYERS} x "
          f"{TRAIN_STEPS} steps")
    steady = sorted(step_ms[2:])
    median = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say("train", f"GPT-2 124M bf16 fused loss, batch {TRAIN_BATCH} x "
                 f"{TRAIN_SEQ}: {TRAIN_STEPS} steps, losses "
                 f"{[round(x, 4) for x in losses]}, val loss "
                 f"{history[0]['val_loss']:.4f}; step ms {step_ms} (median "
                 f"of steps 3+ {median:.2f} ms = {tokens / median * 1e3:.0f} "
                 f"tokens/s); epoch {history[0]['samples_per_sec']:.1f} "
                 f"samples/s; peak memory {peak / 2**30:.2f} GiB; K1 launches "
                 f"fwd {fwd} bwd {bwd}")
    plain_metrics = []
    plain, plain_ms, _, plain_peak, plain_grads = train_run(
        torch, use_flash=False, record=plain_metrics)
    worst = max(abs(a - b) for a, b in zip(losses, plain))
    check(worst <= LOSS_TOL,
          f"train: flash vs plain attention losses differ by {worst:.3e} > "
          f"{LOSS_TOL} ({losses} vs {plain})")
    gaps = gradient_gaps(grads, plain_grads)
    worst_leaf = max(gaps, key=gaps.get)
    check(all(math.isfinite(x) and x <= GRAD_TOL for x in gaps.values()),
          f"train: first-step gradient of {worst_leaf} differs from plain "
          f"attention's by {gaps[worst_leaf]:.3e} of its norm > {GRAD_TOL}")
    qkv = {name: gap for name, gap in gaps.items()
           if name.endswith(("attn.q.weight", "attn.k.weight",
                             "attn.v.weight"))}
    worst_qkv = max(qkv, key=qkv.get)
    say("train", f"first-step gradients, flash vs plain attention, "
                 f"||g - g_plain|| / ||g_plain|| over {len(gaps)} leaves: "
                 f"worst {gaps[worst_leaf]:.3e} ({worst_leaf}), worst q/k/v "
                 f"projection {qkv[worst_qkv]:.3e} ({worst_qkv}) (tol "
                 f"{GRAD_TOL}; attn.k.bias left out: zero in exact "
                 f"arithmetic)")
    plain_median = sorted(plain_ms[2:])[len(plain_ms[2:]) // 2]
    say("train", f"plain attention, same seed and batches: losses "
                 f"{[round(x, 4) for x in plain]}; worst per-step gap "
                 f"{worst:.3e} (tol {LOSS_TOL}: both bf16, attention rounds "
                 f"differently); median step {plain_median:.2f} ms; peak "
                 f"memory {plain_peak / 2**30:.2f} GiB")
    # what phase 15 holds its telemetry run to
    phase6 = {"median_ms": median,
              "plain_grad_norms": [float(m["grad_norm"])
                                   for m in plain_metrics]}
    return fwd, bwd, losses, grads, phase6


def train_cli():
    # checkpoints are phase 9's: none here
    runs = (
        ["--model", "gpt2", "--dataset", "synthetic-tokens", "--seq-len",
         "1024", "--dtype", "bfloat16", "--batch-size", "16", "--epochs", "1",
         "--num-samples", "64", "--checkpoint-dir", ""],
        ["--epochs", "1", "--checkpoint-dir", ""],
        ["--model", "resnet18", "--dataset", "synthetic-image",
         "--image-size", "32", "--augment", "cifar", "--epochs", "1",
         "--num-samples", "256", "--batch-size", "64",
         "--checkpoint-dir", ""],
    )
    for args in runs:
        cmd = [sys.executable, "-m",
               "distributed_pytorch_example_tpu_torch.train", *args]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        log = proc.stdout + proc.stderr
        check(proc.returncode == 0 and "Training completed" in log,
              f"train CLI {args} exit {proc.returncode}: {log[-3000:]}")
        tail = [line.split("] ", 1)[-1] for line in log.splitlines()
                if "Throughput" in line or "Training completed" in line
                or "Val Loss" in line]
        say("train-cli", f"{' '.join(cmd[1:])} in "
                         f"{time.perf_counter() - t0:.1f} s: {tail}")


# ---------------------------------------------------------------------------
# 8. zero1: the ZeRO-1 path at world 2, two processes on the card
# ---------------------------------------------------------------------------

ZERO1_WORLD, ZERO1_STEPS = 2, 4
ZERO1_RUNS = {
    # run (i): ZeRO-1, bucketed sync (the 4 MiB default): K3b carries every
    # uncompressed scatter bucket
    "zero1": dict(zero1=True, wire="none", param_gather="float32"),
    # run (ii): + int8-block gradients and a bf16 parameter gather: K3a
    # carries the psum buckets' int8 gathers and the bf16 gathers
    "zero1-int8": dict(zero1=True, wire="int8-block", param_gather="bf16"),
}
# rank 0's losses of each run, which phase 16 holds its FSDP run to
ZERO1_LOSSES: dict = {}
# first-step gradients of the two-process ZeRO-1 run against the
# one-process replicated run on the same global batch, per leaf,
# ||g - g_ref|| / ||g_ref||: both bf16 compute, but 2 x 8 rows against 16
# rows, so matmuls and the chunked loss round at other places; a wrong
# scale, a tile in the wrong place or a missing rank gives O(1)
ZERO1_GRAD_TOL = 5e-2


class Take:
    """The first ``n`` batches of a loader (epochs, sharding unchanged)."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n
        self.global_batch_size = loader.global_batch_size

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return self.n

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i == self.n:
                return
            yield batch


def params_digest(model) -> str:
    """SHA-256 over every parameter's bytes, in name order."""
    digest = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        digest.update(name.encode())
        digest.update(p.detach().cpu().contiguous().view(-1).numpy()
                      .view("uint8").tobytes())
    return digest.hexdigest()


def path_worker(run: str, ref_path: str, ckpt_dir: str = "") -> int:
    """One rank of the two-process ZeRO-1 run (started by
    :func:`zero1_path` with REPLICAS / PROCESS_ID / MASTER_ADDR /
    MASTER_PORT set); prints one ``chip_smoke_zero1`` JSON line. With
    ``ckpt_dir`` the run saves its gathered checkpoint there."""
    import torch
    import torch.distributed

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
        _scatter_parts,
    )
    from distributed_pytorch_example_tpu_torch.runtime import distributed
    from distributed_pytorch_example_tpu_torch.train import (
        CausalLMTask,
        Trainer,
        make_optimizer,
    )

    cfg = ZERO1_RUNS[run]
    distributed.initialize(device="cuda")
    rank, world = distributed.process_index(), distributed.process_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = GPT2(dtype=torch.bfloat16, logits_mode="hidden", device="cuda",
                 seed=0)
    part = data_parallel(world, dp_shard_opt_state=cfg["zero1"], wire=WireConfig(
        compress=cfg["wire"], param_gather=cfg["param_gather"],
        bucket_bytes=DEFAULT_BUCKET_BYTES))
    trainer = Trainer(model, CausalLMTask(),
                      make_optimizer(model.parameters(), "adam", 1e-3),
                      partitioner=part, log_every=ZERO1_STEPS,
                      checkpoint_dir=ckpt_dir or None,
                      checkpoint_format="gathered")
    train_ds = SyntheticTokenDataset(TRAIN_STEPS * TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ, seed=0)
    loader = Take(DeviceLoader(train_ds, TRAIN_BATCH, device="cuda", seed=0),
                  ZERO1_STEPS)
    step_fn, losses, events = trainer.train_step, [], []
    gaps = {}

    def timed(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step_fn(state, batch)
        end.record()
        if not events:
            gaps.update(first_step_gaps(torch, step_fn.sharded(state),
                                        ref_path, rank, world, _scatter_parts))
        losses.append(metrics["loss"])
        events.append((start, end))
        return metrics

    trainer.train_step = timed
    ring_all_gather.launches = ring_reduce_scatter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(loader, None, epochs=1)
    torch.cuda.synchronize()
    step_ms = [s.elapsed_time(e) for s, e in events]
    print("chip_smoke_zero1 " + json.dumps({
        "run": run, "rank": rank, "world": world,
        "backend": torch.distributed.get_backend(),
        "losses": [float(x) for x in losses], "step_ms": step_ms,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "k3a": ring_all_gather.launches, "k3b": ring_reduce_scatter.launches,
        "grad_gaps": gaps,
        "params_sha256": params_digest(model) if ckpt_dir else None,
        # a multi-process save is synchronous: the hold is the whole save
        "save_s": [r["hold_s"] for r in trainer._saver.records],
    }), flush=True)
    distributed.shutdown()
    return 0


def first_step_gaps(torch, update, ref_path, rank, world, scatter_parts):
    """Per leaf, ||g - g_ref|| / ||g_ref|| of the synced first-step
    gradients (tiles on their rank, replicated leaves whole) against the
    one-process run's, with the squares summed across ranks; on every
    rank, keyed by the port's parameter name."""
    from distributed_pytorch_example_tpu_torch.runtime import distributed

    ref = torch.load(ref_path)
    sums = []
    for leaf, p, tile, dim in zip(update.leaves, update.params, update.tiles,
                                  update.dims):
        want = leaf.to_jax(ref[leaf.name].to("cuda"))
        if tile is not None:
            rows, _ = scatter_parts(want, dim, world)
            got, want = tile.grad.reshape(-1), rows[rank]
            share = 1.0
        else:
            got = leaf.to_jax(p.grad).float().reshape(-1)
            want = want.reshape(-1)
            share = 1.0 / world  # whole on every rank: count it once
        sums.append(torch.stack([(got - want).square().sum() * share,
                                 want.square().sum() * share]))
    total = distributed.all_reduce_sum_(torch.stack(sums))
    return {leaf.name: (total[i, 0].sqrt()
                        / total[i, 1].sqrt().clamp_min(1e-30)).item()
            for i, leaf in enumerate(update.leaves)}


def zero1_path(torch, ref_losses, ref_grads, world=ZERO1_WORLD):
    """Phase 8: both ZeRO-1 runs in ``world`` processes (on one card, or
    one per card where there are enough), each held against the
    one-process replicated run (phase 6's first 4 steps, same seed, data
    and Adam); returns each kernel's launches on rank 0 over both runs."""
    from distributed_pytorch_example_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ref_path = str(_build.BUILD_DIR / "zero1_reference_grads.pt")
    torch.save(ref_grads, ref_path)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_zero1_")
    try:
        return zero1_runs(torch, ref_losses, ref_path, ckpt_dir, world)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def zero1_runs(torch, ref_losses, ref_path, ckpt_dir, world):
    results = {}
    for run in ZERO1_RUNS:
        port = free_port()
        procs = []
        for rank in range(world):
            env = {**os.environ, "REPLICAS": str(world),
                   "PROCESS_ID": str(rank), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--path-worker",
                 run, ref_path, ckpt_dir if run == "zero1" else ""],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        t0 = time.perf_counter()
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=600)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lines = {}
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            found = [line for line in out.splitlines()
                     if line.startswith("chip_smoke_zero1 ")]
            check(proc.returncode == 0 and found,
                  f"zero1 {run}: rank {rank} exit {proc.returncode}: "
                  f"{out[-3000:]}")
            lines[rank] = json.loads(found[-1].split(" ", 1)[1])
        say("zero1", f"{run}: {world} processes on "
                     f"{min(world, torch.cuda.device_count())} card(s) in "
                     f"{time.perf_counter() - t0:.1f} s (backend "
                     f"{lines[0]['backend']})")
        for rank, r in lines.items():
            losses = r["losses"]
            check(len(losses) == ZERO1_STEPS
                  and all(map(math.isfinite, losses)),
                  f"zero1 {run} rank {rank}: losses {losses}")
            worst = max(abs(a - b) for a, b in zip(losses, ref_losses))
            check(worst <= LOSS_TOL,
                  f"zero1 {run} rank {rank}: losses {losses} vs replicated "
                  f"{ref_losses[:ZERO1_STEPS]}: gap {worst:.3e} > {LOSS_TOL}")
            steady = sorted(r["step_ms"][1:])
            say("zero1", f"{run} rank {rank}: losses "
                         f"{[round(x, 4) for x in losses]} (replicated "
                         f"{[round(x, 4) for x in ref_losses[:ZERO1_STEPS]]},"
                         f" worst gap {worst:.3e}, tol {LOSS_TOL}); step ms "
                         f"{[round(x, 2) for x in r['step_ms']]} (median of "
                         f"steps 2+ {steady[len(steady) // 2]:.2f}); peak "
                         f"memory {r['peak_bytes'] / 2**30:.2f} GiB; K3a "
                         f"launches {r['k3a']}, K3b {r['k3b']}")
        gaps = {k: v for k, v in lines[0]["grad_gaps"].items()
                if not k.endswith("attn.k.bias")}
        worst_leaf = max(gaps, key=gaps.get)
        # run (ii)'s gradients are quantized: a block spans leaf joins, so
        # a small leaf beside a large one carries its neighbour's step;
        # its losses are held against run (i) below instead
        held = run == "zero1"
        check(not held or all(math.isfinite(v) and v <= ZERO1_GRAD_TOL
                              for v in gaps.values()),
              f"zero1 {run}: first-step gradient of {worst_leaf} differs from"
              f" the replicated run's by {gaps[worst_leaf]:.3e} > "
              f"{ZERO1_GRAD_TOL}")
        say("zero1", f"{run}: first-step gradients vs the one-process "
                     f"replicated run, ||g - g_ref|| / ||g_ref|| over "
                     f"{len(gaps)} leaves: worst {gaps[worst_leaf]:.3e} "
                     f"({worst_leaf}) "
                     + (f"(tol {ZERO1_GRAD_TOL}; attn.k.bias left out: zero "
                        "in exact arithmetic)" if held
                        else "(int8 blocks: reported, not held)"))
        results[run] = lines
        ZERO1_LOSSES[run] = lines[0]["losses"]
        if run == "zero1":
            zero1_checkpoint(torch, ckpt_dir, lines, world)
    plain = results["zero1"]
    lossy = results["zero1-int8"]
    for rank in range(world):
        gap = max(abs(a - b) for a, b in zip(plain[rank]["losses"],
                                             lossy[rank]["losses"]))
        check(gap <= LOSS_TOL, f"zero1: int8 wire losses differ from the "
                               f"fp32 run's by {gap:.3e} > {LOSS_TOL}")
        check(plain[rank]["k3b"] > 0 and lossy[rank]["k3a"] > 0,
              f"zero1 rank {rank}: K3b launches {plain[rank]['k3b']} in run "
              f"(i), K3a {lossy[rank]['k3a']} in run (ii); want both > 0")
    say("zero1", "int8-block wire + bf16 parameter gather: losses within "
                 f"{LOSS_TOL} of the fp32 ZeRO-1 run on every rank")
    return (sum(results[run][0]["k3a"] for run in ZERO1_RUNS),
            sum(results[run][0]["k3b"] for run in ZERO1_RUNS))


def zero1_checkpoint(torch, ckpt_dir, lines, world):
    """Phase 9 (d): rank 0's gathered ZeRO-1 checkpoint, loaded into a
    one-process model on the card, equals both ranks' parameters."""
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.robustness.integrity import (
        read_verified,
    )
    from distributed_pytorch_example_tpu_torch.train import (
        TrainState,
        load_checkpoint,
        make_optimizer,
    )
    from distributed_pytorch_example_tpu_torch.train.checkpoint import (
        LATEST_NAME,
    )
    from distributed_pytorch_example_tpu_torch.utils import msgpack

    path = os.path.join(ckpt_dir, LATEST_NAME)
    check(os.path.isfile(path), f"zero1: no gathered checkpoint at {path}")
    stamp = msgpack.msgpack_restore(read_verified(path))["mesh_manifest"]
    check(stamp["axes"] == {"data": world} and stamp["zero1_dims"],
          f"zero1: checkpoint stamp axes {stamp['axes']}, "
          f"{len(stamp['zero1_dims'])} ZeRO-1 leaves")
    model = GPT2(dtype=torch.bfloat16, logits_mode="hidden", device="cuda",
                 seed=3)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters(), "adam",
                                                1e-3))
    t0 = time.perf_counter()
    _, epoch, _ = load_checkpoint(path, state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    digest = params_digest(model)
    ranks = {rank: r["params_sha256"] for rank, r in lines.items()}
    check(all(d == digest for d in ranks.values()),
          f"zero1: parameters loaded from the gathered checkpoint "
          f"({digest[:16]}) differ from the ranks' ({ranks})")
    check(state.step == ZERO1_STEPS and epoch == 1,
          f"zero1: checkpoint step {state.step}, epoch {epoch}")
    say("zero1", f"zero1: rank 0's gathered checkpoint ({os.path.getsize(path)}"
                 f" bytes, stamped data={world} with "
                 f"{len(stamp['zero1_dims'])} ZeRO-1 leaves; synchronous "
                 f"save {[round(x * 1e3, 1) for x in lines[0]['save_s']]} "
                 f"ms on rank 0) loaded into one process on the card in "
                 f"{load_s * 1e3:.1f} ms: parameters equal both ranks' bit "
                 f"for bit (sha256 {digest[:16]})")
    del state, model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 9. checkpoint: save, load and resume at full width
# ---------------------------------------------------------------------------

CKPT_EVERY, CKPT_RETAIN = 5, 2
# the token ids the checkpoint phase draws from: the model (vocab 50257)
# learns in 10 steps to put its mass on them, so validation accuracy rises
# above 0 and the epoch writes `best`
CKPT_VOCAB = 256
# resumed steps 6-10 against the uninterrupted run's: the same kernels at
# the same shapes on bit-exact state; bit-equal is expected
RESUME_TOL = 1e-5


def ckpt_run(torch, seed, **trainer_kw):
    """A GPT-2 124M Trainer whose steps record their losses."""
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.train import (
        CausalLMTask,
        Trainer,
        make_optimizer,
    )

    model = GPT2(dtype=torch.bfloat16, logits_mode="hidden", device="cuda",
                 seed=seed)
    trainer = Trainer(model, CausalLMTask(),
                      make_optimizer(model.parameters(), "adam", 1e-3),
                      log_every=CKPT_EVERY, **trainer_kw)
    step_fn, losses = trainer.train_step, []

    def recording(state, batch):
        metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
        return metrics

    trainer.train_step = recording
    return trainer, losses


def ckpt_loaders(torch):
    from distributed_pytorch_example_tpu_torch.data import (
        DeviceLoader,
        SyntheticTokenDataset,
    )

    train_ds = SyntheticTokenDataset(TRAIN_STEPS * TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ, vocab_size=CKPT_VOCAB,
                                     seed=0)
    val_ds = SyntheticTokenDataset(TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                   vocab_size=CKPT_VOCAB, seed=1)
    return (DeviceLoader(train_ds, TRAIN_BATCH, device="cuda", seed=0),
            DeviceLoader(val_ds, TRAIN_BATCH, device="cuda", shuffle=False))


def same_state(torch, a, b):
    """Names of what differs between two train states, bit for bit:
    parameters, Adam moments and step tensors, step and update counts."""
    bad = [f"param {n}" for (n, p), (_, q) in zip(
        a.model.named_parameters(), b.model.named_parameters())
        if not torch.equal(p, q)]
    names = dict((id(p), n) for n, p in a.model.named_parameters())
    for p, q in zip(a.optimizer.params, b.optimizer.params):
        sa, sb = a.optimizer.optimizer.state[p], b.optimizer.optimizer.state[q]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            if not torch.equal(sa[key].cpu(), sb[key].cpu()):
                bad.append(f"{key} of {names.get(id(p), '?')}")
    if a.step != b.step or a.optimizer.updates != b.optimizer.updates:
        bad.append(f"step {a.step}/{b.step}, updates "
                   f"{a.optimizer.updates}/{b.optimizer.updates}")
    return bad


def checkpoint(torch):
    """Phase 9 (a)-(c) in a temporary directory."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        checkpoint_save_load(torch, os.path.join(tmp, "a"))
        checkpoint_cli(os.path.join(tmp, "cli"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def checkpoint_save_load(torch, ckdir):
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from distributed_pytorch_example_tpu_torch.train import (
        TrainState,
        load_checkpoint,
        make_optimizer,
    )
    from distributed_pytorch_example_tpu_torch.train import checkpoint as ck
    from distributed_pytorch_example_tpu_torch.models import GPT2

    # (a) one epoch of 10 steps, `latest` at step 5 and at the epoch's end
    trainer, losses = ckpt_run(torch, 0, checkpoint_dir=ckdir,
                               save_every_steps=CKPT_EVERY,
                               checkpoint_retain=CKPT_RETAIN)
    train_loader, val_loader = ckpt_loaders(torch)
    reset_counts()
    history = trainer.fit(train_loader, val_loader, epochs=1)
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    best = os.path.join(ckdir, ck.BEST_NAME)
    latest = os.path.join(ckdir, ck.LATEST_NAME)
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"checkpoint: losses {losses}")
    check(os.path.isfile(best) and os.path.isfile(latest),
          f"checkpoint: best {os.path.isfile(best)}, latest "
          f"{os.path.isfile(latest)} (val accuracy "
          f"{history[0]['val_accuracy']:.4f} %)")
    trail = ck._gathered_history_paths(latest)
    check(len(trail) == CKPT_RETAIN, f"checkpoint: history {trail}")
    records = trainer._saver.records
    saves = [(os.path.basename(r["path"]), r["hold_s"] * 1e3,
              r["wait_s"] * 1e3, r["copy_s"] * 1e3,
              (r["copy_s"] + r["write_s"]) * 1e3, r["bytes"])
             for r in records]
    say("checkpoint", f"(a) GPT-2 124M bf16, {TRAIN_STEPS} steps, losses "
                      f"{[round(x, 4) for x in losses]}, val accuracy "
                      f"{history[0]['val_accuracy']:.3f} %; saves in order "
                      f"(file: main-thread hold ms = wait for the previous "
                      f"write + copy to host; whole save ms = copy + write; "
                      f"bytes): "
                      + "; ".join(f"{n}: hold {h:.1f} = wait {w:.1f} + copy "
                                  f"{c:.1f}; whole {a:.1f}; {b}"
                                  for n, h, w, c, a, b in saves))
    model = GPT2(dtype=torch.bfloat16, logits_mode="hidden", device="cuda",
                 seed=1)
    fresh = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters(), "adam",
                                                1e-3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, epoch, extra = load_checkpoint(latest, fresh)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    bad = same_state(torch, trainer.state, fresh)
    check(not bad and epoch == 1,
          f"checkpoint: `latest` (epoch {epoch}) differs from the live run "
          f"in {len(bad)} place(s): {bad[:5]}")
    say("checkpoint", f"(a) `latest` loaded into a fresh model and optimizer"
                      f" on the card in {load_ms:.1f} ms: every parameter, "
                      f"Adam moment and step count equals the live run's bit"
                      f" for bit (epoch {epoch}, step {fresh.step}, "
                      f"best_accuracy {extra['best_accuracy']:.3f})")
    del fresh, model, trainer
    torch.cuda.empty_cache()

    # (b) resume from the step-5 history entry, take steps 6-10
    step5 = trail[-1]
    resumed, got = ckpt_run(torch, 2)
    train_loader, _ = ckpt_loaders(torch)
    reset_counts()
    resumed.fit(train_loader, None, epochs=1, resume=step5)
    torch.cuda.synchronize()
    fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    got = [float(x) for x in got]
    rest = TRAIN_STEPS - CKPT_EVERY
    check(len(got) == rest, f"checkpoint: resumed run took {len(got)} steps,"
                            f" want {rest}")
    gap = max(abs(a - b) for a, b in zip(got, losses[CKPT_EVERY:]))
    check(fwd == LAYERS * rest and bwd == LAYERS * rest,
          f"checkpoint: resumed run launched K1 forward {fwd}, backward "
          f"{bwd} times, want {LAYERS} x {rest}")
    check(gap <= RESUME_TOL,
          f"checkpoint: resumed losses {got} vs {losses[CKPT_EVERY:]}: gap "
          f"{gap:.3e} > {RESUME_TOL}")
    say("checkpoint", f"(b) resumed from {os.path.basename(step5)} (step "
                      f"{CKPT_EVERY}): steps {CKPT_EVERY + 1}-{TRAIN_STEPS} "
                      f"losses {[round(x, 4) for x in got]}, largest gap to "
                      f"the uninterrupted run {gap:.3e} (tol {RESUME_TOL}; "
                      f"bit-equal: {got == losses[CKPT_EVERY:]}); K1 "
                      f"launches fwd {fwd} bwd {bwd}")
    del resumed
    torch.cuda.empty_cache()


def checkpoint_cli(ckdir):
    """(c) SIGTERM after the first "Batch" line: rc 143 and `latest` with
    a cursor; the relaunch with --resume continues at that batch."""
    from distributed_pytorch_example_tpu_torch.robustness.integrity import (
        read_verified,
    )
    from distributed_pytorch_example_tpu_torch.utils import msgpack

    args = ["--model", "gpt2", "--dataset", "synthetic-tokens", "--seq-len",
            "1024", "--dtype", "bfloat16", "--batch-size", "16", "--epochs",
            "1", "--num-samples", "320", "--log-every", "1",
            "--checkpoint-dir", ckdir]
    cmd = [sys.executable, "-m", "distributed_pytorch_example_tpu_torch.train",
           *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    seen = []
    try:
        for line in proc.stdout:
            seen.append(line)
            if "Batch" in line:
                proc.send_signal(signal.SIGTERM)
                break
        seen += proc.stdout.readlines()
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log = "".join(seen)
    latest = os.path.join(ckdir, "latest_model.ckpt")
    check(rc == 143 and os.path.isfile(latest),
          f"checkpoint: SIGTERM'd CLI exit {rc}, latest "
          f"{os.path.isfile(latest)}: {log[-3000:]}")
    extra = msgpack.msgpack_restore(read_verified(latest))["extra"]
    check(extra.get("batch_in_epoch", 0) > 0,
          f"checkpoint: SIGTERM `latest` extra {extra}")
    say("checkpoint", f"(c) CLI SIGTERM'd after its first Batch line: exit "
                      f"{rc} in {time.perf_counter() - t0:.1f} s, `latest` at"
                      f" batch {extra['batch_in_epoch']}")
    t0 = time.perf_counter()
    res = subprocess.run(cmd + ["--resume", latest], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    log = res.stdout + res.stderr
    want = f"Resuming epoch 0 at batch {extra['batch_in_epoch']}"
    check(res.returncode == 0 and want in log
          and "Training completed" in log,
          f"checkpoint: --resume exit {res.returncode}: {log[-3000:]}")
    say("checkpoint", f"(c) --resume: exit 0 in {time.perf_counter() - t0:.1f}"
                      f" s, logged \"{want}/...\" and \"Training completed\"")


# ---------------------------------------------------------------------------
# 10. bert: BERT-base masked-LM training at full width and depth
# ---------------------------------------------------------------------------

BERT_PAD = 0
# BERT-base at initialisation collapses: by layer 11 the hidden states of
# all 512 positions point the same way (mean cosine 0.996), so the upper
# layers' q/k kernel gradients are 1000x smaller than their v/o ones and
# any bf16 path holds them only to a few percent: plain bf16 attention's
# first step is 4.7e-2 of their norm off a float32 step (H100, this
# phase). There phase 6's per-leaf GRAD_TOL between two bf16 runs measures
# the leaf's conditioning; each bf16 run is held instead to the float32
# step, the flash run within GRAD_TOL or within this factor of plain bf16
# attention's own gap (a kernel whose delta is off puts those leaves at
# O(1): 1.9 with delta from the bf16 O alone).
BERT_GRAD_SLACK = 2.0


def bert_datasets(pad):
    """10 x 16 synthetic training rows of 512 tokens over BERT's vocabulary
    and one validation batch. With ``pad``, every row but each seventh
    gets a padded tail (its length drawn from seed 2, at least 64 tokens
    kept), one validation row is all pad, and the pad id appears nowhere
    else."""
    import numpy as np

    from distributed_pytorch_example_tpu_torch.data import (
        SyntheticTokenDataset,
    )

    sets = (SyntheticTokenDataset(TRAIN_STEPS * TRAIN_BATCH, seq_len=BERT_SEQ,
                                  vocab_size=BERT_VOCAB, seed=0),
            SyntheticTokenDataset(TRAIN_BATCH, seq_len=BERT_SEQ,
                                  vocab_size=BERT_VOCAB, seed=1))
    if pad is not None:
        rng = np.random.default_rng(2)
        for ds in sets:
            tokens = ds.arrays["tokens"]
            tokens[tokens == pad] = pad + 1
            lens = rng.integers(64, BERT_SEQ + 1, len(tokens))
            lens[::7] = BERT_SEQ
            tokens[np.arange(BERT_SEQ)[None, :] >= lens[:, None]] = pad
        sets[1].arrays["tokens"][-1] = pad
    return sets


def bert_run(torch, use_flash, pad=None, dtype=None):
    """BERT-base MLM, bf16 unless ``dtype`` says otherwise, fused loss,
    through Trainer.fit (see :func:`fit_run`); the same seed draws the same
    masks in every run."""
    from distributed_pytorch_example_tpu_torch.models import BertBase
    from distributed_pytorch_example_tpu_torch.train.tasks import MLMTask

    model = BertBase(dtype=dtype or torch.bfloat16, logits_mode="hidden",
                     use_flash=use_flash, pad_token_id=pad, device="cuda",
                     seed=0)
    task = MLMTask(BERT_VOCAB, BERT_MASK_ID, pad_token_id=pad)
    return fit_run(torch, model, task, *bert_datasets(pad), TRAIN_BATCH)


def bert_masked_run(torch):
    """:func:`bert_run` with the pad id on padded batches, flash and
    plain attention; counts the K1 launches whose C call received the key
    mask (a wrapper around the library's entry points). Returns (launches
    fwd, bwd, masked fwd, masked bwd, losses, plain losses)."""
    import importlib

    # the module (the package exports a function of the same name)
    fa = importlib.import_module(
        "distributed_pytorch_example_tpu_torch.ops.flash_attention")
    real = fa._kernel_fn
    mask_arg = {"dpx_flash_fwd": 5, "dpx_flash_bwd": 8}  # the mask pointer
    masked = dict.fromkeys(mask_arg, 0)

    def spy(name):
        fn = real(name)
        if name not in mask_arg:
            return fn

        def call(*args):
            masked[name] += args[mask_arg[name]] is not None
            return fn(*args)
        return call

    reset_counts()
    fa._kernel_fn = spy
    try:
        losses = bert_run(torch, None, pad=BERT_PAD)[0]
    finally:
        fa._kernel_fn = real
    launched = (fa.flash_attention_fwd.launches,
                fa.flash_attention_bwd.launches)
    plain = bert_run(torch, False, pad=BERT_PAD)[0]
    return (*launched, masked["dpx_flash_fwd"], masked["dpx_flash_bwd"],
            losses, plain)


def bert(torch, smi_line):
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    reset_counts()
    losses, step_ms, history, peak, grads = bert_run(torch, None)
    torch.cuda.synchronize()
    fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"bert: losses {losses}")
    check(math.isfinite(history[0]["val_loss"]),
          f"bert: validation loss {history[0]['val_loss']}")
    check(fwd == LAYERS * (TRAIN_STEPS + 1) and bwd == LAYERS * TRAIN_STEPS,
          f"bert: flash launched fwd {fwd} bwd {bwd} times, want "
          f"{LAYERS} x ({TRAIN_STEPS} steps + 1 validation batch) and "
          f"{LAYERS} x {TRAIN_STEPS}")
    median = sorted(step_ms[2:])[len(step_ms[2:]) // 2]
    tokens = TRAIN_BATCH * BERT_SEQ
    say("bert", f"{smi_line}: BERT-base MLM bf16 fused loss, Adam, batch "
                f"{TRAIN_BATCH} x {BERT_SEQ}: {TRAIN_STEPS} steps, losses "
                f"{[round(x, 4) for x in losses]}, val loss "
                f"{history[0]['val_loss']:.4f}; step ms {step_ms} (median of "
                f"steps 3+ {median:.2f} ms = {tokens / median * 1e3:.0f} "
                f"tokens/s); peak memory {peak / 2**30:.2f} GiB; K1 launches "
                f"fwd {fwd} bwd {bwd}")
    plain, plain_ms, _, plain_peak, plain_grads = bert_run(torch, False)
    worst = max(abs(a - b) for a, b in zip(losses, plain))
    check(worst <= LOSS_TOL,
          f"bert: flash vs plain attention losses differ by {worst:.3e} > "
          f"{LOSS_TOL} ({losses} vs {plain})")
    # first-step gradients against a float32 plain-attention step on the
    # same batch and masks: the flash run's gap within GRAD_TOL, or within
    # BERT_GRAD_SLACK x the bf16 plain run's own gap where that is larger
    # (the upper layers' q/k leaves under rank collapse, see BERT_GRAD_SLACK)
    ref = bert_run(torch, False, dtype=torch.float32)[4]
    gaps = gradient_gaps(grads, ref)
    plain_gaps = gradient_gaps(plain_grads, ref)
    bound = {name: max(GRAD_TOL, BERT_GRAD_SLACK * plain_gaps[name])
             for name in gaps}
    over = {name: gap for name, gap in gaps.items()
            if not (math.isfinite(gap) and gap <= bound[name])}
    worst_leaf = max(gaps, key=lambda name: gaps[name] / bound[name])
    check(not over,
          f"bert: first-step gradients off the float32 step beyond "
          f"max({GRAD_TOL}, {BERT_GRAD_SLACK} x plain bf16's gap): "
          + ", ".join(f"{name} {gap:.3e} (plain {plain_gaps[name]:.3e})"
                      for name, gap in over.items()))
    mutual = gradient_gaps(grads, plain_grads)
    worst_mutual = max(mutual, key=mutual.get)
    worst_plain = max(plain_gaps, key=plain_gaps.get)
    plain_median = sorted(plain_ms[2:])[len(plain_ms[2:]) // 2]
    say("bert", f"plain attention, same seed, batches and masks: worst "
                f"per-step loss gap {worst:.3e} (tol {LOSS_TOL}); median "
                f"step {plain_median:.2f} ms; peak memory "
                f"{plain_peak / 2**30:.2f} GiB. First-step gradients against "
                f"a float32 plain step, ||g - g_f32|| / ||g_f32|| over "
                f"{len(gaps)} leaves: flash worst {gaps[worst_leaf]:.3e} "
                f"({worst_leaf}; bound {bound[worst_leaf]:.3e}), plain bf16 "
                f"worst {plain_gaps[worst_plain]:.3e} ({worst_plain}); flash "
                f"against plain bf16 worst {mutual[worst_mutual]:.3e} "
                f"({worst_mutual})")
    mfwd, mbwd, mask_fwd, mask_bwd, padded, padded_plain = bert_masked_run(
        torch)
    check(all(map(math.isfinite, padded)), f"bert: padded losses {padded}")
    check((mfwd, mbwd) == (fwd, bwd) and (mask_fwd, mask_bwd) == (fwd, bwd),
          f"bert: with pad_token_id K1 launched fwd {mfwd} bwd {mbwd}, with "
          f"the key mask {mask_fwd} / {mask_bwd}; want {fwd} / {bwd}, all "
          "masked")
    gap = max(abs(a - b) for a, b in zip(padded, padded_plain))
    check(gap <= LOSS_TOL, f"bert: padded flash vs plain losses differ by "
                           f"{gap:.3e} > {LOSS_TOL}")
    say("bert", f"pad_token_id={BERT_PAD} on padded tails: K1 fwd {mfwd} "
                f"bwd {mbwd}, every one with the key mask; losses "
                f"{[round(x, 4) for x in padded]}, worst gap to plain "
                f"attention {gap:.3e} (tol {LOSS_TOL})")
    cmd = [sys.executable, "-m", "distributed_pytorch_example_tpu_torch.train",
           "--model", "bert-base", "--dataset", "synthetic-tokens", "--dtype",
           "bfloat16", "--optimizer", "lamb", "--seq-len", str(BERT_SEQ),
           "--batch-size", str(TRAIN_BATCH), "--epochs", "1",
           "--num-samples", "64", "--checkpoint-dir", ""]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    log = proc.stdout + proc.stderr
    check(proc.returncode == 0 and "Training completed" in log,
          f"bert CLI exit {proc.returncode}: {log[-3000:]}")
    tail = [line.split("] ", 1)[-1] for line in log.splitlines()
            if "Throughput" in line or "Training completed" in line
            or "Val Loss" in line]
    say("bert", f"{' '.join(cmd[1:])} in {time.perf_counter() - t0:.1f} s: "
                f"{tail}")
    return fwd, bwd


# ---------------------------------------------------------------------------
# 11. vision: ResNet-50 and ViT-B/16 training with BatchNorm state
# ---------------------------------------------------------------------------

VISION_SIZE, VISION_CLASSES = 224, 1000
VISION_BATCH = {"resnet50": 128, "vit-b16": 64}
# First-step gradients, bf16 compute against a float32 step on the same
# weights and batch, per leaf ||g - g_f32|| / ||g_f32||, held as phase 10
# holds BERT's: within GRAD_TOL, or within BERT_GRAD_SLACK x the gap of a
# second bf16 rounding of the same step (torch.autocast over the float32
# model: convolutions and matmuls in bf16, the head too). ResNet at
# initialisation is ill-conditioned that way: its BatchNorm biases and
# scales sum many terms that nearly cancel, so any bf16 rounding of the
# step leaves them tenths of their norm off float32 (this phase prints
# the port's gap beside autocast's); a wrong backward term puts a leaf
# at O(1), also where autocast's gap is small. A leaf
# whose float32 gradient is exactly zero (the convolutions behind a
# zero-initialised BatchNorm scale, at the first step) must be exactly
# zero in bf16 too. ViT's attn.k.bias is left out (zero in exact
# arithmetic, as in phase 6).
# float32 eval logits, the card (TF32 off: cuDNN's float32 convolutions,
# full-precision matmuls) against the same model on the CPU, both float32
# with other summation orders: max |d| <= this x max |logit|
VISION_FWD_TOL = 1e-3
# the space-to-depth stem against the plain 7x7/2 stem on the card,
# float32 (TF32 off), the same sums regrouped: max |d| <= this x max |out|
S2D_TOL = 1e-5


def forward_flops(torch, model, size):
    """Multiply-adds x 2 of one image's forward at ``size`` x ``size``,
    from the layers' shapes: a transformer's patch conv, every dense
    layer at its token count and the two attention products (2 x 2 S^2 D
    a layer); a ResNet's convolutions from the output shapes of a batch-1
    eval forward (hooks) and its head."""
    head = 2 * model.head.in_features * model.head.out_features
    encoder = getattr(model, "encoder", None)
    if encoder is not None:
        p, dim = model.patch_size, model.model_dim
        seq = model.pos_embed.shape[1]
        total = 2 * (size // p) ** 2 * dim * 3 * p * p + head
        for layer in encoder.layers:
            for lin in (layer.attn.q, layer.attn.k, layer.attn.v,
                        layer.attn.o, layer.mlp.up, layer.mlp.down):
                total += 2 * seq * lin.in_features * lin.out_features
            total += 4 * seq * seq * dim
        return total
    flops = []

    def hook(module, args, out):
        kh, kw = module.kernel_size
        flops.append(2 * out.numel() * module.in_channels * kh * kw)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    model.eval()
    try:
        with torch.no_grad():
            model(torch.zeros(1, size, size, 3, device=model.device))
    finally:
        for h in handles:
            h.remove()
    return sum(flops) + head


def vision_model(torch, name, dtype, seed=0, **kw):
    from distributed_pytorch_example_tpu_torch.models import get_model

    if name.startswith("vit"):
        kw["image_size"] = VISION_SIZE
    return get_model(name, num_classes=VISION_CLASSES, dtype=dtype,
                     device="cuda", seed=seed, **kw)


def vision_data(name):
    from distributed_pytorch_example_tpu_torch.data import (
        SyntheticImageDataset,
    )

    batch = VISION_BATCH[name]
    kw = dict(image_size=VISION_SIZE, num_classes=VISION_CLASSES)
    return (SyntheticImageDataset(TRAIN_STEPS * batch, seed=0, **kw),
            SyntheticImageDataset(batch, seed=1, **kw), batch)


def first_batch(torch, train_ds, batch):
    """The first training batch fit_run's loader hands the step."""
    from distributed_pytorch_example_tpu_torch.data import DeviceLoader

    loader = DeviceLoader(train_ds, batch, device="cuda", seed=0, prefetch=0)
    loader.set_epoch(0)
    return next(iter(loader))


def bn_stats(torch, model):
    from distributed_pytorch_example_tpu_torch.models.batchnorm import (
        running_stats,
    )

    return running_stats(model)


def vision_fit(torch, name, smi_line):
    """(a) / (b): bf16 training through Trainer.fit; returns the first
    step's gradients, the train set and the per-step ms."""
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from distributed_pytorch_example_tpu_torch.train import (
        ClassificationTask,
    )

    train_ds, val_ds, batch = vision_data(name)
    model = vision_model(torch, name, torch.bfloat16)
    flops = forward_flops(torch, model, VISION_SIZE)
    reset_counts()
    losses, step_ms, history, peak, grads = fit_run(
        torch, model, ClassificationTask(), train_ds, val_ds, batch)
    torch.cuda.synchronize()
    launched = flash_attention_fwd.launches + flash_attention_bwd.launches
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"vision {name}: losses {losses}")
    check(math.isfinite(history[0]["val_loss"]),
          f"vision {name}: validation loss {history[0]['val_loss']}")
    # ViT's 197 tokens take the plain attention path (use_flash=None), as
    # XLA's does in the JAX package; ResNet has no attention
    check(launched == 0, f"vision {name}: K1 launched {launched} times")
    stats = bn_stats(torch, model)
    if name.startswith("resnet"):
        init = [torch.zeros_like(t) if i % 2 == 0 else torch.ones_like(t)
                for i, t in enumerate(stats)]
        check(stats and all(bool(torch.isfinite(t).all()) for t in stats),
              f"vision {name}: running statistics not finite")
        moved = sum(not torch.equal(t, i) for t, i in zip(stats, init))
        check(moved == len(stats), f"vision {name}: only {moved} of "
                                   f"{len(stats)} running statistics moved")
    median = sorted(step_ms[2:])[len(step_ms[2:]) // 2]
    images = batch / median * 1e3
    share = images * 3 * flops / _BF16_PEAK
    say("vision", f"{smi_line}: {name} bf16, Adam, batch {batch} x "
                  f"{VISION_SIZE}^2, {VISION_CLASSES} classes, "
                  f"{sum(p.numel() for p in model.parameters()):,} "
                  f"parameters: {TRAIN_STEPS} steps, losses "
                  f"{[round(x, 4) for x in losses]}, val loss "
                  f"{history[0]['val_loss']:.4f}; step ms "
                  f"{[round(x, 2) for x in step_ms]} (median of steps 3+ "
                  f"{median:.2f} ms = {images:.1f} images/s); peak memory "
                  f"{peak / 2**30:.2f} GiB; forward {flops / 1e9:.3f} "
                  f"GFLOP/image (conv and dense shapes), x3 for a step: "
                  f"{share:.3f} of the bf16 dense peak "
                  f"({_BF16_PEAK / 1e12:.0f} TFLOP/s); cudnn.benchmark "
                  f"{torch.backends.cudnn.benchmark}; "
                  + (f"running statistics {len(stats)} tensors, finite and "
                     "moved" if stats else "no BatchNorm"))
    return grads, train_ds, batch


def vision_against_float32(torch, name, grads, train_ds, batch):
    """(c): the first step in float32 on the card against the bf16 run's,
    per leaf; then the float32 model's eval logits on the card against
    the same model's on the CPU."""
    import copy

    import numpy as np

    from distributed_pytorch_example_tpu_torch.train import (
        ClassificationTask,
        TrainState,
        build_train_step,
        make_optimizer,
    )

    model = vision_model(torch, name, torch.float32)
    batch_data = first_batch(torch, train_ds, batch)
    model.train()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        logits = model(batch_data["x"])
    torch.nn.functional.cross_entropy(logits.float(),
                                      batch_data["y"].long()).backward()
    autocast = {n: p.grad.detach().to("cpu", copy=True)
                for n, p in model.named_parameters() if p.grad is not None}
    del logits
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        model.parameters(), "adam", 1e-3))
    build_train_step(ClassificationTask())(state, batch_data)
    ref = {n: p.grad.detach().to("cpu", copy=True)
           for n, p in model.named_parameters() if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    gaps = gradient_gaps(grads, ref)
    second = gradient_gaps(autocast, ref)
    zero = [n for n, g in ref.items() if not bool(g.any())
            and not n.endswith("attn.k.bias")]
    check(all(not bool(grads[n].any()) for n in zero),
          f"vision {name}: a leaf with a zero float32 gradient is not zero "
          "in bf16")
    live = {n: g for n, g in gaps.items() if n not in zero}
    bound = {n: max(GRAD_TOL, BERT_GRAD_SLACK * second[n]) for n in live}
    worst = max(live, key=lambda n: live[n] / bound[n])
    over = {n: g for n, g in live.items()
            if not (math.isfinite(g) and g <= bound[n])}
    check(not over,
          f"vision {name}: first-step gradients off the float32 step beyond "
          f"max({GRAD_TOL}, {BERT_GRAD_SLACK} x autocast's gap): "
          + ", ".join(f"{n} {g:.3e} (autocast {second[n]:.3e})"
                      for n, g in over.items()))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, VISION_SIZE, VISION_SIZE, 3), dtype=np.float32))
    cpu_model = copy.deepcopy(model).cpu().eval()
    model.eval()
    with torch.no_grad():
        got = model(x.cuda()).cpu()
        want = cpu_model(x)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= VISION_FWD_TOL * scale,
          f"vision {name}: float32 eval logits card vs CPU off by {err:.3e} "
          f"> {VISION_FWD_TOL} x {scale:.3e}")
    worst_abs = max(live, key=live.get)
    say("vision", f"{name}: first-step gradients bf16 vs a float32 step on "
                  f"the card, ||g - g_f32|| / ||g_f32|| over {len(live)} "
                  f"leaves: worst {live[worst_abs]:.3e} ({worst_abs}; "
                  f"autocast's {second[worst_abs]:.3e}), nearest its bound "
                  f"{live[worst]:.3e} ({worst}; bound {bound[worst]:.3e}); "
                  f"{len(zero)} leaves exactly zero in both; float32 eval logits (after that step) card vs CPU "
                  f"at batch 4: max |d| {err:.3e} of max |logit| "
                  f"{scale:.3e} (tol {VISION_FWD_TOL} x)")
    del model, cpu_model, state
    torch.cuda.empty_cache()


def vision_s2d(torch):
    """(d): the space-to-depth stem against the plain 7x7/2 stem."""
    s2d = vision_model(torch, "resnet50", torch.float32,
                       space_to_depth_stem=True)
    plain = vision_model(torch, "resnet50", torch.float32)
    with torch.no_grad():
        plain.stem_conv.weight.copy_(
            s2d.stem_conv_kernel.permute(3, 2, 0, 1))
        x = torch.randn(4, 3, VISION_SIZE, VISION_SIZE, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(6))
        x = x.contiguous(memory_format=torch.channels_last)
        got, want = s2d._stem_s2d(x), plain.stem_conv(x)
    err = (got - want).abs().max().item()
    check(got.shape == want.shape and err <= S2D_TOL * want.abs().max().item(),
          f"vision: s2d stem {tuple(got.shape)} off the plain stem "
          f"{tuple(want.shape)} by {err:.3e}")
    say("vision", f"space-to-depth stem = plain 7x7/2 stem at "
                  f"{VISION_SIZE}: {tuple(got.shape)}, max |d| {err:.3e} "
                  f"(tol {S2D_TOL} x max |out|)")


def vision_poisoned(torch):
    """(e): a NaN pixel on the card: the step is skipped and the running
    statistics, parameters and moments stay bit-equal."""
    from distributed_pytorch_example_tpu_torch.train import (
        ClassificationTask,
        TrainState,
        build_train_step,
        make_optimizer,
    )

    model = vision_model(torch, "resnet50", torch.bfloat16)
    optimizer = make_optimizer(model.parameters(), "adam", 1e-3)
    state = TrainState(step=0, model=model, optimizer=optimizer)
    step = build_train_step(ClassificationTask())
    gen = torch.Generator("cuda").manual_seed(7)
    batch = {"x": torch.randn(16, VISION_SIZE, VISION_SIZE, 3, device="cuda",
                              generator=gen),
             "y": torch.randint(0, VISION_CLASSES, (16,), device="cuda",
                                generator=gen)}
    step(state, batch)

    def snapshot():
        moments = [t for st in optimizer.optimizer.state.values()
                   for t in st.values() if torch.is_tensor(t)]
        return [t.clone() for t in (*model.state_dict().values(), *moments)]

    before = snapshot()
    stats_before = [t.clone() for t in bn_stats(torch, model)]
    poisoned = {**batch, "x": batch["x"].clone()}
    poisoned["x"][3, VISION_SIZE // 2, VISION_SIZE // 4, 1] = float("nan")
    bad = float(step(state, poisoned)["bad_step"])
    after = snapshot()
    check(bad == 1.0, f"vision: poisoned step bad_step {bad}")
    stats_after = bn_stats(torch, model)
    check(all(torch.equal(a, b) for a, b in zip(stats_after, stats_before)),
          "vision: the skipped step changed the running statistics")
    check(len(after) == len(before)
          and all(torch.equal(a, b) for a, b in zip(after, before)),
          "vision: the skipped step changed parameters or moments")
    say("vision", f"poisoned step (NaN in one pixel, ResNet-50 bf16, batch "
                  f"16): bad_step {bad:.0f}; {len(stats_after)} running "
                  f"statistics, {len(after)} parameter / buffer / moment "
                  "tensors bit-equal to before the step")


def vision_attention_timing(torch):
    """Informational, no check: one ViT-B/16 attention layer (64 x 197 x
    12 x 64, bf16, forward + backward) through the plain path (the port's
    and JAX's choice at 197 tokens), K1's explicit lane-padded path and
    SDPA."""
    import torch.nn.functional as F

    from distributed_pytorch_example_tpu_torch.ops import attention

    gen = torch.Generator("cuda").manual_seed(8)
    shape = (64, 197, 12, 64)
    q, k, v = (torch.randn(shape, device="cuda", dtype=torch.bfloat16,
                           generator=gen).requires_grad_() for _ in range(3))
    do = torch.randn(shape, device="cuda", dtype=torch.bfloat16,
                     generator=gen)
    paths = {
        "plain": lambda: attention.dot_product_attention(q, k, v,
                                                         use_flash=False),
        "K1 lane-padded": lambda: attention.dot_product_attention(
            q, k, v, use_flash=True),
        "SDPA": lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2)).transpose(1, 2),
    }
    out = {}
    for label, fn in paths.items():
        def run():
            fn().backward(do)
        for _ in range(3):
            run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            run()
        end.record()
        end.synchronize()
        out[label] = round(start.elapsed_time(end) / 20, 4)
    say("vision", f"ViT-B/16 attention layer {shape} bf16, forward + "
                  f"backward ms (informational; the dispatch is unchanged): "
                  f"{json.dumps(out)}")


def vision_cli():
    """(f): the training CLI on ResNet-18 at 32 x 32."""
    cmd = [sys.executable, "-m", "distributed_pytorch_example_tpu_torch.train",
           "--model", "resnet18", "--dataset", "synthetic-image",
           "--image-size", "32", "--dtype", "bfloat16", "--epochs", "1",
           "--num-samples", "512", "--batch-size", "128",
           "--checkpoint-dir", ""]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    log = proc.stdout + proc.stderr
    check(proc.returncode == 0 and "Training completed" in log,
          f"vision CLI exit {proc.returncode}: {log[-3000:]}")
    tail = [line.split("] ", 1)[-1] for line in log.splitlines()
            if "Throughput" in line or "Training completed" in line
            or "Val Loss" in line]
    say("vision", f"{' '.join(cmd[1:])} in {time.perf_counter() - t0:.1f} "
                  f"s: {tail}")


def vision(torch, smi_line):
    for name in ("resnet50", "vit-b16"):
        grads, train_ds, batch = vision_fit(torch, name, smi_line)
        vision_against_float32(torch, name, grads, train_ds, batch)
        del grads, train_ds
        torch.cuda.empty_cache()
    vision_s2d(torch)
    vision_poisoned(torch)
    vision_cli()
    vision_attention_timing(torch)


# ---------------------------------------------------------------------------
# 12. llama: LLaMA (RoPE, RMSNorm, SwiGLU, GQA 12/4) trained and served
# ---------------------------------------------------------------------------

LLAMA_KV_HEADS, LLAMA_VOCAB, LLAMA_MAX_BLOCKS = 4, 32000, 128
# K1 at LLaMA's training shape and at its max_len, the same 16k tokens:
# sequence length -> batch
LLAMA_FLASH = {1024: 16, 2048: 8}
LLAMA_REMAT_STEPS = 3
# the ZeRO-1 lamb run: LLaMA's width at depth 2, two processes on the card
LLAMA_ZERO1_LAYERS, LLAMA_ZERO1_STEPS = 2, 2
# ZeRO-1 lamb against lamb on whole leaves fed the same synced gradients:
# the tiles' squared norms are summed across ranks in float32, so only
# that sum's rounding separates them, ||u - u_ref|| / ||u_ref|| per leaf
LAMB_TILE_TOL = 1e-4
# remat against no remat, the same BERT step with dropout on the card,
# ||g - g_ref|| / ||g_ref|| per leaf: the recompute repeats the same
# kernels on the same inputs, so any gap is a reduction order at most; a
# mask drawn differently in the recompute puts a leaf at O(1)
REMAT_TOL = 1e-3
# K2 at LLaMA's serving geometry (12 query heads over 4 kv heads, 128
# blocks of 16 per row): lengths on and around block edges up to the
# full table
LLAMA_LENS = (0, 15, 16, 17, 511, 1024, 2000, 2047)


def flash_gqa_bound(bandwidth, B, S, N, KVH, H):
    """{kind: (bound ms, by, bytes, flops)} of K1 in bf16, causal, with
    N query heads over KVH kv heads: each input read once, each output
    written once; the causal triangle's products, 2 flops a
    multiply-add (forward q.k^T and p.v; backward the q.k^T recompute,
    dO.v^T, p^T.dO, ds^T.q, ds.k)."""
    q_elem, kv_elem = B * S * N * H * 2, B * S * KVH * H * 2
    row = B * N * S * 4
    tri = B * N * H * S * (S + 1)
    out = {}
    for kind, nbytes, flops in (
            ("fwd", 2 * q_elem + 2 * kv_elem + row, 2 * tri),
            ("bwd", 4 * q_elem + 4 * kv_elem + row, 5 * tri)):
        bytes_ms = nbytes / bandwidth * 1e3
        ops_ms = flops / _BF16_PEAK * 1e3
        out[kind] = (max(bytes_ms, ops_ms),
                     "bytes" if bytes_ms >= ops_ms else "operations",
                     nbytes, flops)
    return out


def llama_flash(torch, bandwidth):
    """(a) K1 at LLaMA's GQA 12/4 shapes, bf16 causal, forward and
    backward against the plain versions, then timed beside the bound and
    SDPA with ``enable_gqa``; returns the ``llama`` fields of the K1
    entries, by sequence length."""
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    N, KVH, H = HEADS, LLAMA_KV_HEADS, HEAD_DIM
    fields = {"fwd": {}, "bwd": {}}
    for S, B in LLAMA_FLASH.items():
        q, k, v, do, _ = flash_case(torch, batch=B, heads=N, kv_heads=KVH,
                                    seq=S, head_dim=H, dtype=torch.bfloat16,
                                    masked=False, seed=S)
        args = dict(causal=True, kv_mask=None, softmax_scale=H ** -0.5)
        o, lse = flash_attention_fwd(q, k, v, **args)
        grads = flash_attention_bwd(q, k, v, o, lse, do, **args)
        ro, rlse = flash_attention_fwd_reference(q, k, v, **args)
        rgrads = flash_attention_bwd_reference(q, k, v, o, lse, do, **args)
        torch.cuda.synchronize()
        errs = flash_errors(torch, (o, lse, *grads), (ro, rlse, *rgrads))
        tols = FLASH_TOL["bfloat16"]
        for key, err in errs.items():
            check(math.isfinite(err) and err <= tols[key],
                  f"K1 llama S={S}: {key} error {err:.3e} > tol "
                  f"{tols[key]:.0e}")
        max_abs = {"fwd": (o.float() - ro.float()).abs().max().item(),
                   "bwd": max((g.float() - r.float()).abs().max().item()
                              for g, r in zip(grads, rgrads))}
        del ro, rlse, rgrads
        say("llama", f"K1 bf16 causal GQA {N}/{KVH} B={B} S={S} H={H}: "
                     + ", ".join(f"{key} {err:.3e} (tol {tols[key]:.0e})"
                                 for key, err in errs.items()))
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        sdpa_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

        def sdpa_bwd():
            return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                       retain_graph=True)

        def sdpa_fwd():
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

        backend = sdpa_backend(torch, qt, kt, vt, is_causal=True,
                               enable_gqa=True)
        ms = {}
        for label, fn, iters in (
            ("fwd_plain", lambda: flash_attention_fwd_reference(
                q, k, v, **args), 3),
            ("fwd", lambda: flash_attention_fwd(q, k, v, **args), 20),
            ("fwd2", lambda: flash_attention_fwd(q, k, v, **args), 20),
            ("fwd_plain2", lambda: flash_attention_fwd_reference(
                q, k, v, **args), 3),
            ("bwd_plain", lambda: flash_attention_bwd_reference(
                q, k, v, o, lse, do, **args), 3),
            ("bwd", lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                **args), 20),
            ("bwd2", lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                 **args), 20),
            ("bwd_plain2", lambda: flash_attention_bwd_reference(
                q, k, v, o, lse, do, **args), 3),
            ("sdpa_fwd", sdpa_fwd, 20),
            ("sdpa_bwd", sdpa_bwd, 20),
        ):
            ms[label] = time_cold(torch, fn, iters=iters)
        for kind, (bound, by, nbytes, flops) in flash_gqa_bound(
                bandwidth, B, S, N, KVH, H).items():
            entry = {
                "shape": f"B={B} N={N} KVH={KVH} S={S} H={H} bf16 causal",
                # (b)'s count at S = 1024; no main-path run counts S = 2048
                "launches": None,
                "max_abs_err": max_abs[kind],
                "ms": min(ms[kind], ms[kind + "2"]),
                "plain_ms": min(ms[kind + "_plain"], ms[kind + "_plain2"]),
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": ms["sdpa_" + kind],
                "library_backend": backend,
            }
            fields[kind][str(S)] = entry
            say("llama", f"flash_attention_{kind} {entry['shape']}: kernel "
                         f"{ms[kind]:.4f}/{ms[kind + '2']:.4f} ms, plain "
                         f"{ms[kind + '_plain']:.4f}/"
                         f"{ms[kind + '_plain2']:.4f} ms, SDPA enable_gqa "
                         f"{ms['sdpa_' + kind]:.4f} ms ("
                         f"{'forward' if kind == 'fwd' else 'backward alone'}"
                         f"; {backend}), bound {bound:.4f} ms "
                         f"({nbytes} bytes, {flops} flops)")
        del q, k, v, do, o, lse, grads, qt, kt, vt, dot, sdpa_out
        torch.cuda.empty_cache()
    return fields


def llama_run(torch, use_flash, dtype=None, remat=False, steps=None):
    """LLaMA at the JAX package's defaults (12 layers of 768, 12 heads over
    4 kv heads, MLP 2048, vocab 32000), bf16 unless ``dtype`` says
    otherwise, fused loss, through Trainer.fit (see :func:`fit_run`) on
    the first ``steps`` of 10 batches of 16 x 1024 synthetic tokens."""
    from distributed_pytorch_example_tpu_torch.data import (
        SyntheticTokenDataset,
    )
    from distributed_pytorch_example_tpu_torch.models import Llama
    from distributed_pytorch_example_tpu_torch.train import CausalLMTask

    model = Llama(dtype=dtype or torch.bfloat16, logits_mode="hidden",
                  use_flash=use_flash, remat=remat, device="cuda", seed=0)
    train_ds = SyntheticTokenDataset(TRAIN_STEPS * TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ,
                                     vocab_size=LLAMA_VOCAB, seed=0)
    val_ds = SyntheticTokenDataset(TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                   vocab_size=LLAMA_VOCAB, seed=1)
    return fit_run(torch, model, CausalLMTask(), train_ds, val_ds,
                   TRAIN_BATCH, steps=steps)


def llama_train(torch, smi_line):
    """(b) and (c): LLaMA trained at full width and depth, against plain
    attention and a float32 step, then with ``remat``. Returns K1's
    launches in (b)'s run."""
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    reset_counts()
    losses, step_ms, history, peak, grads = llama_run(torch, None)
    torch.cuda.synchronize()
    fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"llama: losses {losses}")
    check(math.isfinite(history[0]["val_loss"]),
          f"llama: validation loss {history[0]['val_loss']}")
    check(fwd == LAYERS * (TRAIN_STEPS + 1) and bwd == LAYERS * TRAIN_STEPS,
          f"llama: flash launched fwd {fwd} bwd {bwd} times, want "
          f"{LAYERS} x ({TRAIN_STEPS} steps + 1 validation batch) and "
          f"{LAYERS} x {TRAIN_STEPS}")
    steady = sorted(step_ms[2:])
    median = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say("llama", f"{smi_line}: LLaMA (12 x 768, GQA 12/4, vocab 32000) bf16 "
                 f"fused loss, Adam, batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
                 f"{TRAIN_STEPS} steps, losses "
                 f"{[round(x, 4) for x in losses]}, val loss "
                 f"{history[0]['val_loss']:.4f}; step ms "
                 f"{[round(x, 2) for x in step_ms]} (median of steps 3+ "
                 f"{median:.2f} ms = {tokens / median * 1e3:.0f} tokens/s); "
                 f"peak memory {peak / 2**30:.2f} GiB; K1 launches fwd {fwd} "
                 f"bwd {bwd}")
    plain, plain_ms, _, plain_peak, plain_grads = llama_run(torch, False)
    worst = max(abs(a - b) for a, b in zip(losses, plain))
    check(worst <= LOSS_TOL,
          f"llama: flash vs plain attention losses differ by {worst:.3e} > "
          f"{LOSS_TOL} ({losses} vs {plain})")
    # first-step gradients against a float32 plain-attention step on the
    # same batch: within GRAD_TOL, or within BERT_GRAD_SLACK x plain bf16
    # attention's own gap where that is larger (phase 10's bound)
    ref = llama_run(torch, False, dtype=torch.float32, steps=1)[4]
    gaps = gradient_gaps(grads, ref)
    plain_gaps = gradient_gaps(plain_grads, ref)
    bound = {name: max(GRAD_TOL, BERT_GRAD_SLACK * plain_gaps[name])
             for name in gaps}
    over = {name: gap for name, gap in gaps.items()
            if not (math.isfinite(gap) and gap <= bound[name])}
    check(not over,
          f"llama: first-step gradients off the float32 step beyond "
          f"max({GRAD_TOL}, {BERT_GRAD_SLACK} x plain bf16's gap): "
          + ", ".join(f"{name} {gap:.3e} (plain {plain_gaps[name]:.3e})"
                      for name, gap in over.items()))
    worst_leaf = max(gaps, key=lambda name: gaps[name] / bound[name])
    worst_abs = max(gaps, key=gaps.get)
    worst_plain = max(plain_gaps, key=plain_gaps.get)
    plain_median = sorted(plain_ms[2:])[len(plain_ms[2:]) // 2]
    say("llama", f"plain attention, same seed and batches: losses "
                 f"{[round(x, 4) for x in plain]}, worst per-step gap "
                 f"{worst:.3e} (tol {LOSS_TOL}); median step "
                 f"{plain_median:.2f} ms; peak memory "
                 f"{plain_peak / 2**30:.2f} GiB. First-step gradients "
                 f"against a float32 plain step, ||g - g_f32|| / ||g_f32|| "
                 f"over {len(gaps)} leaves: flash worst {gaps[worst_abs]:.3e}"
                 f" ({worst_abs}), nearest its bound {gaps[worst_leaf]:.3e} "
                 f"({worst_leaf}; bound {bound[worst_leaf]:.3e}); plain bf16"
                 f" worst {plain_gaps[worst_plain]:.3e} ({worst_plain})")
    del grads, plain_grads, ref
    # (c) the same model with remat: the same first steps, less memory
    reset_counts()
    remat, remat_ms, _, remat_peak, _ = llama_run(
        torch, None, remat=True, steps=LLAMA_REMAT_STEPS)
    torch.cuda.synchronize()
    rfwd, rbwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    n = LLAMA_REMAT_STEPS
    gap = max(abs(a - b) for a, b in zip(remat, losses[:n]))
    check(gap <= LOSS_TOL, f"llama: remat losses {remat} vs {losses[:n]}")
    check(remat_peak < peak, f"llama: remat peak {remat_peak} bytes not "
                             f"below the run without remat's {peak}")
    check(rfwd == LAYERS * (2 * n + 1) and rbwd == LAYERS * n,
          f"llama: remat K1 launches fwd {rfwd} bwd {rbwd}, want "
          f"{LAYERS} x (2 x {n} + 1) and {LAYERS} x {n}")
    say("llama", f"remat, {n} steps: losses {[round(x, 4) for x in remat]} "
                 f"(without remat {[round(x, 4) for x in losses[:n]]}; "
                 f"bit-equal {remat == losses[:n]}, worst gap {gap:.3e}); "
                 f"step ms {[round(x, 2) for x in remat_ms]}; peak memory "
                 f"{remat_peak / 2**30:.2f} GiB against "
                 f"{peak / 2**30:.2f} GiB without; K1 launches fwd {rfwd} "
                 f"(the recompute runs each forward again) bwd {rbwd}")
    return fwd, bwd


def llama_cli():
    """(d) the training CLI on LLaMA with adafactor and --remat."""
    cmd = [sys.executable, "-m", "distributed_pytorch_example_tpu_torch.train",
           "--model", "llama", "--dataset", "synthetic-tokens", "--seq-len",
           str(TRAIN_SEQ), "--dtype", "bfloat16", "--batch-size",
           str(TRAIN_BATCH), "--epochs", "1", "--num-samples", "48",
           "--optimizer", "adafactor", "--remat", "--checkpoint-dir", ""]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    log = proc.stdout + proc.stderr
    check(proc.returncode == 0 and "Training completed" in log,
          f"llama CLI exit {proc.returncode}: {log[-3000:]}")
    tail = [line.split("] ", 1)[-1] for line in log.splitlines()
            if "Throughput" in line or "Training completed" in line
            or "Loss" in line]
    say("llama", f"{' '.join(cmd[1:])} in {time.perf_counter() - t0:.1f} s: "
                 f"{tail}")


def llama_lamb_batches(torch, steps=LLAMA_ZERO1_STEPS):
    """The ZeRO-1 lamb (adafactor) run's global batches: 16 x 1024 tokens
    each."""
    from distributed_pytorch_example_tpu_torch.data import (
        SyntheticTokenDataset,
    )

    ds = SyntheticTokenDataset(steps * TRAIN_BATCH,
                               seq_len=TRAIN_SEQ, vocab_size=LLAMA_VOCAB,
                               seed=0)
    tokens = torch.from_numpy(ds.arrays["tokens"]).long()
    return tokens.reshape(steps, TRAIN_BATCH, TRAIN_SEQ)


def llama_lamb_state(torch, partitioner=None, optimizer="lamb"):
    """LLaMA at depth 2, bf16, fused loss, lamb (or ``optimizer``) at lr
    1e-3, and its step."""
    from distributed_pytorch_example_tpu_torch.models import Llama
    from distributed_pytorch_example_tpu_torch.train import (
        CausalLMTask,
        TrainState,
        build_train_step,
        make_optimizer,
    )

    model = Llama(num_layers=LLAMA_ZERO1_LAYERS, dtype=torch.bfloat16,
                  logits_mode="hidden", device="cuda", seed=0)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model, optimizer, 1e-3))
    return state, build_train_step(CausalLMTask(), partitioner=partitioner)


def llama_lamb_worker(ref_path: str) -> int:
    """One rank of the two-process ZeRO-1 lamb run (started by
    :func:`llama_lamb` with REPLICAS / PROCESS_ID / MASTER_ADDR /
    MASTER_PORT set); prints one ``chip_smoke_llama_lamb`` JSON line."""
    import torch

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
        _scatter_parts,
        _unscatter,
    )
    from distributed_pytorch_example_tpu_torch.runtime import distributed
    from distributed_pytorch_example_tpu_torch.train.optimizers import Lamb

    distributed.initialize(device="cuda")
    rank, world = distributed.process_index(), distributed.process_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    part = data_parallel(world, dp_shard_opt_state=True, wire=WireConfig(
        bucket_bytes=DEFAULT_BUCKET_BYTES))
    state, step = llama_lamb_state(torch, part)
    update = step.sharded(state)
    p0 = [leaf.to_jax(p).detach().clone()
          for leaf, p in zip(update.leaves, update.params)]
    per = TRAIN_BATCH // world
    ring_all_gather.launches = ring_reduce_scatter.launches = 0
    losses, ref = [], torch.load(ref_path)
    for i, tokens in enumerate(llama_lamb_batches(torch)):
        local = {"tokens": tokens[rank * per:(rank + 1) * per].to("cuda")}
        losses.append(float(step(state, local)["loss"]))
        if i:
            continue
        gaps = first_step_gaps(torch, update, ref_path, rank, world,
                               _scatter_parts)
        # lamb on whole leaves, fed the synced gradients put together
        full = []
        for leaf, p, tile, dim, cs in zip(update.leaves, update.params,
                                          update.tiles, update.dims,
                                          update.chunk_shapes):
            if tile is None:
                full.append(leaf.to_jax(p.grad).float())
            else:
                rows = distributed.all_gather_tiled(
                    tile.grad.reshape(1, -1))
                full.append(_unscatter(rows, dim, cs))
        leaves = [t.clone().requires_grad_() for t in p0]
        for t, g in zip(leaves, full):
            t.grad = g
        Lamb(leaves, lr=1e-3).step()
        tile_gap, one_gap = 0.0, {}
        for leaf, p, start, want in zip(update.leaves, update.params, p0,
                                        leaves):
            got = leaf.to_jax(p).detach() - start
            step_ref = want.detach() - start
            tile_gap = max(tile_gap, ((got - step_ref).norm()
                                      / step_ref.norm().clamp_min(1e-30))
                           .item())
            one = leaf.to_jax(ref["params"][leaf.name].to("cuda")) - start
            one_gap[leaf.name] = ((got - one).norm()
                                  / one.norm().clamp_min(1e-30)).item()
    print("chip_smoke_llama_lamb " + json.dumps({
        "rank": rank, "world": world, "losses": losses,
        "grad_gaps": gaps, "tile_gap": tile_gap, "update_gaps": one_gap,
        "zero1_leaves": sum(d is not None for d in update.dims),
        "k3a": ring_all_gather.launches, "k3b": ring_reduce_scatter.launches,
    }), flush=True)
    distributed.shutdown()
    return 0


def llama_lamb(torch):
    """(d) lamb under ZeRO-1 at world 2 on the card (two processes, gloo,
    K3 through CUDA IPC) against the one-process replicated lamb run on
    the same global batches."""
    from distributed_pytorch_example_tpu_torch.ops import _build

    state, step = llama_lamb_state(torch)
    losses = []
    for i, tokens in enumerate(llama_lamb_batches(torch)):
        losses.append(float(step(state, {"tokens": tokens.to("cuda")})
                            ["loss"]))
        if not i:
            ref = {"grads": {}, "params": {}}
            for name, p in state.model.named_parameters():
                ref["grads"][name] = p.grad.detach().cpu()
                ref["params"][name] = p.detach().cpu()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ref_path = str(_build.BUILD_DIR / "llama_lamb_reference.pt")
    # first_step_gaps reads the gradients by name at the file's top level
    torch.save({**ref["grads"], "params": ref["params"]}, ref_path)
    del state, step, ref
    torch.cuda.empty_cache()
    port = free_port()
    procs = []
    for rank in range(ZERO1_WORLD):
        env = {**os.environ, "REPLICAS": str(ZERO1_WORLD),
               "PROCESS_ID": str(rank), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--llama-lamb-worker", ref_path],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        os.remove(ref_path)
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        found = [line for line in out.splitlines()
                 if line.startswith("chip_smoke_llama_lamb ")]
        check(proc.returncode == 0 and found,
              f"llama lamb: rank {rank} exit {proc.returncode}: "
              f"{out[-3000:]}")
        r = json.loads(found[-1].split(" ", 1)[1])
        gap = max(abs(a - b) for a, b in zip(r["losses"], losses))
        grads = {k: v for k, v in r["grad_gaps"].items()
                 if not k.endswith("attn.k.bias")}
        worst = max(grads, key=grads.get)
        updates = {k: v for k, v in r["update_gaps"].items()
                   if not k.endswith("attn.k.bias")}
        worst_update = max(updates, key=updates.get)
        check(gap <= LOSS_TOL, f"llama lamb rank {rank}: losses "
                               f"{r['losses']} vs replicated {losses}")
        check(grads[worst] <= ZERO1_GRAD_TOL,
              f"llama lamb rank {rank}: first-step gradient of {worst} "
              f"{grads[worst]:.3e} off the replicated run's > "
              f"{ZERO1_GRAD_TOL}")
        check(r["tile_gap"] <= LAMB_TILE_TOL,
              f"llama lamb rank {rank}: the ZeRO-1 update is "
              f"{r['tile_gap']:.3e} off lamb on whole leaves > "
              f"{LAMB_TILE_TOL}")
        check(r["zero1_leaves"] > 0 and r["k3b"] > 0,
              f"llama lamb rank {rank}: {r['zero1_leaves']} ZeRO-1 leaves, "
              f"K3b launches {r['k3b']}")
        say("llama", f"lamb under ZeRO-1, {ZERO1_WORLD} processes on the "
                     f"card, LLaMA width 768 depth {LLAMA_ZERO1_LAYERS}, "
                     f"rank {rank}: losses "
                     f"{[round(x, 4) for x in r['losses']]} (replicated "
                     f"{[round(x, 4) for x in losses]}, gap {gap:.3e}, tol "
                     f"{LOSS_TOL}); first-step gradients worst "
                     f"{grads[worst]:.3e} ({worst}, tol {ZERO1_GRAD_TOL}); "
                     f"first update against lamb on the whole leaves with "
                     f"the same synced gradients {r['tile_gap']:.3e} (tol "
                     f"{LAMB_TILE_TOL}); against the one-process run's "
                     f"update worst {updates[worst_update]:.3e} "
                     f"({worst_update}; reported: bf16 gradients round "
                     f"per process, and lamb's first update is sign(g)); "
                     f"{r['zero1_leaves']} ZeRO-1 leaves; K3a launches "
                     f"{r['k3a']}, K3b {r['k3b']}")
    say("llama", f"lamb ZeRO-1 run in {time.perf_counter() - t0:.1f} s")


def llama_dropout_remat(torch):
    """(d) one BERT-tiny MLM step with dropout 0.1 on the card, with and
    without remat: the same gradients (the masks are keyed, so the
    recompute draws them again)."""
    from distributed_pytorch_example_tpu_torch.models import BertBase
    from distributed_pytorch_example_tpu_torch.train import (
        TrainState,
        build_train_step,
        make_optimizer,
    )
    from distributed_pytorch_example_tpu_torch.train.tasks import MLMTask

    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(1, BERT_VOCAB, (4, BERT_SEQ), generator=gen)
    out = {}
    for remat in (False, True):
        model = BertBase(model_dim=256, num_layers=2, num_heads=4,
                         mlp_dim=512, dropout_rate=0.1, remat=remat,
                         dtype=torch.bfloat16, logits_mode="hidden",
                         device="cuda", seed=0)
        state = TrainState(step=5, model=model,
                           optimizer=make_optimizer(model, "sgd", 0.0))
        step = build_train_step(MLMTask(BERT_VOCAB, BERT_MASK_ID), seed=1)
        loss = float(step(state, {"tokens": tokens.to("cuda")})["loss"])
        out[remat] = (loss, {n: p.grad.detach().float().clone()
                             for n, p in model.named_parameters()})
    (loss, want), (remat_loss, got) = out[False], out[True]
    gaps = {n: ((got[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
            for n, g in want.items()}
    worst = max(gaps, key=gaps.get)
    equal = all(torch.equal(got[n], g) for n, g in want.items())
    check(gaps[worst] <= REMAT_TOL,
          f"llama: BERT-tiny dropout step, remat gradient of {worst} "
          f"{gaps[worst]:.3e} off the step without remat")
    say("llama", f"BERT-tiny (2 x 256, S {BERT_SEQ}, K1) MLM step with "
                 f"dropout 0.1, remat against none: loss {remat_loss:.6f} vs "
                 f"{loss:.6f}; gradients bit-equal {equal}, worst "
                 f"||g - g_ref|| / ||g_ref|| {gaps[worst]:.3e} ({worst}; "
                 f"tol {REMAT_TOL})")


def rope_pool(torch, pk, table, lens, block_size):
    """The pool's keys rotated by RoPE at the positions the table gives
    them: row b's j-th block holds positions j * block_size + offset."""
    from distributed_pytorch_example_tpu_torch.ops.rope import rope

    out = pk.clone()
    offsets = torch.arange(block_size, device=pk.device)
    for b, pos in enumerate(lens.tolist()):
        live = min(pos // block_size + 1, table.shape[1])
        for j in range(live):
            blk = int(table[b, j])
            out[blk] = rope(pk[blk][None], j * block_size + offsets)[0]
    return out


def llama_paged(torch, bandwidth):
    """(e) K2 at LLaMA's decode shape (fp32, 12 heads over 4 kv heads,
    blocks of 16, 128 per row, pool 513) on RoPE-rotated keys, against
    its plain version, then timed beside its bound and SDPA
    (``enable_gqa``) on pre-gathered KV; returns K2's ``llama`` field."""
    from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
        paged_attention_reference,
        paged_flash_decode,
    )

    N, KVH, H, mb = HEADS, LLAMA_KV_HEADS, HEAD_DIM, LLAMA_MAX_BLOCKS
    q, pk, pv, table, lens = kernel_case(
        torch, batch=SLOTS, heads=N, kv_heads=KVH, head_dim=H,
        block_size=BLOCK_SIZE, max_blocks=mb, num_blocks=NUM_BLOCKS,
        lens=LLAMA_LENS, dtype=torch.float32, seed=12)
    pk = rope_pool(torch, pk, table, lens, BLOCK_SIZE)
    q4, pos2 = q[:, None], lens[:, None]
    got = paged_flash_decode(q, pk, pv, table, lens)
    ref = paged_attention_reference(q4, pk, pv, table, pos2)[:, 0]
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(math.isfinite(err) and err <= 2e-5,
          f"llama K2: max abs err {err:.3e} > tol 2e-05")
    idx = table.long()
    gk = pk[idx].reshape(SLOTS, -1, KVH, H).transpose(1, 2).contiguous()
    gv = pv[idx].reshape(SLOTS, -1, KVH, H).transpose(1, 2).contiguous()
    key_pos = torch.arange(mb * BLOCK_SIZE, device="cuda")
    mask = (key_pos[None, :] <= lens[:, None])[:, None, None, :]
    qh = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = {}
    for key, fn in (
        ("plain", lambda: paged_attention_reference(q4, pk, pv, table, pos2)),
        ("kernel", lambda: paged_flash_decode(q, pk, pv, table, lens)),
        ("kernel2", lambda: paged_flash_decode(q, pk, pv, table, lens)),
        ("plain2", lambda: paged_attention_reference(q4, pk, pv, table,
                                                     pos2)),
        ("library", lambda: sdpa(qh, gk, gv, attn_mask=mask,
                                 enable_gqa=True)),
    ):
        ms[key] = time_cold(torch, fn)
    live_keys = sum(min(p, mb * BLOCK_SIZE - 1) + 1 for p in LLAMA_LENS)
    nbytes = (2 * live_keys * KVH * H * 4 + 2 * SLOTS * N * H * 4
              + SLOTS * mb * 4 + SLOTS * 4)
    flops = 4 * live_keys * N * H
    bytes_ms, ops_ms = nbytes / bandwidth * 1e3, flops / _F32_PEAK * 1e3
    field = {
        "shape": f"B={SLOTS} N={N} KVH={KVH} H={H} fp32 bs={BLOCK_SIZE} "
                 f"mb={mb} lens {list(LLAMA_LENS)}, RoPE'd keys",
        "launches": None,  # filled from the serving run
        "max_abs_err": err,
        "ms": min(ms["kernel"], ms["kernel2"]),
        "plain_ms": min(ms["plain"], ms["plain2"]),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": ms["library"],
    }
    say("llama", f"paged_flash_decode {field['shape']}: max abs err "
                 f"{err:.3e} (tol 2e-05: float32, summation order only); "
                 f"kernel {ms['kernel']:.4f}/{ms['kernel2']:.4f} ms, plain "
                 f"{ms['plain']:.4f}/{ms['plain2']:.4f} ms, library (SDPA "
                 f"enable_gqa on pre-gathered KV) {ms['library']:.4f} ms, "
                 f"bound {field['bound_ms']:.4f} ms ({nbytes} bytes, "
                 f"{flops} flops)")
    return field


def llama_serve(torch):
    """(e) LLaMA at full width served from random weights (float32, pool
    513 x 16, 128 blocks a row, 8 slots, 16 requests), greedy and top-k
    50; checks against the plain forward as phase 4 does GPT-2's. Returns
    K2's launches."""
    from distributed_pytorch_example_tpu_torch.models import Llama
    from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
        paged_flash_decode,
    )
    from distributed_pytorch_example_tpu_torch.serving import (
        InferenceEngine,
        Request,
    )

    model = Llama(decode=True, paged_num_blocks=NUM_BLOCKS,
                  paged_block_size=BLOCK_SIZE,
                  paged_max_blocks=LLAMA_MAX_BLOCKS, device="cuda", seed=0)
    total, greedy = 0, None
    for label, kw in (("greedy", dict(temperature=0.0)),
                      ("sampled", dict(temperature=1.0, top_k=50))):
        engine = InferenceEngine(model, num_slots=SLOTS, device="cuda", **kw)
        engine.warmup()
        torch.cuda.synchronize()
        reset_counts()
        report = engine.run(workload(Request, vocab=LLAMA_VOCAB))
        torch.cuda.synchronize()
        launches = paged_flash_decode.launches
        m = report["metrics"]
        statuses = {r["status"] for r in report["results"].values()}
        check(statuses == {"done"} and m["completed"] == 16,
              f"llama {label}: not every request completed: {statuses}")
        check(launches > 0 and launches == m["decode_steps"] * LAYERS,
              f"llama {label}: K2 launched {launches} times, want "
              f"decode_steps {m['decode_steps']} x {LAYERS}")
        say("llama", f"serve {label} " + json.dumps({
            "metric": "serve_tokens_per_sec",
            "value": round(m["tokens_per_sec"], 2), "unit": "tokens/sec",
            "ttft_ms": m["ttft_ms"], "tpot_ms": m["tpot_ms"],
            "ttft_p99_ms": m["ttft_ms"]["p99"],
            "tpot_p99_ms": m["tpot_ms"]["p99"],
            "decode_tokens_per_sec": round(m["decode_tokens_per_sec"], 2),
            "decode_steps": m["decode_steps"],
            "generated_tokens": m["generated_tokens"],
            "completed": m["completed"], "k2_launches": launches}))
        total += launches
        if label == "greedy":
            greedy = report
    check_against_plain(torch, model, greedy,
                        plain=Llama(device="cuda", seed=0),
                        vocab=LLAMA_VOCAB, phase="llama")
    del model
    torch.cuda.empty_cache()
    return total


def llama(torch, smi_line, bandwidth):
    """Phase 12; returns the K1 and K2 ``llama`` fields with their
    launches on the training and serving paths."""
    k1 = llama_flash(torch, bandwidth)
    fwd, bwd = llama_train(torch, smi_line)
    k1["fwd"][str(TRAIN_SEQ)]["launches"] = fwd
    k1["bwd"][str(TRAIN_SEQ)]["launches"] = bwd
    llama_cli()
    llama_lamb(torch)
    llama_dropout_remat(torch)
    k2 = llama_paged(torch, bandwidth)
    k2["launches"] = llama_serve(torch)
    return k1, k2


# ---------------------------------------------------------------------------
# 13. launch: two ranks through the port's launcher, killed and restarted
# ---------------------------------------------------------------------------

LAUNCH_WORLD = 2
ENTRYPOINT = os.path.join(ROOT, "distributed_pytorch_example_tpu_torch",
                          "launch", "entrypoint.sh")
# GPT-2 124M through the training CLI at world 2, 8 rows a rank: one epoch
# of 8 steps and a validation batch, `latest` every 2 steps in auto's
# format (sharded at world 2), 2 versions kept
LAUNCH_SAMPLES, LAUNCH_EVERY = 128, 2
# SIGKILL on both ranks after their 7th step: `latest` then holds step 2,
# 4 or 6 (the save after step 6 may still be in flight), so the restarted
# run takes at most 6 steps and never reaches a 7th boundary
LAUNCH_KILL = '{"faults":[{"kind":"kill","at":"step","nth":7}]}'
# timed saves of each format of the final state, phase 13 (c)
LAUNCH_SAVES = 3


def launch_args(ckdir):
    return ["--model", "gpt2", "--dataset", "synthetic-tokens", "--seq-len",
            str(TRAIN_SEQ), "--dtype", "bfloat16", "--batch-size",
            str(TRAIN_BATCH // LAUNCH_WORLD), "--epochs", "1",
            "--num-samples", str(LAUNCH_SAMPLES), "--zero1",
            "--overlap-buckets", "-1", "--wire-param-gather", "bf16",
            "--checkpoint-dir", ckdir, "--checkpoint-format", "auto",
            "--save-every-steps", str(LAUNCH_EVERY), "--checkpoint-retain",
            "2", "--log-every", "1"]


def launch_counts():
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_all_gather,
        ring_reduce_scatter,
    )
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    return {"k1_fwd": flash_attention_fwd.launches,
            "k1_bwd": flash_attention_bwd.launches,
            "k3a": ring_all_gather.launches,
            "k3b": ring_reduce_scatter.launches}


def launch_worker(record: str, argv) -> int:
    """One rank of phase 13, run by the launcher as its TRAINING_SCRIPT:
    the port's training CLI with ``argv``. Every step appends its loss and
    the kernels' launch counts to ``<record>.<rank>`` (a killed run keeps
    what it wrote); the end of the fit appends the saves' records, the
    parameters' digest and, with ``CHIP_SMOKE_SAVE_TIMES`` set to a
    directory, :func:`timed_saves` of the final state."""
    from distributed_pytorch_example_tpu_torch.runtime import distributed
    from distributed_pytorch_example_tpu_torch.train import cli, loop

    fit = loop.Trainer.fit

    def recorded_fit(self, *args, **kw):
        step_fn = self.train_step
        path = f"{record}.{distributed.process_index()}"

        def step(state, batch):
            metrics = step_fn(state, batch)
            line = {"step": state.step, "loss": float(metrics["loss"]),
                    **launch_counts()}
            with open(path, "a") as f:
                f.write(json.dumps(line) + "\n")
            return metrics

        self.train_step = step
        history = fit(self, *args, **kw)
        end = {"saves": [{k: r[k] for k in ("hold_s", "copy_s", "wait_s",
                                            "write_s", "bytes")}
                         for r in self._saver.records],
               "params_sha256": params_digest(self.model),
               "counts": launch_counts()}
        if os.environ.get("CHIP_SMOKE_SAVE_TIMES"):
            end["timed"] = timed_saves(self,
                                       os.environ["CHIP_SMOKE_SAVE_TIMES"])
        with open(path, "a") as f:
            f.write(json.dumps(end) + "\n")
        return history

    loop.Trainer.fit = recorded_fit
    return cli.main(argv)


def timed_saves(trainer, root):
    """The trainer's state saved LAUNCH_SAVES times in each format, as
    epochs 1, 2, ... (each save a new version, as in training, so a
    sharded save never clears a dir of its own name), each save starting
    with the card idle and every rank at a barrier and no write of the
    saver in flight: the calling thread's hold, the write on the saver's
    thread (sharded; the gathered format at world 2 writes on the calling
    thread, rank 0 only) and the bytes this rank wrote."""
    import torch

    from distributed_pytorch_example_tpu_torch.runtime import distributed
    from distributed_pytorch_example_tpu_torch.train import checkpoint as ck

    saver, out = ck.AsyncSaver(), {}
    for fmt in ("sharded", "gathered"):
        records = []
        for epoch in range(1, LAUNCH_SAVES + 1):
            saver.wait()
            torch.cuda.synchronize()
            distributed.barrier()
            records.append(ck.save_checkpoint(
                os.path.join(root, f"{fmt}.ckpt"), trainer.state, epoch, 0.0,
                {},
                saver=saver, sharded=fmt == "sharded", retain=1,
                layout=trainer.layout()))
        saver.wait()
        out[fmt] = [{k: r[k] for k in ("hold_s", "copy_s", "write_s",
                                       "bytes")} for r in records]
    distributed.barrier()
    return out


def launch_pair(tmp, name, args, **env_extra):
    """Both ranks through the port's entrypoint.sh (REPLICAS=2, explicit
    PROCESS_ID and COORDINATOR_ADDRESS, a dummy discovery service), each
    in its own process group so that a stuck run is killed whole; returns
    (each launcher's output, each rank's record lines)."""
    port = free_port()
    record = os.path.join(tmp, f"{name}.jsonl")
    # the launcher runs `python`: this interpreter, whatever its name (a
    # wrapper, not a link, so that a virtual environment stays in force)
    bindir = os.path.join(tmp, "bin")
    if not os.path.exists(bindir):
        os.makedirs(bindir)
        wrapper = os.path.join(bindir, "python")
        with open(wrapper, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(wrapper, 0o755)
    procs = []
    for rank in range(LAUNCH_WORLD):
        env = {**os.environ, "REPLICAS": str(LAUNCH_WORLD),
               "PROCESS_ID": str(rank),
               "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "NF_DISCOVERY_SERVICE": "chip-smoke.invalid",
               "PATH": os.pathsep.join([bindir, os.environ["PATH"]]),
               "TRAINING_SCRIPT": os.path.abspath(__file__),
               "SCRIPT_ARGS": " ".join(["--launch-worker", record, *args]),
               **env_extra}
        procs.append(subprocess.Popen(
            ["bash", ENTRYPOINT], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        check(proc.returncode == 0,
              f"launch {name}: rank {rank}'s launcher exit "
              f"{proc.returncode}: {out[-4000:]}")
    lines = {}
    for rank in range(LAUNCH_WORLD):
        with open(f"{record}.{rank}") as f:
            lines[rank] = [json.loads(line) for line in f]
    return outs, lines


def launch_steps(lines):
    """(losses by step, the end record(s)) of one rank's record lines."""
    steps = [r for r in lines if "step" in r]
    return steps, [r for r in lines if "saves" in r]


def launch(torch, smi_line):
    """Phase 13 (a)-(c) in a temporary directory; returns rank 0's K1 and
    K3 launch counts of the restarted run."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    t0 = time.perf_counter()
    try:
        counts = launch_runs(torch, smi_line, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("launch", f"phase 13 in {time.perf_counter() - t0:.1f} s")
    return counts


def launch_runs(torch, smi_line, tmp):
    from distributed_pytorch_example_tpu_torch.train import checkpoint as ck

    # the uninterrupted run, then the timed saves of its final state
    t0 = time.perf_counter()
    ref_dir, timed_dir = os.path.join(tmp, "ref"), os.path.join(tmp, "timed")
    os.makedirs(timed_dir)
    _, ref = launch_pair(tmp, "ref", launch_args(ref_dir),
                         CHIP_SMOKE_SAVE_TIMES=timed_dir)
    ref_losses = {}
    for rank in range(LAUNCH_WORLD):
        steps, ends = launch_steps(ref[rank])
        check([s["step"] for s in steps] == list(range(1, 9)) and ends,
              f"launch: uninterrupted rank {rank} logged steps "
              f"{[s['step'] for s in steps]}")
        ref_losses[rank] = {s["step"]: s["loss"] for s in steps}
    losses = [round(ref_losses[0][s], 4) for s in sorted(ref_losses[0])]
    say("launch", f"uninterrupted: 2 ranks through entrypoint.sh in "
                  f"{time.perf_counter() - t0:.1f} s, losses {losses}")

    # (a) the same run killed after step 7 on both ranks, restarted once
    t0 = time.perf_counter()
    run_dir = os.path.join(tmp, "run")
    outs, got = launch_pair(tmp, "killed", launch_args(run_dir),
                            MAX_RESTARTS="1", DPX_CHAOS=LAUNCH_KILL)
    counts = {}
    for rank in range(LAUNCH_WORLD):
        check("restart 1/1, resuming from" in outs[rank]
              and "SIGKILL at crash point 'step'" in outs[rank],
              f"launch (a): rank {rank} was not killed and restarted: "
              f"{outs[rank][-4000:]}")
        steps, ends = launch_steps(got[rank])
        numbers = [s["step"] for s in steps]
        resumed = numbers[7] - 1 if len(numbers) > 7 else None
        check(numbers[:7] == list(range(1, 8)) and resumed in (2, 4, 6)
              and numbers[7:] == list(range(resumed + 1, 9)) and ends,
              f"launch (a): rank {rank} logged steps {numbers}")
        check(f"Resuming epoch 0 at batch {resumed}/8" in outs[rank],
              f"launch (a): rank {rank} did not log its resume at batch "
              f"{resumed}")
        worst = max(abs(s["loss"] - ref_losses[rank][s["step"]])
                    for s in steps)
        check(worst <= RESUME_TOL,
              f"launch (a): rank {rank}'s losses differ from the "
              f"uninterrupted run's by {worst:.3e} > {RESUME_TOL}")
        same = (ends[-1]["params_sha256"]
                == launch_steps(ref[rank])[1][-1]["params_sha256"])
        counts[rank] = ends[-1]["counts"]
        check(all(v > 0 for v in counts[rank].values()),
              f"launch (a): rank {rank} launch counts {counts[rank]}")
        say("launch", f"(a) rank {rank}: killed after step 7, restarted, "
                      f"resumed at step {resumed}; {len(steps) - 7} steps "
                      f"after the restart, losses within {worst:.3e} of the "
                      f"uninterrupted run's (tol {RESUME_TOL}), final "
                      f"parameters {'' if same else 'not '}bit-equal to "
                      f"its; launches after the restart {counts[rank]}")
    latest = os.path.join(run_dir, ck.LATEST_NAME)
    versions = sorted(os.listdir(f"{latest}.shards"))
    pointed = ck._pointed_version_dir(latest)
    sizes = [os.path.getsize(os.path.join(pointed, f"shard_{r:05d}.msgpack"))
             for r in range(LAUNCH_WORLD)]
    say("launch", f"(a) in {time.perf_counter() - t0:.1f} s; versions on "
                  f"disk {versions}, `latest` -> {os.path.basename(pointed)}"
                  f"; shard file bytes by rank {sizes}, manifest "
                  f"{os.path.getsize(os.path.join(pointed, 'manifest.msgpack'))}")

    launch_world1(torch, timed_dir, ref)
    launch_save_times(ref, smi_line)
    return counts[0]


def launch_world1(torch, timed_dir, ref):
    """(b) The world-2 sharded checkpoint loaded in one process, the
    world a shrink leaves, against the gathered checkpoint of the same
    state, then the next epoch through Trainer.fit."""
    from distributed_pytorch_example_tpu_torch.data import (
        DeviceLoader,
        SyntheticTokenDataset,
    )
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    sharded = os.path.join(timed_dir, "sharded.ckpt")
    gathered = os.path.join(timed_dir, "gathered.ckpt")
    a, losses = ckpt_run(torch, 1)
    b, _ = ckpt_run(torch, 2)
    t0 = time.perf_counter()
    epoch, _ = a.load(sharded)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    b.load(gathered)
    bad = same_state(torch, a.state, b.state)
    check(not bad and epoch == LAUNCH_SAVES and a.state.step == 8,
          f"launch (b): the sharded load differs from the gathered one: "
          f"{bad[:5]} (step {a.state.step}, epoch {epoch})")
    digest = params_digest(a.model)
    check(digest == launch_steps(ref[0])[1][-1]["params_sha256"],
          "launch (b): the loaded parameters differ from the world-2 run's")
    del b
    torch.cuda.empty_cache()
    train_ds = SyntheticTokenDataset(LAUNCH_SAMPLES, seq_len=TRAIN_SEQ,
                                     seed=0)
    loader = DeviceLoader(train_ds, TRAIN_BATCH, device="cuda", seed=0)
    reset_counts()
    a.fit(loader, None, epochs=epoch + 1, resume=sharded)
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    steps = LAUNCH_SAMPLES // TRAIN_BATCH
    check(len(losses) == steps and all(map(math.isfinite, losses))
          and a.state.step == 2 * steps
          and flash_attention_fwd.launches == LAYERS * steps
          and flash_attention_bwd.launches == LAYERS * steps,
          f"launch (b): resumed at world 1: losses {losses}, step "
          f"{a.state.step}, K1 {flash_attention_fwd.launches} / "
          f"{flash_attention_bwd.launches}")
    say("launch", f"(b) world-2 sharded checkpoint (step 8) loaded in one "
                  f"process in {load_s:.2f} s: bit-equal to the gathered "
                  f"checkpoint of the same state and to the world-2 "
                  f"parameters (sha256 {digest[:16]}); one more epoch at "
                  f"world 1 through Trainer.fit: losses "
                  f"{[round(x, 4) for x in losses]}, K1 "
                  f"{flash_attention_fwd.launches} / "
                  f"{flash_attention_bwd.launches}")
    del a
    torch.cuda.empty_cache()


def launch_save_times(ref, smi_line):
    """(c) The calling thread's hold of a sharded save against a gathered
    save of the same state at world 2, per rank."""
    for rank in range(LAUNCH_WORLD):
        timed = launch_steps(ref[rank])[1][-1]["timed"]
        parts = []
        for fmt in ("sharded", "gathered"):
            holds = sorted(r["hold_s"] * 1e3 for r in timed[fmt])
            writes = sorted((r["write_s"] or 0.0) * 1e3 for r in timed[fmt])
            parts.append(
                f"{fmt} hold median {holds[len(holds) // 2]:.1f} ms "
                f"(min {holds[0]:.1f}, max {holds[-1]:.1f}; "
                f"{[round(h, 1) for h in holds]}), write median "
                f"{writes[len(writes) // 2]:.1f} ms, "
                f"{timed[fmt][-1]['bytes']} bytes")
        say("launch", f"(c) rank {rank}, {LAUNCH_SAVES} saves each of the "
                      f"final state ({smi_line}): " + "; ".join(parts))


# ---------------------------------------------------------------------------
# 14. decode: speculative decoding and generate() at full width
# ---------------------------------------------------------------------------

SPEC_TOKENS = 4
# the gap phase 4 allows a greedy token below the plain forward's argmax
# logit, and within which two runs' draws may part: float32 with TF32 off,
# the kernel's and the plain version's logits differ in summation order
# only (phase 4's check_against_plain)
DECODE_LOGIT_TOL = 1e-3
GENERATE_PROMPTS, GENERATE_NEW = 8, 64


class SpanTimes:
    """A trace sink for the engine's spans: host ms by span name (the
    part before any ``:``), in arrival order."""

    def __init__(self):
        self.ms = {}

    def add_complete(self, name, ts_us, dur_us):
        self.ms.setdefault(name.split(":")[0], []).append(dur_us / 1e3)

    def mean(self, name):
        vals = self.ms.get(name, [])
        return sum(vals) / len(vals) if vals else float("nan")


def plain_logits(torch, plain, prompt, tokens):
    """The plain forward's float32 logits at each generated position of a
    stream: row i scores token i."""
    seq = torch.tensor([list(prompt) + list(tokens)], device="cuda")
    plen = len(prompt)
    with torch.inference_mode():
        return plain(seq)[0, plen - 1:plen - 1 + len(tokens)].float()


def greedy_gap(torch, logits, tokens):
    """How far the worst token of a greedy stream sits below its row's
    argmax logit."""
    chosen = logits.gather(1, torch.tensor(tokens, device="cuda")[:, None])
    return (logits.max(dim=1).values - chosen[:, 0]).max().item()


def first_split(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def parted_streams(torch, plain, report, ref, vocab, phase, label,
                   sample=None):
    """Hold each stream of ``report`` to the same request's stream in
    ``ref``: equal, or parted at a near-tie. At the first token where they
    differ (the same prefix before it), the plain forward scores both
    choices: greedy, their logits within ``DECODE_LOGIT_TOL``; sampled
    (``sample`` = (temperature, top_k)), their Gumbel scores, logits /
    temperature plus the request's noise at that position, within the
    tolerance over the temperature, or one of them that close to the
    top-k edge. Returns how many streams are equal."""
    from distributed_pytorch_example_tpu_torch.serving import Request
    from distributed_pytorch_example_tpu_torch.serving.sampling import (
        gumbel_noise,
    )

    reqs = {r.rid: r for r in workload(Request, vocab=vocab)}
    equal = 0
    for rid, r in sorted(report["results"].items()):
        got, want = r["tokens"], ref["results"][rid]["tokens"]
        at = first_split(got, want)
        if at is None:
            check(len(got) == len(want), f"{label} {rid}: streams of "
                  f"{len(got)} and {len(want)} tokens")
            equal += 1
            continue
        req = reqs[rid]
        row = plain_logits(torch, plain, req.prompt, got[:at + 1])[at]
        a, b = got[at], want[at]
        if sample is None:
            gap = (row.max() - min(row[a], row[b])).item()
            edge = float("inf")
            tol = DECODE_LOGIT_TOL
        else:
            temperature, top_k = sample
            scaled = row / temperature
            score = scaled + gumbel_noise(req.seed, len(req.prompt) + at,
                                          vocab).to("cuda")
            gap = abs(score[a] - score[b]).item()
            kth = torch.topk(scaled, top_k).values[-1]
            edge = min(abs(scaled[a] - kth), abs(scaled[b] - kth)).item()
            tol = DECODE_LOGIT_TOL / temperature
        check(min(gap, edge) <= tol,
              f"{label} {rid}: token {at} parts ({a} against {b}) by "
              f"{gap:.3e} (top-k edge {edge:.3e}), not a near-tie within "
              f"{tol}")
        say(phase, f"{label} {rid}: parts at token {at} of {len(got)} "
                   f"({a} against {b}), a near-tie: gap {gap:.3e}, top-k "
                   f"edge {edge:.3e} (tol {tol})")
    return equal


def spec_serve(torch, model, label, vocab, phase="decode", **kw):
    """16 requests through a self-speculating engine (K = SPEC_TOKENS)
    with every launch count set to 0 just before the run; checks every
    request completes and K2 launched K times per layer at every boundary
    (the draft's steps; the verify chunk launches none). Returns the
    report, K2's launches and the run's span times."""
    from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
        paged_flash_decode,
    )
    from distributed_pytorch_example_tpu_torch.serving import (
        InferenceEngine,
        Request,
    )
    from distributed_pytorch_example_tpu_torch.serving.engine import (
        self_draft,
    )

    engine = InferenceEngine(model, num_slots=SLOTS, device="cuda",
                             draft_model=self_draft(model),
                             spec_tokens=SPEC_TOKENS, **kw)
    engine.warmup()
    spans = SpanTimes()
    engine.trace = spans
    torch.cuda.synchronize()
    reset_counts()
    report = engine.run(workload(Request, vocab=vocab))
    torch.cuda.synchronize()
    launches = paged_flash_decode.launches
    m = report["metrics"]
    statuses = {r["status"] for r in report["results"].values()}
    check(statuses == {"done"} and m["completed"] == 16,
          f"{label}: not every request completed: {statuses}")
    want = m["decode_steps"] * SPEC_TOKENS * LAYERS
    check(launches > 0 and launches == want,
          f"{label}: K2 launched {launches} times, want decode_steps "
          f"{m['decode_steps']} x {SPEC_TOKENS} x {LAYERS} = {want}")
    return report, launches, spans


def spec_line(m, spans, launches):
    return (f"{m['generated_tokens']} tokens in {m['elapsed_s']:.3f} s = "
            f"{m['tokens_per_sec']:.1f} tokens/s; decode "
            f"{m['decode_tokens_per_sec']:.1f} tokens/s; TPOT p50 "
            f"{m['tpot_ms']['p50']:.2f} p99 {m['tpot_ms']['p99']:.2f} ms; "
            f"decode_steps {m['decode_steps']}; accept rate "
            f"{m['spec_accept_rate']:.4f} ({m['spec_accepted']} of "
            f"{m['spec_proposed']}); a boundary: draft_propose "
            f"{spans.mean('draft_propose'):.2f} ms + verify_step "
            f"{spans.mean('verify_step'):.2f} ms; K2 launches {launches}")


def plain_line(m):
    return (f"{m['tokens_per_sec']:.1f} tokens/s, decode "
            f"{m['decode_tokens_per_sec']:.1f}, TPOT p50 "
            f"{m['tpot_ms']['p50']:.2f} p99 {m['tpot_ms']['p99']:.2f} ms, "
            f"decode_steps {m['decode_steps']}")


def decode_gpt2(torch, serve_runs):
    """(a) greedy and (b) sampled self-speculation on GPT-2 124M, held to
    phase 4's runs; (d) generate(). Returns K2's launches in (a) and
    (b)."""
    from distributed_pytorch_example_tpu_torch.models import GPT2

    model = GPT2(decode=True, paged_num_blocks=NUM_BLOCKS,
                 paged_block_size=BLOCK_SIZE, paged_max_blocks=MAX_BLOCKS,
                 device="cuda", seed=0)
    plain = GPT2(device="cuda", seed=0).eval()
    greedy, sampled = serve_runs["greedy"], serve_runs["sampled"]
    # (a) greedy: every token is the plain forward's argmax within the gap
    report, launches_a, spans = spec_serve(torch, model, "(a) greedy",
                                           50257, temperature=0.0)
    m, m4 = report["metrics"], greedy["metrics"]
    worst = max(greedy_gap(torch, plain_logits(
        torch, plain, workload_prompt(rid), r["tokens"]), r["tokens"])
        for rid, r in report["results"].items())
    check(worst <= DECODE_LOGIT_TOL,
          f"(a) a greedy token is {worst:.2e} below the plain argmax logit "
          f"(tol {DECODE_LOGIT_TOL})")
    check(m["decode_steps"] < m4["decode_steps"],
          f"(a) {m['decode_steps']} speculative boundaries, not fewer than "
          f"phase 4's {m4['decode_steps']} decode steps")
    equal = parted_streams(torch, plain, report, greedy, 50257, "decode",
                           "(a) greedy")
    say("decode", f"(a) GPT-2 greedy, K={SPEC_TOKENS}: {spec_line(m, spans, launches_a)}")
    say("decode", f"(a) phase 4's greedy run without speculation: "
                  f"{plain_line(m4)}")
    say("decode", f"(a) every token of the 16 streams within "
                  f"{worst:.2e} of the plain forward's argmax (tol "
                  f"{DECODE_LOGIT_TOL}); {equal} of 16 streams equal phase "
                  f"4's")
    # (b) sampled at temperature 1.0, top-k 50
    report, launches_b, spans = spec_serve(torch, model, "(b) sampled",
                                           50257, temperature=1.0, top_k=50)
    m, m4 = report["metrics"], sampled["metrics"]
    equal = parted_streams(torch, plain, report, sampled, 50257, "decode",
                           "(b) sampled", sample=(1.0, 50))
    say("decode", f"(b) GPT-2 temperature 1.0 top-k 50, K={SPEC_TOKENS}: "
                  f"{spec_line(m, spans, launches_b)}")
    say("decode", f"(b) phase 4's sampled run without speculation: "
                  f"{plain_line(m4)}; {equal} of 16 streams equal")
    del model
    torch.cuda.empty_cache()
    decode_generate(torch, plain, greedy)
    del plain
    torch.cuda.empty_cache()
    return launches_a + launches_b


def decode_generate(torch, plain, greedy):
    """(d) generate() over the contiguous cache on GPT-2 124M (float32):
    the first GENERATE_PROMPTS prompts of the workload, one call each,
    GENERATE_NEW greedy tokens; each token the plain forward's argmax
    within the gap, each stream phase 4's paged one (on the tokens that
    run served) or parted from it at a near-tie."""
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
        paged_flash_decode,
    )
    from distributed_pytorch_example_tpu_torch.serving import Request
    from distributed_pytorch_example_tpu_torch.train import generate

    model = GPT2(decode=True, device="cuda", seed=0)
    reqs = workload(Request)[:GENERATE_PROMPTS]
    generate(model, [reqs[0].prompt], 2, temperature=0.0)  # first call
    torch.cuda.synchronize()
    reset_counts()
    streams, secs = {}, 0.0
    for req in reqs:
        t0 = time.perf_counter()
        out = generate(model, [req.prompt], GENERATE_NEW, temperature=0.0)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        streams[req.rid] = out[0, len(req.prompt):].tolist()
    # the contiguous cache's attention is the plain version, as in JAX
    check(paged_flash_decode.launches == 0,
          f"(d) generate() launched K2 {paged_flash_decode.launches} times")
    worst = max(greedy_gap(torch, plain_logits(
        torch, plain, req.prompt, streams[req.rid]), streams[req.rid])
        for req in reqs)
    check(worst <= DECODE_LOGIT_TOL,
          f"(d) a generate() token is {worst:.2e} below the plain argmax "
          f"logit (tol {DECODE_LOGIT_TOL})")
    served = {"results": {
        rid: {"tokens": streams[rid][:len(greedy["results"][rid]["tokens"])]}
        for rid in streams}}
    equal = parted_streams(torch, plain, served, {"results": {
        rid: greedy["results"][rid] for rid in streams}}, 50257, "decode",
        "(d) generate")
    ms = secs * 1e3 / (GENERATE_PROMPTS * GENERATE_NEW)
    say("decode", f"(d) generate(): {GENERATE_PROMPTS} prompts x "
                  f"{GENERATE_NEW} greedy tokens, one call each, "
                  f"{ms:.2f} ms a token (prefill included; "
                  f"{secs:.3f} s in all); every token within {worst:.2e} "
                  f"of the plain argmax; {equal} of {GENERATE_PROMPTS} "
                  f"streams equal phase 4's paged greedy streams")


def decode_llama(torch):
    """(c) greedy self-speculation on LLaMA 125M (GQA 12/4, RoPE), held to
    the plain forward as phase 12 holds its serving. Returns K2's
    launches."""
    from distributed_pytorch_example_tpu_torch.models import Llama

    model = Llama(decode=True, paged_num_blocks=NUM_BLOCKS,
                  paged_block_size=BLOCK_SIZE,
                  paged_max_blocks=LLAMA_MAX_BLOCKS, device="cuda", seed=0)
    report, launches, spans = spec_serve(torch, model, "(c) llama greedy",
                                         LLAMA_VOCAB, temperature=0.0)
    plain = Llama(device="cuda", seed=0).eval()
    check_against_plain(torch, model, report, plain=plain,
                        vocab=LLAMA_VOCAB, phase="decode")
    worst = max(greedy_gap(torch, plain_logits(
        torch, plain, workload_prompt(rid, LLAMA_VOCAB), r["tokens"]),
        r["tokens"]) for rid, r in report["results"].items())
    check(worst <= DECODE_LOGIT_TOL,
          f"(c) a greedy token is {worst:.2e} below the plain argmax logit "
          f"(tol {DECODE_LOGIT_TOL})")
    say("decode", f"(c) LLaMA greedy, K={SPEC_TOKENS}: "
                  f"{spec_line(report['metrics'], spans, launches)}; every "
                  f"token within {worst:.2e} of the plain argmax")
    del model, plain
    torch.cuda.empty_cache()
    return launches


def decode(torch, serve_runs):
    """Phase 14; returns K2's launches on its runs."""
    t0 = time.perf_counter()
    launches = decode_gpt2(torch, serve_runs)
    launches += decode_llama(torch)
    say("decode", f"phase 14 took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# 15. telemetry: graft-scope through Trainer.fit, the profiler, overlap
#     accounting at world 2, and adafactor under ZeRO-1
# ---------------------------------------------------------------------------

# the telemetry run's per-N-step records and the clock's fence cadence
TELEMETRY_EVERY, TELEMETRY_SAMPLE = 2, 2
# the FLOP count against the analytic count under the same rule
FLOPS_TOL = 0.02
# the ZeRO-1 runs profiled under measure_overlap, after one warm-up step
OVERLAP_STEPS = 3
# adafactor under ZeRO-1: LLaMA's width at depth 2, steps
ADAFACTOR_ZERO1_STEPS = 3


def analytic_lm_flops(model, batch, seq, layers, heads, head_dim,
                      model_dim, vocab):
    """The FLOP count's rule on paper: 6 N T over the weights the matmuls
    use (the 2-D parameters; the tied embedding is the head), plus 2 T D V
    for the chunked loss's logits recompute, plus K1's formula (causal
    pairs, the forward's two products and the backward's recompute and
    four, 2 FLOPs a product element)."""
    tokens = batch * seq
    n = sum(p.numel() for p in model.parameters() if p.dim() == 2)
    pairs = batch * heads * seq * (seq + 1) // 2
    return (6 * n * tokens + 2 * tokens * model_dim * vocab
            + layers * 7 * 2 * head_dim * pairs)


def telemetry_fit(torch, smi_line, phase6):
    """(a) GPT-2 124M through Trainer.fit with per-N-step telemetry
    records; returns K1's launches."""
    from distributed_pytorch_example_tpu_torch.data import (
        SyntheticTokenDataset,
    )
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from distributed_pytorch_example_tpu_torch.telemetry import (
        TelemetryConfig,
    )
    from distributed_pytorch_example_tpu_torch.train import CausalLMTask

    tmp = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        metrics_file = os.path.join(tmp, "metrics.jsonl")
        model = GPT2(dtype=torch.bfloat16, logits_mode="hidden",
                     device="cuda", seed=0)
        analytic = analytic_lm_flops(model, TRAIN_BATCH, TRAIN_SEQ, LAYERS,
                                     HEADS, HEAD_DIM, HEADS * HEAD_DIM,
                                     50257)
        train_ds = SyntheticTokenDataset(TRAIN_STEPS * TRAIN_BATCH,
                                         seq_len=TRAIN_SEQ, seed=0)
        val_ds = SyntheticTokenDataset(TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=1)
        reset_counts()
        losses, step_ms, _, _, _ = fit_run(
            torch, model, CausalLMTask(), train_ds, val_ds, TRAIN_BATCH,
            telemetry=TelemetryConfig(every=TELEMETRY_EVERY,
                                      sample_every=TELEMETRY_SAMPLE),
            metrics_file=metrics_file)
        fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
        with open(metrics_file) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        with open(os.path.join(tmp, "trace_events.json")) as f:
            spans = {e["name"] for e in json.load(f) if e.get("ph") == "X"}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(fwd == LAYERS * (TRAIN_STEPS + 1) and bwd == LAYERS * TRAIN_STEPS,
          f"telemetry: K1 launches fwd {fwd} bwd {bwd}, want {LAYERS} x "
          f"{TRAIN_STEPS + 1} and {LAYERS} x {TRAIN_STEPS} (phase 6's)")
    records = [r for r in lines if "event" not in r and "epoch" not in r]
    check([r["step"] for r in records]
          == list(range(TELEMETRY_EVERY, TRAIN_STEPS + 1, TELEMETRY_EVERY)),
          f"telemetry: per-N-step records at {[r['step'] for r in records]}")
    for r in records:
        check(r.get("flops_per_step_per_device") is not None
              and r.get("hbm_peak_bytes") is not None
              and math.isfinite(r.get("grad_norm", math.nan))
              and math.isfinite(r.get("param_norm", math.nan))
              and r.get("nonfinite_grads") == 0,
              f"telemetry: record at step {r['step']}: {r}")
        # the clock anchors at step 1 and takes its first sample
        # TELEMETRY_SAMPLE steps later (JAX's contract): records before
        # that carry no step time yet
        if r["step"] >= 1 + TELEMETRY_SAMPLE:
            mfu = r.get("mfu_analytic")
            check(r.get("step_time_ms") is not None and mfu is not None
                  and 0 < mfu <= 1,
                  f"telemetry: step time / mfu_analytic at step "
                  f"{r['step']}: {r.get('step_time_ms')} / {mfu}")
    flops = records[0]["flops_per_step_per_device"]
    gap = abs(flops - analytic) / analytic
    check(gap <= FLOPS_TOL,
          f"telemetry: flops_per_step_per_device {flops:.4e} vs analytic "
          f"{analytic:.4e}: {gap:.3%} > {FLOPS_TOL:.0%}")
    plain = phase6["plain_grad_norms"][1]
    got = records[0]["grad_norm"]
    norm_gap = abs(got - plain) / plain
    check(norm_gap <= GRAD_TOL,
          f"telemetry: step-2 grad_norm {got} vs plain attention's {plain}"
          f": {norm_gap:.3e} > {GRAD_TOL}")
    check({"step", "data_load", "h2d", "eval"} <= spans,
          f"telemetry: trace_events.json spans {sorted(spans)}")
    timed = [r for r in records if r.get("step_time_ms") is not None]
    clock_ms = sorted(r["step_time_ms"] for r in timed)
    mfus = [round(r["mfu_analytic"], 4) for r in timed]
    say("telemetry", f"(a) GPT-2 124M bf16 {TRAIN_BATCH} x {TRAIN_SEQ}, "
                     f"{TRAIN_STEPS} steps through Trainer.fit with records "
                     f"every {TELEMETRY_EVERY} steps: flops_per_step_per_"
                     f"device {flops:.4e} (analytic {analytic:.4e}: 6 N T + "
                     f"2 T D V + K1's causal formula; gap {gap:.3%}, tol "
                     f"{FLOPS_TOL:.0%}); hbm_peak_bytes "
                     f"{records[0]['hbm_peak_bytes']}; step_time_ms "
                     f"(the clock) {[round(x, 2) for x in clock_ms]} against "
                     f"phase 6's median {phase6['median_ms']:.2f} ms and this"
                     f" run's event-timed median of steps 3+ "
                     f"{sorted(step_ms[2:])[len(step_ms[2:]) // 2]:.2f} ms; "
                     f"mfu_analytic {mfus}; step-2 grad_norm {got:.6f} vs "
                     f"plain attention's {plain:.6f} (gap {norm_gap:.3e}, tol"
                     f" {GRAD_TOL}); param_norm {records[-1]['param_norm']:.4f}"
                     f"; K1 fwd {fwd} bwd {bwd}; spans {sorted(spans)}; on "
                     f"{smi_line}")
    return fwd, bwd


def telemetry_cli():
    """(b) The training CLI on GPT-2 with the profiler over steps [2, 4)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        prof = os.path.join(tmp, "prof")
        cmd = [sys.executable, "-m",
               "distributed_pytorch_example_tpu_torch.train", "--model",
               "gpt2", "--dataset", "synthetic-tokens", "--seq-len", "1024",
               "--dtype", "bfloat16", "--batch-size", str(TRAIN_BATCH),
               "--epochs", "1", "--num-samples", str(5 * TRAIN_BATCH),
               "--checkpoint-dir", "", "--profile-dir", prof,
               "--profile-steps", "2,4"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        log = proc.stdout + proc.stderr
        check(proc.returncode == 0 and "Training completed" in log,
              f"telemetry CLI exit {proc.returncode}: {log[-3000:]}")
        check("Profiler trace started" in log
              and "Profiler trace written" in log,
              f"telemetry CLI: no profiler log lines: {log[-3000:]}")
        files = sorted(os.listdir(prof))
        check(files == ["trace_steps_2_4.json"],
              f"telemetry CLI: profile dir holds {files}")
        path = os.path.join(prof, files[0])
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {name: sum(name in e.get("name", "") for e in kernels)
             for name in ("flash_fwd_bf16_kernel", "flash_dq_bf16_kernel",
                          "flash_dkv_bf16_kernel")}
    check(all(found.values()),
          f"telemetry CLI: CUDA kernel events in the trace {found} "
          f"({len(kernels)} kernel events)")
    say("telemetry", f"(b) {' '.join(cmd[1:])} in "
                     f"{time.perf_counter() - t0:.1f} s: trace {files[0]} "
                     f"({size} bytes, {len(kernels)} CUDA kernel events; K1 "
                     f"kernels {found})")


def telemetry_worker(ckpt_dir: str) -> int:
    """One rank of (c) and (d) (started by :func:`telemetry_pair` with
    REPLICAS / PROCESS_ID / MASTER_ADDR / MASTER_PORT set); prints one
    ``chip_smoke_telemetry`` JSON line."""
    import torch

    from distributed_pytorch_example_tpu_torch.data import (
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
        _unscatter,
    )
    from distributed_pytorch_example_tpu_torch.runtime import distributed
    from distributed_pytorch_example_tpu_torch.telemetry import (
        exchange_step_times,
        measure_overlap,
    )
    from distributed_pytorch_example_tpu_torch.train import (
        CausalLMTask,
        TrainState,
        build_train_step,
        make_optimizer,
    )
    from distributed_pytorch_example_tpu_torch.train.checkpoint import (
        LATEST_NAME,
        save_checkpoint,
    )
    from distributed_pytorch_example_tpu_torch.train.optimizers import (
        Adafactor,
    )

    distributed.initialize(device="cuda")
    rank, world = distributed.process_index(), distributed.process_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    per = TRAIN_BATCH // world
    out = {"rank": rank, "world": world, "overlap": {}}
    tokens = torch.from_numpy(SyntheticTokenDataset(
        (OVERLAP_STEPS + 1) * TRAIN_BATCH, seq_len=TRAIN_SEQ,
        seed=0).arrays["tokens"]).long().reshape(
            OVERLAP_STEPS + 1, TRAIN_BATCH, TRAIN_SEQ)
    batches = [{"tokens": t[rank * per:(rank + 1) * per].to("cuda")}
               for t in tokens]
    # (c) phase 8's runs (i) and (ii), profiled
    for run, cfg in ZERO1_RUNS.items():
        model = GPT2(dtype=torch.bfloat16, logits_mode="hidden",
                     device="cuda", seed=0)
        part = data_parallel(world, dp_shard_opt_state=cfg["zero1"],
                             wire=WireConfig(
                                 compress=cfg["wire"],
                                 param_gather=cfg["param_gather"],
                                 bucket_bytes=DEFAULT_BUCKET_BYTES))
        state = TrainState(step=0, model=model,
                           optimizer=make_optimizer(model.parameters(),
                                                    "adam", 1e-3))
        step = build_train_step(CausalLMTask(), partitioner=part)
        float(step(state, batches[0])["loss"])  # warm-up

        def run_steps(n, step=step, state=state):
            for batch in batches[1:1 + n]:
                metrics = step(state, batch)
            float(metrics["loss"])

        ring_all_gather.launches = ring_reduce_scatter.launches = 0
        trace_dir = tempfile.mkdtemp(prefix=f"chip_smoke_overlap_{rank}_")
        try:
            got = measure_overlap(run_steps, trace_dir, steps=OVERLAP_STEPS,
                                  device="cuda")
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        check(got is not None, f"telemetry (c) {run} rank {rank}: the "
                               "trace holds no CUDA kernel")
        got["k3a"] = ring_all_gather.launches
        got["k3b"] = ring_reduce_scatter.launches
        got["exchange"] = exchange_step_times(got["wall_us_per_step"] / 1e3)
        out["overlap"][run] = got
        del model, state, step
        torch.cuda.empty_cache()
    # (d) adafactor under ZeRO-1, LLaMA's width at depth 2
    part = data_parallel(world, dp_shard_opt_state=True, wire=WireConfig(
        bucket_bytes=DEFAULT_BUCKET_BYTES))
    state, step = llama_lamb_state(torch, part, optimizer="adafactor")
    update = step.sharded(state)
    ref = [leaf.to_jax(p).detach().clone().requires_grad_()
           for leaf, p in zip(update.leaves, update.params)]
    ref_opt = Adafactor(ref, lr=1e-3)
    losses, tile_gap = [], 0.0
    for tokens in llama_lamb_batches(torch, ADAFACTOR_ZERO1_STEPS):
        local = {"tokens": tokens[rank * per:(rank + 1) * per].to("cuda")}
        losses.append(float(step(state, local)["loss"]))
        # adafactor on whole leaves, fed the same synced gradients
        for i, (leaf, p, tile) in enumerate(zip(
                update.leaves, update.params, update.tiles)):
            if tile is None:
                ref[i].grad = leaf.to_jax(p.grad).float()
            else:
                rows = distributed.all_gather_tiled(
                    tile.grad.reshape(1, -1))
                ref[i].grad = _unscatter(rows, update.dims[i],
                                         update.chunk_shapes[i])
        starts = [r.detach().clone() for r in ref]
        ref_opt.step()
        for leaf, p, r, start in zip(update.leaves, update.params, ref,
                                     starts):
            want = r.detach() - start
            got_u = leaf.to_jax(p).detach().float() - start
            tile_gap = max(tile_gap, ((got_u - want).norm()
                                      / want.norm().clamp_min(1e-30)).item())
            # hold the next step to the same starting point
            r.data.copy_(leaf.to_jax(p).detach())
    save_checkpoint(os.path.join(ckpt_dir, LATEST_NAME), state, 1,
                    losses[-1], {}, sharded=True, layout=step.layout(state))
    distributed.barrier()
    out["adafactor"] = {
        "losses": losses, "tile_gap": tile_gap,
        "zero1_leaves": sum(d is not None for d in update.dims),
        "factored_tiles": len(state.optimizer.optimizer.tiles),
        "params_sha256": params_digest(state.model),
    }
    print("chip_smoke_telemetry " + json.dumps(out), flush=True)
    distributed.shutdown()
    return 0


def telemetry_pair(torch, smi_line):
    """(c) and (d) in one pair of processes sharing the card; returns rank
    0's K3a and K3b launches in (c)'s profiled windows."""
    from distributed_pytorch_example_tpu_torch.models import Llama
    from distributed_pytorch_example_tpu_torch.train import (
        TrainState,
        load_checkpoint,
        make_optimizer,
    )
    from distributed_pytorch_example_tpu_torch.train.checkpoint import (
        LATEST_NAME,
    )

    state, step = llama_lamb_state(torch, optimizer="adafactor")
    ref_losses = [float(step(state, {"tokens": t.to("cuda")})["loss"])
                  for t in llama_lamb_batches(torch, ADAFACTOR_ZERO1_STEPS)]
    del state, step
    torch.cuda.empty_cache()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_adafactor_")
    try:
        port = free_port()
        procs = []
        for rank in range(ZERO1_WORLD):
            env = {**os.environ, "REPLICAS": str(ZERO1_WORLD),
                   "PROCESS_ID": str(rank), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--telemetry-worker", ckpt_dir],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        t0 = time.perf_counter()
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=600)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lines = {}
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            found = [line for line in out.splitlines()
                     if line.startswith("chip_smoke_telemetry ")]
            check(proc.returncode == 0 and found,
                  f"telemetry pair: rank {rank} exit {proc.returncode}: "
                  f"{out[-3000:]}")
            lines[rank] = json.loads(found[-1].split(" ", 1)[1])
        say("telemetry", f"(c)+(d): {ZERO1_WORLD} processes on the card in "
                         f"{time.perf_counter() - t0:.1f} s")
        for rank, r in lines.items():
            for run, o in r["overlap"].items():
                check(o.get("collective_us_per_step", 0) > 0,
                      f"telemetry (c) {run} rank {rank}: no collective "
                      f"device time (a trace without CUDA activity?): {o}")
                frac = o["overlap_frac"]
                check(frac is not None and 0 <= frac <= 1,
                      f"telemetry (c) {run} rank {rank}: overlap_frac {frac}")
                scopes = o["by_scope"]
                if run == "zero1":
                    k3b = scopes.get("ring_reduce_scatter", 0) + sum(
                        v for k, v in scopes.items()
                        if k.startswith("wire_bucket"))
                    check(o["k3b"] > 0 and k3b > 0,
                          f"telemetry (c) {run} rank {rank}: K3b launches "
                          f"{o['k3b']}, by_scope {scopes}")
                else:
                    check(o["k3a"] > 0
                          and scopes.get("ring_all_gather", 0) > 0,
                          f"telemetry (c) {run} rank {rank}: K3a launches "
                          f"{o['k3a']}, by_scope {scopes}")
                ex = o["exchange"]
                check(len(ex.get("step_time_ms_per_host", ())) == ZERO1_WORLD
                      and "step_time_skew" in ex,
                      f"telemetry (c) {run} rank {rank}: exchange {ex}")
                say("telemetry", f"(c) {run} rank {rank}: {OVERLAP_STEPS} "
                                 f"profiled steps, wall "
                                 f"{o['wall_us_per_step'] / 1e3:.2f} ms a "
                                 f"step, collective "
                                 f"{o['collective_us_per_step'] / 1e3:.2f} "
                                 f"ms, compute "
                                 f"{o['compute_us_per_step'] / 1e3:.2f} ms, "
                                 f"overlap_frac {frac:.4f}; by_scope (ms a "
                                 f"step) "
                                 f"{ {k: round(v / 1e3, 3) for k, v in sorted(scopes.items())} }"
                                 f"; K3a {o['k3a']} K3b {o['k3b']} launches;"
                                 f" per-host step ms "
                                 f"{ex['step_time_ms_per_host']}, skew "
                                 f"{ex['step_time_skew']}; on {smi_line}")
            a = r["adafactor"]
            gap = max(abs(x - y) for x, y in zip(a["losses"], ref_losses))
            check(gap <= LOSS_TOL,
                  f"telemetry (d) rank {rank}: adafactor ZeRO-1 losses "
                  f"{a['losses']} vs one process {ref_losses}")
            check(a["tile_gap"] <= LAMB_TILE_TOL,
                  f"telemetry (d) rank {rank}: the ZeRO-1 update is "
                  f"{a['tile_gap']:.3e} off adafactor on whole leaves > "
                  f"{LAMB_TILE_TOL}")
            check(a["zero1_leaves"] > 0 and a["factored_tiles"] > 0,
                  f"telemetry (d) rank {rank}: {a}")
            say("telemetry", f"(d) adafactor under ZeRO-1, LLaMA width 768 "
                             f"depth {LLAMA_ZERO1_LAYERS}, rank {rank}: "
                             f"losses {[round(x, 4) for x in a['losses']]} "
                             f"(one process "
                             f"{[round(x, 4) for x in ref_losses]}, gap "
                             f"{gap:.3e}, tol {LOSS_TOL}); updates against "
                             f"adafactor on whole leaves fed the same "
                             f"synced gradients, worst "
                             f"||u - u_ref|| / ||u_ref|| {a['tile_gap']:.3e}"
                             f" (tol {LAMB_TILE_TOL}); {a['zero1_leaves']} "
                             f"ZeRO-1 leaves")
        # the world-2 sharded checkpoint in one process
        model = Llama(num_layers=LLAMA_ZERO1_LAYERS, dtype=torch.bfloat16,
                      logits_mode="hidden", device="cuda", seed=3)
        state = TrainState(step=0, model=model,
                           optimizer=make_optimizer(model, "adafactor", 1e-3))
        load_checkpoint(os.path.join(ckpt_dir, LATEST_NAME), state)
        digest = params_digest(model)
        ranks = {rank: r["adafactor"]["params_sha256"]
                 for rank, r in lines.items()}
        check(all(d == digest for d in ranks.values())
              and state.step == ADAFACTOR_ZERO1_STEPS,
              f"telemetry (d): the world-2 sharded checkpoint loaded at "
              f"world 1 ({digest[:16]}, step {state.step}) differs from the"
              f" ranks' ({ranks})")
        say("telemetry", f"(d) the world-2 sharded adafactor checkpoint "
                         f"loaded in one process: parameters equal both "
                         f"ranks' bit for bit (sha256 {digest[:16]}), step "
                         f"{state.step}")
        del state, model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return (sum(o["k3a"] for o in lines[0]["overlap"].values()),
            sum(o["k3b"] for o in lines[0]["overlap"].values()))


def telemetry(torch, smi_line, phase6):
    """Phase 15; returns K1's launches in (a) and rank 0's K3 launches in
    (c)'s profiled windows."""
    t0 = time.perf_counter()
    fwd, bwd = telemetry_fit(torch, smi_line, phase6)
    telemetry_cli()
    k3a, k3b = telemetry_pair(torch, smi_line)
    say("telemetry", f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return fwd, bwd, k3a, k3b


# ---------------------------------------------------------------------------
# 16. fsdp: GPT-2 124M under --partition fsdp --mesh-fsdp 2
# ---------------------------------------------------------------------------

FSDP_WORLD, FSDP_STEPS = 2, 4
# FSDP against the replicated run in the same two processes, per step: the
# same bf16 forward on the same rows from the same (exactly gathered)
# float32 parameters, and a two-rank float32 gradient sum is exact in any
# order, so the gap is expected to be 0; 1e-5 is the resume tolerance
FSDP_LOSS_TOL = RESUME_TOL
# the cost record's residency against the card's steady-step peak in the
# same run (phase 15's peaks 8.10 GiB at 16 rows in one process): the
# figure is the state + batch + the step's growth; what the counter's peak
# holds beyond that is the loader's next batch and the allocator's own
HBM_MARGIN = 0.05


def fsdp_worker(ckpt_dir: str) -> int:
    """One rank of phase 16 (started by :func:`fsdp_phase` with REPLICAS /
    PROCESS_ID / MASTER_ADDR / MASTER_PORT set): the replicated world-2
    run, then the FSDP run (mesh data=1 x fsdp=2) of the same steps,
    which saves its sharded checkpoint in ``ckpt_dir``; prints one
    ``chip_smoke_fsdp`` JSON line."""
    import torch
    import torch.distributed

    from distributed_pytorch_example_tpu_torch.data import (
        DeviceLoader,
        SyntheticTokenDataset,
    )
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_all_gather,
        ring_reduce_scatter,
    )
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from distributed_pytorch_example_tpu_torch.parallel import (
        data_parallel,
        fsdp,
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

    distributed.initialize(device="cuda")
    rank, world = distributed.process_index(), distributed.process_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    train_ds = SyntheticTokenDataset(TRAIN_STEPS * TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ, seed=0)
    val_ds = SyntheticTokenDataset(TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=1)
    out = {"rank": rank, "world": world,
           "backend": torch.distributed.get_backend()}
    for run in ("replicated", "fsdp"):
        model = GPT2(dtype=torch.bfloat16, logits_mode="hidden",
                     device="cuda", seed=0)
        part = (fsdp(make_mesh(MeshSpec(data=1, fsdp=world)))
                if run == "fsdp" else data_parallel(world))
        trainer = Trainer(model, CausalLMTask(),
                          make_optimizer(model.parameters(), "adam", 1e-3),
                          partitioner=part, log_every=FSDP_STEPS,
                          checkpoint_dir=ckpt_dir if run == "fsdp" else None,
                          checkpoint_format="sharded")
        step_fn, losses, events, peaks = trainer.train_step, [], [], []

        def timed(state, batch, step_fn=step_fn, losses=losses,
                  events=events, peaks=peaks):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start.record()
            metrics = step_fn(state, batch)
            end.record()
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            losses.append(float(metrics["loss"]))
            events.append((start, end))
            return metrics

        trainer.train_step = timed
        reset_counts()
        trainer.fit(Take(DeviceLoader(train_ds, TRAIN_BATCH, device="cuda",
                                      seed=0), FSDP_STEPS),
                    DeviceLoader(val_ds, TRAIN_BATCH, device="cuda",
                                 shuffle=False), epochs=1)
        torch.cuda.synchronize()
        counts = {"k1_fwd": flash_attention_fwd.launches,
                  "k1_bwd": flash_attention_bwd.launches,
                  "k3a": ring_all_gather.launches,
                  "k3b": ring_reduce_scatter.launches}
        rec = {"losses": losses,
               "step_ms": [s.elapsed_time(e) for s, e in events],
               "step_peaks": peaks, "launches": counts,
               "hbm_peak_bytes": trainer.telemetry_summary["compiles"][
                   "train_step"]["hbm_peak_bytes"]}
        if run == "fsdp":
            update = trainer._step.sharded(trainer.state)
            rec["tiles"] = sum(t is not None for t in update.tiles)
            rec["freed"] = all(p.untyped_storage().nbytes() == 0
                               for p, t in zip(update.params, update.tiles)
                               if t is not None)
            rec["tile_bytes"] = sum(t.numel() * t.element_size()
                                    for t in update.tiles if t is not None)
            # the gathered parameters (a collective), as the flax tree
            rec["params_sha256"] = tree_digest(
                trainer.layout().params(gather=True))
        out[run] = rec
        del trainer, model, part
        gc.collect()
        torch.cuda.empty_cache()
    print("chip_smoke_fsdp " + json.dumps(out), flush=True)
    distributed.shutdown()
    return 0


def tree_digest(tree) -> str:
    """SHA-256 over a flax tree's leaves' bytes, in path order."""
    digest = hashlib.sha256()

    def walk(node, prefix=""):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{prefix}/{key}")
            return
        digest.update(prefix.encode())
        digest.update(node.detach().float().cpu().contiguous().view(-1)
                      .numpy().view("uint8").tobytes())

    walk(tree)
    return digest.hexdigest()


def fsdp_phase(torch, smi_line):
    """Phase 16; returns rank 0's K1 forward / backward, K3a and K3b
    launches in the FSDP run."""
    t0 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    try:
        lines = fsdp_pair(ckpt_dir)
        fsdp_check(torch, lines, ckpt_dir, smi_line)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    say("fsdp", f"phase 16 took {time.perf_counter() - t0:.1f} s")
    n = lines[0]["fsdp"]["launches"]
    return n["k1_fwd"], n["k1_bwd"], n["k3a"], n["k3b"]


def fsdp_pair(ckpt_dir):
    port = free_port()
    procs = []
    for rank in range(FSDP_WORLD):
        env = {**os.environ, "REPLICAS": str(FSDP_WORLD),
               "PROCESS_ID": str(rank), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fsdp-worker",
             ckpt_dir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
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
    lines = {}
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        found = [line for line in out.splitlines()
                 if line.startswith("chip_smoke_fsdp ")]
        check(proc.returncode == 0 and found,
              f"fsdp: rank {rank} exit {proc.returncode}: {out[-3000:]}")
        lines[rank] = json.loads(found[-1].split(" ", 1)[1])
    return lines


def fsdp_check(torch, lines, ckpt_dir, smi_line):
    from distributed_pytorch_example_tpu_torch import interop
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.train import (
        CausalLMTask,
        Trainer,
        make_optimizer,
    )
    from distributed_pytorch_example_tpu_torch.train.checkpoint import (
        LATEST_NAME,
    )

    say("fsdp", f"{FSDP_WORLD} processes on one card (backend "
                f"{lines[0]['backend']}), {TRAIN_BATCH // FSDP_WORLD} rows "
                f"each, {FSDP_STEPS} steps + 1 validation batch; {smi_line}")
    phase8 = ZERO1_LOSSES.get("zero1")
    for rank, r in lines.items():
        got, rep = r["fsdp"], r["replicated"]
        losses = got["losses"]
        check(len(losses) == FSDP_STEPS and all(map(math.isfinite, losses)),
              f"fsdp rank {rank}: losses {losses}")
        gap = max(abs(a - b) for a, b in zip(losses, rep["losses"]))
        check(gap <= FSDP_LOSS_TOL,
              f"fsdp rank {rank}: losses {losses} vs the replicated world-2 "
              f"run's {rep['losses']}: gap {gap:.3e} > {FSDP_LOSS_TOL}")
        line = (f"rank {rank}: losses {[round(x, 5) for x in losses]} vs "
                f"replicated world 2 {[round(x, 5) for x in rep['losses']]} "
                f"(gap {gap:.3e}, tol {FSDP_LOSS_TOL})")
        if phase8:
            gap8 = max(abs(a - b) for a, b in zip(losses, phase8))
            check(gap8 <= LOSS_TOL,
                  f"fsdp rank {rank}: losses {losses} vs phase 8 (i)'s "
                  f"{phase8}: gap {gap8:.3e} > {LOSS_TOL}")
            line += f"; vs phase 8 (i) gap {gap8:.3e} (tol {LOSS_TOL})"
        say("fsdp", line)
        n = got["launches"]
        check(n["k1_fwd"] == LAYERS * (FSDP_STEPS + 1)
              and n["k1_bwd"] == LAYERS * FSDP_STEPS,
              f"fsdp rank {rank}: K1 launches {n['k1_fwd']} / {n['k1_bwd']},"
              f" want {LAYERS * (FSDP_STEPS + 1)} / {LAYERS * FSDP_STEPS}")
        check(n["k3a"] > 0 and n["k3b"] > 0,
              f"fsdp rank {rank}: K3a {n['k3a']}, K3b {n['k3b']}; want > 0")
        check(got["tiles"] > 0 and got["freed"],
              f"fsdp rank {rank}: {got['tiles']} tiles, parameters freed "
              f"between steps: {got['freed']}")
        for name, rec in (("fsdp", got), ("replicated", rep)):
            ms = sorted(rec["step_ms"][1:])
            hbm = rec["hbm_peak_bytes"]
            steady = max(rec["step_peaks"][1:])
            check(hbm is not None and abs(hbm - steady) <= HBM_MARGIN * steady,
                  f"fsdp rank {rank} {name}: hbm_peak_bytes {hbm} vs the "
                  f"steady steps' peak {steady} (margin {HBM_MARGIN})")
            say("fsdp", f"rank {rank} {name}: step ms median "
                        f"{ms[len(ms) // 2]:.2f} (steps 2+, {ms[0]:.2f}-"
                        f"{ms[-1]:.2f}); hbm_peak_bytes {hbm} "
                        f"({hbm / 2**30:.3f} GiB; steps 2+ peak "
                        f"{steady / 2**30:.3f} GiB); launches K1 "
                        f"{rec['launches']['k1_fwd']} / "
                        f"{rec['launches']['k1_bwd']}, K3a "
                        f"{rec['launches']['k3a']}, K3b "
                        f"{rec['launches']['k3b']}")
        say("fsdp", f"rank {rank}: hbm_peak_bytes FSDP "
                    f"{got['hbm_peak_bytes'] / 2**30:.3f} GiB against "
                    f"replicated {rep['hbm_peak_bytes'] / 2**30:.3f} GiB "
                    f"({(rep['hbm_peak_bytes'] - got['hbm_peak_bytes']) / 2**30:+.3f}"
                    f" GiB saved); {got['tiles']} tiles, "
                    f"{got['tile_bytes'] / 2**30:.3f} GiB of parameter tiles")
    digests = {r["fsdp"]["params_sha256"] for r in lines.values()}
    check(len(digests) == 1, f"fsdp: ranks gathered different parameters")
    # the sharded checkpoint, loaded in one process on the card
    model = GPT2(dtype=torch.bfloat16, logits_mode="hidden", device="cuda",
                 seed=5)
    trainer = Trainer(model, CausalLMTask(),
                      make_optimizer(model.parameters(), "adam", 1e-3),
                      telemetry=False)
    t0 = time.perf_counter()
    epoch, _ = trainer.load(os.path.join(ckpt_dir, LATEST_NAME))
    load_s = time.perf_counter() - t0
    got = tree_digest(interop.params_to_flax(model))
    check(epoch == 1 and got in digests,
          f"fsdp: the world-2 FSDP checkpoint loaded at world 1 (epoch "
          f"{epoch}) holds other parameters than the gathered ones")
    say("fsdp", f"the sharded FSDP checkpoint loaded at world 1 in "
                f"{load_s:.2f} s: parameters bit-equal to the gathered ones "
                f"(sha256 {got[:16]})")
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 17. tp: GPT-2 124M and LLaMA under --partition tp --mesh-tensor 2
# ---------------------------------------------------------------------------

TP_WORLD, TP_ROWS, TP_STEPS = 2, 8, 4
LLAMA_TP_LAYERS, LLAMA_TP_STEPS = 2, 2
# TP against a replicated run of the same rows: both bf16, but a
# row-parallel layer rounds each rank's half product to bf16 before the
# float32 sum where one GEMM rounds once, so activations differ by bf16
# ulps from the first layer on; phase 6's bound for two bf16 runs that
# round differently (flash against plain attention)
TP_LOSS_TOL = LOSS_TOL


def tp_fit(kind: str, mesh=None, ckpt_dir=None) -> dict:
    """One ``Trainer.fit`` of phase 17 on the card, Adam at lr 1e-3,
    ``TP_ROWS`` rows a step: GPT-2 124M (``TP_STEPS`` steps and one
    validation batch) or LLaMA at depth ``LLAMA_TP_LAYERS``
    (``LLAMA_TP_STEPS`` steps), cut over ``mesh``'s tensor axis (None: one
    replicated process). Returns the losses, step ms and peaks, launches,
    the tensor group's collectives, ``hbm_peak_bytes``, the state's bytes
    and the gathered parameters' digest."""
    import torch

    from distributed_pytorch_example_tpu_torch import interop
    from distributed_pytorch_example_tpu_torch.data import (
        DeviceLoader,
        SyntheticTokenDataset,
    )
    from distributed_pytorch_example_tpu_torch.models import GPT2, Llama
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from distributed_pytorch_example_tpu_torch.parallel import (
        TensorParallel,
        tensor_parallel,
        transformer_partitioner,
    )
    from distributed_pytorch_example_tpu_torch.train import (
        CausalLMTask,
        Trainer,
        make_optimizer,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    tp = None if mesh is None else TensorParallel.from_mesh(mesh)
    if kind == "gpt2":
        model = GPT2(dtype=torch.bfloat16, logits_mode="hidden",
                     device="cuda", seed=0, tensor_parallel=tp)
        vocab, steps, val = 50257, TP_STEPS, True
    else:
        model = Llama(num_layers=LLAMA_TP_LAYERS, dtype=torch.bfloat16,
                      logits_mode="hidden", device="cuda", seed=0,
                      tensor_parallel=tp)
        vocab, steps, val = LLAMA_VOCAB, LLAMA_TP_STEPS, False
    train_ds = SyntheticTokenDataset(steps * TP_ROWS, seq_len=TRAIN_SEQ,
                                     vocab_size=vocab, seed=0)
    val_ds = SyntheticTokenDataset(TP_ROWS, seq_len=TRAIN_SEQ,
                                   vocab_size=vocab, seed=1)
    trainer = Trainer(model, CausalLMTask(),
                      make_optimizer(model.parameters(), "adam", 1e-3),
                      partitioner=(None if mesh is None
                                   else transformer_partitioner(mesh)),
                      log_every=steps, checkpoint_dir=ckpt_dir,
                      checkpoint_format="sharded")
    step_fn, losses, events, peaks = trainer.train_step, [], [], []

    def timed(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start.record()
        metrics = step_fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        losses.append(float(metrics["loss"]))
        events.append((start, end))
        return metrics

    trainer.train_step = timed
    reset_counts()
    tensor_parallel.reset_counts()
    trainer.fit(DeviceLoader(train_ds, TP_ROWS, device="cuda", seed=0,
                             mesh=mesh),
                DeviceLoader(val_ds, TP_ROWS, device="cuda", shuffle=False,
                             mesh=mesh) if val else None, epochs=1)
    torch.cuda.synchronize()
    opt = trainer.state.optimizer.optimizer
    state_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters()) + sum(
        v.numel() * v.element_size() for st in opt.state.values()
        for v in st.values() if isinstance(v, torch.Tensor) and v.dim())
    params = (trainer.layout().params(gather=True) if mesh is not None
              else interop.params_to_flax(model))
    rec = {"losses": losses,
           "step_ms": [s.elapsed_time(e) for s, e in events],
           "step_peaks": peaks,
           "launches": {"k1_fwd": flash_attention_fwd.launches,
                        "k1_bwd": flash_attention_bwd.launches},
           "tensor": dict(tensor_parallel.counts),
           "hbm_peak_bytes": trainer.telemetry_summary["compiles"][
               "train_step"]["hbm_peak_bytes"],
           "params": sum(p.numel() for p in model.parameters()),
           "state_bytes": state_bytes,
           "params_sha256": tree_digest(params)}
    del trainer, model, opt, params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def tp_worker(ckpt_dir: str) -> int:
    """One rank of phase 17 (started by :func:`tp_phase` with REPLICAS /
    PROCESS_ID / MASTER_ADDR / MASTER_PORT set): GPT-2 under the mesh
    data=1 x tensor=2, saving its sharded checkpoint in ``ckpt_dir``, then
    LLaMA; prints one ``chip_smoke_tp`` JSON line."""
    import torch.distributed

    from distributed_pytorch_example_tpu_torch.runtime import (
        MeshSpec,
        distributed,
        make_mesh,
    )

    distributed.initialize(device="cuda")
    mesh = make_mesh(MeshSpec(data=1, tensor=TP_WORLD))
    out = {"rank": distributed.process_index(),
           "world": distributed.process_count(),
           "backend": torch.distributed.get_backend(),
           "gpt2": tp_fit("gpt2", mesh, ckpt_dir),
           "llama": tp_fit("llama", mesh)}
    print("chip_smoke_tp " + json.dumps(out), flush=True)
    distributed.shutdown()
    return 0


def tp_phase(torch, smi_line):
    """Phase 17; returns rank 0's K1 forward / backward launches in the
    GPT-2 TP run."""
    t0 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        lines = tp_pair(ckpt_dir)
        tp_check(torch, lines, ckpt_dir, smi_line)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    say("tp", f"phase 17 took {time.perf_counter() - t0:.1f} s")
    n = lines[0]["gpt2"]["launches"]
    return n["k1_fwd"], n["k1_bwd"]


def tp_pair(ckpt_dir):
    port = free_port()
    procs = []
    for rank in range(TP_WORLD):
        env = {**os.environ, "REPLICAS": str(TP_WORLD),
               "PROCESS_ID": str(rank), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-worker",
             ckpt_dir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
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
    lines = {}
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        found = [line for line in out.splitlines()
                 if line.startswith("chip_smoke_tp ")]
        check(proc.returncode == 0 and found,
              f"tp: rank {rank} exit {proc.returncode}: {out[-3000:]}")
        lines[rank] = json.loads(found[-1].split(" ", 1)[1])
    return lines


def tp_check(torch, lines, ckpt_dir, smi_line):
    from distributed_pytorch_example_tpu_torch import interop
    from distributed_pytorch_example_tpu_torch.models import GPT2
    from distributed_pytorch_example_tpu_torch.train import (
        CausalLMTask,
        Trainer,
        make_optimizer,
    )
    from distributed_pytorch_example_tpu_torch.train.checkpoint import (
        LATEST_NAME,
    )

    say("tp", f"{TP_WORLD} processes on one card (backend "
              f"{lines[0]['backend']}), mesh data=1 x tensor={TP_WORLD}, "
              f"the same {TP_ROWS} rows on each; {smi_line}")
    for kind in ("gpt2", "llama"):
        ref = tp_fit(kind)  # one replicated process, the same rows
        gpt = kind == "gpt2"
        layers = LAYERS if gpt else LLAMA_TP_LAYERS
        steps = TP_STEPS if gpt else LLAMA_TP_STEPS
        passes = steps + 1 if gpt else steps
        want_tensor = ({"forward": 2 * layers * passes,
                        "backward": 2 * layers * steps} if gpt else
                       {"forward": (2 * layers + 2) * passes,
                        "backward": (2 * layers + 1) * steps})
        check(lines[0][kind]["losses"] == lines[1][kind]["losses"],
              f"tp {kind}: the ranks' losses differ: "
              f"{lines[0][kind]['losses']} / {lines[1][kind]['losses']}")
        for rank, r in lines.items():
            got = r[kind]
            losses = got["losses"]
            check(len(losses) == steps and all(map(math.isfinite, losses)),
                  f"tp {kind} rank {rank}: losses {losses}")
            gap = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
            check(gap <= TP_LOSS_TOL,
                  f"tp {kind} rank {rank}: losses {losses} vs the "
                  f"replicated run's {ref['losses']}: gap {gap:.3e} > "
                  f"{TP_LOSS_TOL}")
            n = got["launches"]
            check(n["k1_fwd"] == layers * passes
                  and n["k1_bwd"] == layers * steps,
                  f"tp {kind} rank {rank}: K1 launches {n['k1_fwd']} / "
                  f"{n['k1_bwd']}, want {layers * passes} / "
                  f"{layers * steps}")
            check(got["tensor"] == want_tensor,
                  f"tp {kind} rank {rank}: tensor-group collectives "
                  f"{got['tensor']}, want {want_tensor}")
            hbm = got["hbm_peak_bytes"]
            check(hbm is not None and hbm < ref["hbm_peak_bytes"],
                  f"tp {kind} rank {rank}: hbm_peak_bytes {hbm} not below "
                  f"the replicated run's {ref['hbm_peak_bytes']}")
            ms = sorted(got["step_ms"][1:])
            say("tp", f"{kind} rank {rank}: losses "
                      f"{[round(x, 5) for x in losses]} vs replicated "
                      f"{[round(x, 5) for x in ref['losses']]} (gap "
                      f"{gap:.3e}, tol {TP_LOSS_TOL}); step ms median "
                      f"{ms[len(ms) // 2]:.2f} (steps 2+, {ms[0]:.2f}-"
                      f"{ms[-1]:.2f}); launches K1 {n['k1_fwd']} / "
                      f"{n['k1_bwd']}, tensor all-reduces "
                      f"{got['tensor']}")
            say("tp", f"{kind} rank {rank}: {got['params']:,} parameters "
                      f"of {ref['params']:,}; float32 state "
                      f"{got['state_bytes'] / 2**30:.3f} GiB against "
                      f"{ref['state_bytes'] / 2**30:.3f}; hbm_peak_bytes "
                      f"{hbm} ({hbm / 2**30:.3f} GiB) against replicated "
                      f"{ref['hbm_peak_bytes']} "
                      f"({ref['hbm_peak_bytes'] / 2**30:.3f} GiB); steps 2+ "
                      f"peak {max(got['step_peaks'][1:]) / 2**30:.3f} GiB")
        ms = sorted(ref["step_ms"][1:])
        say("tp", f"{kind} replicated: step ms median {ms[len(ms) // 2]:.2f}"
                  f" ({ms[0]:.2f}-{ms[-1]:.2f}), launches K1 "
                  f"{ref['launches']['k1_fwd']} / {ref['launches']['k1_bwd']}")
    digests = {r["gpt2"]["params_sha256"] for r in lines.values()}
    check(len(digests) == 1, "tp: ranks gathered different parameters")
    # the sharded checkpoint, loaded in one process on the card
    model = GPT2(dtype=torch.bfloat16, logits_mode="hidden", device="cuda",
                 seed=5)
    trainer = Trainer(model, CausalLMTask(),
                      make_optimizer(model.parameters(), "adam", 1e-3),
                      telemetry=False)
    t0 = time.perf_counter()
    epoch, _ = trainer.load(os.path.join(ckpt_dir, LATEST_NAME))
    load_s = time.perf_counter() - t0
    got = tree_digest(interop.params_to_flax(model))
    check(epoch == 1 and got in digests,
          f"tp: the world-2 TP checkpoint loaded at world 1 (epoch {epoch}) "
          "holds other parameters than the gathered ones")
    say("tp", f"the sharded TP checkpoint loaded at world 1 in "
              f"{load_s:.2f} s: parameters bit-equal to the gathered ones "
              f"(sha256 {got[:16]})")
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        import distributed_pytorch_example_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the port package is missing ({err}); run from "
              "the repository root", file=sys.stderr)
        return 2
    phase = "probe"
    t_start = time.perf_counter()
    try:
        smi_line, bandwidth = probe(torch)
        phase = "build"
        build()
        phase = "kernel"
        k2 = check_kernels(torch, bandwidth)
        k1_fwd, k1_bwd = check_flash(torch, bandwidth)
        k3a, k3b = check_ring(torch, bandwidth)
        phase = "serve"
        k2["launches"], serve_runs = serve(torch)
        phase = "cli"
        cli()
        phase = "train"
        (k1_fwd["launches"], k1_bwd["launches"], losses, grads,
         phase6) = train(torch)
        phase = "train-cli"
        train_cli()
        phase = "zero1"
        k3a["launches"], k3b["launches"] = zero1_path(torch, losses, grads)
        phase = "checkpoint"
        checkpoint(torch)
        phase = "bert"
        k1_fwd["bert"]["launches"], k1_bwd["bert"]["launches"] = bert(
            torch, smi_line)
        phase = "vision"
        vision(torch, smi_line)
        phase = "llama"
        k1_llama, k2["llama"] = llama(torch, smi_line, bandwidth)
        k1_fwd["llama"], k1_bwd["llama"] = k1_llama["fwd"], k1_llama["bwd"]
        phase = "launch"
        counts = launch(torch, smi_line)
        for entry, key in ((k1_fwd, "k1_fwd"), (k1_bwd, "k1_bwd"),
                           (k3a, "k3a"), (k3b, "k3b")):
            entry["launch"] = {"launches": counts[key],
                               "run": "phase 13 (a), rank 0 after the "
                                      "restart"}
        phase = "decode"
        k2["decode"] = {"launches": decode(torch, serve_runs),
                        "run": "phase 14 (a)-(c): the drafts' one-token "
                               "steps"}
        phase = "telemetry"
        fwd, bwd, k3a_n, k3b_n = telemetry(torch, smi_line, phase6)
        k1_fwd["telemetry"] = {"launches": fwd, "run": "phase 15 (a)"}
        k1_bwd["telemetry"] = {"launches": bwd, "run": "phase 15 (a)"}
        for entry, n in ((k3a, k3a_n), (k3b, k3b_n)):
            entry["telemetry"] = {"launches": n,
                                  "run": "phase 15 (c), rank 0's profiled "
                                         "windows"}
        phase = "fsdp"
        for entry, n in zip((k1_fwd, k1_bwd, k3a, k3b),
                            fsdp_phase(torch, smi_line)):
            entry["fsdp"] = {"launches": n, "run": "phase 16, rank 0 of "
                                                   "the FSDP run"}
        phase = "tp"
        for entry, n in zip((k1_fwd, k1_bwd), tp_phase(torch, smi_line)):
            entry["tp"] = {"launches": n, "run": "phase 17, rank 0 of the "
                                                 "GPT-2 TP run (6 heads)"}
    except Exception:  # report the failed phase and exit non-zero
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} FAILED", file=sys.stderr)
        return 1
    say("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k2, k1_fwd, k1_bwd, k3a, k3b]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--path-worker"]:
        sys.exit(path_worker(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--llama-lamb-worker"]:
        sys.exit(llama_lamb_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--telemetry-worker"]:
        sys.exit(telemetry_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--fsdp-worker"]:
        sys.exit(fsdp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--launch-worker"]:
        sys.exit(launch_worker(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
