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

Each main path (serve, train, zero1, checkpoint, bert, vision, and
llama's train and serve) runs with every launch count set to 0 just
before it and read just after.

The line before the last is a JSON object listing every ported kernel with
its numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
    return sum(launches for _, launches in runs.values())


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


def fit_run(torch, model, task, train_ds, val_ds, batch, steps=None):
    """One epoch of ``Trainer.fit`` on the card, Adam at lr 1e-3, over the
    first ``steps`` batches (default all); returns (losses, step ms,
    history, peak bytes, the first step's gradients by name on the
    CPU)."""
    from distributed_pytorch_example_tpu_torch.data import DeviceLoader
    from distributed_pytorch_example_tpu_torch.train import (
        Trainer,
        make_optimizer,
    )

    trainer = Trainer(model, task,
                      make_optimizer(model.parameters(), "adam", 1e-3),
                      log_every=5)
    step_fn, losses, events, first_grads = trainer.train_step, [], [], {}

    def timed(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step_fn(state, batch)
        end.record()
        if not events:  # copied to the host: the peak stays the run's own
            first_grads.update(
                (name, p.grad.detach().to("cpu", copy=True))
                for name, p in model.named_parameters() if p.grad is not None
            )
        losses.append(metrics["loss"])
        events.append((start, end))
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
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in events]
    del trainer, model
    torch.cuda.empty_cache()
    return [float(x) for x in losses], step_ms, history, peak, first_grads


def train_run(torch, use_flash):
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
                   TRAIN_BATCH)


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
    plain, plain_ms, _, plain_peak, plain_grads = train_run(torch,
                                                            use_flash=False)
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
    return fwd, bwd, losses, grads


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
                      checkpoint_dir=ckpt_dir or None)
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


def llama_lamb_batches(torch):
    """The ZeRO-1 lamb run's global batches: 16 x 1024 tokens each."""
    from distributed_pytorch_example_tpu_torch.data import (
        SyntheticTokenDataset,
    )

    ds = SyntheticTokenDataset(LLAMA_ZERO1_STEPS * TRAIN_BATCH,
                               seq_len=TRAIN_SEQ, vocab_size=LLAMA_VOCAB,
                               seed=0)
    tokens = torch.from_numpy(ds.arrays["tokens"]).long()
    return tokens.reshape(LLAMA_ZERO1_STEPS, TRAIN_BATCH, TRAIN_SEQ)


def llama_lamb_state(torch, partitioner=None):
    """LLaMA at depth 2, bf16, fused loss, lamb at lr 1e-3, and its step."""
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
                       optimizer=make_optimizer(model, "lamb", 1e-3))
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
    try:
        smi_line, bandwidth = probe(torch)
        phase = "build"
        build()
        phase = "kernel"
        k2 = check_kernels(torch, bandwidth)
        k1_fwd, k1_bwd = check_flash(torch, bandwidth)
        k3a, k3b = check_ring(torch, bandwidth)
        phase = "serve"
        k2["launches"] = serve(torch)
        phase = "cli"
        cli()
        phase = "train"
        k1_fwd["launches"], k1_bwd["launches"], losses, grads = train(torch)
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
    except Exception:  # report the failed phase and exit non-zero
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} FAILED", file=sys.stderr)
        return 1
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
    sys.exit(main())
