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
   card at the main path's shapes, then time kernel, plain version and one
   library call, beside the least time the card could take (the bound);
4. serve  — GPT-2 124M at full width (random weights from a seed) through
   ``InferenceEngine.run``: 16 requests greedy, then at temperature 1.0 with
   top-k 50; checks every request completes, the paged-decode kernel ran
   once per layer per decode step, and the paged logits and greedy tokens
   agree with the port's plain full-sequence forward;
5. cli    — ``python -m distributed_pytorch_example_tpu_torch.serve``
   at its defaults; its JSON line must parse.

The line before the last is a JSON object listing every ported kernel with
its numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# HBM bandwidth (bytes/s) by the card's reported name (NVIDIA data sheets);
# float32 peak outside the tensor cores (FLOP/s) for the H100 SXM part.
_BANDWIDTH = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
              ("H100", 3.35e12))
_F32_PEAK = 67e12

SLOTS, HEADS, HEAD_DIM, LAYERS = 8, 12, 64, 12
BLOCK_SIZE, MAX_BLOCKS, NUM_BLOCKS = 16, 64, 513
# row lengths straddling block edges: first/last position of a block,
# one-block rows, a full table
KERNEL_LENS = (0, 15, 16, 17, 255, 256, 511, 1023)


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


def time_cold(torch, fn, iters=50):
    """Mean ms of ``fn`` with the 50 MB L2 flushed before every launch (the
    serving path reads each layer's pool cold); events bracket only fn."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
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
        paged_attention_reference,
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

    # timing at the main path's shape and dtype (fp32 MHA)
    q, pk, pv, table, lens = kernel_case(
        torch, seed=0, heads=HEADS, kv_heads=HEADS, head_dim=HEAD_DIM,
        dtype=torch.float32, **geometry,
    )
    q4, pos2 = q[:, None], lens[:, None]
    idx = table.long()
    gk = pk[idx].reshape(SLOTS, -1, HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    gv = pv[idx].reshape(SLOTS, -1, HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    key_pos = torch.arange(MAX_BLOCKS * BLOCK_SIZE, device="cuda")
    mask = (key_pos[None, :] <= lens[:, None])[:, None, None, :]
    qh = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = {}
    # plain, kernel, kernel, plain: keep the comparison inside one call
    for label, fn in (
        ("plain", lambda: paged_attention_reference(q4, pk, pv, table, pos2)),
        ("kernel", lambda: paged_flash_decode(q, pk, pv, table, lens)),
        ("kernel2", lambda: paged_flash_decode(q, pk, pv, table, lens)),
        ("plain2", lambda: paged_attention_reference(q4, pk, pv, table, pos2)),
        ("library", lambda: sdpa(qh, gk, gv, attn_mask=mask)),
    ):
        ms[label] = time_cold(torch, fn)
    live_keys = sum(min(p, MAX_BLOCKS * BLOCK_SIZE - 1) + 1 for p in KERNEL_LENS)
    kv_bytes = 2 * live_keys * HEADS * HEAD_DIM * 4
    io_bytes = 2 * SLOTS * HEADS * HEAD_DIM * 4 + table.numel() * 4 + SLOTS * 4
    flops = 4 * live_keys * HEADS * HEAD_DIM
    bytes_ms = (kv_bytes + io_bytes) / bandwidth * 1e3
    ops_ms = flops / _F32_PEAK * 1e3
    say("kernel", f"paged_flash_decode fp32 B={SLOTS} N={HEADS} H={HEAD_DIM} "
                  f"bs={BLOCK_SIZE} mb={MAX_BLOCKS} lens={list(KERNEL_LENS)}: "
                  f"kernel {ms['kernel']:.4f}/{ms['kernel2']:.4f} ms, plain "
                  f"{ms['plain']:.4f}/{ms['plain2']:.4f} ms, library (SDPA on "
                  f"pre-gathered KV) {ms['library']:.4f} ms, bound "
                  f"{max(bytes_ms, ops_ms):.4f} ms "
                  f"({kv_bytes + io_bytes} bytes, {flops} flops)")
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
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": ms["library"],
    }


# ---------------------------------------------------------------------------
# 4. serve: the main path at full width
# ---------------------------------------------------------------------------


def workload(Request, seed=0, n=16):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [
        Request(
            rid=f"req{i:04d}",
            prompt=[int(t) for t in rng.integers(0, 50257,
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
        paged_flash_decode.launches = 0
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


def check_against_plain(torch, model, report):
    """Greedy tokens and paged logits against the plain full-sequence
    forward on the card (same weights, no KV cache, no kernel)."""
    from distributed_pytorch_example_tpu_torch.models import GPT2

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
            prompt = workload_prompt(rid)
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
            say("serve", f"{rid}: {len(r['tokens'])} greedy tokens are the "
                         f"plain forward's argmax (exact={exact}, worst gap "
                         f"{gap:.2e})")
        # paged prefill + 3 decode steps vs the plain forward, logit by logit
        rid = rids[0]
        prompt = workload_prompt(rid)
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
        say("serve", f"paged prefill + {len(gen)} decode steps vs plain "
                     f"forward: max abs logit err {err:.3e} (tol "
                     f"{logit_tol}: float32, reduction order only)")


def workload_prompt(rid):
    from distributed_pytorch_example_tpu_torch.serving import Request

    return list(next(r for r in workload(Request) if r.rid == rid).prompt)


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
        _smi, bandwidth = probe(torch)
        phase = "build"
        build()
        phase = "kernel"
        k2 = check_kernels(torch, bandwidth)
        phase = "serve"
        k2["launches"] = serve(torch)
        phase = "cli"
        cli()
    except Exception:  # report the failed phase and exit non-zero
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
