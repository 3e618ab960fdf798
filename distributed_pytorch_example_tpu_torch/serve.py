"""Serving CLI: seeded open-loop load over the port's paged-KV engine.

The single-replica path of the JAX package's ``serve.py``, with the same
flags and defaults plus ``--device`` (default ``cuda``): an
:class:`InferenceEngine` over a randomly initialised GPT-2 of CLI-chosen
size (``--family gpt2``) or LLaMA (``--family llama``: RoPE, RMSNorm,
SwiGLU, ``--num-kv-heads`` kv heads), driven by a seeded Poisson
open-loop workload of mixed prompt and output lengths. stdout gets exactly ONE JSON line with the same keys as
the JAX package's ``serve.py``; per-request detail lines go to stderr::

    python -m distributed_pytorch_example_tpu_torch.serve --requests 16 --rate 4

Both families build ``mlp_dim = 2 * model_dim``, as the JAX ``serve.py``
does. ``--spec-tokens K`` (K >= 2) turns on speculative decoding by
self-speculation: the draft is a second decode module of the same
geometry whose parameters are the target's own tensors (no second copy of
the weights) over a pool of its own; exact-match acceptance keeps the
streams those of plain decoding. Not in this slice, and refused with a
pointer to ROADMAP.md: ``--mesh``, ``--auto-mesh``, ``--replicas > 1`` and
``--publish-dir``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_range(spec: str, flag: str):
    try:
        lo, hi = (int(x) for x in spec.split(":"))
    except ValueError:
        raise SystemExit(f"{flag} wants LO:HI, got {spec!r}")
    if lo < 1 or hi < lo:
        raise SystemExit(f"{flag} wants 1 <= LO <= HI, got {spec!r}")
    return lo, hi


def build_requests(args):
    """The seeded workload: Poisson arrivals, uniform mixed lengths (the
    JAX ``serve.py``'s numpy stream, so both CLIs serve the same requests)."""
    import numpy as np

    from distributed_pytorch_example_tpu_torch.serving import Request

    rng = np.random.default_rng(args.seed)
    plo, phi = _parse_range(args.prompt_len, "--prompt-len")
    olo, ohi = _parse_range(args.max_new, "--max-new")
    arrivals = (
        np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
        if args.rate > 0 else np.zeros(args.requests)
    )
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(plo, phi + 1))
        reqs.append(Request(
            rid=f"req{i:04d}",
            prompt=[int(t) for t in rng.integers(0, args.vocab_size, plen)],
            max_new_tokens=int(rng.integers(olo, ohi + 1)),
            seed=args.seed * 100_003 + i,
            arrival=float(arrivals[i]),
            session=(
                f"s{i % args.sessions}" if args.sessions > 0 else None
            ),
        ))
    return reqs


def build_model(args):
    """The paged decode model of ``--family`` (random weights from
    ``--seed``) on ``--device``."""
    from distributed_pytorch_example_tpu_torch.models import GPT2, Llama

    kw = dict(
        vocab_size=args.vocab_size, max_len=args.max_len,
        model_dim=args.model_dim, num_layers=args.num_layers,
        num_heads=args.num_heads, mlp_dim=2 * args.model_dim,
    )
    if args.family == "llama":
        cls = Llama
        kw["num_kv_heads"] = args.num_kv_heads or args.num_heads
    else:
        cls = GPT2
    return cls(
        **kw, decode=True, paged_num_blocks=args.num_blocks,
        paged_block_size=args.block_size, paged_max_blocks=args.max_blocks,
        device=args.device, seed=args.seed,
    )


def build_engine(args, trace, model=None):
    """The engine over ``model`` (default :func:`build_model`); with
    ``--spec-tokens`` the target drafts for itself (self-speculation)."""
    from distributed_pytorch_example_tpu_torch.serving import InferenceEngine
    from distributed_pytorch_example_tpu_torch.serving.engine import (
        self_draft,
    )

    if model is None:
        model = build_model(args)
    spec = {}
    if args.spec_tokens:
        spec = dict(draft_model=self_draft(model),
                    spec_tokens=args.spec_tokens)
    return InferenceEngine(
        model, num_slots=args.slots, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, trace=trace, mode=args.mode,
        device=args.device, **spec,
    )


def parse_chaos(spec: str):
    """Same contract as the JAX ``serve.py``'s --chaos: a preset or a JSON plan."""
    from distributed_pytorch_example_tpu_torch.robustness import chaos

    return (
        chaos.ChaosPlan.from_json(spec)
        if spec.lstrip().startswith("{") else chaos.preset(spec)
    )


def _config_dict(args):
    return {
        "family": args.family, "requests": args.requests,
        "rate": args.rate, "mode": args.mode, "slots": args.slots,
        "num_blocks": args.num_blocks, "block_size": args.block_size,
        "max_blocks": args.max_blocks,
        "prompt_len": args.prompt_len, "max_new": args.max_new,
        "temperature": args.temperature, "top_k": args.top_k,
        "top_p": args.top_p, "seed": args.seed, "device": args.device,
        **({"chaos": args.chaos} if args.chaos else {}),
        **({"sessions": args.sessions} if args.sessions else {}),
        **({"spec_tokens": args.spec_tokens} if args.spec_tokens else {}),
    }


def write_metrics_snapshot(path, metrics, config):
    """``--metrics-snapshot``: dump the latency summaries next to the
    trace, for offline inspection."""
    import os

    payload = {
        "metrics": {
            k: v for k, v in metrics.items()
            if k in ("ttft_ms", "tpot_ms", "queue_wait_ms")
        },
        "config": config,
    }
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def _not_in_slice(parser, flag):
    parser.error(
        f"{flag} is not ported to the PyTorch package yet; see ROADMAP.md "
        "queue 1 (use the JAX package's serve.py meanwhile)"
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--family", default="gpt2",
                        choices=("gpt2", "llama"))
    parser.add_argument("--vocab-size", type=int, default=256)
    parser.add_argument("--max-len", type=int, default=128)
    parser.add_argument("--model-dim", type=int, default=64)
    parser.add_argument("--num-layers", type=int, default=2)
    parser.add_argument("--num-heads", type=int, default=4)
    parser.add_argument("--num-kv-heads", type=int, default=0,
                        help="llama GQA kv heads (0 = num-heads)")
    parser.add_argument("--slots", type=int, default=4,
                        help="decode batch rows (the fixed slot array)")
    parser.add_argument("--num-blocks", type=int, default=64,
                        help="KV pool blocks per layer (incl. scratch)")
    parser.add_argument("--block-size", type=int, default=8,
                        help="tokens per pool block")
    parser.add_argument("--max-blocks", type=int, default=16,
                        help="page-table width (max context / block size)")
    parser.add_argument("--requests", type=int, default=32)
    parser.add_argument("--rate", type=float, default=8.0,
                        help="Poisson arrival rate, req/s (0 = all at t=0)")
    parser.add_argument("--prompt-len", default="4:24", metavar="LO:HI",
                        help="uniform prompt-length range")
    parser.add_argument("--max-new", default="8:32", metavar="LO:HI",
                        help="uniform output-length range")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=1.0,
                        help="0 = greedy")
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--spec-tokens", type=int, default=0,
                        help="speculative decoding window K >= 2 (0 = "
                        "off): the model drafts for itself "
                        "(self-speculation), the verify step commits the "
                        "exact-match prefix, so the output is that of "
                        "non-speculative decode at any temperature")
    parser.add_argument("--mode", default="continuous",
                        choices=("continuous", "static"),
                        help="static = classic wave batching (admit only "
                        "when every slot drained)")
    parser.add_argument("--mesh", default="",
                        help="sharded serving (not ported)")
    parser.add_argument("--auto-mesh", action="store_true",
                        help="planner-picked mesh (not ported)")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="write per-request Chrome trace spans here")
    parser.add_argument("--metrics-snapshot", default=None, metavar="PATH",
                        help="dump the latency summaries as JSON here")
    parser.add_argument("--replicas", type=int, default=1,
                        help="fleet replicas (only 1 is ported)")
    parser.add_argument("--sessions", type=int, default=0,
                        help="tag requests with K round-robin session ids")
    parser.add_argument("--chaos", default="",
                        help="fault-injection preset name or JSON plan "
                        "(e.g. a poison-request plan)")
    parser.add_argument("--publish-dir", default="", metavar="DIR",
                        help="weight hot-swap channel (not ported)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default cuda; "
                        "'cpu' runs the plain versions of the kernels)")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.requests < 1:
        parser.error("--requests must be >= 1")
    if args.max_blocks * args.block_size > args.max_len:
        parser.error("--max-blocks * --block-size must be <= --max-len")
    if args.spec_tokens and args.spec_tokens < 2:
        parser.error("--spec-tokens must be 0 (off) or >= 2")
    for flag, asked in (
        ("--mesh", bool(args.mesh)),
        ("--auto-mesh", args.auto_mesh),
        ("--replicas > 1", args.replicas != 1),
        ("--publish-dir", bool(args.publish_dir)),
    ):
        if asked:
            _not_in_slice(parser, flag)

    from distributed_pytorch_example_tpu_torch.runtime.device import (
        resolve_device,
    )
    from distributed_pytorch_example_tpu_torch.telemetry.trace import (
        TraceWriter,
    )

    device = resolve_device(args.device)
    if args.chaos:
        # the plan is live before the engine exists
        from distributed_pytorch_example_tpu_torch.robustness import chaos

        chaos.install(parse_chaos(args.chaos))

    trace = TraceWriter(args.trace)
    engine = build_engine(args, trace)
    requests = build_requests(args)
    import torch

    where = (
        torch.cuda.get_device_name(device) if device.type == "cuda"
        else "cpu"
    )
    print(
        f"serve: {args.family} on {where}, {args.requests} requests, "
        f"rate={args.rate}/s, mode={args.mode}, slots={args.slots}, "
        f"pool={args.num_blocks}x{args.block_size}"
        + (f", chaos={args.chaos}" if args.chaos else ""),
        file=sys.stderr,
    )
    report = engine.run(requests)
    trace.close()
    if args.metrics_snapshot:
        write_metrics_snapshot(
            args.metrics_snapshot, report["metrics"], _config_dict(args)
        )
    for rid, r in sorted(report["results"].items()):
        print(json.dumps({
            "rid": rid, "status": r["status"],
            "prompt_len": r["prompt_len"], "new_tokens": len(r["tokens"]),
            "ttft_s": r["ttft_s"], "preemptions": r["preemptions"],
            **({"error": r["error"]} if r["error"] else {}),
        }), file=sys.stderr)

    m = report["metrics"]
    line = {
        "metric": "serve_tokens_per_sec",
        "value": round(m["tokens_per_sec"], 2),
        "unit": "tokens/sec",
        "ttft_ms": m["ttft_ms"],
        "tpot_ms": m["tpot_ms"],
        "queue_wait_ms": m["queue_wait_ms"],
        "ttft_p99_ms": m["ttft_ms"]["p99"],
        "tpot_p99_ms": m["tpot_ms"]["p99"],
        "queue_wait_p99_ms": m["queue_wait_ms"]["p99"],
        "decode_tokens_per_sec": round(m["decode_tokens_per_sec"], 2),
        "spec_accept_rate": (
            round(m["spec_accept_rate"], 4)
            if m["spec_accept_rate"] is not None else None
        ),
        "slot_occupancy": round(m["slot_occupancy"], 4),
        "decode_steps": m["decode_steps"],
        "generated_tokens": m["generated_tokens"],
        "elapsed_s": round(m["elapsed_s"], 3),
        "admitted": m["admitted"],
        "completed": m["completed"],
        "errored": m["errored"],
        "rejected": m["rejected"],
        "preempted": m["preempted"],
        "config": _config_dict(args),
    }
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
