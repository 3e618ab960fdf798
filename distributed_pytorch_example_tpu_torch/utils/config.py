"""Command-line configuration (the part of the JAX package's
utils/config.py that the training slice serves).

Flags keep the JAX package's names and defaults. The JAX package's other
flags are accepted by name so that a JAX command line parses, and
:func:`check_unserved` refuses any of them set away from its default.
"""

from __future__ import annotations

import argparse

# flag -> the JAX package's default: set to anything else, the port refuses
UNSERVED = {
    "auto_mesh": False,
    "mesh_data": -1,
    "mesh_fsdp": 1,
    "mesh_tensor": 1,
    "mesh_sequence": 1,
    "sp_mode": None,
    "mesh_expert": 1,
    "mesh_pipe": 1,
    "pipe_microbatches": 0,
    "pipe_schedule": "gpipe",
    "pipe_virtual": 1,
    "pipe_no_recompute": False,
    "moe_experts": 0,
    "moe_every": 2,
    "moe_top_k": None,
    "partition": "dp",
    "profile_dir": None,
    "profile_steps": "10,13",
    "telemetry_every": 0,
    "shard_cache_mb": 0,
    "publish_dir": None,
}


def add_reference_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The reference's flags and defaults (train.py:214-219)."""
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=64,
                        help="PER-REPLICA batch size (reference semantics); "
                        "global batch = batch-size * number of processes")
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--num-samples", type=int, default=10000)
    parser.add_argument("--checkpoint-dir", type=str, default="./checkpoints",
                        help="best/latest checkpoints and metrics.jsonl; "
                        "'' writes none")
    parser.add_argument("--resume", type=str, default=None,
                        help="a checkpoint of either package to resume "
                        "from; a missing path trains from scratch "
                        "(reference parity)")
    return parser


def add_framework_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The framework flags this slice serves."""
    parser.add_argument("--model", type=str, default="mlp",
                        help="mlp|resnet18|resnet50|vit-b16|bert-base|gpt2|"
                        "llama")
    parser.add_argument("--dataset", type=str, default="synthetic",
                        help="synthetic (mlp) | synthetic-image | "
                        "cifar10-synthetic | cifar10 | digits (resnet18, "
                        "resnet50, vit-b16) | synthetic-tokens | "
                        "tokens-file (gpt2, bert-base, llama)")
    parser.add_argument("--augment", type=str, default="none",
                        choices=("none", "cifar", "crop", "imagenet"),
                        help="train-time augmentation: cifar = pad-crop + "
                        "flip, crop = pad-crop only (label-asymmetric data "
                        "like digits), imagenet = random-resized-crop + "
                        "flip")
    parser.add_argument("--augment-workers", type=int, default=0,
                        help="threads transforming each batch's "
                        "augmentation; 0 = one per 32 images, capped at "
                        "the cpu count")
    parser.add_argument("--image-size", type=int, default=32,
                        help="synthetic-image side, the imagenet crop's "
                        "output side")
    parser.add_argument("--data-dir", type=str, default=None,
                        help="root of real datasets (cifar10 reads "
                        "cifar-10-batches-py/ there, tokens-file train.bin "
                        "/ val.bin); defaults to $DPX_DATA_DIR or ./data")
    parser.add_argument("--token-dtype", type=str, default="uint16",
                        choices=("uint16", "uint32", "int32"),
                        help="element dtype of raw .bin token files")
    parser.add_argument("--seq-len", type=int, default=512)
    parser.add_argument("--pad-token-id", type=int, default=None,
                        help="bert: mask keys at this token id out of "
                        "attention (padding) and keep them out of the MLM "
                        "loss; default: no padding mask")
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-every", type=int, default=10,
                        help="batches between rank-0 progress logs "
                        "(reference train.py:144)")
    parser.add_argument("--lm-loss", type=str, default="fused",
                        choices=("fused", "dense"),
                        help="fused = chunked vocab cross-entropy, no "
                        "materialized (B,S,V) f32 logits; dense = full "
                        "logits")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="compute dtype (parameters stay float32)")
    parser.add_argument("--flash", type=str, default="auto",
                        choices=("auto", "on", "off"),
                        help="flash attention kernel: auto-select, force, "
                        "or disable")
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=("adam", "adamw", "sgd", "lamb", "adafactor"),
                        help="reference default: adam (train.py:249); "
                        "adafactor not under --zero1 or --wire")
    parser.add_argument("--schedule", type=str, default="constant",
                        choices=("constant", "cosine", "linear"))
    parser.add_argument("--warmup-steps", type=int, default=0)
    parser.add_argument("--weight-decay", type=float, default=0.0)
    parser.add_argument("--grad-clip", type=float, default=None,
                        help="global-norm gradient clipping threshold")
    parser.add_argument("--remat", action="store_true",
                        help="transformer models: recompute each block's "
                        "activations in the backward pass (trades compute "
                        "for memory)")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="accumulate k micro-steps per optimizer step")
    parser.add_argument("--zero1", action="store_true",
                        help="ZeRO-1: shard optimizer state over the "
                        "processes (reduce-scattered grads + parameter "
                        "re-replication; parallel/api.py)")
    parser.add_argument("--wire", type=str, default="none",
                        choices=("none", "int8-block"),
                        help="gradient-collective compression: int8-block "
                        "= int8 payloads with per-block bf16 scales "
                        "(parallel/wire.py)")
    parser.add_argument("--wire-block", type=int, default=256,
                        help="elements per bf16 scale block for --wire "
                        "int8-block")
    parser.add_argument("--wire-stochastic", action="store_true",
                        help="stochastic rounding in the wire quantizer "
                        "(unbiased gradient mean; default round-to-nearest)")
    parser.add_argument("--wire-param-gather", type=str, default="float32",
                        choices=("float32", "bf16", "int8-block"),
                        help="payload of the ZeRO-1 parameter "
                        "re-replication gather; float32 keeps master "
                        "weights exact")
    parser.add_argument("--overlap-buckets", type=int, default=0,
                        metavar="BYTES",
                        help=">0: fused bucketed gradient sync, leaves "
                        "packed into ~BYTES of fp32 per bucket (reverse "
                        "leaf order), one collective per bucket (on the "
                        "card: the ring kernels); -1 = the default 4 MiB; "
                        "0 = one collective per leaf")
    parser.add_argument("--max-bad-steps", type=int, default=8,
                        help="nonfinite steps skipped before the run fails; "
                        "0 disables the budget")
    parser.add_argument("--no-skip-nonfinite", action="store_true",
                        help="apply the optimizer update even when gradients "
                        "are nonfinite")
    parser.add_argument("--no-telemetry", action="store_true",
                        help="accepted for JAX parity; the port has no "
                        "telemetry scope yet")
    parser.add_argument("--checkpoint-format", type=str, default="auto",
                        choices=("auto", "gathered", "sharded"),
                        help="gathered: one all-gathered file (reference "
                        "parity); auto: gathered at every process count "
                        "(the JAX package picks sharded for several "
                        "processes); sharded is not ported yet")
    parser.add_argument("--metrics-file", type=str, default=None,
                        help="JSONL epoch-metrics path (default: "
                        "<checkpoint-dir>/metrics.jsonl)")
    parser.add_argument("--save-every-steps", type=int, default=0,
                        help=">0: also write `latest` every N train batches "
                        "with the loader cursor, so --resume restarts at "
                        "the exact batch")
    parser.add_argument("--checkpoint-retain", type=int, default=3,
                        help="checkpoint generations kept per file "
                        "(older ones are fallback candidates when `latest` "
                        "is torn or corrupt); 0 keeps no history")
    parser.add_argument("--chaos", type=str, default=None,
                        help="deterministic fault injection: a preset name "
                        "(nan-step|io-flake) or a ChaosPlan JSON object; "
                        "equivalent to setting $DPX_CHAOS")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def add_unserved_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The JAX package's remaining flags, by name and default, so that a
    JAX command line parses; :func:`check_unserved` refuses them."""
    for name, default in UNSERVED.items():
        flag = "--" + name.replace("_", "-")
        if default is False:
            parser.add_argument(flag, action="store_true",
                                help=argparse.SUPPRESS)
        else:
            kind = type(default) if default is not None else str
            parser.add_argument(flag, type=kind, default=default,
                                help=argparse.SUPPRESS)
    return parser


def check_unserved(parser: argparse.ArgumentParser, args) -> None:
    """``parser.error`` on any flag of :data:`UNSERVED` set away from its
    default."""
    for name, default in UNSERVED.items():
        if getattr(args, name) != default:
            parser.error(
                f"--{name.replace('_', '-')} is not ported to the PyTorch "
                "package yet; see ROADMAP.md queue 1"
            )
