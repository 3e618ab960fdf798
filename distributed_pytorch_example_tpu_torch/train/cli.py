"""Training CLI — the port's counterpart of the JAX package's ``train.py``.

    python -m distributed_pytorch_example_tpu_torch.train [flags]

With no flags it runs the reference's default config (reference
train.py:214-218): SimpleNet on 10,000 synthetic samples, 10 epochs,
per-replica batch 64, Adam at lr 1e-3, train:val 10:1, on the card.
``--model gpt2 --dataset synthetic-tokens`` trains GPT-2 124M; in
``--dtype bfloat16`` at a sequence length that is a multiple of 128 its
attention runs the flash kernels forward and backward.

More than one process (``REPLICAS`` > 1, see runtime/distributed.py)
gives data parallelism: each process takes its shard of the global batch
and the gradients are averaged across processes every step. ``--zero1``
shards the optimizer state across the processes, ``--wire`` compresses the
gradient collectives, ``--overlap-buckets`` fuses them into buckets (on
the card, the ring kernels carry them), and ``--grad-accum k`` applies the
optimizer every k-th step to the mean of k steps' gradients (the JAX CLI's
``optax.MultiSteps``).
Checkpoints go to ``--checkpoint-dir`` (default ``./checkpoints``): best
and latest at each epoch's end, ``latest`` every ``--save-every-steps``
batches too, and ``metrics.jsonl``. ``--resume`` takes a checkpoint of
either package. SIGTERM (SIGINT) finishes the step in flight, saves
``latest`` with the loader cursor and exits 143 (130); the next launch
with ``--resume`` continues at that batch.
``--device cpu`` runs on the CPU; the default, ``cuda``, raises without a
card. Flags of the JAX CLI that this slice does not serve are refused.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from distributed_pytorch_example_tpu_torch.data import (
    DeviceLoader,
    SyntheticClassificationDataset,
    SyntheticTokenDataset,
)
from distributed_pytorch_example_tpu_torch.models import GPT2, SimpleNet
from distributed_pytorch_example_tpu_torch.parallel import (
    WireConfig,
    data_parallel,
)
from distributed_pytorch_example_tpu_torch.parallel.wire import (
    DEFAULT_BUCKET_BYTES,
)
from distributed_pytorch_example_tpu_torch.robustness import (
    BadStepBudgetExceeded,
    chaos,
)
from distributed_pytorch_example_tpu_torch.runtime import distributed as dist
from distributed_pytorch_example_tpu_torch.runtime.device import resolve_device
from distributed_pytorch_example_tpu_torch.runtime.logging import (
    get_logger,
    setup_logging,
)
from distributed_pytorch_example_tpu_torch.train.loop import (
    PreemptionInterrupt,
    Trainer,
)
from distributed_pytorch_example_tpu_torch.train.optimizers import (
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train.tasks import (
    CausalLMTask,
    ClassificationTask,
)
from distributed_pytorch_example_tpu_torch.utils.config import (
    add_framework_args,
    add_reference_args,
    add_unserved_args,
    check_unserved,
)

logger = get_logger(__name__)

_DATASETS = {"mlp": "synthetic", "gpt2": "synthetic-tokens"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    add_reference_args(parser)
    add_framework_args(parser)
    add_unserved_args(parser)
    return parser


def build_dataset(args, num_samples: int, seed: int):
    if args.dataset == "synthetic":
        return SyntheticClassificationDataset(
            num_samples=num_samples, num_classes=args.num_classes, seed=seed
        )
    return SyntheticTokenDataset(num_samples=num_samples, seq_len=args.seq_len,
                                 vocab_size=50257, seed=seed)


def build_model(args, device: torch.device):
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.model == "mlp":
        return SimpleNet(num_classes=args.num_classes, dtype=dtype,
                         device=device, seed=args.seed)
    return GPT2(
        dtype=dtype,
        use_flash=None if args.flash == "auto" else args.flash == "on",
        logits_mode="hidden" if args.lm_loss == "fused" else "full",
        device=device, seed=args.seed,
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_unserved(parser, args)
    if args.checkpoint_format == "sharded":
        parser.error("--checkpoint-format sharded is not ported to the "
                     "PyTorch package yet (ROADMAP.md queue 1, item 9); use "
                     "auto or gathered")
    if args.model not in _DATASETS:
        parser.error(f"--model {args.model!r} is not ported yet; the port "
                     f"trains {sorted(_DATASETS)}")
    if args.dataset != _DATASETS[args.model]:
        parser.error(f"--model {args.model} trains on --dataset "
                     f"{_DATASETS[args.model]}, not {args.dataset!r}")
    if args.optimizer in ("lamb", "adafactor"):
        parser.error(f"--optimizer {args.optimizer} is not ported yet")
    if args.model == "gpt2" and not 2 <= args.seq_len <= 1024:
        parser.error(f"--seq-len {args.seq_len} outside GPT-2's context "
                     "[2, 1024]")

    setup_logging()
    if args.chaos:
        chaos.install(
            chaos.ChaosPlan.from_json(args.chaos)
            if args.chaos.lstrip().startswith("{")
            else chaos.preset(args.chaos)
        )
    device = resolve_device(args.device)
    config = dist.initialize(device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.process_count()
    if args.grad_accum < 1:
        parser.error(f"--grad-accum must be >= 1, got {args.grad_accum}")
    global_batch = args.batch_size * world
    logger.info("Starting distributed training with %d processes on %s "
                "(process %d)", world, device, config.process_id)
    logger.info("Configuration: epochs=%d, batch_size=%d (global %d), lr=%s",
                args.epochs, args.batch_size, global_batch, args.lr)
    train_ds = build_dataset(args, args.num_samples, seed=args.seed)
    val_ds = build_dataset(args, max(args.num_samples // 10, global_batch),
                           seed=args.seed + 1)
    model = build_model(args, device)
    task = ClassificationTask() if args.model == "mlp" else CausalLMTask()
    train_loader = DeviceLoader(train_ds, global_batch, device=device,
                                shuffle=True, seed=args.seed)
    val_loader = DeviceLoader(val_ds, global_batch, device=device,
                              shuffle=False, seed=args.seed)
    logger.info("Dataset size: %d, batches per epoch: %d", len(train_ds),
                len(train_loader))
    optimizer = make_optimizer(
        model.parameters(), args.optimizer, args.lr,
        schedule=args.schedule, warmup_steps=args.warmup_steps,
        # the schedule advances once per OPTIMIZER step; with accumulation
        # that is every k-th step
        total_steps=max(1, args.epochs * len(train_loader) // args.grad_accum),
        weight_decay=args.weight_decay, grad_clip_norm=args.grad_clip,
        every_k=args.grad_accum,
    )
    partitioner = data_parallel(
        world, dp_shard_opt_state=args.zero1,
        wire=WireConfig(
            compress=args.wire, block_size=args.wire_block,
            stochastic_rounding=args.wire_stochastic,
            param_gather=args.wire_param_gather,
            bucket_bytes=(DEFAULT_BUCKET_BYTES if args.overlap_buckets < 0
                          else args.overlap_buckets),
        ),
    )
    trainer = Trainer(model, task, optimizer, partitioner=partitioner,
                      checkpoint_dir=args.checkpoint_dir,
                      log_every=args.log_every, seed=args.seed,
                      metrics_file=args.metrics_file,
                      checkpoint_format=args.checkpoint_format,
                      save_every_steps=args.save_every_steps,
                      max_bad_steps=args.max_bad_steps,
                      skip_nonfinite=not args.no_skip_nonfinite,
                      checkpoint_retain=args.checkpoint_retain)
    try:
        trainer.fit(train_loader, val_loader, epochs=args.epochs,
                    resume=args.resume)
    except PreemptionInterrupt as err:
        # the checkpoint landed in fit(); 143 / 130 tell the launcher not to
        # restart, and the next launch resumes at the saved batch
        dist.shutdown()
        return err.exit_code
    except BadStepBudgetExceeded:
        logger.exception("graft-armor: persistent nonfinite fault; aborting")
        dist.shutdown()
        return 1
    dist.shutdown()
    return 0
