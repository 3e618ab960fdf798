"""Training CLI — the port's counterpart of the JAX package's ``train.py``.

    python -m distributed_pytorch_example_tpu_torch.train [flags]

With no flags it runs the reference's default config (reference
train.py:214-218): SimpleNet on 10,000 synthetic samples, 10 epochs,
per-replica batch 64, Adam at lr 1e-3, train:val 10:1, on the card.
``--model gpt2 --dataset synthetic-tokens`` trains GPT-2 124M and
``--model bert-base --dataset synthetic-tokens`` BERT-base with the
masked-LM task (vocab 30522, ``[MASK]`` = 103, ``--seq-len`` at most 512;
``--pad-token-id`` masks pad keys out of attention and pad positions out
of the loss); in ``--dtype bfloat16`` at a sequence length that is a
multiple of 128 their attention runs the flash kernels forward and
backward. ``--dataset tokens-file`` reads a real corpus from
``<--data-dir or $DPX_DATA_DIR or ./data>/train.bin`` and ``val.bin``
(raw ``--token-dtype``, memory-mapped, checked against a ``DPX-CRC1``
sidecar when there is one).
``--model resnet18|resnet50|vit-b16`` trains an image classifier on
``--dataset synthetic-image`` (Gaussian ``--image-size`` squares),
``cifar10`` (the pickle batches under the data dir) or ``digits``
(scikit-learn's bundled set), with ``--augment cifar|crop|imagenet`` on
``--augment-workers`` threads; ``--num-classes`` at its default follows
the dataset's label space, and a smaller value is refused.

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
import os
from typing import List, Optional

import torch

from distributed_pytorch_example_tpu_torch.data import (
    AugmentedDataset,
    DeviceLoader,
    SyntheticClassificationDataset,
    SyntheticImageDataset,
    SyntheticTokenDataset,
    load_cifar10,
    load_digits,
    load_token_file,
    pad_crop_flip,
    random_resized_crop_flip,
)
from distributed_pytorch_example_tpu_torch.data.vision import data_root
from distributed_pytorch_example_tpu_torch.models import get_model
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
    MLMTask,
)
from distributed_pytorch_example_tpu_torch.utils.config import (
    add_framework_args,
    add_reference_args,
    add_unserved_args,
    check_unserved,
)

logger = get_logger(__name__)

_TOKENS = ("synthetic-tokens", "tokens-file")
# the JAX CLI's image datasets (its image-shards waits for ROADMAP item 13)
_IMAGES = ("synthetic-image", "cifar10-synthetic", "cifar10", "digits")
_VISION = ("resnet18", "resnet50", "vit-b16")
_DATASETS = {"mlp": ("synthetic",), "gpt2": _TOKENS, "bert-base": _TOKENS,
             **dict.fromkeys(_VISION, _IMAGES)}
_VOCAB = {"gpt2": 50257, "bert-base": 30522}  # JAX train.py:46-56
_MAX_SEQ = {"gpt2": 1024, "bert-base": 512}
_LM = tuple(_MAX_SEQ)
MASK_TOKEN_ID = 103  # BERT's [MASK] (JAX train.py:101-106)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    add_reference_args(parser)
    add_framework_args(parser)
    add_unserved_args(parser)
    return parser


def build_dataset(args, num_samples: int, seed: int, train: bool = True):
    if args.dataset == "synthetic":
        return SyntheticClassificationDataset(
            num_samples=num_samples, num_classes=args.num_classes, seed=seed
        )
    if args.dataset in ("synthetic-image", "cifar10-synthetic"):
        return SyntheticImageDataset(
            num_samples=num_samples, image_size=args.image_size,
            num_classes=args.num_classes, seed=seed)
    if args.dataset == "cifar10":
        return load_cifar10(train=train, data_dir=args.data_dir)
    if args.dataset == "digits":
        return load_digits(train=train)
    if args.dataset == "tokens-file":
        return load_token_file(
            os.path.join(data_root(args.data_dir),
                         "train.bin" if train else "val.bin"),
            seq_len=args.seq_len, dtype=args.token_dtype)
    return SyntheticTokenDataset(num_samples=num_samples, seq_len=args.seq_len,
                                 vocab_size=_VOCAB[args.model], seed=seed)


def augment(args, train_ds, global_batch: int):
    """``train_ds`` under ``--augment`` (the JAX CLI's recipes, seeded by
    ``--seed``), or as it is."""
    if args.augment == "none":
        return train_ds
    if args.augment == "imagenet":
        transform = random_resized_crop_flip(size=args.image_size,
                                             seed=args.seed)
    else:
        transform = pad_crop_flip(flip=args.augment == "cifar",
                                  seed=args.seed)
    workers = args.augment_workers or min(max(1, global_batch // 32),
                                          os.cpu_count() or 1)
    return AugmentedDataset(train_ds, transform, workers=workers,
                            seed=args.seed)


def build_model(args, device: torch.device,
                image_size: Optional[int] = None):
    """The model of ``--model``; ``image_size`` (ViT's position table)
    defaults to ``--image-size``."""
    kw = dict(dtype=torch.bfloat16 if args.dtype == "bfloat16"
              else torch.float32, device=device, seed=args.seed)
    if args.model in ("mlp",) + _VISION:
        kw["num_classes"] = args.num_classes
    if args.model in ("vit-b16", "gpt2", "bert-base"):
        kw["use_flash"] = None if args.flash == "auto" else args.flash == "on"
    if args.model == "vit-b16":
        kw["image_size"] = image_size or args.image_size
    if args.model in _LM:
        kw["logits_mode"] = "hidden" if args.lm_loss == "fused" else "full"
    if args.pad_token_id is not None:
        kw["pad_token_id"] = args.pad_token_id
    return get_model(args.model, **kw)


def build_task(args, model):
    if args.dataset == "synthetic" or args.dataset in _IMAGES:
        return ClassificationTask()
    if args.model == "bert-base":
        return MLMTask(model.vocab_size, mask_token_id=MASK_TOKEN_ID,
                       pad_token_id=args.pad_token_id)
    return CausalLMTask()


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
    if args.dataset not in _DATASETS[args.model]:
        parser.error(f"--model {args.model} trains on --dataset "
                     f"{'|'.join(_DATASETS[args.model])}, not "
                     f"{args.dataset!r}")
    if args.optimizer == "adafactor":
        parser.error("--optimizer adafactor is not ported yet (ROADMAP.md "
                     "queue 1, item 7)")
    if args.optimizer == "lamb" and (args.zero1 or args.wire != "none"):
        parser.error("--optimizer lamb under --zero1 or --wire is not "
                     "ported yet: its per-leaf norms span every rank's tile "
                     "(ROADMAP.md queue 1, item 7)")
    if args.augment != "none" and args.dataset not in _IMAGES:
        parser.error(f"--augment only applies to image datasets, not "
                     f"{args.dataset!r}")
    if args.pad_token_id is not None and args.model != "bert-base":
        parser.error(f"--pad-token-id is only supported for bert models, "
                     f"not {args.model!r}")
    if args.model in _MAX_SEQ and not 2 <= args.seq_len <= _MAX_SEQ[args.model]:
        parser.error(f"--seq-len {args.seq_len} outside {args.model}'s "
                     f"context [2, {_MAX_SEQ[args.model]}]")

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
                           seed=args.seed + 1, train=False)
    image_size = None
    if args.dataset in _IMAGES:
        image_size = (args.image_size if args.augment == "imagenet"
                      else train_ds[0]["x"].shape[0])
    train_ds = augment(args, train_ds, global_batch)
    # a real dataset knows its label space: the flag's default must not
    # size a head too small for it (the JAX CLI's rule)
    ds_classes = getattr(train_ds, "num_classes", 0)
    if ds_classes and ds_classes != args.num_classes:
        if args.num_classes == parser.get_default("num_classes"):
            logger.info("Using num_classes=%d from the dataset (flag "
                        "default %d)", ds_classes, args.num_classes)
            args.num_classes = ds_classes
        elif ds_classes > args.num_classes:
            parser.error(f"--num-classes {args.num_classes} < dataset "
                         f"label space {ds_classes}")
    model = build_model(args, device, image_size)
    task = build_task(args, model)
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
