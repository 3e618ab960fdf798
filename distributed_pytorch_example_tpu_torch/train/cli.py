"""Training CLI — the port's counterpart of the JAX package's ``train.py``.

    python -m distributed_pytorch_example_tpu_torch.train [flags]

With no flags it runs the reference's default config (reference
train.py:214-218): SimpleNet on 10,000 synthetic samples, 10 epochs,
per-replica batch 64, Adam at lr 1e-3, train:val 10:1, on the card.
``--model gpt2 --dataset synthetic-tokens`` trains GPT-2 124M,
``--model llama`` the JAX package's LLaMA (125M, vocab 32000, ``--seq-len``
at most 2048, RoPE and 12 query heads over 4 kv heads) and
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
and the gradients are averaged across processes every step.
``--partition fsdp --mesh-fsdp F`` (``--model mlp|gpt2``) lays the
processes out on a (data, fsdp) mesh (``--mesh-data`` -1 takes the rest)
and shards every parameter and its moments over ``fsdp``: the step
gathers the parameters and reduce-scatters the gradients (on the card
through the ring kernels). ``--partition tp --mesh-tensor T`` (``--model
gpt2|llama``) lays them out on a (data, tensor) mesh and cuts every
block's attention heads and MLP over ``tensor`` (Megatron tensor
parallelism; LLaMA's token table, head and loss over the vocab too): a
tensor group's ranks read the same rows, and the batch splits over
``data``. The other mesh axes are refused (ROADMAP.md queue 1, item
15). ``--zero1``
shards the optimizer state across the processes, ``--wire`` compresses the
gradient collectives, ``--overlap-buckets`` fuses them into buckets (on
the card, the ring kernels carry them), and ``--grad-accum k`` applies the
optimizer every k-th step to the mean of k steps' gradients (the JAX CLI's
``optax.MultiSteps``). ``--remat`` recomputes each transformer block in
the backward pass (the other models ignore it, as in JAX).
Checkpoints go to ``--checkpoint-dir`` (default ``./checkpoints``): best
and latest at each epoch's end, ``latest`` every ``--save-every-steps``
batches too, and ``metrics.jsonl``; ``--checkpoint-format`` picks one
gathered file or the sharded format (per-process shard files, a manifest
and a pointer), and ``auto`` takes the sharded format when there is more
than one process. ``--resume`` takes a checkpoint of either package, in
either format, at any process count. SIGTERM (SIGINT) finishes the step in flight, saves
``latest`` with the loader cursor and exits 143 (130); the next launch
with ``--resume`` continues at that batch.
Telemetry is on (``--no-telemetry`` turns it off): ``trace_events.json``
beside ``metrics.jsonl`` holds the step, data_load, h2d, eval and
checkpoint spans, recovery events are records of ``metrics.jsonl``, and
``--telemetry-every N`` adds a record every N steps (step_time_ms,
mfu_analytic, flops_per_step_per_device, hbm_peak_bytes, the sentinels).
``--profile-dir`` writes a ``torch.profiler`` Chrome trace of the global
steps ``--profile-steps start,stop``.
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
    TensorParallel,
    WireConfig,
    data_parallel,
    fsdp,
    transformer_partitioner,
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
from distributed_pytorch_example_tpu_torch.runtime.mesh import (
    MeshSpec,
    make_mesh,
)
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
_LLAMA = ("llama", "llama-tiny")
_DATASETS = {"mlp": ("synthetic",), "gpt2": _TOKENS, "bert-base": _TOKENS,
             **dict.fromkeys(_LLAMA, _TOKENS),
             **dict.fromkeys(_VISION, _IMAGES)}
# JAX train.py:46-56
_VOCAB = {"gpt2": 50257, "bert-base": 30522, **dict.fromkeys(_LLAMA, 32000)}
_MAX_SEQ = {"gpt2": 1024, "bert-base": 512, **dict.fromkeys(_LLAMA, 2048)}
_LM = tuple(_MAX_SEQ)
_TRANSFORMERS = ("vit-b16",) + _LM
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
                image_size: Optional[int] = None,
                tensor_parallel: Optional[TensorParallel] = None):
    """The model of ``--model``; ``image_size`` (ViT's position table)
    defaults to ``--image-size``; ``tensor_parallel`` cuts a transformer
    LM over the tensor axis (``--partition tp``)."""
    kw = dict(dtype=torch.bfloat16 if args.dtype == "bfloat16"
              else torch.float32, device=device, seed=args.seed)
    if tensor_parallel is not None:
        kw["tensor_parallel"] = tensor_parallel
    if args.model in ("mlp",) + _VISION:
        kw["num_classes"] = args.num_classes
    if args.model in _TRANSFORMERS:
        kw["use_flash"] = None if args.flash == "auto" else args.flash == "on"
        if args.remat:
            kw["remat"] = True
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


# the models that one CPU test holds against the JAX package's fsdp, and
# its transformer_partitioner
_FSDP_MODELS = ("mlp", "gpt2")
_TP_MODELS = ("gpt2",) + _LLAMA


def check_tensor_partition(parser: argparse.ArgumentParser, args) -> None:
    """``parser.error`` on what ``--partition tp`` does not serve yet,
    naming ROADMAP.md item 11."""
    if args.model not in _TP_MODELS:
        parser.error(f"--partition tp of --model {args.model} is not ported "
                     "to the PyTorch package yet (the port's tensor "
                     f"parallelism serves {'|'.join(_TP_MODELS)}); see "
                     "ROADMAP.md queue 1, item 11")
    refused = [
        ("--zero1", args.zero1),
        (f"--optimizer {args.optimizer}",
         args.optimizer in ("lamb", "adafactor")),
        ("--wire / --wire-param-gather", args.wire != "none"
         or args.wire_param_gather != "float32"),
        ("--overlap-buckets", args.overlap_buckets != 0),
        ("--remat", args.remat),
    ]
    for flag, bad in refused:
        if bad:
            parser.error(f"{flag} under --partition tp is not ported to the "
                         "PyTorch package yet; see ROADMAP.md queue 1, "
                         "item 11")


def check_partition(parser: argparse.ArgumentParser, args) -> None:
    """``parser.error`` on a ``--partition`` / ``--mesh-*`` combination the
    port does not serve (the JAX CLI's own refusals in its words, the
    rest naming ROADMAP.md)."""
    if args.partition not in ("dp", "fsdp", "tp"):
        parser.error(f"--partition must be dp|fsdp|tp, got "
                     f"{args.partition!r}")
    if args.partition != "tp" and args.mesh_tensor != 1:
        parser.error("--mesh-tensor above 1 needs --partition tp in the "
                     "PyTorch package; see ROADMAP.md queue 1, item 11")
    if args.partition != "fsdp" and args.mesh_fsdp != 1:
        parser.error("--mesh-fsdp above 1 needs --partition fsdp in the "
                     "PyTorch package; see ROADMAP.md queue 1, item 11")
    if args.partition == "tp":
        check_tensor_partition(parser, args)
    if args.partition != "fsdp":
        return
    # JAX train.py:350-355
    if args.zero1:
        parser.error("--zero1 is redundant under --partition fsdp (FSDP "
                     "already shards optimizer state with the params)")
    if args.model not in _FSDP_MODELS:
        parser.error(f"--partition fsdp of --model {args.model} is not held "
                     "against the JAX package yet (the port's FSDP serves "
                     f"{'|'.join(_FSDP_MODELS)}); see ROADMAP.md queue 1, "
                     "item 11")
    if args.optimizer in ("lamb", "adafactor"):
        parser.error(f"--optimizer {args.optimizer} under --partition fsdp "
                     "is not ported to the PyTorch package yet; see "
                     "ROADMAP.md queue 1, item 11")
    if args.wire != "none" or args.wire_param_gather != "float32":
        parser.error("--wire / --wire-param-gather under --partition fsdp "
                     "are not ported to the PyTorch package yet; see "
                     "ROADMAP.md queue 1, item 11")


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_unserved(parser, args)
    if args.model not in _DATASETS:
        parser.error(f"--model {args.model!r} is not ported yet; the port "
                     f"trains {sorted(_DATASETS)}")
    if args.dataset not in _DATASETS[args.model]:
        parser.error(f"--model {args.model} trains on --dataset "
                     f"{'|'.join(_DATASETS[args.model])}, not "
                     f"{args.dataset!r}")
    if args.augment != "none" and args.dataset not in _IMAGES:
        parser.error(f"--augment only applies to image datasets, not "
                     f"{args.dataset!r}")
    if args.pad_token_id is not None and args.model != "bert-base":
        parser.error(f"--pad-token-id is only supported for bert models, "
                     f"not {args.model!r}")
    if args.model in _MAX_SEQ and not 2 <= args.seq_len <= _MAX_SEQ[args.model]:
        parser.error(f"--seq-len {args.seq_len} outside {args.model}'s "
                     f"context [2, {_MAX_SEQ[args.model]}]")
    check_partition(parser, args)

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
    spec = MeshSpec(data=args.mesh_data, fsdp=args.mesh_fsdp,
                    tensor=args.mesh_tensor)
    try:
        resolved = spec.resolve(world)
    except ValueError as err:
        parser.error(f"--mesh-data {args.mesh_data} --mesh-fsdp "
                     f"{args.mesh_fsdp} --mesh-tensor {args.mesh_tensor} "
                     f"over {world} processes: {err}")
    if args.grad_accum < 1:
        parser.error(f"--grad-accum must be >= 1, got {args.grad_accum}")
    # the processes of one tensor group read the same rows
    global_batch = args.batch_size * resolved.data * resolved.fsdp
    mesh = make_mesh(spec) if args.partition != "dp" else None
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
    tp_kw = ({"tensor_parallel": TensorParallel.from_mesh(mesh)}
             if args.partition == "tp" else {})
    model = build_model(args, device, image_size, **tp_kw)
    task = build_task(args, model)
    train_loader = DeviceLoader(train_ds, global_batch, device=device,
                                shuffle=True, seed=args.seed, mesh=mesh)
    val_loader = DeviceLoader(val_ds, global_batch, device=device,
                              shuffle=False, seed=args.seed, mesh=mesh)
    logger.info("Dataset size: %d, batches per epoch: %d", len(train_ds),
                len(train_loader))
    try:
        profile_window = tuple(int(x) for x in args.profile_steps.split(","))
        if len(profile_window) != 2 or profile_window[0] >= profile_window[1]:
            raise ValueError
    except ValueError:
        parser.error("--profile-steps must be 'start,stop' with start < stop")
    optimizer = make_optimizer(
        model, args.optimizer, args.lr,
        schedule=args.schedule, warmup_steps=args.warmup_steps,
        # the schedule advances once per OPTIMIZER step; with accumulation
        # that is every k-th step
        total_steps=max(1, args.epochs * len(train_loader) // args.grad_accum),
        weight_decay=args.weight_decay, grad_clip_norm=args.grad_clip,
        every_k=args.grad_accum,
    )
    if args.partition == "fsdp":
        partitioner = fsdp(mesh)
    elif args.partition == "tp":
        partitioner = transformer_partitioner(mesh)
    else:
        partitioner = data_parallel(world, dp_shard_opt_state=args.zero1)
    # the wire policy rides the partitioner, as in the JAX CLI
    partitioner.wire = WireConfig(
        compress=args.wire, block_size=args.wire_block,
        stochastic_rounding=args.wire_stochastic,
        param_gather=args.wire_param_gather,
        bucket_bytes=(DEFAULT_BUCKET_BYTES if args.overlap_buckets < 0
                      else args.overlap_buckets),
    )
    trainer = Trainer(model, task, optimizer, partitioner=partitioner,
                      checkpoint_dir=args.checkpoint_dir,
                      log_every=args.log_every, seed=args.seed,
                      metrics_file=args.metrics_file,
                      checkpoint_format=args.checkpoint_format,
                      save_every_steps=args.save_every_steps,
                      max_bad_steps=args.max_bad_steps,
                      skip_nonfinite=not args.no_skip_nonfinite,
                      checkpoint_retain=args.checkpoint_retain,
                      profile_dir=args.profile_dir,
                      profile_window=profile_window,
                      telemetry=not args.no_telemetry,
                      telemetry_every=args.telemetry_every)
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
