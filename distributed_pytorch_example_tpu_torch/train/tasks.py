"""Tasks: loss + metrics binding a model to a batch format (the JAX
package's train/tasks.py).

A task computes ``(loss, metrics)`` from (model, batch); metrics are
device scalars (no host sync). Loss and accuracy are means over the local
batch; the train and eval steps average them across processes, which with
equal shards (the sampler's padding contract) is the mean over the global
batch, as in JAX. The masked-LM task comes with BERT (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from distributed_pytorch_example_tpu_torch.ops.chunked_ce import (
    chunked_softmax_xent,
)

Metrics = Dict[str, torch.Tensor]


def _fused_head(model) -> bool:
    """True when the model returns hidden states for the fused chunked-CE
    loss (``logits_mode='hidden'`` + ``head_params``)."""
    return getattr(model, "logits_mode", "full") == "hidden"


class ClassificationTask:
    """Cross-entropy classification on {'x', 'y'} batches: the reference's
    CrossEntropyLoss (train.py:250) and top-1 accuracy in percent."""

    batch_keys = ("x", "y")

    def compute_loss(self, model, batch, *, train: bool
                     ) -> Tuple[torch.Tensor, Metrics]:
        logits = model(batch["x"])
        labels = batch["y"].long()
        loss = F.cross_entropy(logits.float(), labels)
        accuracy = 100.0 * (logits.argmax(-1) == labels).float().mean()
        return loss, {"loss": loss.detach(), "accuracy": accuracy}


class CausalLMTask:
    """Next-token LM on {'tokens'} batches (GPT-2).

    The model sees the full sequence (so seq_len stays tile-aligned for the
    flash kernel); position t's output predicts token t+1 and the last
    position is left out of the loss.
    """

    batch_keys = ("tokens",)

    def compute_loss(self, model, batch, *, train: bool
                     ) -> Tuple[torch.Tensor, Metrics]:
        tokens = batch["tokens"].long()
        out = model(tokens)
        targets = tokens[:, 1:]
        if _fused_head(model):
            embedding, bias = model.head_params()
            per_tok, argmax = chunked_softmax_xent(
                out[:, :-1], embedding, targets, bias=bias, dtype=model.dtype
            )
            loss = per_tok.mean()
        else:
            logits = out[:, :-1].float()
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   targets.reshape(-1))
            argmax = logits.argmax(-1)
        accuracy = 100.0 * (argmax == targets).float().mean()
        return loss, {"loss": loss.detach(), "accuracy": accuracy}
