"""Tasks: loss + metrics binding a model to a batch format (the JAX
package's train/tasks.py).

A task computes ``(loss, metrics)`` from (model, batch); metrics are
device scalars (no host sync). Loss and accuracy are means over the local
batch; the train and eval steps average them across processes, which with
equal shards (the sampler's padding contract) is the mean over the global
batch, as in JAX. A task that scores a data-dependent subset (the masked
LM) also has ``compute_sums``, ``(loss sum, metric sums, count)``, so that
the replicated step can divide by the count over every process
(train/step.py). A task with ``uses_generator`` (the masked LM) draws
from the step's ``torch.Generator`` (the JAX task's ``rng``) on the
batch's device, passed as ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def _head_kw(model) -> dict:
    """The fused loss's vocab-parallel arguments for a head sharded over
    the tensor axis (``head_shard``), else none."""
    shard = getattr(model, "head_shard", lambda: None)()
    if shard is None:
        return {}
    return {"tensor_parallel": shard[0], "vocab_start": shard[1]}


def dequantize_inputs(x: torch.Tensor) -> torch.Tensor:
    """uint8 image batches -> float32 in [0, 1] on the batch's device (the
    JAX package's ``dequantize_inputs`` contract): a uint8 model input of
    rank >= 3 is a [0, 255] image; a uint8 input of lower rank (token ids
    as bytes, say) would be silently corrupted by the rescale, so it
    raises. Every other dtype passes through."""
    if x.dtype != torch.uint8:
        return x
    if x.dim() < 3:
        raise TypeError(
            f"uint8 model input of shape {tuple(x.shape)} is not an image "
            "batch (rank < 3); the framework rescales uint8 inputs to "
            "[0,1] float32 as images. Cast non-image inputs (e.g. token "
            "ids) to int32 on the host.")
    return x.float() / 255.0


class ClassificationTask:
    """Cross-entropy classification on {'x', 'y'} batches: the reference's
    CrossEntropyLoss (train.py:250) and top-1 accuracy in percent. uint8
    images are rescaled to [0, 1] first (:func:`dequantize_inputs`)."""

    batch_keys = ("x", "y")

    def compute_loss(self, model, batch, *, train: bool
                     ) -> Tuple[torch.Tensor, Metrics]:
        logits = model(dequantize_inputs(batch["x"]))
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
                out[:, :-1], embedding, targets, bias=bias,
                dtype=model.dtype, **_head_kw(model))
            loss = per_tok.mean()
        else:
            logits = out[:, :-1].float()
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   targets.reshape(-1))
            argmax = logits.argmax(-1)
        accuracy = 100.0 * (argmax == targets).float().mean()
        return loss, {"loss": loss.detach(), "accuracy": accuracy}


class MLMTask:
    """BERT-style masked LM on {'tokens'} batches (the JAX package's
    ``MLMTask``).

    The recipe: select ``mask_rate`` of the positions; of those, 80 %
    become ``mask_token_id``, 10 % a random token and 10 % stay as they
    are; the loss is the mean cross-entropy over the selected positions
    only (divided by ``max(count, 1)``), and accuracy is over them too.
    ``pad_token_id`` (real, padded corpora) keeps pad positions out of
    the selection, so out of the loss, and the random draw never yields
    the pad id; pair it with the model's own ``pad_token_id``, which keeps
    pad keys out of attention.

    Two pure halves, so that a test can feed JAX's own draws to the loss:
    :meth:`corrupt` draws the masks from an explicit ``torch.Generator``
    (the port cannot reproduce ``jax.random``'s bits and does not try),
    and :meth:`loss` scores the model's output (:meth:`loss_sums` before
    the division, which the replicated step takes over the global count).
    """

    batch_keys = ("tokens",)
    uses_generator = True

    def __init__(self, vocab_size: int, mask_token_id: int,
                 mask_rate: float = 0.15, pad_token_id: Optional[int] = None):
        self.vocab_size = vocab_size
        self.mask_token_id = mask_token_id
        self.mask_rate = mask_rate
        self.pad_token_id = pad_token_id

    def corrupt(self, tokens: torch.Tensor, generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(inputs, selected)``: the masked model inputs and the (B, S)
        boolean positions the loss scores. ``generator`` lies on
        ``tokens``' device."""
        kw = dict(generator=generator, device=tokens.device)
        selected = torch.rand(tokens.shape, **kw) < self.mask_rate
        kind = torch.rand(tokens.shape, **kw)
        if self.pad_token_id is None:
            random_tokens = torch.randint(0, self.vocab_size, tokens.shape,
                                          dtype=tokens.dtype, **kw)
        else:
            selected &= tokens != self.pad_token_id
            # draw from [0, vocab - 1) and step over the pad id: a fake pad
            # at a scored position would drop out of attention
            r = torch.randint(0, self.vocab_size - 1, tokens.shape,
                              dtype=tokens.dtype, **kw)
            random_tokens = torch.where(r >= self.pad_token_id, r + 1, r)
        inputs = torch.where(
            selected & (kind < 0.8), self.mask_token_id,
            torch.where(selected & (kind >= 0.9), random_tokens, tokens))
        return inputs, selected

    @staticmethod
    def loss_sums(model, out: torch.Tensor, tokens: torch.Tensor,
                  selected: torch.Tensor
                  ) -> Tuple[torch.Tensor, Metrics, torch.Tensor]:
        """``(loss sum, {"loss": loss sum, "accuracy": 100 x correct},
        count)``: the cross-entropy of the original ``tokens`` summed over
        the ``selected`` positions, fused (chunked CE against the tied
        table and ``mlm_bias``) when the model returns hidden states, else
        on its float32 logits."""
        if _fused_head(model):
            embedding, bias = model.head_params()
            per_tok, argmax = chunked_softmax_xent(
                out, embedding, tokens, bias=bias, dtype=model.dtype,
                **_head_kw(model))
        else:
            logits = out.float()
            per_tok = F.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1),
                reduction="none").reshape(tokens.shape)
            argmax = logits.argmax(-1)
        loss_sum = torch.where(selected, per_tok, 0.0).sum()
        correct = (selected & (argmax == tokens)).sum()
        return (loss_sum, {"loss": loss_sum.detach(),
                           "accuracy": 100.0 * correct},
                selected.sum())

    @staticmethod
    def _means(loss_sum: torch.Tensor, sums: Metrics, count: torch.Tensor
               ) -> Tuple[torch.Tensor, Metrics]:
        denom = count.clamp_min(1)
        loss = loss_sum / denom
        return loss, {"loss": loss.detach(),
                      "accuracy": sums["accuracy"] / denom}

    @classmethod
    def loss(cls, model, out: torch.Tensor, tokens: torch.Tensor,
             selected: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
        """The mean over the local ``selected`` positions (divided by
        ``max(count, 1)``), loss and accuracy."""
        return cls._means(*cls.loss_sums(model, out, tokens, selected))

    def compute_sums(self, model, batch, *, train: bool,
                     generator: torch.Generator
                     ) -> Tuple[torch.Tensor, Metrics, torch.Tensor]:
        tokens = batch["tokens"].long()
        inputs, selected = self.corrupt(tokens, generator)
        return self.loss_sums(model, model(inputs), tokens, selected)

    def compute_loss(self, model, batch, *, train: bool,
                     generator: torch.Generator
                     ) -> Tuple[torch.Tensor, Metrics]:
        return self._means(*self.compute_sums(model, batch, train=train,
                                              generator=generator))
