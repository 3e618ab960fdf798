"""Autoregressive text generation over a contiguous KV cache (the JAX
package's train/generate.py).

Usage::

    model = GPT2(decode=True)   # the training model's weights load as is
    tokens = generate(model, prompt, max_new_tokens=64, temperature=0.8,
                      top_k=40, rng=0)

A prefill runs the whole prompt through the model in one call, then a
Python loop feeds one token a step. Every attention layer keeps its K/V
in a (batch, prompt + max_new_tokens, kv_heads, head_dim) cache sized at
the start of each call and dropped at its end (``init_cache`` /
``clear_cache``); the cache never enters the ``state_dict``. JAX compiles
the whole loop into one program (a ``lax.scan``); here each step is its
own launches on the host's clock, and no CUDA graph captures them yet.

Sampling is the serving engine's (serving/sampling.py): the same
truncation, and Gumbel-max draws with noise from CPU generators, so the
draw does not depend on the device. ``rng`` is an int seed:

- ``rng_fold="split"`` draws each step's (B, V) noise from one generator
  seeded with ``rng`` that advances step by step;
- ``rng_fold="position"`` draws the noise of absolute position ``p``
  from a generator seeded with ``row_seed(rng, p)``. Row 0 is then the
  engine's draw for a request with seed ``rng``, so a one-row
  ``generate`` reproduces the paged engine token for token; the other
  rows take the following numbers of the same generator, so rows stay
  independent, as under JAX's one key for the batch.

Sharded decode (``partitioner=``) is not ported (ROADMAP.md item 11).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributed_pytorch_example_tpu_torch.serving.sampling import (
    gumbel,
    row_seed,
    truncate_logits,
)


def _sample(logits: torch.Tensor, noise: Optional[torch.Tensor],
            temperature: float, top_k: Optional[int],
            top_p: Optional[float]) -> torch.Tensor:
    """One token per row of (B, V) float32 logits -> (B,) int64: argmax at
    temperature 0, else the argmax of the truncated logits plus the
    (B, V) Gumbel ``noise`` (a draw from their softmax)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = truncate_logits(logits, temperature, top_k, top_p)
    return torch.argmax(logits + noise.to(logits.device, non_blocking=True),
                        dim=-1)


def generate(
    model,
    prompt,
    max_new_tokens: int,
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    rng: Optional[int] = None,
    partitioner=None,
    rng_fold: str = "split",
) -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations of ``prompt`` (B, P) ints.

    ``model`` is a GPT-2 or LLaMA built with ``decode=True`` and no paged
    pool. ``temperature=0`` is greedy argmax; ``top_k`` / ``top_p``
    (nucleus) truncate the distribution; with ``eos_id`` a row keeps
    emitting EOS after its first one (the shape stays (B, P + N): trim on
    the host). Returns (B, P + max_new_tokens) int64 token ids on the
    model's device. ``rng`` is an int seed (default 0) drawn as the module
    docstring says.
    """
    if rng_fold not in ("split", "position"):
        raise ValueError(
            f"rng_fold must be 'split' or 'position', got {rng_fold!r}"
        )
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        # top_p == 0 would wrap the nucleus cut index to -1 and silently
        # disable truncation, the opposite of the caller's intent
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k is not None:
        vocab = getattr(model, "vocab_size", None)
        if top_k < 1 or (vocab is not None and top_k > vocab):
            raise ValueError(
                f"top_k must be in [1, vocab_size={vocab}], got {top_k}"
            )
    if not getattr(model, "decode", False):
        raise ValueError(
            "generate() needs a decode-mode model: construct it with "
            "decode=True (same params as the training model)"
        )
    if getattr(model, "paged_num_blocks", 0):
        raise ValueError(
            "generate() decodes over the contiguous KV cache: construct "
            "the model with decode=True and no paged_num_blocks (the paged "
            "pool is the serving engine's)"
        )
    if partitioner is not None:
        raise NotImplementedError(
            "sharded decode (generate(partitioner=...)) is not ported to "
            "the PyTorch package yet; see ROADMAP.md item 11"
        )
    seed = 0 if rng is None else int(rng)
    device = model.device
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.asarray(prompt))
    prompt = prompt.to(device=device, dtype=torch.long)
    batch, prompt_len = prompt.shape
    vocab = model.vocab_size
    split_gen = torch.Generator().manual_seed(seed)

    def noise_at(position: int) -> Optional[torch.Tensor]:
        if temperature == 0.0:
            return None
        if rng_fold == "position":
            gen = torch.Generator().manual_seed(row_seed(seed, position))
            return gumbel(gen, (batch, vocab))
        return gumbel(split_gen, (batch, vocab))

    def step(logits, position):
        return _sample(logits[:, -1].float(), noise_at(position),
                       temperature, top_k, top_p)

    was_training = model.training
    model.eval()
    model.init_cache(batch, prompt_len + max_new_tokens)
    try:
        with torch.inference_mode():
            # prefill; the first sampled token sits at position prompt_len
            tok = step(model(prompt), prompt_len)
            done = (tok == eos_id if eos_id is not None
                    else torch.zeros_like(tok, dtype=torch.bool))
            out = [tok]
            for pos in range(prompt_len + 1, prompt_len + max_new_tokens):
                tok = step(model(tok[:, None]), pos)
                if eos_id is not None:
                    # shapes stay static: a finished row keeps emitting EOS
                    tok = torch.where(done, eos_id, tok)
                    done = done | (tok == eos_id)
                out.append(tok)
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
    finally:
        model.clear_cache()
        model.train(was_training)
