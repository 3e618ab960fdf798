"""Sampling math for the serving engine.

``truncate_logits`` is the JAX package's truncation (temperature / top-k /
top-p) step for step, tie rule included: a top-k cut keeps every logit
that is not ``< kth``, and the nucleus keeps every logit not ``<`` the
threshold at the smallest sorted prefix whose mass reaches ``top_p``.

The rng contract (the JAX engine's, with torch's bits in place of JAX's):
the token at absolute position ``p`` (0-based, prompt included) of a
request with seed ``s`` is drawn with noise from a CPU ``torch.Generator``
seeded from ``(s, p)`` alone. A row's draw therefore depends on its own
request, position and logits only — never on which other rows share the
batch — so preemption restarts and co-resident changes reproduce the
same tokens. The noise comes from a CPU generator so the draw is the same
whichever device computed the logits. ``temperature == 0`` is argmax.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def row_seed(seed: int, position: int) -> int:
    """The generator seed for (request seed, absolute position)."""
    return _splitmix64(_splitmix64(int(seed) & _MASK64) ^ int(position)) >> 1


def gumbel_noise(seed: int, position: int, vocab: int) -> torch.Tensor:
    """(vocab,) float32 Gumbel noise for one row's draw, on the CPU."""
    gen = torch.Generator().manual_seed(row_seed(seed, position))
    u = torch.rand(vocab, generator=gen, dtype=torch.float32)
    return -torch.log(-torch.log(u))


def truncate_logits(
    logits: torch.Tensor,
    temperature: float,
    top_k: Optional[int],
    top_p: Optional[float],
) -> torch.Tensor:
    """Temperature-scale and truncate (..., V) logits; temperature > 0."""
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype, device=logits.device)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p is not None:
        # nucleus: keep the smallest prefix of the sorted distribution
        # whose mass reaches top_p (the first token always survives)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cut = torch.sum(cum - probs < top_p, dim=-1, keepdim=True)  # >= 1
        threshold = torch.gather(sorted_logits, -1, cut - 1)
        logits = torch.where(logits < threshold, neg_inf, logits)
    return logits


def sample_rows(
    logits: torch.Tensor,
    seeds: Sequence[int],
    positions: Sequence[int],
    temperature: float,
    top_k: Optional[int],
    top_p: Optional[float],
) -> torch.Tensor:
    """One token per row of (B, V) float32 logits -> (B,) int64.

    Row ``b`` draws with :func:`gumbel_noise` of ``(seeds[b],
    positions[b])`` (Gumbel-max: the argmax of logits plus Gumbel noise is
    a draw from their softmax), so rows are independent of each other.
    """
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = truncate_logits(logits, temperature, top_k, top_p)
    vocab = logits.shape[-1]
    noise = torch.stack([
        gumbel_noise(s, p, vocab) for s, p in zip(seeds, positions)
    ]).to(logits.device, non_blocking=True)
    return torch.argmax(logits + noise, dim=-1)
