"""The port's chunked cross-entropy against the JAX package's.

Loss, argmax and the gradients with respect to hidden, embedding and bias,
on numpy inputs from a seed, including vocabularies that are not a
multiple of the block width (a narrow last block).

Tolerances: float32 operands 2e-5 relative and absolute (both sides
float32, only the summation order differs). bf16 operands: the forward
products match (bf16 inputs, float32 accumulation on both sides), so the
loss keeps 2e-5; in the backward the port also rounds the (softmax -
onehot) matrix to bf16 before its products, as the TPU's default-precision
float32 matmul does, while JAX on the CPU keeps it float32: gradients
agree to 1e-2 of their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.ops.chunked_ce import (
    chunked_softmax_xent as jax_xent,
)
from distributed_pytorch_example_tpu_torch.ops.chunked_ce import (
    chunked_softmax_xent,
)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def make_inputs(vocab, dim=32, seed=0, bias=False):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((3, 7, dim), dtype=np.float32)
    embedding = (rng.standard_normal((vocab, dim)) * 0.1).astype(np.float32)
    targets = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    b = (rng.standard_normal(vocab) * 0.1).astype(np.float32) if bias else None
    weights = rng.standard_normal((3, 7)).astype(np.float32)
    return hidden, embedding, targets, b, weights


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("vocab,block,bias", [
    (777, 128, False),     # narrow last block
    (1000, 1000, True),    # one block, with a bias
    (5000, 4096, False),   # the default block width
])
def test_chunked_ce_matches_jax(vocab, block, bias, dtype):
    jdt, tdt = DTYPES[dtype]
    hidden, embedding, targets, b, w = make_inputs(vocab, bias=bias)

    def jax_loss(h, e, bb):
        loss, argmax = jax_xent(h, e, jnp.asarray(targets), bias=bb,
                                block_size=block, dtype=jdt)
        return jnp.sum(loss * w), (loss, argmax)

    argnums = (0, 1, 2) if bias else (0, 1)
    args = [jnp.asarray(hidden), jnp.asarray(embedding),
            None if b is None else jnp.asarray(b)]
    (_, (jloss, jargmax)), jgrads = jax.value_and_grad(
        jax_loss, argnums=argnums, has_aux=True)(*args)

    th = torch.from_numpy(hidden).requires_grad_()
    te = torch.from_numpy(embedding).requires_grad_()
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    loss, argmax = chunked_softmax_xent(
        th.to(tdt), te, torch.from_numpy(targets), bias=tb, block_size=block,
        dtype=tdt,
    )
    (loss * torch.from_numpy(w)).sum().backward()
    assert loss.dtype == torch.float32 and loss.shape == (3, 7)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(argmax.numpy(), np.asarray(jargmax))
    grads = [th.grad, te.grad] + ([tb.grad] if bias else [])
    for name, got, want in zip("heb", grads, jgrads):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                       atol=2e-5, err_msg=f"d{name}")
        else:
            err = np.abs(got.float().numpy() - want).max()
            assert err <= 1e-2 * np.abs(want).max(), (name, err)


def test_chunked_ce_validates_shapes():
    hidden, embedding, targets, _, _ = make_inputs(100)
    h, e, t = map(torch.from_numpy, (hidden, embedding, targets))
    with pytest.raises(ValueError, match="embedding dim"):
        chunked_softmax_xent(h, e[:, :16], t)
    with pytest.raises(ValueError, match="targets shape"):
        chunked_softmax_xent(h, e, t[:, :3])
