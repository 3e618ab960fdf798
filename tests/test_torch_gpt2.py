"""The port's GPT-2 against the JAX package's, on shared weights.

Weights cross with ``interop``; tokens, tables and lengths are numpy
arrays handed to both. Tolerance 1e-4 on float32 logits: both sides run
float32 throughout, and the frameworks only sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models import GPT2
from distributed_pytorch_example_tpu_torch.ops import paged_attention
from distributed_pytorch_example_tpu_torch.train.state import to_host, to_numpy

torch.set_num_threads(2)

KW = dict(vocab_size=97, max_len=64, model_dim=32, num_layers=2,
          num_heads=4, mlp_dim=64)
PAGED = dict(paged_num_blocks=32, paged_block_size=4, paged_max_blocks=8)
TOL = 1e-4


def _np(tree):
    """A flax tree of tensor views (``interop.params_to_flax``) as numpy
    copies."""
    return to_numpy(to_host(tree))


@pytest.fixture(scope="module")
def shared():
    # the port's seeded init, carried to a flax tree (no JAX init to compile)
    model = GPT2(**KW, device="cpu", seed=0)
    sd = model.state_dict()
    params = _np(interop.params_to_flax(model))
    return params, sd


def test_full_sequence_logits_match_jax(shared):
    params, sd = shared
    model = GPT2(**KW, device="cpu")
    model.load_state_dict(sd)
    tokens = np.random.default_rng(0).integers(0, 97, (2, 24))
    ref = JaxGPT2(**KW).apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_paged_prefill_then_decode_matches_jax(shared):
    """One bucket-padded prefill of a fresh row, then three one-token
    decode calls, through both packages' paged models with the same
    tables and lengths: logits agree at every step."""
    params, sd = shared
    jmodel = JaxGPT2(**KW, decode=True, **PAGED)
    cache = jmodel.init(
        jax.random.key(0), jnp.zeros((2, 1), jnp.int32)
    )["cache"]
    model = GPT2(**KW, decode=True, **PAGED, device="cpu")
    model.load_state_dict(sd)

    def set_tables(c, table, lens):
        def fix(path, leaf):
            name = getattr(path[-1], "key", "")
            if name == "page_table":
                return jnp.asarray(table)
            if name == "row_lens":
                return jnp.asarray(lens)
            return leaf
        return jax.tree_util.tree_map_with_path(fix, c)

    def step(c, tokens, table, lens):
        logits, vars_ = jmodel.apply(
            {"params": params, "cache": set_tables(c, table, lens)},
            jnp.asarray(tokens), mutable=["cache"],
        )
        with torch.no_grad():
            got = model(torch.from_numpy(tokens),
                        page_table=torch.from_numpy(table),
                        row_lens=torch.from_numpy(lens))
        np.testing.assert_allclose(
            got.numpy(), np.asarray(logits), atol=TOL, rtol=0
        )
        return vars_["cache"], got

    rng = np.random.default_rng(1)
    plen, bucket = 6, 8
    prompt = np.zeros((1, bucket), np.int64)
    prompt[0, :plen] = rng.integers(0, 97, plen)
    # row 0 holds blocks 5 and 9 (non-identity placement); row 1 is idle
    table = np.zeros((2, 8), np.int32)
    table[0, :3] = [5, 9, 2]
    cache, _ = step(cache, prompt, table[:1], np.zeros((1,), np.int32))
    before = paged_attention.paged_flash_decode.launches
    for t in range(3):
        tokens = np.asarray([[rng.integers(0, 97)], [0]], np.int64)
        lens = np.asarray([plen + t, 0], np.int32)
        cache, _ = step(cache, tokens, table, lens)
    # CPU tensors take the plain version: the kernel never launched
    assert paged_attention.paged_flash_decode.launches == before


def test_refused_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPT2(**KW, moe_experts=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPT2(**KW, pipe_axis="pipe", device="cpu")
    with pytest.raises(NotImplementedError, match="contiguous"):
        GPT2(**KW, decode=True, device="cpu")
    with pytest.raises(ValueError, match="decode"):
        GPT2(**KW, **PAGED, device="cpu")
