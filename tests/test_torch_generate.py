"""The port's ``generate()`` over a contiguous KV cache against the JAX
package's, on shared weights.

Weights cross with ``interop`` from the port's seeded init (tiny models:
JAX ``tests/test_generate.py``'s sizes). Greedy streams must be EQUAL to
JAX's ``generate`` and to a full recompute; the logits of a prefill and
three cached steps agree with JAX's within 1e-5 (float32 throughout, the
frameworks sum in different orders). Sampling draws torch's bits, not
JAX's, so it is held to its own contract: the truncation is respected, a
seed reproduces its stream, and a one-row ``generate(rng_fold=
"position")`` equals the port's paged engine for a request of that seed.
The validations raise JAX's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu.models.llama import Llama as JaxLlama
from distributed_pytorch_example_tpu.train.generate import (
    generate as jax_generate,
)
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models import GPT2, Llama
from distributed_pytorch_example_tpu_torch.serving import (
    InferenceEngine,
    Request,
)
from distributed_pytorch_example_tpu_torch.train import generate
from distributed_pytorch_example_tpu_torch.train.state import to_host, to_numpy

torch.set_num_threads(2)

GPT2_KW = dict(vocab_size=97, max_len=64, model_dim=32, num_layers=2,
               num_heads=4, mlp_dim=64)
LLAMA_KW = dict(vocab_size=97, max_len=64, model_dim=32, num_layers=2,
                num_heads=4, num_kv_heads=2, mlp_dim=64)
FAMILIES = {"gpt2": (GPT2, JaxGPT2, GPT2_KW),
            "llama": (Llama, JaxLlama, LLAMA_KW)}
PAGED = dict(paged_num_blocks=32, paged_block_size=4, paged_max_blocks=8)
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def families():
    """family -> (training model, decode model, flax params) on the port's
    seeded weights."""
    out = {}
    for name, (cls, _, kw) in FAMILIES.items():
        train = cls(**kw, device="cpu", seed=0)
        decode = cls(**kw, decode=True, device="cpu")
        decode.load_state_dict(train.state_dict())
        params = to_numpy(to_host(interop.params_to_flax(train)))
        out[name] = (train, decode, params)
    return out


def _prompt(batch=2, length=8, seed=0):
    return np.random.default_rng(seed).integers(0, 97, (batch, length))


def _full_recompute(model, prompt, n):
    tokens = torch.from_numpy(prompt)
    with torch.no_grad():
        for _ in range(n):
            nxt = model(tokens)[:, -1].argmax(dim=-1)
            tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    return tokens.numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_greedy_equals_jax_generate_and_full_recompute(families, family):
    train, decode, params = families[family]
    jcls, kw = FAMILIES[family][1], FAMILIES[family][2]
    prompt = _prompt()
    want = np.asarray(jax_generate(jcls(**kw, decode=True), params,
                                   jnp.asarray(prompt, jnp.int32), 12,
                                   temperature=0.0))
    got = generate(decode, prompt, 12, temperature=0.0).numpy()
    assert got.shape == (2, 20)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _full_recompute(train, prompt, 12))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_and_cached_steps_match_jax_logits(families, family):
    """A prefill of 8 tokens then 3 one-token calls over a 16-position
    cache: the logits of every call agree with JAX's decode model."""
    _, decode, params = families[family]
    jcls, kw = FAMILIES[family][1], FAMILIES[family][2]
    jmodel = jcls(**kw, decode=True)
    prompt = _prompt()
    cache = jmodel.init(jax.random.key(0), jnp.zeros((2, 16), jnp.int32),
                        train=False)["cache"]
    calls = [prompt] + [_prompt(2, 1, seed=1 + t) for t in range(3)]
    step = jax.jit(lambda c, t: jmodel.apply(
        {"params": params, "cache": c}, t, train=False, mutable=["cache"]))
    decode.init_cache(2, 16)
    try:
        for tokens in calls:
            ref, vars_ = step(cache, jnp.asarray(tokens, jnp.int32))
            cache = vars_["cache"]
            with torch.no_grad():
                got = decode(torch.from_numpy(tokens))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=LOGIT_TOL, rtol=0)
    finally:
        decode.clear_cache()
    assert all(m.cache_k is None for m in decode.modules()
               if hasattr(m, "cache_k"))


def test_decode_model_state_dict_is_the_training_models(families):
    for train, decode, _ in families.values():
        decode.init_cache(2, 16)
        try:
            assert list(decode.state_dict()) == list(train.state_dict())
        finally:
            decode.clear_cache()


def test_sampling_respects_top_k_top_p_and_the_seed(families):
    """Every sampled token lies in its step's top-k (or nucleus) of the
    full-recompute logits; one seed gives one stream, another another."""
    train, decode, _ = families["gpt2"]
    prompt = _prompt(2, 4, seed=5)
    for trunc in (dict(top_k=5), dict(top_p=0.5)):
        a = generate(decode, prompt, 10, temperature=1.0, rng=1, **trunc)
        b = generate(decode, prompt, 10, temperature=1.0, rng=1, **trunc)
        c = generate(decode, prompt, 10, temperature=1.0, rng=2, **trunc)
        assert torch.equal(a, b)
        assert not torch.equal(a, c)
        for out in (a, c):
            with torch.no_grad():
                logits = train(out[:, :-1])[:, 3:]  # the 10 sampled steps
            chosen = logits.gather(2, out[:, 4:, None])[..., 0]
            if "top_k" in trunc:
                kth = logits.topk(5, dim=-1).values[..., -1]
                assert (chosen >= kth).all()
            else:
                # the nucleus keeps a token when the mass of the tokens
                # above it stays below top_p
                probs = torch.softmax(logits, dim=-1)
                mine = probs.gather(2, out[:, 4:, None])
                assert ((probs * (probs > mine)).sum(-1) < 0.5).all()


def test_eos_freezes_a_finished_row(families):
    _, decode, _ = families["gpt2"]
    prompt = np.zeros((2, 4), np.int64)
    free = generate(decode, prompt, 12, temperature=1.0, rng=3)[0, 4:]
    # the second sampled token is the EOS: it provably occurs, and the
    # frozen run draws the same noise, so the tokens before it agree
    eos = int(free[1])
    frozen = generate(decode, prompt, 12, temperature=1.0, rng=3,
                      eos_id=eos)[0, 4:]
    hit = int(torch.nonzero(frozen == eos)[0, 0])
    assert torch.equal(frozen[:hit + 1], free[:hit + 1])
    assert (frozen[hit:] == eos).all()
    assert not (free[hit:] == eos).all()  # the free run kept sampling


BAD_ARGS = [dict(rng_fold="chain"), dict(max_new_tokens=0), dict(top_p=0.0),
            dict(top_p=1.5), dict(top_k=0), dict(top_k=98),
            dict(decode=False)]


def test_validations_raise_as_jax(families):
    train, decode, params = families["gpt2"]
    prompt = np.zeros((1, 4), np.int64)
    for bad in BAD_ARGS:
        bad = dict(bad)
        is_decode = bad.pop("decode", True)
        n = bad.pop("max_new_tokens", 4)
        with pytest.raises(ValueError) as want:
            jax_generate(JaxGPT2(**GPT2_KW, decode=is_decode), params,
                         jnp.asarray(prompt, jnp.int32), n, **bad)
        with pytest.raises(ValueError) as got:
            generate(decode if is_decode else train, prompt, n, **bad)
        assert str(got.value) == str(want.value), bad


def test_partitioner_raises_naming_item_11(families):
    _, decode, _ = families["gpt2"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 11"):
        generate(decode, np.zeros((1, 4), np.int64), 4, partitioner=object())
    paged = GPT2(**GPT2_KW, decode=True, **PAGED, device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        generate(paged, np.zeros((1, 4), np.int64), 4)


def test_position_fold_equals_the_paged_engine(families):
    """A one-row ``generate(rng_fold="position")`` with seed s samples the
    tokens the paged engine samples for a request with seed s, at
    temperature 0.9 and top-k 5; in a batch of two equal prompts row 0
    keeps them and row 1 draws its own. Both families."""
    for family in sorted(FAMILIES):
        _position_fold_equals_the_paged_engine(families, family)


def _position_fold_equals_the_paged_engine(families, family):
    train, decode, _ = families[family]
    cls, _, kw = FAMILIES[family]
    paged = cls(**kw, decode=True, **PAGED, device="cpu")
    paged.load_state_dict(train.state_dict())
    sample = dict(temperature=0.9, top_k=5)
    prompts = [_prompt(1, n, seed=10 + n)[0] for n in (8, 5, 11)]
    reqs = [Request(rid=f"r{i}", prompt=[int(t) for t in p],
                    max_new_tokens=12, seed=7 + i)
            for i, p in enumerate(prompts)]
    served = InferenceEngine(paged, num_slots=2, device="cpu",
                             **sample).run(reqs)["results"]
    for i, p in enumerate(prompts):
        got = generate(decode, p[None], 12, rng=7 + i, rng_fold="position",
                       **sample)[0, len(p):].tolist()
        assert got == served[f"r{i}"]["tokens"], i
    pair = generate(decode, np.stack([prompts[0]] * 2), 12, rng=7,
                    rng_fold="position", **sample)[:, 8:]
    assert pair[0].tolist() == served["r0"]["tokens"]
    assert pair[1].tolist() != pair[0].tolist()
