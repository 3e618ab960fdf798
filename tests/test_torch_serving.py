"""The port's serving engine against the JAX package's, on shared weights.

Both engines serve the same requests on the same GPT-2 weights (carried
across with ``interop``) at ``temperature=0``; the token streams must be
EQUAL, not close. The workloads cover continuous batching, static
batching, a pool small enough to force a preemption, and a
``poison-request`` chaos plan that must evict only its target. One pool
geometry serves all four, so the JAX side compiles its programs once.

Sampling at temperature > 0 draws torch's bits, not JAX's, so it is held
to its own contract: the truncation equals JAX's exactly, and a row's
draw depends only on its request seed, position and logits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu.robustness import chaos as jax_chaos
from distributed_pytorch_example_tpu.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from distributed_pytorch_example_tpu.serving.sampling import (
    truncate_logits as jax_truncate_logits,
)
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch.models import GPT2
from distributed_pytorch_example_tpu_torch.robustness import chaos
from distributed_pytorch_example_tpu_torch.serving import (
    EngineFetchTimeout,
    InferenceEngine,
    Request,
)
from distributed_pytorch_example_tpu_torch.serving.sampling import (
    sample_rows,
    truncate_logits,
)
from distributed_pytorch_example_tpu_torch.telemetry.trace import TraceWriter
from distributed_pytorch_example_tpu_torch.train.state import to_host, to_numpy

torch.set_num_threads(2)

GPT2_KW = dict(vocab_size=97, max_len=64, model_dim=32, num_layers=2,
               num_heads=4, mlp_dim=64)
# 11 allocatable blocks of 4 tokens: two 28-token requests cannot coexist
# at full length, so the "preempt" workload must preempt
PAGED = dict(paged_num_blocks=12, paged_block_size=4, paged_max_blocks=8)


def _np(tree):
    """A flax tree of tensor views (``interop.params_to_flax``) as numpy
    copies."""
    return to_numpy(to_host(tree))


@pytest.fixture(scope="module")
def models():
    # the port's seeded init, carried to a flax tree (no JAX init to compile)
    seeded = GPT2(**GPT2_KW, device="cpu", seed=0)
    sd = seeded.state_dict()
    params = _np(interop.params_to_flax(seeded))
    model = GPT2(**GPT2_KW, decode=True, **PAGED, device="cpu")
    model.load_state_dict(sd)
    return JaxGPT2(**GPT2_KW, decode=True, **PAGED), params, model


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 97, n)] for n in lengths]


# name -> (prompt lengths, max_new, run mode, poisoned request id)
WORKLOADS = {
    "continuous": ((8, 5, 7, 3), 8, "continuous", None),
    "static": ((8, 5, 7, 3), 8, "static", None),
    "preempt": ((8, 8), 20, "continuous", None),
    "poison": ((6, 7, 5), 8, "continuous", "r1"),
}


def _serve(engine, request_cls, prompts, max_new, mode):
    reqs = [
        request_cls(rid=f"r{i}", prompt=p, max_new_tokens=max_new, seed=i)
        for i, p in enumerate(prompts)
    ]
    return engine.run(reqs, mode=mode)


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_token_streams_equal_jax_engine(models, workload):
    jmodel, params, model = models
    lengths, max_new, mode, poisoned = WORKLOADS[workload]
    prompts = _prompts(lengths, seed=len(workload))
    plans = []
    if poisoned is not None:
        fault = dict(kind="poison-request", at=poisoned, step=2)
        plans = [jax_chaos.ChaosPlan([jax_chaos.Fault(**fault)]),
                 chaos.ChaosPlan([chaos.Fault(**fault)])]
        jax_chaos.install(plans[0])
        chaos.install(plans[1])
    try:
        ref = _serve(JaxEngine(jmodel, params, num_slots=2), JaxRequest,
                     prompts, max_new, mode)
        got = _serve(InferenceEngine(model, num_slots=2, device="cpu"),
                     Request, prompts, max_new, mode)
    finally:
        jax_chaos.uninstall()
        chaos.uninstall()
    for rid, r in ref["results"].items():
        g = got["results"][rid]
        assert (g["status"], g["tokens"], g["error"], g["preemptions"]) == (
            r["status"], r["tokens"], r["error"], r["preemptions"]
        ), rid
    for key in ("decode_steps", "completed", "errored", "preempted",
                "admitted", "generated_tokens"):
        assert got["metrics"][key] == ref["metrics"][key], key
    if workload == "preempt":
        assert got["metrics"]["preempted"] >= 1
    if workload == "poison":
        # only the target is evicted; its co-residents finish in full
        statuses = {rid: r["status"] for rid, r in got["results"].items()}
        assert statuses == {"r0": "done", "r1": "error", "r2": "done"}
        assert got["results"]["r1"]["tokens"] == ref["results"]["r1"]["tokens"]
        assert len(got["results"]["r1"]["tokens"]) == 2
        clean = _serve(InferenceEngine(model, num_slots=2, device="cpu"),
                       Request, prompts, max_new, mode)
        for rid in ("r0", "r2"):
            assert got["results"][rid]["tokens"] == (
                clean["results"][rid]["tokens"]
            )


def test_truncate_logits_equals_jax_exactly():
    """Ties included: logits on a quarter-integer grid tie often, and both
    the top-k rule (drop only ``< kth``) and the nucleus cut keep ties."""
    rng = np.random.default_rng(0)
    logits = (rng.integers(-8, 8, (6, 32)) / 4.0).astype(np.float32)
    for temperature, top_k, top_p in [
        (1.0, 5, None), (0.7, 1, None), (1.0, None, 0.5),
        (1.3, None, 0.9), (0.9, 8, 0.8), (1.0, 32, 1.0),
    ]:
        ref = np.asarray(jax_truncate_logits(
            jnp.asarray(logits), temperature, top_k, top_p
        ))
        got = truncate_logits(
            torch.from_numpy(logits), temperature, top_k, top_p
        ).numpy()
        np.testing.assert_array_equal(got, ref)
        assert np.isneginf(got).any() or top_k in (None, 32)


def test_seeded_sampling_is_per_row_deterministic():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((3, 97)).astype(np.float32))
    kw = dict(temperature=1.0, top_k=20, top_p=None)
    a = sample_rows(logits, [7, 8, 9], [5, 6, 7], **kw)
    assert torch.equal(a, sample_rows(logits, [7, 8, 9], [5, 6, 7], **kw))
    # other rows' logits, seeds and positions do not move row 0's draw
    other = logits.clone()
    other[1:] = torch.from_numpy(
        rng.standard_normal((2, 97)).astype(np.float32)
    )
    b = sample_rows(other, [7, 1, 2], [5, 0, 1], **kw)
    assert b[0] == a[0]
    # the draw depends on the position: 20 positions are not all equal
    draws = {int(sample_rows(logits[:1], [7], [p], **kw)[0]) for p in range(20)}
    assert len(draws) > 1
    assert torch.equal(
        sample_rows(logits, [0, 0, 0], [0, 0, 0], 0.0, None, None),
        logits.argmax(dim=-1),
    )


def test_sampled_stream_independent_of_co_residents(models):
    """At temperature 1.0 each request's tokens are the same served alone
    as beside other requests, a preempted-and-restarted one included."""
    _, _, model = models
    prompts = _prompts((8, 8, 5), seed=9)

    def serve(idx):
        engine = InferenceEngine(model, num_slots=2, temperature=1.0,
                                 top_k=5, device="cpu")
        return engine.run([
            Request(rid=f"r{i}", prompt=prompts[i], max_new_tokens=20,
                    seed=i) for i in idx
        ])["results"]

    crowded = serve([0, 1, 2])
    assert any(r["preemptions"] for r in crowded.values())
    for i in range(3):
        assert crowded[f"r{i}"]["tokens"] == serve([i])[f"r{i}"]["tokens"]


def test_trace_spans_and_fetch_retry_deadline(models, tmp_path):
    """Request spans land in the Chrome trace; a transient OSError in a
    device fetch is retried; a fetch past ``fetch_timeout_s`` raises
    EngineFetchTimeout instead of hanging."""
    import json
    import threading

    _, _, model = models
    trace = TraceWriter(str(tmp_path / "trace.json"))
    engine = InferenceEngine(model, num_slots=2, trace=trace, device="cpu",
                             fetch_timeout_s=5.0)
    engine.run([Request(rid="r0", prompt=[1, 2, 3], max_new_tokens=3)])
    trace.close()
    names = {e["name"] for e in json.loads((tmp_path / "trace.json").read_text())}
    assert {"prefill:r0", "decode_step", "queue:r0", "decode:r0"} <= names

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return 7

    assert engine._fetch(flaky, "flaky fetch") == 7 and len(calls) == 3
    engine.fetch_timeout_s = 0.05
    release = threading.Event()
    with pytest.raises(EngineFetchTimeout):
        engine._fetch(lambda: release.wait(5.0), "hung fetch")
    release.set()
