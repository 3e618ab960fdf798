"""The port's speculative decoding against the JAX package's, on the CPU.

Self-speculation (the draft is the target: ``self_draft``, the same
weights over a pool of its own) on tiny models whose weights cross with
``interop``. At temperature 0 the speculative streams must EQUAL JAX's
``generate`` and JAX's speculative engine, in fewer decode boundaries than
the plain engine. Sampling draws torch's bits, not JAX's, so sampled
speculative streams are held to the port's own non-speculative engine.
Below the engine: ``sample_token_matrix`` is ``sample_rows`` position by
position, bit for bit; a verify chunk's logits equal K sequential decode
steps within 1e-5 (float32, summation order only); a window that runs past
the table writes only to the scratch block. Last, the serve CLI with
``--spec-tokens 4``.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.models.gpt2 import GPT2 as JaxGPT2
from distributed_pytorch_example_tpu.models.llama import Llama as JaxLlama
from distributed_pytorch_example_tpu.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from distributed_pytorch_example_tpu.train.generate import (
    generate as jax_generate,
)
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch import serve as port_serve
from distributed_pytorch_example_tpu_torch.models import GPT2, Llama
from distributed_pytorch_example_tpu_torch.serving import (
    InferenceEngine,
    Request,
)
from distributed_pytorch_example_tpu_torch.serving.engine import self_draft
from distributed_pytorch_example_tpu_torch.serving.sampling import (
    sample_rows,
    sample_token_matrix,
)
from distributed_pytorch_example_tpu_torch.train import generate
from distributed_pytorch_example_tpu_torch.train.state import to_host, to_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT2_KW = dict(vocab_size=97, max_len=64, model_dim=32, num_layers=2,
               num_heads=4, mlp_dim=64)
LLAMA_KW = dict(vocab_size=97, max_len=64, model_dim=32, num_layers=2,
                num_heads=4, num_kv_heads=2, mlp_dim=64)
FAMILIES = {"gpt2": (GPT2, JaxGPT2, GPT2_KW),
            "llama": (Llama, JaxLlama, LLAMA_KW)}
PAGED = dict(paged_num_blocks=32, paged_block_size=4, paged_max_blocks=8)
# JAX's preemption geometry: 11 allocatable blocks of 4 tokens, so two
# 28-token requests cannot coexist at full length
TIGHT = dict(paged_num_blocks=12, paged_block_size=4, paged_max_blocks=8)
# one prefill bucket keeps JAX's compiles few
BUCKETS = [16]
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def families():
    """family -> (port paged model, flax params) on the port's seeded
    weights."""
    out = {}
    for name, (cls, _, kw) in FAMILIES.items():
        seeded = cls(**kw, device="cpu", seed=0)
        paged = cls(**kw, decode=True, **PAGED, device="cpu")
        paged.load_state_dict(seeded.state_dict())
        out[name] = (paged, to_numpy(to_host(interop.params_to_flax(seeded))))
    return out


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 97, n)] for n in lengths]


def _requests(cls, prompts, max_new):
    return [cls(rid=f"r{i}", prompt=p, max_new_tokens=max_new, seed=i)
            for i, p in enumerate(prompts)]


def _spec(model, spec_tokens=4, **kw):
    return InferenceEngine(model, num_slots=2, device="cpu",
                           draft_model=self_draft(model),
                           spec_tokens=spec_tokens, prefill_buckets=BUCKETS,
                           **kw)


def _streams(report):
    return {rid: r["tokens"] for rid, r in report["results"].items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spec_greedy_equals_jax_generate_and_jax_spec_engine(families,
                                                             family):
    model, params = families[family]
    _, jcls, kw = FAMILIES[family]
    prompts = _prompts((8, 5, 11), seed=6)
    jpaged = jcls(**kw, decode=True, **PAGED)
    jspec = JaxEngine(jpaged, params, num_slots=2, temperature=0.0,
                      draft_model=jpaged, draft_params=params, spec_tokens=4,
                      prefill_buckets=BUCKETS)
    want = jspec.run(_requests(JaxRequest, prompts, 12))
    plain = InferenceEngine(model, num_slots=2, temperature=0.0,
                            device="cpu", prefill_buckets=BUCKETS)
    plain_steps = plain.run(_requests(Request, prompts, 12))["metrics"][
        "decode_steps"]
    got = _spec(model, temperature=0.0).run(_requests(Request, prompts, 12))
    assert _streams(got) == _streams(want)
    jdecode = jcls(**kw, decode=True)
    for i, p in enumerate(prompts):
        ref = np.asarray(jax_generate(jdecode, params,
                                      jnp.asarray([p], jnp.int32), 12,
                                      temperature=0.0))[0, len(p):]
        assert got["results"][f"r{i}"]["status"] == "done"
        assert got["results"][f"r{i}"]["tokens"] == ref.tolist(), i
    for key in ("decode_steps", "spec_proposed", "spec_accepted",
                "generated_tokens"):
        assert got["metrics"][key] == want["metrics"][key], key
    assert got["metrics"]["decode_steps"] < plain_steps


def test_spec_sampled_streams_equal_the_plain_engine(families):
    prompts = _prompts((8, 5, 11), seed=7)
    sample = dict(temperature=0.9, top_k=5)
    for model, _ in families.values():
        plain = InferenceEngine(model, num_slots=2, device="cpu", **sample)
        want = plain.run(_requests(Request, prompts, 10))
        got = _spec(model, **sample).run(_requests(Request, prompts, 10))
        assert _streams(got) == _streams(want)
        assert got["metrics"]["spec_proposed"] > 0


def test_spec_preemption_restart_replays_the_same_tokens(families):
    """Block pressure with a speculative window in flight: the preempted
    request restarts to the tokens ``generate()`` gives it alone (the
    window's growth is clamped to the request's ceiling, the draws fold
    absolute positions)."""
    model, _ = families["gpt2"]
    tight = GPT2(**GPT2_KW, decode=True, **TIGHT, device="cpu")
    tight.load_state_dict(model.state_dict())
    decode = GPT2(**GPT2_KW, decode=True, device="cpu")
    decode.load_state_dict(model.state_dict())
    prompts = _prompts((8, 8), seed=8)
    report = _spec(tight, temperature=0.0).run(
        _requests(Request, prompts, 20))
    assert report["metrics"]["preempted"] >= 1
    for i, p in enumerate(prompts):
        r = report["results"][f"r{i}"]
        ref = generate(decode, [p], 20, temperature=0.0)[0, len(p):]
        assert r["status"] == "done" and r["tokens"] == ref.tolist(), i


class _Spans:
    def __init__(self):
        self.names = []

    def add_complete(self, name, ts_us, dur_us):
        self.names.append(name)


def test_spec_accept_rate_is_reported_only_when_on(families):
    """The accept rate and its counters, and the speculative spans."""
    model, _ = families["gpt2"]
    prompts = _prompts((8, 5), seed=9)
    spans = _Spans()
    m = _spec(model, temperature=0.0, trace=spans).run(
        _requests(Request, prompts, 12))["metrics"]
    assert {"draft_prefill:r0", "draft_prefill:r1", "draft_propose",
            "verify_step"} <= set(spans.names)
    assert spans.names.count("draft_propose") == m["decode_steps"]
    assert "decode_step" not in spans.names
    assert m["decode_tokens"] > 0 and m["decode_tokens_per_sec"] > 0
    assert 0.8 <= m["spec_accept_rate"] <= 1.0
    assert m["spec_proposed"] >= m["spec_accepted"] > 0
    pm = InferenceEngine(model, num_slots=2, temperature=0.0,
                         device="cpu").run(
        _requests(Request, prompts, 12))["metrics"]
    assert pm["spec_accept_rate"] is None
    assert pm["spec_proposed"] == pm["spec_accepted"] == 0


def test_mismatched_or_non_decode_drafts_are_refused(families):
    model, _ = families["gpt2"]
    other = GPT2(**GPT2_KW, decode=True, paged_num_blocks=16,
                 paged_block_size=8, paged_max_blocks=4, device="cpu")
    with pytest.raises(ValueError, match="paged geometry"):
        InferenceEngine(model, device="cpu", draft_model=other,
                        spec_tokens=4)
    with pytest.raises(ValueError, match="decode=True"):
        InferenceEngine(model, device="cpu", spec_tokens=4,
                        draft_model=GPT2(**GPT2_KW, device="cpu"))
    with pytest.raises(ValueError, match="spec_tokens"):
        InferenceEngine(model, device="cpu", draft_model=model,
                        spec_tokens=1)
    with pytest.raises(ValueError, match="draft_model"):
        InferenceEngine(model, device="cpu", spec_tokens=4)


def test_sample_token_matrix_is_sample_rows_per_position():
    """Greedy, top-k and top-p, bit for bit."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(3, 4, 97)).astype(np.float32))
    seeds, positions = [3, 11, 0], [5, 17, 1]
    for trunc in (dict(temperature=0.0), dict(temperature=0.9, top_k=5),
                  dict(temperature=1.0, top_p=0.8)):
        kw = {"top_k": None, "top_p": None, **trunc}
        got = sample_token_matrix(logits, seeds, positions, **kw)
        assert got.shape == (3, 4) and got.dtype == torch.int64
        for i in range(4):
            want = sample_rows(logits[:, i], seeds,
                               [p + i for p in positions], **kw)
            assert torch.equal(got[:, i], want), (trunc, i)


def _prefilled(model):
    """Two rows prefilled at other offsets (6 and 3 tokens) into blocks
    placed out of order; returns (table, lens)."""
    table = np.zeros((2, 8), np.int32)
    table[0, :3] = [5, 9, 2]
    table[1, :3] = [7, 3, 11]
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for row, plen in ((0, 6), (1, 3)):
            prompt = np.zeros((1, 8), np.int64)
            prompt[0, :plen] = rng.integers(0, 97, plen)
            model(torch.from_numpy(prompt),
                  page_table=torch.from_numpy(table[row:row + 1]),
                  row_lens=torch.zeros(1, dtype=torch.int32))
    return torch.from_numpy(table), torch.tensor([6, 3], dtype=torch.int32)


def _pools(model):
    return [b.clone() for n, b in model.named_buffers() if "pages" in n]


def test_verify_chunk_equals_sequential_decode_steps(families):
    """A 4-token verify chunk on one pool, 4 one-token decode steps on a
    copy of it: the logits agree within 1e-5, and so do the pools. Both
    families."""
    window = torch.from_numpy(
        np.random.default_rng(2).integers(0, 97, (2, 4)))
    for model, _ in families.values():
        table, lens = _prefilled(model)
        twin = self_draft(model)
        with torch.no_grad():
            chunk = model(window, page_table=table, row_lens=lens,
                          verify=True)
            steps = torch.cat([
                twin(window[:, i:i + 1], page_table=table, row_lens=lens + i)
                for i in range(4)], dim=1)
        assert chunk.shape == (2, 4, 97)
        torch.testing.assert_close(chunk, steps, atol=LOGIT_TOL, rtol=0)
        for a, b in zip(_pools(model), _pools(twin)):
            torch.testing.assert_close(a, b, atol=LOGIT_TOL, rtol=0)


def test_verify_window_past_the_table_writes_only_to_scratch(families):
    """Row 0 sits 2 positions before its context limit (8 blocks of 4):
    of a 4-token window, 2 positions fall past the table. They land on the
    scratch block; row 0's other positions and row 1's blocks are
    untouched. Both families."""
    for model, _ in families.values():
        _window_past_the_table(model)


def _window_past_the_table(model):
    table, _ = _prefilled(model)
    table[0] = torch.tensor([5, 9, 2, 13, 14, 15, 16, 17], dtype=torch.int32)
    lens = torch.tensor([30, 3], dtype=torch.int32)
    before = _pools(model)
    window = torch.from_numpy(
        np.random.default_rng(3).integers(0, 97, (2, 4)))
    with torch.no_grad():
        logits = model(window, page_table=table, row_lens=lens, verify=True)
    assert torch.isfinite(logits).all()
    for old, new in zip(before, _pools(model)):
        changed = (old != new).flatten(2).any(-1)  # (block, offset)
        written = {(int(b), int(o)) for b, o in changed.nonzero()}
        row0 = {(17, 2), (17, 3)}  # positions 30 and 31
        row1 = {(7, 3), (3, 0), (3, 1), (3, 2)}  # positions 3 .. 6
        assert written - {(0, o) for o in range(4)} <= row0 | row1
        assert written & row0 == row0 and written & row1 == row1
        assert any(b == 0 for b, _ in written)  # positions 32, 33


def _jax_serve_cli():
    """The JAX package's ``serve.py`` (a script at the repository root)."""
    spec = importlib.util.spec_from_file_location(
        "jax_serve_cli", os.path.join(ROOT, "serve.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CLI_FLAGS = ["--num-layers", "1", "--requests", "4", "--rate", "0",
             "--slots", "2", "--prompt-len", "3:8", "--max-new", "4:12",
             "--temperature", "0", "--spec-tokens", "4"]


def test_serve_cli_spec_tokens_prints_jax_keys_and_greedy_streams(
        capsys, monkeypatch):
    jax_cli = _jax_serve_cli()
    monkeypatch.setattr(sys, "argv", ["serve.py", *CLI_FLAGS])
    assert jax_cli.main() == 0
    want_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_serve.main(CLI_FLAGS + ["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line.keys() == want_line.keys()
    assert set(line["config"]) - set(want_line["config"]) == {"device"}
    assert line["config"]["spec_tokens"] == 4
    assert line["spec_accept_rate"] is not None
    for key in ("completed", "generated_tokens", "decode_steps",
                "spec_accept_rate"):
        assert line[key] == want_line[key], key

    # the greedy streams, on the JAX CLI's weights carried across
    args = port_serve.build_parser().parse_args(CLI_FLAGS + ["--device",
                                                             "cpu"])
    jengine = jax_cli.build_engine(args, None)
    model = port_serve.build_model(args)
    interop.params_from_flax(model, jax.tree_util.tree_map(
        np.asarray, jengine.params))
    engine = port_serve.build_engine(args, None, model)
    assert engine.spec_tokens == jengine.spec_tokens == 4
    want = jengine.run(jax_cli.build_requests(args))
    got = engine.run(port_serve.build_requests(args))
    assert _streams(got) == _streams(want)
    with pytest.raises(SystemExit):
        port_serve.main(["--spec-tokens", "1", "--device", "cpu"])
