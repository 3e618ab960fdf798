"""The port's LLaMA serving path against the JAX package's, on the CPU.

The paged model (RoPE at each row's ``row_lens + arange(seq)``, a GQA
pool of kv heads) against JAX's on the same weights, tables and lengths:
float32 logits to 1e-4 (float32 throughout; summation order only, as
``tests/test_torch_gpt2.py``). Then the two serving CLIs with the same
flags (``--family llama --num-kv-heads 2``, greedy): the JAX ``serve.py``
draws the weights from ``--seed``, the port's model takes them through
``interop``, and both engines serve the CLIs' seeded workload; the token
streams must be equal (``-m slow``: JAX's engine compiles for 8-13 s).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.models.llama import Llama as JaxLlama
from distributed_pytorch_example_tpu_torch import interop
from distributed_pytorch_example_tpu_torch import serve as port_serve
from distributed_pytorch_example_tpu_torch.models import Llama
from distributed_pytorch_example_tpu_torch.train.state import to_host, to_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(vocab_size=97, max_len=64, model_dim=64, num_layers=2,
          num_heads=4, num_kv_heads=2, mlp_dim=128)
PAGED = dict(paged_num_blocks=32, paged_block_size=4, paged_max_blocks=8)
TOL = 1e-4
# one layer and prompts inside one prefill bucket keep JAX's compiles few;
# the paged test below holds two layers
FLAGS = ["--family", "llama", "--num-kv-heads", "2", "--num-layers", "1",
         "--requests", "6", "--rate", "0", "--slots", "3",
         "--prompt-len", "3:8", "--max-new", "4:12", "--temperature", "0",
         "--device", "cpu"]


def _jax_serve_cli():
    """The JAX package's ``serve.py`` (a script at the repository root)."""
    spec = importlib.util.spec_from_file_location(
        "jax_serve_cli", os.path.join(ROOT, "serve.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_paged_prefill_then_decode_matches_jax():
    """A bucket-padded prefill of a fresh row, then three one-token decode
    calls with a second row at another offset: logits agree at every
    step, so RoPE's per-row positions and the GQA pool do."""
    seeded = Llama(**KW, device="cpu", seed=0)
    params = to_numpy(to_host(interop.params_to_flax(seeded)))
    jmodel = JaxLlama(**KW, decode=True, **PAGED)
    cache = jmodel.init(jax.random.key(0),
                        jnp.zeros((2, 1), jnp.int32))["cache"]
    model = Llama(**KW, decode=True, **PAGED, device="cpu")
    model.load_state_dict(seeded.state_dict())
    assert model.layers[0].attn.pages_k.shape == (32, 4, 2, 16)

    def set_tables(c, table, lens):
        def fix(path, leaf):
            name = getattr(path[-1], "key", "")
            if name == "page_table":
                return jnp.asarray(table)
            if name == "row_lens":
                return jnp.asarray(lens)
            return leaf
        return jax.tree_util.tree_map_with_path(fix, c)

    @jax.jit
    def jstep(c, tokens):
        return jmodel.apply({"params": params, "cache": c}, tokens,
                            mutable=["cache"])

    def step(c, tokens, table, lens):
        logits, vars_ = jstep(set_tables(c, table, lens), jnp.asarray(tokens))
        with torch.no_grad():
            got = model(torch.from_numpy(tokens),
                        page_table=torch.from_numpy(table),
                        row_lens=torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=TOL,
                                   rtol=0)
        return vars_["cache"]

    rng = np.random.default_rng(1)
    table = np.zeros((2, 8), np.int32)
    table[0, :3] = [5, 9, 2]
    table[1, :3] = [7, 3, 11]
    for row, plen in ((0, 6), (1, 3)):
        prompt = np.zeros((2, 8), np.int64)
        prompt[:, :plen] = rng.integers(0, 97, plen)
        one = np.zeros((2, 8), np.int32)
        one[0] = table[row]
        cache = step(cache, prompt[:1], one[:1], np.zeros((1,), np.int32))
    for t in range(3):
        tokens = rng.integers(0, 97, (2, 1))
        cache = step(cache, tokens, table,
                     np.asarray([6 + t, 3 + t], np.int32))


@pytest.mark.slow  # JAX's engine compiles: ~8-13 s of worker time
def test_serve_cli_streams_equal_jax_serve_cli():
    jax_cli = _jax_serve_cli()
    args = port_serve.build_parser().parse_args(FLAGS)
    jengine = jax_cli.build_engine(args, None)
    model = port_serve.build_model(args)
    interop.params_from_flax(model, jax.tree_util.tree_map(
        np.asarray, jengine.params))
    engine = port_serve.build_engine(args, None, model)
    jreqs, reqs = jax_cli.build_requests(args), port_serve.build_requests(args)
    assert [(r.prompt, r.max_new_tokens) for r in reqs] == [
        (r.prompt, r.max_new_tokens) for r in jreqs]
    want = jengine.run(jreqs)["results"]
    got = engine.run(reqs)["results"]
    assert sorted(got) == sorted(want) and len(got) == 6
    for rid, r in want.items():
        assert r["status"] == got[rid]["status"] == "done", rid
        assert got[rid]["tokens"] == r["tokens"], rid


def test_serve_cli_prints_jax_keys_for_llama(capsys):
    assert port_serve.main(FLAGS) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "serve_tokens_per_sec"
    assert line["completed"] == 6 and line["errored"] == 0
    assert line["config"]["family"] == "llama"
    for key in ("ttft_ms", "tpot_ms", "ttft_p99_ms", "tpot_p99_ms",
                "decode_tokens_per_sec", "slot_occupancy"):
        assert key in line, key
