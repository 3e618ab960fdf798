"""The port's CUDA kernel and its serving path on the card.

Every test here needs an NVIDIA GPU: the kernel has no CPU mode. Each one
decides inside its fixture whether a card is visible and skips without
one. The file imports no JAX (the card's machine has none), so it runs
there on its own, without the JAX conftest::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The kernel is held against its plain version on the same inputs, with
chip_smoke.py's cases and tolerances at small shapes.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from distributed_pytorch_example_tpu_torch.models import GPT2
from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
    paged_attention_reference,
    paged_decode_attention,
    paged_flash_decode,
)
from distributed_pytorch_example_tpu_torch.serving import (
    InferenceEngine,
    Request,
)

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

# float32 throughout: only the summation order differs. bf16 inputs with
# float32 math, output rounded to bf16: half an ulp at |out| < 4 is 7.8e-3.
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 2)],
                         ids=["mha", "gqa"])
@pytest.mark.parametrize("head_dim", [16, 64, 128])
def test_kernel_matches_plain_version(card, dtype, heads, kv_heads, head_dim):
    """Row lengths straddle block edges (last/first position of a block,
    a full table) and the scratch block is poisoned with 1e4."""
    q, pk, pv, table, lens = chip_smoke.kernel_case(
        torch, batch=5, heads=heads, kv_heads=kv_heads, head_dim=head_dim,
        block_size=4, max_blocks=8, num_blocks=48, lens=(0, 3, 4, 5, 31),
        dtype=dtype, seed=head_dim,
    )
    before = paged_flash_decode.launches
    got = paged_flash_decode(q, pk, pv, table, lens)
    assert paged_flash_decode.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    ref = paged_attention_reference(
        q.float()[:, None], pk.float(), pv.float(), table, lens[:, None]
    )[:, 0]
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL[dtype], err
    # the dispatcher sends a one-token CUDA query to the kernel
    via = paged_decode_attention(q[:, None], pk, pv, table, lens[:, None])
    assert torch.equal(via[:, 0], got)
    assert paged_flash_decode.launches == before + 2


def test_kernel_refuses_inputs_it_does_not_take(card):
    q, pk, pv, table, lens = chip_smoke.kernel_case(
        torch, batch=2, heads=4, kv_heads=4, head_dim=64, block_size=4,
        max_blocks=4, num_blocks=16, lens=(3, 9), dtype=torch.float32,
        seed=0,
    )
    bad = {
        "float16": (q.half(), pk.half(), pv.half(), table, lens),
        "int64 table": (q, pk, pv, table.long(), lens),
        "strided pages": (q, pk.transpose(0, 1).contiguous().transpose(0, 1),
                          pv, table, lens),
        "head_dim 48": (q[..., :48].contiguous(), pk[..., :48].contiguous(),
                        pv[..., :48].contiguous(), table, lens),
        "group of 16": (q.repeat(1, 16, 1), pk[:, :, :4], pv[:, :, :4],
                        table, lens),
        "lens on the CPU": (q, pk, pv, table, lens.cpu()),
    }
    before = paged_flash_decode.launches
    for name, args in bad.items():
        with pytest.raises(ValueError):
            paged_flash_decode(*args)
            pytest.fail(f"{name} was accepted")
    assert paged_flash_decode.launches == before


def test_engine_decodes_through_the_kernel(card):
    """A small GPT-2 served greedily on the card: the kernel launches once
    per layer at every decode step, and the tokens equal the same
    engine's on the CPU."""
    kw = dict(vocab_size=97, max_len=64, model_dim=64, num_layers=3,
              num_heads=4, mlp_dim=128, decode=True, paged_num_blocks=24,
              paged_block_size=4, paged_max_blocks=8, seed=3)
    rng = np.random.default_rng(3)
    reqs = [
        Request(rid=f"r{i}", prompt=[int(t) for t in rng.integers(0, 97, n)],
                max_new_tokens=10, seed=i)
        for i, n in enumerate((9, 4, 12))
    ]
    cpu = InferenceEngine(GPT2(**kw, device="cpu"), num_slots=2,
                          device="cpu").run(reqs)
    engine = InferenceEngine(GPT2(**kw, device="cuda"), num_slots=2,
                             device="cuda")
    paged_flash_decode.launches = 0
    got = engine.run(reqs)
    assert got["metrics"]["decode_steps"] > 0
    assert paged_flash_decode.launches == got["metrics"]["decode_steps"] * 3
    for rid, r in cpu["results"].items():
        assert got["results"][rid]["status"] == "done"
        assert got["results"][rid]["tokens"] == r["tokens"], rid
