"""The port's CUDA kernels and their serving and training paths on the card.

Every test here needs an NVIDIA GPU: a CUDA kernel has no CPU mode. Each one
decides inside its fixture whether a card is visible and skips without
one. The file imports no JAX (the card's machine has none), so it runs
there on its own, without the JAX conftest::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Each kernel is held against its plain version on the same inputs, with
chip_smoke.py's cases and tolerances at small shapes.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from distributed_pytorch_example_tpu_torch.models import GPT2
from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
    paged_attention_reference,
    paged_decode_attention,
    paged_flash_decode,
)
from distributed_pytorch_example_tpu_torch.serving import (
    InferenceEngine,
    Request,
)
from distributed_pytorch_example_tpu_torch.train import (
    CausalLMTask,
    TrainState,
    build_train_step,
    make_optimizer,
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


# ---------------------------------------------------------------------------
# K1: flash attention forward and backward
# ---------------------------------------------------------------------------


def flash_case(*, batch, heads, kv_heads, seq, head_dim, dtype, masked,
               seed, device="cuda"):
    """chip_smoke's K1 inputs: q/k/v/do from a seed; with ``masked`` the
    last batch row has no valid key (a dead row) and the first loses its
    last quarter of keys."""
    return chip_smoke.flash_case(
        torch, batch=batch, heads=heads, kv_heads=kv_heads, seq=seq,
        head_dim=head_dim, dtype=dtype, masked=masked, seed=seed,
        device=device,
    )


FLASH_CASES = {
    # name: (dtype, causal, heads, kv_heads, seq, head_dim, masked)
    "bf16-causal": (torch.bfloat16, True, 4, 4, 256, 64, False),
    "fp32-full": (torch.float32, False, 4, 4, 128, 64, False),
    "bf16-gqa": (torch.bfloat16, True, 4, 2, 128, 64, False),
    "fp32-gqa-masked": (torch.float32, False, 4, 2, 128, 64, True),
    "bf16-masked": (torch.bfloat16, False, 2, 2, 128, 64, True),
    "bf16-h128": (torch.bfloat16, True, 2, 2, 128, 128, False),
    "bf16-h256": (torch.bfloat16, False, 2, 1, 128, 256, True),
    "fp32-h128": (torch.float32, True, 2, 2, 128, 128, False),
    "fp32-h256": (torch.float32, True, 2, 2, 64, 256, False),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain_versions(card, case):
    dtype, causal, heads, kv_heads, seq, head_dim, masked = FLASH_CASES[case]
    q, k, v, do, mask = flash_case(
        batch=2, heads=heads, kv_heads=kv_heads, seq=seq, head_dim=head_dim,
        dtype=dtype, masked=masked, seed=seq + head_dim,
    )
    kw = dict(causal=causal, kv_mask=mask, softmax_scale=head_dim ** -0.5)
    fwd0, bwd0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    o, lse = flash_attention_fwd(q, k, v, **kw)
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert flash_attention_fwd.launches == fwd0 + 1
    assert flash_attention_bwd.launches == bwd0 + 1
    ro, rlse = flash_attention_fwd_reference(q, k, v, **kw)
    # the backward reference runs on the kernel's own o and lse, so the
    # comparison isolates the backward kernels
    rgrads = flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    errs = chip_smoke.flash_errors(torch, (o, lse, *grads),
                                   (ro, rlse, *rgrads))
    tols = chip_smoke.FLASH_TOL[str(dtype).split(".")[-1]]
    for name, err in errs.items():
        assert err <= tols[name], (case, name, err, tols[name])
    if masked:  # the dead row: output 0, lse NEG_INF, zero gradients
        assert torch.all(o[-1] == 0) and torch.all(lse[-1] == -1e30)
        assert torch.all(grads[0][-1] == 0)


def test_flash_autograd_launches_the_kernels(card):
    q, k, v, do, _ = flash_case(batch=2, heads=2, kv_heads=2, seq=128,
                                head_dim=64, dtype=torch.bfloat16,
                                masked=False, seed=7)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fwd0, bwd0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v, causal=True)
    out.backward(do)
    assert flash_attention_fwd.launches == fwd0 + 1
    assert flash_attention_bwd.launches == bwd0 + 1
    assert q.grad.dtype == torch.bfloat16 and q.grad.shape == q.shape


def test_flash_kernels_refuse_inputs_they_do_not_take(card):
    q, k, v, do, _ = flash_case(batch=1, heads=2, kv_heads=2, seq=128,
                                head_dim=64, dtype=torch.bfloat16,
                                masked=False, seed=1)
    strided = torch.empty(1, 128, 2, 128, dtype=q.dtype, device=q.device)
    strided = strided[..., ::2]
    strided.copy_(q)
    bad = {
        "cpu": (q.cpu(), k.cpu(), v.cpu()),
        "strided head dim": (strided, k, v),
        "head_dim 32": (q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous()),
        "float16": (q.half(), k.half(), v.half()),
        "seq 96": (q[:, :96].contiguous(), k[:, :96].contiguous(),
                   v[:, :96].contiguous()),
        "mixed dtypes": (q, k.float(), v),
    }
    before = flash_attention_fwd.launches
    for name, (a, b, c) in bad.items():
        with pytest.raises(ValueError):
            flash_attention_fwd(a, b, c, causal=True, kv_mask=None,
                                softmax_scale=0.125)
            pytest.fail(f"{name} was accepted")
    assert flash_attention_fwd.launches == before


def test_gpt2_train_step_runs_the_flash_kernels(card):
    """A 2-layer GPT-2 train step (width 128, 2 heads of 64, seq 128,
    float32) on the card launches the flash forward and backward once per
    layer, and matches the same step on the CPU (plain attention): loss to
    1e-4, and each gradient leaf to max|g - g_cpu| <= 1e-4 * max(max|g_cpu|,
    1e-3). Float32 on both sides with TF32 off, summation order only (the
    JAX-vs-port CPU step measures about 1e-6 of each leaf's scale); a
    missing or wrong dq, dk or dv term is off by O(1) in the q, k or v
    projection's leaves. The floor 1e-3 is for the k-projection bias,
    whose gradient is zero in exact arithmetic (rounding noise on both
    sides)."""
    kw = dict(vocab_size=256, max_len=128, model_dim=128, num_layers=2,
              num_heads=2, mlp_dim=512, logits_mode="hidden", seed=0)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 128)).astype(np.int32))
    torch.backends.cuda.matmul.allow_tf32 = False
    losses, grads = {}, {}
    for dev in ("cpu", "cuda"):
        model = GPT2(**kw, device=dev)
        state = TrainState(step=0, model=model,
                           optimizer=make_optimizer(model.parameters()))
        fwd0 = flash_attention_fwd.launches
        bwd0 = flash_attention_bwd.launches
        metrics = build_train_step(CausalLMTask())(
            state, {"tokens": tokens.to(dev)})
        losses[dev] = float(metrics["loss"])
        grads[dev] = {name: p.grad.detach().cpu()
                      for name, p in model.named_parameters()}
        launched = (flash_attention_fwd.launches - fwd0,
                    flash_attention_bwd.launches - bwd0)
        assert launched == ((0, 0) if dev == "cpu" else (2, 2)), (dev,
                                                                  launched)
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4, losses
    for name, want in grads["cpu"].items():
        scale = max(want.abs().max().item(), 1e-3)
        err = (grads["cuda"][name] - want).abs().max().item()
        assert err <= 1e-4 * scale, (name, err, scale)
