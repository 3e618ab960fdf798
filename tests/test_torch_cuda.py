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
from distributed_pytorch_example_tpu_torch.models import GPT2, BertBase
from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from distributed_pytorch_example_tpu_torch.ops.paged_attention import (
    decode_splits,
    paged_attention_reference,
    paged_decode_attention,
    paged_decode_split_reference,
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
from distributed_pytorch_example_tpu_torch.train.tasks import MLMTask

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


def split_count(q, pk, table):
    """The kernel's split count for these inputs on this card."""
    return decode_splits(
        q.shape[0], pk.shape[2], table.shape[1], pk.shape[1],
        torch.cuda.get_device_properties(q.device).multi_processor_count,
    )


def check_split_kernel(q, pk, pv, table, lens):
    """K2 against its plain version and its split arithmetic on the same
    inputs; a second call, and one after the scratch block is cleared, must
    give the same bits. Returns the split count."""
    dtype = q.dtype
    splits = split_count(q, pk, table)
    got = paged_flash_decode(q, pk, pv, table, lens)
    ref = paged_attention_reference(
        q.float()[:, None], pk.float(), pv.float(), table, lens[:, None]
    )[:, 0]
    split_ref = paged_decode_split_reference(
        q.float(), pk.float(), pv.float(), table, lens, splits
    )
    for want in (ref, split_ref):
        err = (got.float() - want).abs().max().item()
        assert err <= TOL[dtype], (splits, err)
    assert torch.equal(paged_flash_decode(q, pk, pv, table, lens), got)
    pk[0] = 0
    pv[0] = 0
    assert torch.equal(paged_flash_decode(q, pk, pv, table, lens), got)
    return splits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (6, 2), (16, 2)],
                         ids=["group1", "group3", "group8"])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_split_kernel_on_mixed_rows(card, dtype, heads, kv_heads, head_dim):
    """A 128-key row whose splits are all live beside one-block rows whose
    other splits are empty, block edges and a position past the table."""
    q, pk, pv, table, lens = chip_smoke.kernel_case(
        torch, batch=6, heads=heads, kv_heads=kv_heads, head_dim=head_dim,
        block_size=4, max_blocks=32, num_blocks=96,
        lens=(127, 0, 3, 4, 61, 200), dtype=dtype, seed=head_dim + heads,
    )
    assert check_split_kernel(q, pk, pv, table, lens) > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("pos", [1023, 1500, 0],
                         ids=["full-table", "past-table", "pos-0"])
def test_split_kernel_on_one_row(card, dtype, pos):
    """One row at the serving geometry: one block per split."""
    q, pk, pv, table, lens = chip_smoke.kernel_case(
        torch, batch=1, heads=12, kv_heads=12, head_dim=64, block_size=16,
        max_blocks=64, num_blocks=80, lens=(pos,), dtype=dtype, seed=pos,
    )
    assert check_split_kernel(q, pk, pv, table, lens) == 64


def test_kernel_call_never_synchronises(card):
    """The split count comes from shapes: a call reads nothing back from
    the card (PyTorch's sync debug mode raises on any synchronising op)."""
    q, pk, pv, table, lens = chip_smoke.kernel_case(
        torch, batch=8, heads=12, kv_heads=12, head_dim=64, block_size=16,
        max_blocks=64, num_blocks=513, lens=chip_smoke.KERNEL_LENS,
        dtype=torch.float32, seed=0,
    )
    paged_flash_decode(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        paged_flash_decode(q, pk, pv, table, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")


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
    # more k tiles than the kernels' two-stage ring has stages
    "bf16-causal-2048": (torch.bfloat16, True, 2, 2, 2048, 64, False),
    # BERT's attention: 12 heads, S 512, a key mask, no causal mask
    "bf16-bert-512": (torch.bfloat16, False, 12, 12, 512, 64, True),
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


def test_flash_kernels_at_the_training_shape(card):
    """GPT-2 124M's attention as the training step calls it: B 16, N 12,
    S 1024, H 64, bf16, causal, at chip_smoke's tolerances."""
    q, k, v, do, _ = flash_case(batch=16, heads=12, kv_heads=12, seq=1024,
                                head_dim=64, dtype=torch.bfloat16,
                                masked=False, seed=1024)
    kw = dict(causal=True, kv_mask=None, softmax_scale=64 ** -0.5)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    ro, rlse = flash_attention_fwd_reference(q, k, v, **kw)
    rgrads = flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    errs = chip_smoke.flash_errors(torch, (o, lse, *grads),
                                   (ro, rlse, *rgrads))
    tols = chip_smoke.FLASH_TOL["bfloat16"]
    for name, err in errs.items():
        assert err <= tols[name], (name, err, tols[name])


def test_flash_kernels_at_the_bert_shape(card):
    """BERT-base's attention as its train step calls it: B 16, N 12, S 512,
    H 64, bf16, non-causal, with chip_smoke's key mask (padded tails on and
    around the 128-key tile edges, one key, an all-pad row), at
    chip_smoke's tolerances; a padded key gets zero dk and dv, the dead
    row output 0, lse NEG_INF and zero dq."""
    lens = chip_smoke.BERT_LENS
    q, k, v, do, mask = chip_smoke.flash_case(
        torch, batch=16, heads=12, kv_heads=12, seq=512, head_dim=64,
        dtype=torch.bfloat16, masked=True, seed=512, lens=lens)
    kw = dict(causal=False, kv_mask=mask, softmax_scale=64 ** -0.5)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    ro, rlse = flash_attention_fwd_reference(q, k, v, **kw)
    rgrads = flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    errs = chip_smoke.flash_errors(torch, (o, lse, *grads),
                                   (ro, rlse, *rgrads))
    tols = chip_smoke.FLASH_TOL["bfloat16"]
    for name, err in errs.items():
        assert err <= tols[name], (name, err, tols[name])
    assert torch.all(o[-1] == 0) and torch.all(lse[-1] == -1e30)
    assert torch.all(grads[0][-1] == 0)
    for row, n in enumerate(lens):
        assert torch.all(grads[1][row, n:] == 0), row
        assert torch.all(grads[2][row, n:] == 0), row


def collapsed_case(seed, batch=2, heads=2, seq=512, head_dim=64):
    """Attention inputs whose keys, queries and values share one direction
    (each a common vector plus 5 % noise), as in a deep post-LN encoder at
    initialisation, and the (seq, head_dim) inputs x of the projection
    whose weight gradient is x^T dK; bf16 on the card."""
    gen = torch.Generator().manual_seed(seed)

    def shared(width):
        base = torch.randn(batch, 1, heads, width, generator=gen)
        return base + 0.05 * torch.randn(batch, seq, heads, width,
                                         generator=gen)

    q, k, v = (shared(head_dim) for _ in range(3))
    do = torch.randn(batch, seq, heads, head_dim, generator=gen)
    x = shared(head_dim)[0, :, 0].double()
    return [t.to("cuda", torch.bfloat16) for t in (q, k, v, do)], x


def test_flash_backward_keeps_dk_on_collapsed_keys(card):
    """Where every key's v is nearly the same, dP - delta is a small
    difference; with delta taken from the bf16 O, its rounding shifts that
    difference by a constant per row, and x^T dK (the k projection's weight
    gradient) came out 1.6-38x its norm off (the plain versions' math on
    the CPU, these inputs). With delta summed from the backward's own p
    and dp the bf16 kernels hold it within 0.15 of a float64 computation
    (the plain versions: 3.5e-2 to 5.1e-2; plain bf16 attention 4.4e-2 to
    6.7e-2)."""
    (q, k, v, do), x = collapsed_case(11)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fwd0, bwd0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    flash_attention(q, k, v).backward(do)
    assert (flash_attention_fwd.launches - fwd0,
            flash_attention_bwd.launches - bwd0) == (1, 1)
    q64, k64, v64, do64 = (t.detach().double().cpu() for t in (q, k, v, do))
    s = torch.einsum("bqnh,bknh->bnqk", q64, k64) / 8
    p = torch.softmax(s, -1)
    dp = torch.einsum("bqnh,bknh->bnqk", do64, v64)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) / 8
    dk = torch.einsum("bnqk,bqnh->bknh", ds, q64)
    for b in range(2):
        for n in range(2):
            want = x.t() @ dk[b, :, n]
            got = x.t() @ k.grad[b, :, n].double().cpu()
            err = ((got - want).norm() / want.norm()).item()
            assert err <= 0.15, (b, n, err)


def test_bert_mlm_step_runs_the_flash_kernels(card):
    """A 2-layer BERT (width 128, 2 heads of 64, seq 128, float32, pad id
    0, padded tails and an all-pad row): the MLM loss and its gradients on
    the same masked inputs on the card (K1, key mask) and on the CPU
    (plain attention), at the GPT-2 step test's tolerances (loss 1e-4,
    each leaf 1e-4 of max(max|g_cpu|, 1e-3)); then one train step through
    the card's own draws launches K1 once per layer each way."""
    kw = dict(vocab_size=256, max_len=128, model_dim=128, num_layers=2,
              num_heads=2, mlp_dim=512, logits_mode="hidden", pad_token_id=0,
              seed=0)
    tokens = np.random.default_rng(0).integers(1, 256, (4, 128))
    for row, n in enumerate((128, 77, 1, 0)):
        tokens[row, n:] = 0
    tokens = torch.from_numpy(tokens)
    task = MLMTask(256, mask_token_id=103, mask_rate=0.3, pad_token_id=0)
    inputs, selected = task.corrupt(tokens, torch.Generator().manual_seed(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    losses, grads = {}, {}
    for dev in ("cpu", "cuda"):
        model = BertBase(**kw, device=dev)
        fwd0 = flash_attention_fwd.launches
        bwd0 = flash_attention_bwd.launches
        loss, _ = task.loss(model, model(inputs.to(dev)), tokens.to(dev),
                            selected.to(dev))
        loss.backward()
        losses[dev] = loss.item()
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
    model = BertBase(**kw, device="cuda")
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        model.parameters(), "lamb", 1e-3))
    fwd0, bwd0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    metrics = build_train_step(task)(state, {"tokens": tokens.cuda()})
    assert np.isfinite(float(metrics["loss"]))
    assert (flash_attention_fwd.launches - fwd0,
            flash_attention_bwd.launches - bwd0) == (2, 2)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_backward_is_deterministic(card, causal):
    """No atomics: two backward calls on the same inputs give bit-equal
    dq, dk and dv (GQA, so dk/dv sum a group of heads)."""
    q, k, v, do, mask = flash_case(batch=2, heads=8, kv_heads=2, seq=512,
                                   head_dim=64, dtype=torch.bfloat16,
                                   masked=not causal, seed=5)
    kw = dict(causal=causal, kv_mask=mask, softmax_scale=0.125)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    first = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


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
        # bf16 tiles are 128 rows at head_dim 64
        "seq 64": (q[:, :64].contiguous(), k[:, :64].contiguous(),
                   v[:, :64].contiguous()),
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


# -- K3: the ring collectives, with in-process ranks -------------------------


def ring_group(world, timeout_s=10.0):
    from distributed_pytorch_example_tpu_torch.ops.collectives import PeerRing

    rings = PeerRing.local_group(world, "cuda", timeout_s=timeout_s)
    return rings, [torch.cuda.Stream() for _ in range(world)]


def close_group(rings):
    torch.cuda.synchronize()
    for ring in rings:
        ring.close()


# (world, elements per rank): one piece, payloads of many pieces, one 4
# MiB float32 gradient bucket (the main path's) at every world, and 256 x
# 37 x 8, which no piece size of either kernel divides (the last piece
# is short)
RING_CASES = [(2, 512), (4, 2048), (8, 256 * 8), (2, 3 << 20), (4, 3 << 18),
              (2, 1 << 20), (4, 1 << 20), (8, 1 << 20), (8, 256 * 37 * 8)]


@pytest.mark.parametrize("world,n", RING_CASES,
                         ids=[f"R{w}-n{n}" for w, n in RING_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["fp32", "bf16", "int8"])
def test_ring_kernels_match_plain_versions(card, world, n, dtype):
    """K3a equals the plain gather exactly (it moves bytes); K3b is within
    chip_smoke's float32 rounding bound of the plain float32 sum, and
    equals the sum in the TPU ring's order bit for bit."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_all_gather,
        ring_all_gather_reference,
        ring_reduce_scatter,
        ring_reduce_scatter_reference,
        ring_reduce_scatter_ring_order,
    )

    rings, streams = ring_group(world)
    try:
        xs = chip_smoke.ring_inputs(torch, world, n, dtype, seed=n + world)
        ag0 = ring_all_gather.launches
        got = chip_smoke.ring_run(torch, ring_all_gather, rings, xs, streams)
        want = ring_all_gather_reference(xs)
        torch.cuda.synchronize()
        for ring in rings:
            ring.check()
        assert ring_all_gather.launches == ag0 + world
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if dtype == torch.int8:
            return
        rs0 = ring_reduce_scatter.launches
        got = chip_smoke.ring_run(torch, ring_reduce_scatter, rings, xs,
                                  streams)
        want = ring_reduce_scatter_reference(xs)
        tols = chip_smoke.ring_rs_bound(torch, xs, world)
        torch.cuda.synchronize()
        for ring in rings:
            ring.check()
        assert ring_reduce_scatter.launches == rs0 + world
        for g, w, t in zip(got, want, tols):
            assert g.shape == (n // world,) and g.dtype == dtype
            assert bool(((g.float() - w.float()).abs() <= t).all())
        for g, e in zip(got, ring_reduce_scatter_ring_order(xs)):
            assert torch.equal(g, e)
    finally:
        close_group(rings)


def test_ring_kernels_stay_right_over_calls_of_changing_size(card):
    """Twelve gathers and twelve reduce-scatters in flight back to back on
    every rank, cycling through sizes whose pieces split unevenly (a
    staging slot is reused with other offsets each call) and through the
    four stream ids, each result held against its plain version."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_all_gather,
        ring_all_gather_reference,
        ring_reduce_scatter,
        ring_reduce_scatter_reference,
    )

    world = 4
    sizes = [(1 << 20) + 256 * world, 5 * 256 * world, (3 << 18) + 512 * world]
    rings, streams = ring_group(world)
    try:
        calls = []
        for i in range(12):
            xs = chip_smoke.ring_inputs(torch, world, sizes[i % 3],
                                        torch.float32, seed=i)
            ag = chip_smoke.ring_run(
                torch, lambda x, ring, sid=i % 4: ring_all_gather(
                    x, ring, stream=sid), rings, xs, streams)
            rs = chip_smoke.ring_run(
                torch, lambda x, ring, sid=(i + 1) % 4: ring_reduce_scatter(
                    x, ring, stream=sid), rings, xs, streams)
            calls.append((xs, ag, rs))
        torch.cuda.synchronize()
        for ring in rings:
            ring.check()
        for i, (xs, ag, rs) in enumerate(calls):
            for g, w in zip(ag, ring_all_gather_reference(xs)):
                assert torch.equal(g, w), i
            tols = chip_smoke.ring_rs_bound(torch, xs, world)
            for g, w, t in zip(rs, ring_reduce_scatter_reference(xs), tols):
                assert bool(((g - w).abs() <= t).all()), i
    finally:
        close_group(rings)


def test_ring_wait_times_out_when_a_rank_never_launches(card):
    """Rank 1 never launches: rank 0's kernel gives up after its bounded
    wait, records the error and returns; check() raises. The ring is dead
    afterwards: its next launch returns at once and check() raises again."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_all_gather,
    )

    rings, _ = ring_group(2, timeout_s=0.2)
    try:
        x = torch.ones(512, device="cuda")
        ring_all_gather(x, rings[0])
        torch.cuda.synchronize()
        with pytest.raises(RuntimeError, match="timed out"):
            rings[0].check()
        rings[1].check()  # the rank that never launched has no error
        ring_all_gather(x, rings[0])
        torch.cuda.synchronize()
        with pytest.raises(RuntimeError, match="timed out"):
            rings[0].check()
    finally:
        close_group(rings)


def test_ring_stream_ids_in_flight_at_once_do_not_cross(card):
    """Two gathers and two reduce-scatters of distinct stream ids in
    flight at once, issued in opposite orders on the two ranks, each id
    on its own CUDA stream: every result is its own collective's."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_all_gather,
        ring_all_gather_reference,
        ring_reduce_scatter,
        ring_reduce_scatter_reference,
    )

    world, n = 2, 1 << 16
    rings, _ = ring_group(world)
    try:
        ops = [(ring_all_gather, ring_all_gather_reference, 0),
               (ring_all_gather, ring_all_gather_reference, 1),
               (ring_reduce_scatter, ring_reduce_scatter_reference, 0),
               (ring_reduce_scatter, ring_reduce_scatter_reference, 1)]
        inputs = [chip_smoke.ring_inputs(torch, world, n, torch.float32,
                                         seed=10 + i) for i in range(len(ops))]
        streams = [[torch.cuda.Stream() for _ in ops] for _ in range(world)]
        main = torch.cuda.current_stream()
        got = [[None] * world for _ in ops]
        for rank in range(world):
            order = range(len(ops)) if rank == 0 else reversed(range(len(ops)))
            for i in order:
                fn, _, sid = ops[i]
                stream = streams[rank][i]
                stream.wait_stream(main)
                with torch.cuda.stream(stream):
                    got[i][rank] = fn(inputs[i][rank], rings[rank],
                                      stream=sid)
        torch.cuda.synchronize()
        for ring in rings:
            ring.check()
        for i, (_, ref, _) in enumerate(ops):
            want = ref(inputs[i])
            for rank in range(world):
                # a two-term float32 sum is the same in either order
                assert torch.equal(got[i][rank], want[rank]), (i, rank)
    finally:
        close_group(rings)


def test_all_eight_collective_ids_in_flight_at_once_do_not_cross(card):
    """Four gathers and four reduce-scatters, every collective id, in
    flight at once on two ranks, each on its own CUDA stream and issued in
    opposite orders on the two ranks. Each launch takes 64 CTAs, near its
    co-residency share of 66 (132 SMs x 8 / (8 ids x 2 ranks)), so the 16
    launches hold 1,024 of the card's 1,056 CTA places and must all be
    resident at once; every result is its own collective's."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        MAX_STREAMS,
        ring_all_gather,
        ring_all_gather_reference,
        ring_reduce_scatter,
        ring_reduce_scatter_reference,
    )

    world, n = 2, 1 << 20
    rings, _ = ring_group(world)
    try:
        ops = [(fn, ref, sid) for fn, ref in (
            (ring_all_gather, ring_all_gather_reference),
            (ring_reduce_scatter, ring_reduce_scatter_reference))
            for sid in range(MAX_STREAMS)]
        inputs = [chip_smoke.ring_inputs(torch, world, n, torch.float32,
                                         seed=20 + i) for i in range(len(ops))]
        streams = [[torch.cuda.Stream() for _ in ops] for _ in range(world)]
        main = torch.cuda.current_stream()
        got = [[None] * world for _ in ops]
        for rank in range(world):
            order = range(len(ops)) if rank == 0 else reversed(range(len(ops)))
            for i in order:
                fn, _, sid = ops[i]
                stream = streams[rank][i]
                stream.wait_stream(main)
                with torch.cuda.stream(stream):
                    got[i][rank] = fn(inputs[i][rank], rings[rank],
                                      stream=sid)
        torch.cuda.synchronize()
        for ring in rings:
            ring.check()
        for i, (_, ref, _) in enumerate(ops):
            for rank, want in enumerate(ref(inputs[i])):
                # a two-term float32 sum is the same in either order
                assert torch.equal(got[i][rank], want), (i, rank)
    finally:
        close_group(rings)


@pytest.mark.parametrize("chunk", [256 * 4099, 256 * 65537],
                         ids=["one-round", "rounds"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["fp32", "bf16", "int8"])
def test_all_gather_takes_a_payload_no_piece_divides(card, chunk, dtype):
    """256 x a prime elements per rank: no piece size (a multiple of 4
    KiB) divides the payload, so the last piece is short; the larger one
    exceeds the staging slots, so every CTA takes several pieces."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_all_gather,
        ring_all_gather_reference,
    )

    world = 2
    rings, streams = ring_group(world)
    try:
        xs = chip_smoke.ring_inputs(torch, world, chunk, dtype,
                                    seed=chunk % 89)
        before = ring_all_gather.launches
        got = chip_smoke.ring_run(torch, ring_all_gather, rings, xs, streams)
        torch.cuda.synchronize()
        for ring in rings:
            ring.check()
        assert ring_all_gather.launches == before + world
        for g, w in zip(got, ring_all_gather_reference(xs)):
            assert g.dtype == dtype and torch.equal(g, w)
    finally:
        close_group(rings)


def absent_rank_raises(fn):
    """Three of four ranks launch ``fn`` with a 0.2 s wait bound: each of
    them raises at its ring's check() within a second, and the absent rank
    has no error. Returns the inputs and a fresh group of four rings, on
    which the caller makes a good call."""
    import time

    world = 4
    rings, streams = ring_group(world, timeout_s=0.2)
    try:
        xs = chip_smoke.ring_inputs(torch, world, 1 << 20, torch.float32,
                                    seed=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chip_smoke.ring_run(torch, fn, rings[:-1], xs[:-1], streams[:-1])
        for ring in rings[:-1]:
            with pytest.raises(RuntimeError, match="timed out"):
                ring.check()
        assert time.perf_counter() - t0 <= 1.0
        rings[-1].check()  # the absent rank never waited
        return xs, ring_group(world)
    finally:
        close_group(rings)


def test_all_gather_raises_when_a_rank_never_arrives(card):
    """A gather with one rank absent raises on the other three within a
    second; the card then serves a good gather on a fresh ring."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_all_gather,
        ring_all_gather_reference,
    )

    xs, fresh = absent_rank_raises(ring_all_gather)
    try:
        got = chip_smoke.ring_run(torch, ring_all_gather, fresh[0], xs,
                                  fresh[1])
        torch.cuda.synchronize()
        for ring in fresh[0]:
            ring.check()
        for g, w in zip(got, ring_all_gather_reference(xs)):
            assert torch.equal(g, w)
    finally:
        close_group(fresh[0])


# -- K3b: the one-shot reduce-scatter, bit for bit in the ring's order --------

# 256 x a prime: a chunk that no piece size (a multiple of 256 elements)
# divides, so the last piece is short; the larger one exceeds the staging
# slots, so every CTA takes several pieces
PRIME_CHUNKS = (256 * 4099, 256 * 65537)


def rs_exact(rings, streams, xs, *, stream=0):
    """K3b on every in-process rank against the ring-order sum, bit for
    bit; returns the launch count it added."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_reduce_scatter,
        ring_reduce_scatter_ring_order,
    )

    before = ring_reduce_scatter.launches
    got = chip_smoke.ring_run(
        torch, lambda x, ring: ring_reduce_scatter(x, ring, stream=stream),
        rings, xs, streams)
    want = ring_reduce_scatter_ring_order(xs)
    torch.cuda.synchronize()
    for ring in rings:
        ring.check()
    for rank, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (rank, (g.float() - w.float()).abs().max())
    return ring_reduce_scatter.launches - before


@pytest.mark.parametrize("chunk", PRIME_CHUNKS, ids=["one-round", "rounds"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_reduce_scatter_takes_a_chunk_no_piece_divides(card, chunk, dtype):
    world = 2
    rings, streams = ring_group(world)
    try:
        xs = chip_smoke.ring_inputs(torch, world, world * chunk, dtype,
                                    seed=chunk % 97)
        assert rs_exact(rings, streams, xs) == world
    finally:
        close_group(rings)


def test_reduce_scatter_over_changing_sizes_and_stream_ids(card):
    """Sixteen calls back to back on every rank's CUDA stream, cycling
    through three sizes and the four stream ids (each id its own set of
    slots and counters), each held bit for bit against the ring order."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_reduce_scatter,
        ring_reduce_scatter_ring_order,
    )

    world = 4
    sizes = [world * 256 * 4099, world * 256, world * 256 * 37]
    rings, streams = ring_group(world)
    try:
        calls = []
        for i in range(16):
            xs = chip_smoke.ring_inputs(torch, world, sizes[i % 3],
                                        torch.float32, seed=100 + i)
            got = chip_smoke.ring_run(
                torch, lambda x, ring, sid=i % 4: ring_reduce_scatter(
                    x, ring, stream=sid), rings, xs, streams)
            calls.append((xs, got))
        torch.cuda.synchronize()
        for ring in rings:
            ring.check()
        for i, (xs, got) in enumerate(calls):
            for g, w in zip(got, ring_reduce_scatter_ring_order(xs)):
                assert torch.equal(g, w), i
    finally:
        close_group(rings)


def test_reduce_scatter_raises_when_a_rank_never_arrives(card):
    """Three of four ranks launch, with a 0.2 s wait bound: each of them
    raises at its ring's check() within a second, the absent rank has no
    error, and the card then serves a good call on a fresh ring."""
    from distributed_pytorch_example_tpu_torch.ops.collectives import (
        ring_reduce_scatter,
    )

    xs, fresh = absent_rank_raises(ring_reduce_scatter)
    try:
        assert rs_exact(*fresh, xs) == len(xs)
    finally:
        close_group(fresh[0])


# ---------------------------------------------------------------------------
# BatchNorm and the ResNet on the card (no kernel of the port's own: the
# module's arithmetic on CUDA tensors against the same module on the CPU)
# ---------------------------------------------------------------------------


def _bn_pair(dtype, seed=0):
    from distributed_pytorch_example_tpu_torch.models import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-1, 1, generator=gen)
    x = (torch.randn(4, 6, 9, 7, generator=gen) * 3 + 1).to(dtype)
    dy = torch.randn(4, 6, 9, 7, generator=gen).to(dtype)
    return bn, x, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_batchnorm_on_the_card_matches_its_cpu_result(card, dtype):
    """Output, input / scale / bias gradients and running statistics:
    float32 statistics either way, so only the summation order differs;
    bf16 outputs and input gradients are rounded (TOL's half ulp)."""
    import copy

    bn, x, dy = _bn_pair(dtype)
    gpu = copy.deepcopy(bn).to(card)
    out = {}
    for module, dev in ((bn, "cpu"), (gpu, card)):
        xi = x.to(dev).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        y = module(xi)
        y.backward(dy.to(dev))
        out[str(dev)] = [t.detach().float().cpu() for t in (
            y, xi.grad, module.weight.grad, module.bias.grad,
            module.running_mean, module.running_var)]
        assert y.dtype == dtype
    for got, want in zip(out["cuda"], out["cpu"]):
        scale = max(want.abs().max().item(), 1.0)
        assert (got - want).abs().max().item() <= TOL[dtype] * scale


def test_resnet_channels_last_matches_contiguous_input(card):
    """The model's NHWC input is a channels_last NCHW view; a contiguous
    NCHW copy of the same images gives the same logits and gradients
    (cuDNN picks other algorithms: float32 with TF32 off, summation order
    only)."""
    from distributed_pytorch_example_tpu_torch.models import (
        BottleneckBlock,
        ResNet,
    )

    model = ResNet((1, 1), BottleneckBlock, num_classes=5, num_filters=8,
                   device=card, seed=0)
    x = torch.randn(4, 32, 32, 3, device=card,
                    generator=torch.Generator(card).manual_seed(1))
    grads, tf32 = [], torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for images in (x, x.permute(0, 3, 1, 2).contiguous()
                       .permute(0, 2, 3, 1)):
            model.zero_grad()
            logits = model(images)
            logits.square().sum().backward()
            grads.append((logits.detach(), [p.grad.clone()
                                            for p in model.parameters()]))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (a, ga), (b, gb) = grads
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for u, v in zip(ga, gb):
        torch.testing.assert_close(u, v, atol=1e-4, rtol=1e-3)


def test_skipped_step_restores_the_running_stats_on_the_card(card):
    from distributed_pytorch_example_tpu_torch.models import (
        BasicBlock,
        ResNet,
    )
    from distributed_pytorch_example_tpu_torch.models.batchnorm import (
        running_stats,
    )
    from distributed_pytorch_example_tpu_torch.train import (
        ClassificationTask,
    )

    model = ResNet((1, 1), BasicBlock, num_classes=5, num_filters=8,
                   small_inputs=True, dtype=torch.bfloat16, device=card)
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        model.parameters(), "adam", 1e-3))
    step = build_train_step(ClassificationTask())
    gen = torch.Generator(card).manual_seed(2)
    batch = {"x": torch.randn(4, 16, 16, 3, device=card, generator=gen),
             "y": torch.randint(0, 5, (4,), device=card, generator=gen)}
    step(state, batch)
    before = [t.clone() for t in running_stats(model)]
    params = [p.detach().clone() for p in model.parameters()]
    batch["x"][2, 5, 5, 0] = float("nan")
    assert float(step(state, batch)["bad_step"]) == 1.0
    assert all(torch.equal(a, b) for a, b in zip(running_stats(model),
                                                   before))
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), params))
