"""The port's flash attention (K1) against the JAX package's, on the CPU.

On CPU tensors the port's ``flash_attention`` runs its plain forward and
its plain explicit backward, the same math its CUDA kernels compute. They
are held against the JAX package's ``_xla_attention`` (the plain path)
and against its Pallas kernel in interpret mode, with 128 x 64 blocks so
the multi-block forward and the fused multi-block backward (K1a, K1c)
run. Inputs are numpy arrays from a seed, handed to both.

Tolerances (the JAX package's own flash tests): output 2e-5 and lse 2e-5,
both float32 with only the summation order differing; gradients 5e-4,
since the backward sums over a whole sequence of products.

``torch.exp`` of a float32 CPU tensor is MKL's ``vmsExp`` (high-accuracy
mode). MKL sets VML up on its first call in a process. When that first
call is a parallel one, entered by two OpenMP threads at once (the pool
already exists after an MKL matmul), one thread's half has come back up
to 1.5e-4 off (relative), in about one process in six; every later call
is exact, and no JAX is needed for it. The port's forward then missed
JAX by 7.75e-5. So this module makes MKL's first exp call itself, on one
thread, when it is imported (:func:`set_up_mkl_vml`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.ops.attention import _xla_attention
from distributed_pytorch_example_tpu.ops.pallas import flash_attention as jfa
from distributed_pytorch_example_tpu_torch.ops import attention as port_attn
from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)

torch.set_num_threads(2)


def set_up_mkl_vml():
    """MKL's first vector-math call of the process, made on one thread:
    a tensor below ATen's parallel grain."""
    torch.exp(torch.zeros(8))


set_up_mkl_vml()

O_TOL, LSE_TOL, GRAD_TOL = 2e-5, 2e-5, 5e-4
BLOCK_Q, BLOCK_K = 128, 64

# name: (causal, seq, heads, kv_heads, masked)
CASES = {
    "causal-128": (True, 128, 2, 2, False),
    "full-256": (False, 256, 2, 2, False),
    "gqa-masked-256": (False, 256, 4, 2, True),
    "gqa-causal-masked-128": (True, 128, 4, 2, True),
}


def make_inputs(seq, heads, kv_heads, masked, seed=0, head_dim=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, seq, heads, head_dim), dtype=np.float32)
    k, v = (rng.standard_normal((2, seq, kv_heads, head_dim), dtype=np.float32)
            for _ in range(2))
    g = rng.standard_normal(q.shape, dtype=np.float32)
    mask = None
    if masked:  # row 0 loses its last quarter of keys; row 1 has none
        mask = np.ones((2, seq), bool)
        mask[0, seq - seq // 4:] = False
        mask[1] = False
    return q, k, v, g, mask


def jax_reference(q, k, v, g, mask, causal):
    """(o, lse, grads) from the interpret-mode Pallas kernel, and (o,
    grads) from _xla_attention."""
    scale = q.shape[-1] ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jmask = None if mask is None else jnp.asarray(mask)

    def kernel(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, kv_mask=jmask,
                                   block_q=BLOCK_Q, block_k=BLOCK_K,
                                   interpret=True)

    def plain(q, k, v):
        return _xla_attention(q, k, v, None, jmask, causal, scale)

    out = {}
    for name, fn in (("kernel", kernel), ("plain", plain)):
        o, vjp = jax.vjp(fn, jq, jk, jv)
        out[name] = (np.asarray(o), [np.asarray(t) for t in vjp(jg)])
    mask3 = None if mask is None else jnp.asarray(mask, jnp.float32)[:, None]
    _, lse = jfa._fwd(*(t.transpose(0, 2, 1, 3) for t in (jq, jk, jv)),
                      mask3, causal, scale, BLOCK_Q, BLOCK_K, True)
    return out, np.asarray(lse)[..., 0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_jax(case):
    causal, seq, heads, kv_heads, masked = CASES[case]
    q, k, v, g, mask = make_inputs(seq, heads, kv_heads, masked)
    ref, ref_lse = jax_reference(q, k, v, g, mask, causal)

    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    launches = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    o = flash_attention(tq, tk, tv, causal=causal, kv_mask=tmask)
    o.backward(torch.from_numpy(g))
    grads = [t.grad.numpy() for t in (tq, tk, tv)]
    # CPU tensors take the plain versions: no kernel launched
    assert (flash_attention_fwd.launches,
            flash_attention_bwd.launches) == launches
    _, lse = flash_attention_fwd_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), causal=causal,
        kv_mask=None if mask is None else tmask.float(),
        softmax_scale=q.shape[-1] ** -0.5,
    )
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=LSE_TOL, rtol=0)
    for name in ("kernel", "plain"):
        ro, rgrads = ref[name]
        np.testing.assert_allclose(o.detach().numpy(), ro, atol=O_TOL, rtol=0,
                                   err_msg=f"o vs {name}")
        for d, got, want in zip("qkv", grads, rgrads):
            np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=0,
                                       err_msg=f"d{d} vs {name}")
    if masked:  # the dead row: output 0, lse NEG_INF, zero gradients
        assert np.all(o.detach().numpy()[1] == 0)
        assert np.all(lse.numpy()[1] == NEG_INF)
        assert np.all(grads[0][1] == 0)
        assert np.all(grads[1][1] == 0) and np.all(grads[2][1] == 0)


def test_dispatch_auto_on_cpu_takes_the_plain_path():
    q, k, v, _, _ = make_inputs(128, 2, 2, False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = flash_attention_fwd.launches
    got = port_attn.dot_product_attention(tq, tk, tv, causal=True)
    want = port_attn._plain_attention(tq, tk, tv, None, None, True,
                                      q.shape[-1] ** -0.5)
    assert torch.equal(got, want)
    assert flash_attention_fwd.launches == before
    assert port_attn._flash_unsupported_reason(
        tq, tk, tv, None, True) == "flash kernel is CUDA-only"


def test_dispatch_forced_flash_refuses_what_the_kernel_cannot_take():
    q, k, v, _, _ = make_inputs(128, 2, 2, False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="CUDA-only"):
        port_attn.dot_product_attention(tq, tk, tv, causal=True,
                                        use_flash=True)
    mask = torch.ones(2, 1, 128, 128, dtype=torch.bool)
    with pytest.raises(ValueError, match="custom masks"):
        port_attn.dot_product_attention(tq, tk, tv, mask=mask,
                                        use_flash=True)
    with pytest.raises(ValueError, match="seq_q != seq_k"):
        port_attn.dot_product_attention(tq[:, :64], tk, tv, causal=True,
                                        use_flash=True)


@pytest.mark.parametrize("causal", [False, True])
def test_lane_padded_flash_equals_plain(causal):
    """``use_flash=True`` at seq 200 pads to 256 with masked keys; on the
    CPU the padded call runs the plain flash math and equals plain
    attention on the real positions, gradients included."""
    q, k, v, g, _ = make_inputs(200, 2, 2, False, seed=3)
    outs = []
    for path in ("padded", "plain"):
        tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
        if path == "padded":
            o = port_attn._flash_lane_padded(tq, tk, tv, None, causal, 0.125)
        else:
            o = port_attn._plain_attention(tq, tk, tv, None, None, causal,
                                           0.125)
        o.backward(torch.from_numpy(g))
        outs.append([o.detach()] + [t.grad for t in (tq, tk, tv)])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=O_TOL, rtol=0)
