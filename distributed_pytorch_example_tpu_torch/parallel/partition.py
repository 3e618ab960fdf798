"""Transformer partition rules: Megatron tensor parallelism (the JAX
package's parallel/partition.py).

The rules below are JAX's table, copied: a leaf whose flax path matches
gets the spec, so the port's specs equal JAX's for every leaf, optimizer
moments included (they mirror the parameters' paths):

- column-parallel (output features on ``tensor``): attention ``q/k/v``
  and the MLP's ``up`` / ``gate``, their biases with them;
- row-parallel (input features on ``tensor``): attention ``o`` and the
  MLP's ``down``; their biases and every norm stay replicated;
- the MoE, layer-stacked and pipeline rules, which the port's models do
  not reach yet (ROADMAP.md item 15).

``PlanSpec(family="transformer").lower`` adds the vocab-parallel
embedding and head rules (``parallel/plan.py``). In JAX GSPMD inserts
the collectives these specs imply; the port's layers place them by hand
(``parallel/tensor_parallel.py``).
"""

from __future__ import annotations

from distributed_pytorch_example_tpu_torch.parallel.api import (
    DEFAULT_OPT_SHARD_MIN_SIZE,
    P,
    Partitioner,
)

# Paths follow the naming contract of models/transformer.py:
#   .../attn/{q,k,v,o}/{kernel,bias}, .../mlp/{up,down}/{kernel,bias}
TRANSFORMER_TP_RULES: tuple = (
    # column-parallel: shard output dim
    (r"attn/(q|k|v)/kernel$", P(None, "tensor")),
    (r"attn/(q|k|v)/bias$", P("tensor")),
    (r"mlp/(up|gate)/kernel$", P(None, "tensor")),
    (r"mlp/(up|gate)/bias$", P("tensor")),
    # row-parallel: shard input dim, replicate bias
    (r"attn/o/kernel$", P("tensor", None)),
    (r"mlp/down/kernel$", P("tensor", None)),
    # expert parallelism: MoE expert dim sharded on 'expert'; the router
    # stays replicated
    (r"moe/(up|down|gate)_kernel$", P("expert", None, None)),
    (r"moe/(up|down)_bias$", P("expert", None)),
    # layer-stacked MoE decoder: (L, E, ...) expert weights shard stages
    # on 'pipe' and the expert dim on 'expert'. Before the generic stacked
    # rules: 'moe_up_kernel' would otherwise match them.
    (r"moe_(up|down|gate)_kernel$", P("pipe", "expert", None, None)),
    (r"moe_(up|down)_bias$", P("pipe", "expert", None)),
    (r"router_kernel$", P("pipe", None, None)),
    (r"router_bias$", P("pipe", None)),
    # layer-stacked decoder: leading num_layers dim on 'pipe', features on
    # 'tensor' per the same column/row split
    (r"(q|k|v|up|gate)_kernel$", P("pipe", None, "tensor")),
    (r"(q|k|v|up)_bias$", P("pipe", "tensor")),
    (r"(o|down)_kernel$", P("pipe", "tensor", None)),
    (r"(o|down)_bias$", P("pipe", None)),
    (r"ln[12]_(scale|bias)$", P("pipe", None)),
)


def transformer_partitioner(
    mesh,
    fsdp_rest: bool = False,
    dp_shard_opt_state: bool = False,
    opt_shard_min_size: int = DEFAULT_OPT_SHARD_MIN_SIZE,
    wire=None,
) -> Partitioner:
    """TP rules for transformer blocks, vocab-parallel embeddings and
    heads where the vocab divides the tensor size, every other leaf
    replicated. Lowers ``PlanSpec(family="transformer", ...)``;
    ``fsdp_rest`` and ``dp_shard_opt_state`` are refused there (ROADMAP.md
    queue 1, item 11)."""
    from distributed_pytorch_example_tpu_torch.parallel.plan import PlanSpec

    return PlanSpec(
        family="transformer",
        fsdp_rest=fsdp_rest,
        zero1=dp_shard_opt_state,
        opt_shard_min_size=opt_shard_min_size,
        wire=wire,
    ).lower(mesh=mesh)
