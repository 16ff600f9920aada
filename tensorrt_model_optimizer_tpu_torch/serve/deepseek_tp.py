"""Tensor- and expert-parallel DeepSeek serving: one rank's shard (port of
`serve/deepseek_tp.py`).

JAX's plan over one mesh axis (default "tp"):

 - MLA shards over heads: `q_b_proj` / `q_proj` and `kv_b_proj` are
   column-parallel (their output rows are head-major), `o_proj` is
   row-parallel (SUM after, the per-token amax of a dynamic input quantizer
   MAX-reduced first);
 - the latent projections (`q_a_proj`, `kv_a_proj`), their norms and the
   latent cache replicate: the cache is shared by every head, so attention
   stays local to each rank;
 - the routed experts are expert-parallel over the same axis ([L, E, ...]
   stacks sliced on E); the router and its correction bias replicate;
 - the shared experts' and the dense layers' MLPs are column / row parallel
   as Llama's (`serve/tp.py`); the routed partial and the shared expert's
   down partial ride one SUM;
 - the embedding, the head and the norms replicate.

`shard_deepseek(cm, n_shards, rank)` slices the canonical packs as
`tp.shard_site` does and returns the rank's `DeepseekCompressedModel` over
`local_cfg` (heads and the dense FFN divided by the degree), with `shard =
(axis, n_shards, rank)`. The heads, the routed experts, the shared experts'
and the dense FFN must divide by the degree (`ValueError`, where JAX
asserts).
"""

from __future__ import annotations

import dataclasses

from . import tp as tp_mod

# column-parallel (output dim sharded)
DS_COL = (
    "self_attn.q_proj",
    "self_attn.q_b_proj",
    "self_attn.kv_b_proj",
    "mlp.gate_proj",
    "mlp.up_proj",
    "shared.gate_proj",
    "shared.up_proj",
)
# row-parallel (input dim sharded, SUM after)
DS_ROW = ("self_attn.o_proj", "mlp.down_proj", "shared.down_proj")
# expert-parallel (leading E axis of [L, E, ...] stacks sharded)
DS_EP = ("moe.gate_proj", "moe.up_proj", "moe.down_proj")


def local_cfg(cfg, d: int):
    """The per-rank config: heads and the dense FFN divided by the degree."""
    return dataclasses.replace(cfg, num_attention_heads=cfg.num_attention_heads // d,
                               intermediate_size=cfg.intermediate_size // d)


def shard_deepseek(cm, n_shards: int, rank: int, axis: str = "tp"):
    """Rank `rank`'s shard of a `DeepseekCompressedModel` for n_shards-way
    TP / EP (see the module docstring)."""
    if cm.shard is not None:
        raise ValueError(f"already a shard: {cm.shard}")
    cfg, d, r = cm.model_cfg, n_shards, rank
    for what, n in (("heads", cfg.num_attention_heads), ("routed experts", cfg.n_routed_experts),
                    ("shared experts' ffn", cfg.moe_intermediate_size * cfg.n_shared_experts),
                    ("ffn", cfg.intermediate_size)):
        if n % d:
            raise ValueError(f"{what} ({n}) not divisible by tp={d}")
    params = dict(cm.params)
    qstate = dict(cm.qstate)
    for key, pkey in (("dense", "layers_dense"), ("moe", "layers_moe")):
        if pkey not in params:
            continue
        group = {}
        for name, arrays in params[pkey].items():
            kind = cm.kinds.get(name)
            if name in DS_EP:
                group[name] = tp_mod.shard_experts(arrays, d, r)
            elif kind is not None and name in DS_COL + DS_ROW:
                group[name] = tp_mod.shard_site(kind, arrays, name in DS_COL, d, r)
            else:  # latent projections, norms, router, e_bias
                group[name] = arrays
        params[pkey] = group
        if key in qstate:
            qstate[key] = tp_mod.shard_qstate(qstate[key], d, r, DS_ROW)
    return dataclasses.replace(cm, model_cfg=local_cfg(cfg, d), params=params, qstate=qstate, shard=(axis, d, r))
