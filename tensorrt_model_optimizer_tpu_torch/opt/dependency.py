"""Structural dependency map (port of `opt/dependency.py`; the JAX module
has no JAX in it, the port keeps its own copy).

The reference fx-traces a model to find which dimensions must change
together under pruning. Here the architectures are explicit, so the
dependency graph is declared per architecture: each named dimension lists
the (param, axis) sites tied to it, and pruning a dimension slices every
listed site coherently (what `prune/minitron.py` does for Llama). Generic
search code validates and enumerates prunable dimensions from these tables.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DimGroup:
    """A prunable dimension and every (param, axis) slot tied to it."""

    name: str
    size_attr: str  # the config field holding the dimension's size
    sites: tuple[tuple[str, int], ...]  # (param path under layers/, axis)
    divisor_attr: str | None = None  # granularity constraint (e.g. head_dim)


LLAMA_DIM_GROUPS: tuple[DimGroup, ...] = (
    DimGroup(
        name="hidden",
        size_attr="hidden_size",
        sites=(
            ("embed_tokens", 1),
            ("lm_head", 1),
            ("norm", 0),
            ("layers/input_layernorm", 1),
            ("layers/post_attention_layernorm", 1),
            ("layers/self_attn.q_proj", 2),
            ("layers/self_attn.k_proj", 2),
            ("layers/self_attn.v_proj", 2),
            ("layers/self_attn.o_proj", 1),
            ("layers/mlp.gate_proj", 2),
            ("layers/mlp.up_proj", 2),
            ("layers/mlp.down_proj", 1),
        ),
    ),
    DimGroup(
        name="intermediate",
        size_attr="intermediate_size",
        sites=(
            ("layers/mlp.gate_proj", 1),
            ("layers/mlp.up_proj", 1),
            ("layers/mlp.down_proj", 2),
        ),
    ),
    DimGroup(
        name="kv_heads",
        size_attr="num_key_value_heads",
        sites=(
            ("layers/self_attn.k_proj", 1),
            ("layers/self_attn.v_proj", 1),
            # q / o follow through the GQA ratio (heads per kv group)
            ("layers/self_attn.q_proj", 1),
            ("layers/self_attn.o_proj", 2),
        ),
        divisor_attr="head_dim",
    ),
    DimGroup(
        name="depth",
        size_attr="num_hidden_layers",
        sites=tuple(
            (f"layers/{n}", 0)
            for n in ("input_layernorm", "post_attention_layernorm", "self_attn.q_proj", "self_attn.k_proj",
                      "self_attn.v_proj", "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
        ),
    ),
)


def validate_groups(params: dict, cfg, groups=LLAMA_DIM_GROUPS) -> list[str]:
    """Check that every declared site's axis matches its config dimension.
    Returns the violations (empty: consistent); a missing site (lm_head when
    tied) is skipped, and so is the kv_heads group (its sites are heads x
    head_dim wide: `prune/minitron.py` handles them)."""
    problems = []
    for g in groups:
        expect = getattr(cfg, g.size_attr)
        if g.size_attr == "num_key_value_heads":
            continue
        for path, axis in g.sites:
            node = params
            for part in path.split("/"):
                if not isinstance(node, dict) or part not in node:
                    node = None
                    break
                node = node[part]
            if node is None:
                continue
            if node.shape[axis] != expect:
                problems.append(f"{g.name}: {path} axis {axis} is {node.shape[axis]}, expected {expect}")
    return problems
