"""Tensor-, expert- and data-parallel serving: one rank's shard of a
compressed model (port of `serve/tp.py`).

JAX's plan, Megatron-style over one mesh axis (default "tp"):

 - column-parallel sites (`COL_SITES`: q / k / v / gate / up, the shared
   expert's gate / up) shard the output dim O; their biases follow them;
 - row-parallel sites (`ROW_SITES`: o / down / the shared expert's down)
   shard the input dim K; the engine all-reduces (SUM) their partial
   output, and a dynamic per-token activation amax of such a site is first
   all-reduced (MAX) so every shard quantizes against the single-device
   scale (`engine._qlinear`);
 - MoE expert stacks [L, E, ...] shard the expert axis E (expert
   parallelism: the engine routes on the replicated activations, runs its
   own E/d experts and SUMs the combined partial, `engine._moe_ffn`);
 - GPT-OSS's sinks shard with the q heads; the router, the norms and the
   embedding / head replicate;
 - SVDQuant adapters: B's rows on column sites, A's input dim on row sites
   (their partial sums ride the same SUM);
 - a row site's input pre_quant_scale shards on K;
 - the KV caches shard their kv heads over "tp" and their batch (dense) or
   page pool and slots (paged) over the data-parallel axis (`cache_specs`,
   `paged_cache_specs`, `local_shape`).

JAX keeps one global checkpoint and re-lays its TPU planes so a slice of
the packed bytes is each device's pack (`_plane_to_tp_major`,
`_word_pack_sharded`). Here each rank holds its shard by value: the
canonical packs (`quant/compress.py`: plane-packed INT4 / NVFP4 / MXFP4
nibbles with their block scales, INT8, FP8, bf16) are unpacked to codes,
sliced and packed again as the rank's own canonical pack, and the engine
converts that local pack to its serving layout with the port's own packers
(`convert_packed_layouts`: W4A8's pack pads a ragged local K with zero
codes as it always does). The values a rank serves are the single-device
model's, sliced.

`shard_compressed(cm, n_shards, rank)` returns the rank's shard: a
`CompressedModel` over `local_cfg` (heads, kv heads and FFN divided by the
degree) that records (axis, n_shards, rank) in its `shard` field. Heads, kv
heads, the FFN and the experts must divide by the degree (`ValueError`,
where JAX asserts). `nvfp4_layout="i8"` raises `NotImplementedError` under
a mesh: JAX's TP engine silently serves it as word2 (weight-only NVFP4,
`serve/tp.py:227`), and the port does not change the format unasked.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quant.compress import CompressedModel, _infer_bsz, plane_pack

COL_SITES = (
    "self_attn.q_proj",
    "self_attn.k_proj",
    "self_attn.v_proj",
    "mlp.gate_proj",
    "mlp.up_proj",
    "shared.gate_proj",
    "shared.up_proj",
)
ROW_SITES = ("self_attn.o_proj", "mlp.down_proj", "shared.down_proj")

I8_UNDER_MESH = ("nvfp4_layout='i8' (W8A8 over NVFP4's values) is not served under a mesh: JAX's tensor-parallel "
                 "engine serves it as word2 (weight-only NVFP4) with a log warning, and the port does not change "
                 "the format unasked; serve nvfp4_layout='word2' under the mesh, or 'i8' on one device")


def _own(t: torch.Tensor) -> torch.Tensor:
    """A copy with storage of its own (a slice's view would keep, and share,
    the whole tensor)."""
    return t.clone(memory_format=torch.contiguous_format)


def _part(t: torch.Tensor, dim: int, d: int, r: int) -> torch.Tensor:
    """Shard r of d of t along dim, as a tensor of its own."""
    n = t.shape[dim]
    if n % d:
        raise ValueError(f"dim {dim} of size {n} does not divide by {d}")
    return _own(t.narrow(dim, r * (n // d), n // d))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.element_size() == 1 and t.is_floating_point() else t


def _unplanes(packed: torch.Tensor) -> torch.Tensor:
    """[.., O/2, K] plane-packed bytes -> [.., O, K] 4-bit codes in row order."""
    return torch.cat([packed & 0xF, packed >> 4], dim=-2)


def _split_planes(lo: torch.Tensor, hi: torch.Tensor, d: int, r: int) -> tuple:
    """Per-plane scale arrays [.., O/2, nblk] -> shard r's rows of the
    row-ordered whole, split again into its own two planes."""
    whole = torch.cat([_bytes(lo), _bytes(hi)], dim=-2)
    dim = whole.ndim - 2
    part = _part(whole, dim, d, r)
    h = part.shape[dim] // 2
    a, b = _own(part.narrow(dim, 0, h)), _own(part.narrow(dim, h, h))
    return a.view(lo.dtype), b.view(hi.dtype)


def _k_blocks(scales: torch.Tensor, K: int, d: int, r: int) -> torch.Tensor:
    """Block scales [.., nblk] of a K-sharded site -> shard r's blocks: a
    slice where the blocks divide by d and align with the shards, the whole
    array where there is one block (each shard's kernel then reads it as a
    block of its local K), else ValueError (JAX's)."""
    nblk = scales.shape[-1]
    bsz = _infer_bsz(K, nblk)
    if nblk % d == 0 and (K // d) % bsz == 0:
        return _part(scales, scales.ndim - 1, d, r)
    if nblk == 1:
        return _own(scales)
    raise ValueError(f"K block count {nblk} not divisible by tp={d}")


def shard_site(kind: str, arrays: dict, col: bool, d: int, r: int) -> dict:
    """Shard r of d of one canonical packed site (any leading axes): its
    output rows (`col`) or its input columns, packed again as the rank's own
    canonical pack."""
    if d == 1:
        return dict(arrays)
    out = dict(arrays)
    if kind == "bf16":
        out["w"] = _part(arrays["w"], arrays["w"].ndim - (2 if col else 1), d, r)
    elif kind in ("int8", "fp8"):
        q = arrays["q"]
        out["q"] = _part(q, q.ndim - (2 if col else 1), d, r)
        sc = arrays["scale"]
        # int8: per-channel [.., O, 1], sharded with the rows; fp8: per tensor
        out["scale"] = _part(sc, sc.ndim - 2, d, r) if (col and kind == "int8") else _own(sc)
    elif kind in ("int4", "nvfp4", "mxfp4"):
        lo_k, hi_k = ("exp_lo", "exp_hi") if kind == "mxfp4" else ("scale_lo", "scale_hi")
        packed = arrays["packed"]
        if col:
            codes = _part(_unplanes(packed), packed.ndim - 2, d, r)
            if codes.shape[-2] % 2:
                raise ValueError(f"{kind}: a shard of {codes.shape[-2]} rows does not plane-pack")
            out["packed"] = plane_pack(codes)
            out[lo_k], out[hi_k] = _split_planes(arrays[lo_k], arrays[hi_k], d, r)
        else:
            K = packed.shape[-1]
            out["packed"] = _part(packed, packed.ndim - 1, d, r)
            out[lo_k] = _k_blocks(arrays[lo_k], K, d, r)
            out[hi_k] = _k_blocks(arrays[hi_k], K, d, r)
        if kind == "nvfp4":
            out["global_scale"] = _own(arrays["global_scale"])
    else:
        raise ValueError(f"cannot shard kind {kind!r}: shard the canonical pack, before its serving layout")
    return out


def shard_experts(arrays: dict, d: int, r: int) -> dict:
    """Expert parallelism: every [L, E, ...] leaf of an expert stack sliced
    on E (each expert's pack is whole, so no repacking)."""
    return {k: (_part(v, 1, d, r) if isinstance(v, torch.Tensor) and v.ndim >= 2 else v) for k, v in arrays.items()}


def local_cfg(cfg, d: int):
    """The per-rank model config: heads, kv heads and the FFN divided by the
    degree; head_dim pinned (it is otherwise derived from the global
    hidden / heads ratio, which the local head count would break)."""
    return dataclasses.replace(cfg, num_attention_heads=cfg.num_attention_heads // d,
                               num_key_value_heads=cfg.num_key_value_heads // d,
                               intermediate_size=cfg.intermediate_size // d, head_dim=cfg.hd)


def check_divisible(cfg, d: int, moe: bool) -> None:
    """JAX's checks of `shard_compressed`, raised as ValueError."""
    for what, n in (("q heads", cfg.num_attention_heads), ("kv heads", cfg.num_key_value_heads),
                    ("ffn", cfg.intermediate_size)):
        if n % d:
            raise ValueError(f"{what} ({n}) not divisible by tp={d}")
    if moe and cfg.num_experts % d:
        raise ValueError(f"experts ({cfg.num_experts}) not divisible by tp={d}")


def _shard_state(st, d: int, r: int, row: bool):
    """A QuantizerState with a row site's input pre_quant_scale sharded on K."""
    if st is None or not row or getattr(st, "pre_quant_scale", None) is None:
        return st
    pqs = st.pre_quant_scale
    return dataclasses.replace(st, pre_quant_scale=_part(pqs, pqs.ndim - 1, d, r))


def shard_qstate(qstate: dict, d: int, r: int, row_sites=ROW_SITES) -> dict:
    """The quantizer state on one rank: replicated, but for the input
    pre_quant_scale of row sites, sharded on K."""
    out = {}
    for site, sub in (qstate or {}).items():
        if isinstance(sub, dict):
            out[site] = {which: _shard_state(st, d, r, which == "input" and site in row_sites)
                         for which, st in sub.items()}
        else:
            out[site] = sub
    return out


def shard_compressed(cm: CompressedModel, n_shards: int, rank: int, axis: str = "tp",
                     nvfp4_layout: str = "word2") -> CompressedModel:
    """Rank `rank`'s shard of `cm` for n_shards-way tensor / expert
    parallelism (see the module docstring): canonical packs sliced and
    packed again, over `local_cfg`, with `shard = (axis, n_shards, rank)`.
    `nvfp4_layout` is the engine's: under a mesh it refuses "i8"."""
    if cm.shard is not None:
        raise ValueError(f"already a shard: {cm.shard}")
    cfg, d, r = cm.model_cfg, n_shards, rank
    if nvfp4_layout == "i8" and "nvfp4" in cm.kinds.values():
        raise NotImplementedError(I8_UNDER_MESH)
    layers = cm.params["layers"]
    moe = any(n.startswith("moe.") for n in cm.kinds)
    check_divisible(cfg, d, moe)
    new = {}
    for name, v in layers.items():
        if name in cm.kinds:
            if name.startswith("moe."):
                new[name] = shard_experts(v, d, r)
            else:
                new[name] = shard_site(cm.kinds[name], v, name in COL_SITES, d, r)
        elif name in ("moe.router", "moe.router__bias"):
            new[name] = v
        elif name.startswith("moe.") and name.endswith("__bias"):
            new[name] = _part(v, 1, d, r)
        elif name == "self_attn.sinks":
            new[name] = _part(v, 1, d, r)
        elif name.endswith("__bias") and name[: -len("__bias")] in COL_SITES:
            new[name] = _part(v, v.ndim - 1, d, r)
        else:  # norms, row-site biases, anything residual-shaped
            new[name] = v
    adapters = None
    if cm.adapters is not None:
        adapters = {}
        for site, ad in cm.adapters.items():
            ad = dict(ad)
            if site in COL_SITES:
                ad["B"] = _part(ad["B"], ad["B"].ndim - 2, d, r)
            elif site in ROW_SITES:
                ad["A"] = _part(ad["A"], ad["A"].ndim - 1, d, r)
            adapters[site] = ad
    params = {**cm.params, "layers": new}
    return dataclasses.replace(cm, model_cfg=local_cfg(cfg, d), params=params,
                               qstate=shard_qstate(cm.qstate, d, r), adapters=adapters, shard=(axis, d, r))


def cache_specs(axis: str = "tp", dp: Optional[str] = None, kvh: bool = False, scales: bool = False) -> dict:
    """The dense KV cache's sharding, JAX's PartitionSpecs as tuples of axis
    names (None: not sharded): the kv-head axis over `axis`, the batch over
    `dp`. `kvh`: the kernel engine's kv-head-major cache [L, B, n_kv, S, C]
    (else the einsum cache [L, B, S, n_kv, C]); `scales`: NVFP4's block-scale
    arrays, sharded like their planes."""
    if kvh:
        sp = (None, dp, axis, None, None)
        out = {"k": sp, "v": sp, "pos": ()}
        if scales:
            out["ks"] = out["vs"] = sp
        return out
    sp = (None, dp, None, axis, None)
    return {"k": sp, "v": sp, "pos": ()}


def paged_cache_specs(packed_nvfp4: bool = False, axis: str = "tp", dp: Optional[str] = None) -> dict:
    """The page pool's sharding: pages [L, P, n_kv, page, C] shard the kv
    heads over `axis`; with `dp` each replica owns its share of the pool,
    of the block table's rows and of the slots (block-table page ids are
    replica-local)."""
    sp = (None, dp, axis, None, None)
    out = {"k_pages": sp, "v_pages": sp, "block_table": (dp, None), "seq_lens": (dp,)}
    if packed_nvfp4:
        out["k_scales"] = out["v_scales"] = sp
    return out


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """A global shape's per-rank shape under a spec (every sharded dim
    divided by its axis' size; it must divide)."""
    out = list(shape)
    for i, ax in enumerate(spec):
        n = mesh.size(ax) if mesh is not None else 1
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} ({out[i]}) does not divide by axis {ax!r} ({n})")
        out[i] //= n
    return tuple(out)
