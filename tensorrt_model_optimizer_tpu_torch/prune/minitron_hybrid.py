"""Minitron pruning of hybrid Mamba2 / attention / MLP stacks (port of
`prune/minitron_hybrid.py`).

Prunable: Mamba heads (the activation magnitude of the gated out_proj input,
a head's mean), KV-head groups, FFN channels, hidden channels and depth
(block influence over the hybrid pattern). Heads are ranked within their
`n_groups` bucket and an equal count is kept in each, so `n_groups` and the
heads a group stay uniform. The host side is numpy, as JAX's: the scores
cross to the host as f32 arrays and the selections are `np.argsort`'s on
the same arrays, so equal scores give equal plans in both packages (ties
break alike). `prune` returns (new cfg, new params, plan); heal with
distillation afterwards.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from ..models import mamba
from ..models.mamba import ATTN, MAMBA, MLP
from .minitron import _host


@dataclasses.dataclass
class HybridImportance:
    mamba_head: Optional[np.ndarray]  # [Lm, H]
    kv_group: Optional[np.ndarray]  # [La, n_kv]
    ffn: Optional[np.ndarray]  # [Lf, I]
    hidden: np.ndarray  # [hidden]
    block: np.ndarray  # [len(pattern)] depth importance (BI)


@torch.no_grad()
def importance(cfg: mamba.MambaConfig, params: dict, batches: Iterable[torch.Tensor]) -> HybridImportance:
    """Activation-magnitude importance from one captured forward a batch;
    depth from the cosine between consecutive blocks' inputs of the first
    batch (Minitron's block influence)."""
    acc: dict = {}
    block_sig = None
    n = 0
    for b in batches:
        caps = mamba.forward(cfg, params, b, capture=True)[3]
        for k in ("mixer_out_in", "down_in", "o_in"):
            if k in caps:
                v = torch.mean(torch.abs(caps[k].float()), dim=1)
                acc[k] = v if k not in acc else acc[k] + v
        h = torch.mean(torch.abs(caps["block_in"].float()), dim=(0, 1))
        acc["hidden"] = h if "hidden" not in acc else acc["hidden"] + h
        if block_sig is None:
            block_sig = _host(caps["block_in"])
        n += 1

    H, P = cfg.mamba_num_heads, cfg.mamba_head_dim
    nH, hd, nKV = cfg.num_attention_heads, cfg.hd, cfg.num_key_value_heads
    mamba_head = kv_group = ffn = None
    if "mixer_out_in" in acc:
        a = _host(acc["mixer_out_in"])
        mamba_head = a.reshape(a.shape[0], H, P).mean(-1) / n
    if "o_in" in acc:
        a = _host(acc["o_in"])
        head = a.reshape(a.shape[0], nH, hd).mean(-1) / n
        kv_group = head.reshape(a.shape[0], nKV, nH // nKV).mean(-1)
    if "down_in" in acc:
        ffn = _host(acc["down_in"]) / n

    L = block_sig.shape[0]  # [L, n, h]
    block = np.ones(L)
    for i in range(L - 1):
        a, b_ = block_sig[i].ravel(), block_sig[i + 1].ravel()
        cos = float(np.dot(a, b_) / (np.linalg.norm(a) * np.linalg.norm(b_) + 1e-9))
        block[i] = 1.0 - cos
    block[-1] = block.max()
    return HybridImportance(mamba_head=mamba_head, kv_group=kv_group, ffn=ffn, hidden=_host(acc["hidden"]) / n,
                            block=block)


@dataclasses.dataclass
class HybridPrunePlan:
    keep_mamba_heads: Optional[np.ndarray]
    keep_kv_groups: Optional[np.ndarray]
    keep_ffn: Optional[np.ndarray]
    keep_hidden: np.ndarray
    keep_blocks: np.ndarray
    new_pattern: str


def _mamba_row_index(cfg: mamba.MambaConfig, keep_heads: np.ndarray):
    """Rows of in_proj / conv / out_proj's columns that the kept heads
    touch -> (in_proj rows, conv rows, head rows); B and C are kept whole."""
    P, G, N = cfg.mamba_head_dim, cfg.n_groups, cfg.ssm_state_size
    d_inner = cfg.d_inner
    head_rows = np.concatenate([np.arange(h * P, (h + 1) * P) for h in keep_heads])
    b_rows = 2 * d_inner + np.arange(G * N)
    c_rows = 2 * d_inner + G * N + np.arange(G * N)
    dt_rows = 2 * d_inner + 2 * G * N + keep_heads
    in_proj_rows = np.concatenate([head_rows, d_inner + head_rows, b_rows, c_rows, dt_rows])
    conv_rows = np.concatenate([head_rows, d_inner + np.arange(2 * G * N)])
    return in_proj_rows, conv_rows, head_rows


def _kept_occurrences(pattern: str, kind: str, keep_blocks: np.ndarray) -> np.ndarray:
    """The indices, within `kind`'s stack, of the kept blocks of that kind."""
    kept_set = set(keep_blocks.tolist())
    occ, kept = 0, []
    for i, ch in enumerate(pattern):
        if ch == kind:
            if i in kept_set:
                kept.append(occ)
            occ += 1
    return np.asarray(kept, np.int64)


def prune(cfg: mamba.MambaConfig, params: dict, scores: HybridImportance, *, mamba_num_heads: Optional[int] = None,
          num_kv_heads: Optional[int] = None, intermediate_size: Optional[int] = None,
          hidden_size: Optional[int] = None,
          num_blocks: Optional[int] = None) -> tuple[mamba.MambaConfig, dict, HybridPrunePlan]:
    """Slice `params` to the targets (None keeps a dimension) ->
    (new cfg, new params, plan). The selections are uniform across blocks:
    each is an `np.argsort` of the blocks' mean score."""
    H, G = cfg.mamba_num_heads, cfg.n_groups
    nH, hd, nKV = cfg.num_attention_heads, cfg.hd, cfg.num_key_value_heads
    pattern = cfg.hybrid_pattern
    tgt_Hm = mamba_num_heads or H
    tgt_kv = num_kv_heads or nKV
    tgt_I = intermediate_size or cfg.intermediate_size
    tgt_h = hidden_size or cfg.hidden_size
    tgt_L = num_blocks or len(pattern)
    if tgt_Hm % G:
        raise ValueError("kept mamba heads must stay divisible by n_groups")

    keep_heads = None
    if scores.mamba_head is not None and tgt_Hm < H:
        per_group, gsize = tgt_Hm // G, H // G
        mean_imp = scores.mamba_head.mean(0)  # [H]
        keep = []
        for g in range(G):
            grp = np.arange(g * gsize, (g + 1) * gsize)
            keep.append(np.sort(grp[np.argsort(-mean_imp[grp])[:per_group]]))
        keep_heads = np.concatenate(keep)
    elif tgt_Hm < H:
        keep_heads = np.arange(tgt_Hm)

    keep_kv = None
    if tgt_kv < nKV:
        imp = scores.kv_group.mean(0) if scores.kv_group is not None else np.arange(nKV)[::-1]
        keep_kv = np.sort(np.argsort(-imp)[:tgt_kv])

    keep_ffn = None
    if tgt_I < cfg.intermediate_size:
        imp = scores.ffn.mean(0) if scores.ffn is not None else np.arange(cfg.intermediate_size)[::-1]
        keep_ffn = np.sort(np.argsort(-imp)[:tgt_I])

    keep_hid = np.sort(np.argsort(-scores.hidden)[:tgt_h])
    keep_blocks = np.sort(np.argsort(-scores.block)[:tgt_L])
    new_pattern = "".join(pattern[i] for i in keep_blocks)
    plan = HybridPrunePlan(keep_heads, keep_kv, keep_ffn, keep_hid, keep_blocks, new_pattern)

    dev = params["embed_tokens"].device

    def idx(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    hid = idx(keep_hid)
    new_params: dict = {"embed_tokens": params["embed_tokens"][:, hid], "norm": params["norm"][hid]}
    if "lm_head" in params:
        new_params["lm_head"] = params["lm_head"][:, hid]

    if "layers_mamba" in params:
        lm = params["layers_mamba"]
        occ = idx(_kept_occurrences(pattern, MAMBA, keep_blocks))
        kh = keep_heads if keep_heads is not None else np.arange(H)
        in_rows, conv_rows, head_rows = (idx(r) for r in _mamba_row_index(cfg, kh))
        kh = idx(kh)
        new_params["layers_mamba"] = {
            "norm": lm["norm"][occ][:, hid],
            "mixer.in_proj": lm["mixer.in_proj"][occ][:, in_rows][:, :, hid],
            "mixer.out_proj": lm["mixer.out_proj"][occ][:, hid][:, :, head_rows],
            "mixer.conv_w": lm["mixer.conv_w"][occ][:, conv_rows],
            "mixer.conv_b": lm["mixer.conv_b"][occ][:, conv_rows],
            "mixer.A_log": lm["mixer.A_log"][occ][:, kh],
            "mixer.D": lm["mixer.D"][occ][:, kh],
            "mixer.dt_bias": lm["mixer.dt_bias"][occ][:, kh],
            "mixer.gnorm": lm["mixer.gnorm"][occ][:, head_rows],
        }

    rep = nH // nKV
    if "layers_attn" in params:
        la = params["layers_attn"]
        occ = idx(_kept_occurrences(pattern, ATTN, keep_blocks))
        kv = keep_kv if keep_kv is not None else np.arange(nKV)
        q_heads = np.concatenate([np.arange(g * rep, (g + 1) * rep) for g in kv])
        q_rows = idx(np.concatenate([np.arange(h * hd, (h + 1) * hd) for h in q_heads]))
        kv_rows = idx(np.concatenate([np.arange(g * hd, (g + 1) * hd) for g in kv]))
        new_params["layers_attn"] = {
            "norm": la["norm"][occ][:, hid],
            "self_attn.q_proj": la["self_attn.q_proj"][occ][:, q_rows][:, :, hid],
            "self_attn.k_proj": la["self_attn.k_proj"][occ][:, kv_rows][:, :, hid],
            "self_attn.v_proj": la["self_attn.v_proj"][occ][:, kv_rows][:, :, hid],
            "self_attn.o_proj": la["self_attn.o_proj"][occ][:, hid][:, :, q_rows],
        }

    if "layers_mlp" in params:
        lf = params["layers_mlp"]
        occ = idx(_kept_occurrences(pattern, MLP, keep_blocks))
        kf = idx(keep_ffn if keep_ffn is not None else np.arange(cfg.intermediate_size))
        new_params["layers_mlp"] = {
            "norm": lf["norm"][occ][:, hid],
            "mlp.up_proj": lf["mlp.up_proj"][occ][:, kf][:, :, hid],
            "mlp.down_proj": lf["mlp.down_proj"][occ][:, hid][:, :, kf],
        }
    # a block type that depth pruning removed whole loses its stack
    for key, kind in (("layers_mamba", MAMBA), ("layers_attn", ATTN), ("layers_mlp", MLP)):
        if key in new_params and kind not in new_pattern:
            del new_params[key]

    new_cfg = dataclasses.replace(cfg, hybrid_pattern=new_pattern, mamba_num_heads=tgt_Hm, num_key_value_heads=tgt_kv,
                                  num_attention_heads=tgt_kv * rep, head_dim=hd, intermediate_size=tgt_I,
                                  hidden_size=tgt_h)
    return new_cfg, new_params, plan
