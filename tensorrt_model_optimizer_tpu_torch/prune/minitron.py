"""Minitron structured pruning, width and depth, of Llama models (port of
`prune/minitron.py`).

Activation-magnitude importance from captured forwards (no hooks) for
attention KV-head groups, FFN channels, hidden channels and layer depth;
then a one-shot slice of the params into the smaller architecture, to be
healed by distillation. The host side stays in numpy, as JAX's: the scores
cross to the host as f32 arrays, the depth score is the cosine between
consecutive layers' `attn_in` captures of the first batch, and the
selections are `np.argsort`'s, so equal scores give equal plans in both
packages. `head_dim` is kept when the hidden size is pruned.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from ..models import llama


@dataclasses.dataclass
class ImportanceScores:
    kv_group: np.ndarray  # [L, n_kv] attention KV-group importance
    ffn: np.ndarray  # [L, I] FFN channel importance
    hidden: np.ndarray  # [H] hidden channel importance
    layer: np.ndarray  # [L] depth importance


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@torch.no_grad()
def importance(cfg: llama.LlamaConfig, params: llama.Params, batches: Iterable[torch.Tensor],
               capture_tokens: int = 128) -> ImportanceScores:
    """Activation-magnitude importance from one captured forward a batch."""
    o_acc = ffn_acc = hid_acc = layer_sig = None
    n = 0
    for b in batches:
        caps = llama.forward(cfg, params, b, capture_tokens=capture_tokens)[3]
        o = torch.mean(torch.abs(caps["o_in"].float()), dim=1)
        f = torch.mean(torch.abs(caps["down_in"].float()), dim=1)
        h = torch.mean(torch.abs(caps["attn_in"].float()), dim=(0, 1))
        o_acc = o if o_acc is None else o_acc + o
        ffn_acc = f if ffn_acc is None else ffn_acc + f
        hid_acc = h if hid_acc is None else hid_acc + h
        if layer_sig is None:
            layer_sig = _host(caps["attn_in"])
        n += 1

    nH, hd, nKV = cfg.num_attention_heads, cfg.hd, cfg.num_key_value_heads
    rep = nH // nKV
    head_imp = _host(o_acc).reshape(cfg.num_hidden_layers, nH, hd).mean(-1) / n
    kv_imp = head_imp.reshape(cfg.num_hidden_layers, nKV, rep).mean(-1)

    # depth: the layers whose block changes the hidden stream least matter
    # least (the cosine between consecutive attn_in captures, Minitron's BI)
    L = layer_sig.shape[0]
    layer_imp = np.ones(L)
    for i in range(L - 1):
        a, b_ = layer_sig[i].ravel(), layer_sig[i + 1].ravel()
        cos = float(np.dot(a, b_) / (np.linalg.norm(a) * np.linalg.norm(b_) + 1e-9))
        layer_imp[i] = 1.0 - cos
    layer_imp[-1] = layer_imp.max()  # keep the final layer

    return ImportanceScores(kv_group=kv_imp, ffn=_host(ffn_acc) / n, hidden=_host(hid_acc) / n, layer=layer_imp)


@dataclasses.dataclass
class PrunePlan:
    keep_kv_groups: np.ndarray  # [n_kv_new] (uniform across layers)
    keep_ffn: np.ndarray  # [I_new]
    keep_hidden: np.ndarray  # [H_new]
    keep_layers: np.ndarray  # [L_new]


def prune(cfg: llama.LlamaConfig, params: llama.Params, scores: ImportanceScores, *,
          num_kv_heads: Optional[int] = None, intermediate_size: Optional[int] = None,
          hidden_size: Optional[int] = None,
          num_layers: Optional[int] = None) -> tuple[llama.LlamaConfig, llama.Params, PrunePlan]:
    """Slice the model to the target widths / depth, uniform across layers
    (as Minitron: per-layer scores averaged into one global selection).
    Returns (new_cfg, new_params, plan); the given params are not written."""
    nH, hd, nKV = cfg.num_attention_heads, cfg.hd, cfg.num_key_value_heads
    rep = nH // nKV
    tgt_kv = num_kv_heads or nKV
    tgt_I = intermediate_size or cfg.intermediate_size
    tgt_H = hidden_size or cfg.hidden_size
    tgt_L = num_layers or cfg.num_hidden_layers

    keep_kv = np.sort(np.argsort(-scores.kv_group.mean(0))[:tgt_kv])
    keep_ffn = np.sort(np.argsort(-scores.ffn.mean(0))[:tgt_I])
    keep_hid = np.sort(np.argsort(-scores.hidden)[:tgt_H])
    keep_lay = np.sort(np.argsort(-scores.layer)[:tgt_L])
    plan = PrunePlan(keep_kv, keep_ffn, keep_hid, keep_lay)

    # kv group g covers q heads [g * rep, (g + 1) * rep)
    q_heads = np.concatenate([np.arange(g * rep, (g + 1) * rep) for g in keep_kv])
    q_rows = np.concatenate([np.arange(h * hd, (h + 1) * hd) for h in q_heads])
    kv_rows = np.concatenate([np.arange(g * hd, (g + 1) * hd) for g in keep_kv])

    dev = params["embed_tokens"].device
    ix = {k: torch.from_numpy(np.asarray(v, np.int64)).to(dev)
          for k, v in dict(lay=keep_lay, hid=keep_hid, ffn=keep_ffn, q=q_rows, kv=kv_rows).items()}
    lay = params["layers"]

    def sel(name, rows, cols=None):  # the kept layers' [rows] (and [:, cols])
        t = lay[name][ix["lay"]][:, ix[rows]]
        return t if cols is None else t[:, :, ix[cols]]

    new_layers = {
        "input_layernorm": sel("input_layernorm", "hid"),
        "post_attention_layernorm": sel("post_attention_layernorm", "hid"),
        "self_attn.q_proj": sel("self_attn.q_proj", "q", "hid"),
        "self_attn.k_proj": sel("self_attn.k_proj", "kv", "hid"),
        "self_attn.v_proj": sel("self_attn.v_proj", "kv", "hid"),
        "self_attn.o_proj": sel("self_attn.o_proj", "hid", "q"),
        "mlp.gate_proj": sel("mlp.gate_proj", "ffn", "hid"),
        "mlp.up_proj": sel("mlp.up_proj", "ffn", "hid"),
        "mlp.down_proj": sel("mlp.down_proj", "hid", "ffn"),
    }
    new_params: llama.Params = {
        "embed_tokens": params["embed_tokens"][:, ix["hid"]],
        "layers": new_layers,
        "norm": params["norm"][ix["hid"]],
    }
    if "lm_head" in params:
        new_params["lm_head"] = params["lm_head"][:, ix["hid"]]

    new_cfg = dataclasses.replace(cfg, num_hidden_layers=tgt_L, num_key_value_heads=tgt_kv,
                                  num_attention_heads=tgt_kv * rep, intermediate_size=tgt_I, hidden_size=tgt_H,
                                  head_dim=hd)
    return new_cfg, new_params, plan
