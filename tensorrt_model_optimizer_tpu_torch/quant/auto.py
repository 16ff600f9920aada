"""AutoQuantize: a format per (layer, projection group) under an
effective-bits budget (port of `quant/auto.py`, `mtq.auto_quantize`).

 - Scores: the Taylor estimate E_tokens[(sum_d dL/dy_d * dy_d)^2] with dy =
   x @ (Q_c(W) - W)^T ("gradient"), or the projection's output KL on the
   captured inputs ("kl_div"). dL/dy at every projection's
   output comes from one backward pass through zero probes added to the
   outputs' first rows (`_collect_grads_and_inputs`), as JAX's vjp does.
 - Selection: one candidate a row, the summed score minimal, the summed
   weight cost within the budget: `scipy.optimize.milp` (HiGHS), with a
   greedy fallback.
 - The result runs as a quant layout per layer through
   `llama.forward_unrolled`, its state calibrated by max after the search.

q/k/v and gate/up are grouped (one format a group), as `ptq.CAPTURE_GROUPS`
groups them. `auto_quantize_moe` prices the routed experts at their active
share (top_k / num_experts) and scores by KL.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..models import llama
from . import quantizer as Q
from .config import QuantizeConfig, get_preset
from .ptq import CAPTURE_GROUPS, _dynamic_like

GROUPS = list(CAPTURE_GROUPS.items())  # [(capture key, member projections)]


@dataclasses.dataclass
class AutoQuantizeResult:
    choice: list  # choice[layer][group key] = candidate index
    candidates: list
    scores: np.ndarray  # [rows, candidates]
    effective_bits: float
    layer_layouts: list
    qstate_list: Optional[list] = None


def _collect_grads_and_inputs(cfg: llama.LlamaConfig, params: dict, tokens: torch.Tensor, capture_tokens: int):
    """One forward and one backward -> (caps {"attn_in/i", "o_in/i",
    "mlp_in/i", "down_in/i": [n, d_in]}, grads {"proj/i": [n, d_out] f32}):
    each projection's input rows and the loss's gradient at its output rows,
    the first n = capture_tokens of the flattened [B*T] tokens. The decoder
    stack is JAX's inline copy (plain Llama, einsum attention whatever the
    config's attn_impl), the probes zeros added to each output's first n
    rows; the loss the next-token CE of the whole batch on itself."""
    B, T = tokens.shape
    n = min(capture_tokens, B * T)
    dev = tokens.device
    shapes = llama._layer_shapes(cfg)
    probes = {f"{name}/{i}": torch.zeros((n, shapes[name][0]), dtype=torch.float32, device=dev,
                                         requires_grad=True)
              for i in range(cfg.num_hidden_layers) for name in llama.PROJ_NAMES}
    hd, nH, nKV = cfg.hd, cfg.num_attention_heads, cfg.num_key_value_heads
    caps = {}
    with torch.enable_grad():
        positions = torch.arange(T, device=dev, dtype=torch.int32)[None, :].expand(B, T)
        x = params["embed_tokens"].detach()[tokens].to(cfg.dtype)
        mask = llama.causal_mask(T, dev)
        for i in range(cfg.num_hidden_layers):
            lp = {k: v[i].detach() for k, v in params["layers"].items()}

            def proj(t, name):
                y = t @ lp[name].t().to(t.dtype)
                flat = y.reshape(-1, y.shape[-1])
                flat = torch.cat([flat[:n] + probes[f"{name}/{i}"].to(flat.dtype), flat[n:]])
                return flat.reshape(y.shape)

            h = llama.rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
            caps[f"attn_in/{i}"] = llama._grab(h, n).detach()
            q = proj(h, "self_attn.q_proj").reshape(B, T, nH, hd)
            k = proj(h, "self_attn.k_proj").reshape(B, T, nKV, hd)
            v = proj(h, "self_attn.v_proj").reshape(B, T, nKV, hd)
            q = llama.rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
            k = llama.rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
            k_all = torch.repeat_interleave(k, nH // nKV, dim=2)
            v_all = torch.repeat_interleave(v, nH // nKV, dim=2)
            scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k_all.float()) / math.sqrt(hd) + mask
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx = torch.einsum("bnqk,bknd->bqnd", probs, v_all).reshape(B, T, nH * hd)
            caps[f"o_in/{i}"] = llama._grab(ctx, n).detach()
            x = x + proj(ctx, "self_attn.o_proj")
            h = llama.rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
            caps[f"mlp_in/{i}"] = llama._grab(h, n).detach()
            g = proj(h, "mlp.gate_proj")
            u = proj(h, "mlp.up_proj")
            y = (torch.nn.functional.silu(g.float()) * u.float()).to(x.dtype)
            caps[f"down_in/{i}"] = llama._grab(y, n).detach()
            x = x + proj(y, "mlp.down_proj")
        x = llama.rms_norm(x, params["norm"].detach(), cfg.rms_norm_eps)
        head_w = params.get("lm_head", params["embed_tokens"]).detach()
        logits = (x @ head_w.t().to(x.dtype)).float()
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        loss = -torch.gather(logp, -1, tokens[:, 1:, None].long()).mean()
        names = list(probes)
        grads = torch.autograd.grad(loss, [probes[k] for k in names])
    return caps, dict(zip(names, grads))


def _quantized(w: torch.Tensor, wcfg: Q.QuantizerConfig) -> torch.Tensor:
    with torch.no_grad():
        return Q.quantize(w.float(), _dynamic_like(wcfg), None)


@torch.no_grad()
def _candidate_delta_score(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, wcfg) -> torch.Tensor:
    """[L]: mean over tokens of (g . (x @ (Q(W) - W)^T))^2, for stacked layers."""
    if not wcfg.enable:
        return torch.zeros(w.shape[0], device=w.device)
    dw = _quantized(w, wcfg) - w.float()
    dy = torch.einsum("lni,loi->lno", x.float(), dw)
    tok = torch.einsum("lno,lno->ln", dy, g.float())
    return torch.mean(tok ** 2, dim=-1)


@torch.no_grad()
def _candidate_kl_score(x: torch.Tensor, w: torch.Tensor, wcfg) -> torch.Tensor:
    """[L]: mean over tokens of KL(softmax(y) || softmax(y_q)) over the
    output features (the gradient-free `kl_div` mode)."""
    if not wcfg.enable:
        return torch.zeros(w.shape[0], device=w.device)
    x32 = x.float()
    y0 = torch.einsum("lni,loi->lno", x32, w.float())
    y1 = torch.einsum("lni,loi->lno", x32, _quantized(w, wcfg))
    p = torch.softmax(y0, dim=-1)
    kl = torch.sum(p * (torch.log_softmax(y0, dim=-1) - torch.log_softmax(y1, dim=-1)), dim=-1)
    return torch.mean(kl, dim=-1)


def _layout_of(sites: dict) -> llama.QuantLayout:
    return llama.QuantLayout(sites=tuple(sites.items()))


def _resolved(cand: QuantizeConfig, members, sites: dict) -> None:
    for m in members:
        sites[f"{m}.weight"] = cand.resolve(f"model.layers.0.{m}.weight_quantizer")
        sites[f"{m}.input"] = cand.resolve(f"model.layers.0.{m}.input_quantizer")


def auto_quantize(model_cfg: llama.LlamaConfig, params: dict, candidates: Sequence, calib_batches: Iterable,
                  effective_bits: float = 6.0, capture_tokens: int = 64, score_method: str = "gradient",
                  checkpoint_path: Optional[str] = None) -> AutoQuantizeResult:
    """Search per-(layer, group) formats under the effective-bits budget.

    `checkpoint_path` (.npz): the scores and costs, the expensive part;
    where the file exists the scoring is skipped and only the selection
    runs (a new budget re-solves in seconds). The first batch is scored;
    every batch calibrates the result."""
    dev = params["embed_tokens"].device
    batches = [b.to(dev) for b in calib_batches]
    tokens = batches[0]
    resume = checkpoint_path is not None and os.path.exists(checkpoint_path)
    if not resume:
        caps, grads = _collect_grads_and_inputs(model_cfg, params, tokens, capture_tokens)
    cand_cfgs = [get_preset(c) if isinstance(c, str) else c for c in candidates]
    L = model_cfg.num_hidden_layers
    shapes = llama._layer_shapes(model_cfg)

    group_rows = [(i, key) for key, _ in GROUPS for i in range(L)] if resume else []
    scores, costs = [], []
    for cap_key, members in (() if resume else GROUPS):
        X = torch.stack([caps[f"{cap_key}/{i}"] for i in range(L)])
        s_per, c_per = [], []
        n_params_group = sum(shapes[m][0] * shapes[m][1] for m in members)
        for cand in cand_cfgs:
            total = torch.zeros(L, device=X.device)
            bits = 16.0
            for m in members:
                wcfg = cand.resolve(f"model.layers.0.{m}.weight_quantizer")
                w = params["layers"][m]
                if score_method == "kl_div":
                    total = total + _candidate_kl_score(X, w, wcfg)
                else:
                    gm = torch.stack([grads[f"{m}/{i}"] for i in range(L)])
                    total = total + _candidate_delta_score(X, w, gm, wcfg)
                bits = min(bits, wcfg.fake_bits if wcfg.enable else 16.0)
            s_per.append(total.cpu().numpy())
            c_per.append(bits * n_params_group / 8.0)
        for i in range(L):
            group_rows.append((i, cap_key))
            scores.append([s[i] for s in s_per])
            costs.append(list(c_per))
    if resume:
        data = np.load(checkpoint_path)
        scores_np, costs_np = data["scores"], data["costs"]
    else:
        scores_np, costs_np = np.asarray(scores), np.asarray(costs)
        if checkpoint_path:
            np.savez(checkpoint_path, scores=scores_np, costs=costs_np)

    total_params = sum(shapes[m][0] * shapes[m][1] for _, ms in GROUPS for m in ms) * L
    pick = _solve_ilp(scores_np, costs_np, effective_bits * total_params / 8.0)
    choice = [dict() for _ in range(L)]
    for row, (layer, key) in enumerate(group_rows):
        choice[layer][key] = int(pick[row])

    layer_layouts = []
    for i in range(L):
        sites = {}
        for cap_key, members in GROUPS:
            _resolved(cand_cfgs[choice[i][cap_key]], members, sites)
        layer_layouts.append(_layout_of(sites))

    # the mixed model's state, max-calibrated over every batch (the
    # post-search calibration of `auto_quantize`)
    qstate_list = [
        {name: {k: Q.init_state(lay.get(f"{name}.{k}"), shape, dev)
                for k, shape in (("weight", shapes[name]), ("input", (1, 1, shapes[name][1])))
                if lay.get(f"{name}.{k}").enable}
         for name in llama.PROJ_NAMES
         if any(lay.get(f"{name}.{k}").enable for k in ("weight", "input"))}
        for lay in layer_layouts]
    with torch.no_grad():
        for b in batches:
            new_states = llama.forward_unrolled(model_cfg, params, b, layer_layouts, qstate_list,
                                                calib=True)[1]
            qstate_list = [{**qstate_list[i], **new_states[i]} for i in range(L)]

    achieved = float(costs_np[np.arange(len(pick)), pick].sum() * 8.0 / total_params)
    return AutoQuantizeResult(choice=choice, candidates=list(candidates), scores=scores_np, effective_bits=achieved,
                              layer_layouts=layer_layouts, qstate_list=qstate_list)


def _solve_ilp(scores: np.ndarray, costs: np.ndarray, budget: float) -> np.ndarray:
    """One candidate a row minimizing the summed score, the summed cost
    within the budget: scipy's MILP (HiGHS), else a greedy pass."""
    rows, ncand = scores.shape
    try:
        from scipy.optimize import Bounds, LinearConstraint, milp

        onehot = np.zeros((rows, rows * ncand))
        for r in range(rows):
            onehot[r, r * ncand: (r + 1) * ncand] = 1.0
        res = milp(c=scores.reshape(-1),
                   constraints=[LinearConstraint(costs.reshape(1, -1), -np.inf, budget),
                                LinearConstraint(onehot, 1.0, 1.0)],
                   integrality=np.ones(rows * ncand), bounds=Bounds(0, 1))
        if res.success:
            return np.argmax(res.x.reshape(rows, ncand), axis=1)
    except ImportError:
        pass
    return _solve_greedy(scores, costs, budget)


def _solve_greedy(scores: np.ndarray, costs: np.ndarray, budget: float) -> np.ndarray:
    """The cheapest candidate everywhere, then the best score reduction per
    byte while the budget allows (JAX's fallback)."""
    rows = scores.shape[0]
    pick = np.argmin(costs, axis=1)
    while True:
        cur_cost = costs[np.arange(rows), pick].sum()
        best_gain, best_move = 0.0, None
        for r in range(rows):
            for c in range(costs.shape[1]):
                dc = costs[r, c] - costs[r, pick[r]]
                ds = scores[r, pick[r]] - scores[r, c]
                if ds > 0 and cur_cost + dc <= budget:
                    gain = ds / max(dc, 1.0)
                    if gain > best_gain:
                        best_gain, best_move = gain, (r, c)
        if best_move is None:
            return pick
        pick[best_move[0]] = best_move[1]


# --------------------------------------------------------------------------
# MoE AutoQuantize with the active-expert cost model
# --------------------------------------------------------------------------


@dataclasses.dataclass
class AutoQuantizeMoEResult:
    choice: list  # per layer: {"attn": candidate, "moe": candidate}
    layer_layouts: list
    effective_bits: float
    expert_cost_ratio: float


ATTN_MEMBERS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj")


def auto_quantize_moe(cfg, params: dict, candidates: Sequence, calib_batches: Iterable, effective_bits: float = 6.0,
                      capture_tokens: int = 64, expert_cost_ratio: Optional[float] = None,
                      forward_fn=None) -> AutoQuantizeMoEResult:
    """AutoQuantize of a routed-MoE model with active-expert costing: the
    experts' weight bytes count at top_k / num_experts (per decoded token
    only the active experts' bytes are read); scores are KL on the captured
    layer inputs, the experts' summed at the same ratio. `forward_fn`
    selects GPT-OSS's or Llama4's forward (mixtral's signature)."""
    from ..models import mixtral

    batches = list(calib_batches)
    ratio = expert_cost_ratio if expert_cost_ratio is not None else cfg.top_k / cfg.num_experts
    fwd = forward_fn or mixtral.forward
    with torch.no_grad():
        _, _, caps = fwd(cfg, params, batches[0], capture_tokens=capture_tokens)
    X_attn, X_moe = caps["attn_in"], caps["moe_in"]
    cand_cfgs = [get_preset(c) if isinstance(c, str) else c for c in candidates]
    L, E = cfg.num_hidden_layers, cfg.num_experts
    H, I = cfg.hidden_size, cfg.intermediate_size
    hd, nH, nKV = cfg.hd, cfg.num_attention_heads, cfg.num_key_value_heads
    attn_params = 2 * nH * hd * H + 2 * nKV * hd * H
    expert_params = 3 * I * H * E  # raw; the cost scales by `ratio`
    layers = params["layers"]

    scores, costs = [], []
    for cand in cand_cfgs:
        s_attn, bits_a = torch.zeros(L, device=X_attn.device), 16.0
        for m in ATTN_MEMBERS:
            wcfg = cand.resolve(f"model.layers.0.{m}.weight_quantizer")
            # o_proj scored on attn_in as a proxy (the same hidden distribution)
            s_attn = s_attn + _candidate_kl_score(X_attn, layers[m], wcfg)
            bits_a = min(bits_a, wcfg.fake_bits if wcfg.enable else 16.0)
        s_moe, bits_m = torch.zeros(L, device=X_moe.device), 16.0
        for m in mixtral.MOE_NAMES:
            wcfg = cand.resolve(f"model.layers.0.{m}.weight_quantizer")
            w = layers[m]  # [L, E, O, I]
            per_e = []
            for e in range(E):
                if m == "moe.down_proj":  # the down input: silu(X Wg^T) * (X Wu^T), per expert
                    x32 = X_moe.float()
                    g = torch.einsum("lni,loi->lno", x32, layers["moe.gate_proj"][:, e].float())
                    u = torch.einsum("lni,loi->lno", x32, layers["moe.up_proj"][:, e].float())
                    per_e.append(_candidate_kl_score(torch.nn.functional.silu(g) * u, w[:, e], wcfg))
                else:
                    per_e.append(_candidate_kl_score(X_moe, w[:, e], wcfg))
            s_moe = s_moe + ratio * sum(per_e)
            bits_m = min(bits_m, wcfg.fake_bits if wcfg.enable else 16.0)
        scores.append((s_attn.cpu().numpy(), s_moe.cpu().numpy()))
        costs.append((bits_a * attn_params / 8.0, bits_m * expert_params * ratio / 8.0))

    rows_s, rows_c, rows_meta = [], [], []
    for i in range(L):
        for j, key in enumerate(("attn", "moe")):
            rows_meta.append((i, key))
            rows_s.append([s[j][i] for s in scores])
            rows_c.append([c[j] for c in costs])
    total = (attn_params + expert_params * ratio) * L
    pick = _solve_ilp(np.asarray(rows_s), np.asarray(rows_c), effective_bits * total / 8.0)
    choice = [dict() for _ in range(L)]
    for row, (layer, key) in enumerate(rows_meta):
        choice[layer][key] = int(pick[row])
    layer_layouts, spent = [], 0.0
    for i in range(L):
        sites = {}
        _resolved(cand_cfgs[choice[i]["attn"]], ATTN_MEMBERS, sites)
        _resolved(cand_cfgs[choice[i]["moe"]], mixtral.MOE_NAMES, sites)
        layer_layouts.append(_layout_of(sites))
        spent += rows_c[2 * i][choice[i]["attn"]] + rows_c[2 * i + 1][choice[i]["moe"]]
    return AutoQuantizeMoEResult(choice, layer_layouts, float(spent * 8.0 / total), float(ratio))
