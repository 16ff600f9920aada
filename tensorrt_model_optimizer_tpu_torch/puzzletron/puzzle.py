"""Puzzletron: heterogeneous block-substitution NAS (port of
`puzzletron/puzzle.py`).

Per decoder layer a library of replacement candidates (full, ffn-pruned,
kv-pruned, attention or MLP removed, no-op, and attention swapped for a
locally distilled Mamba2 mixer), each scored locally: the MSE of its output
against the full layer's on that layer's true input (the full model's
activations, propagated layer by layer). A one-hot MILP picks a candidate a
layer under a parameter budget (`run_puzzle`), or under memory / decode
latency budgets from an analytic roofline (`subblock_stats`,
`run_puzzle_constrained`); the stitched child runs through
`forward_hetero`, heals by distillation (`heal_child`) and saves as a
standalone checkpoint (`save_child` / `load_child`, JAX's layout: a child
saved by either package loads in the other).

Deliberate differences from the JAX package:
 - `subblock_stats`' default rates are the H100's (3.35 TB/s, 989 TFLOP/s
   dense bf16); pass `hbm_gbps` / `tflops` for another device.
 - `build_mamba_candidate` draws its initial mixer from a seeded
   `torch.Generator` (JAX from `jax.random.key(seed)`), or takes it as
   `init_mixer`; it trains with `quant.qat.Adam`, optax.adam's arithmetic.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ..models import llama
from ..models import mamba as mamba_mod
from ..prune import minitron
from ..quant import qat


@dataclasses.dataclass
class Candidate:
    name: str
    cfg: Optional[llama.LlamaConfig]  # None: no-op (the layer is skipped)
    params: Optional[dict]  # the layer's params
    cost: int  # parameter count
    score: float = 0.0  # local output MSE
    skip: Optional[str] = None  # "attn" | "mlp" | "mamba": a sub-block swap
    mamba_cfg: Optional[object] = None  # the MambaConfig of an attn2mamba candidate's "mixer.*" params


@dataclasses.dataclass
class PuzzleResult:
    choices: list[str]  # candidate name a layer
    layers: list[Candidate]
    total_params: int
    full_params: int


def _layer_param_count(cfg: llama.LlamaConfig) -> int:
    return sum(o * i for o, i in llama._layer_shapes(cfg).values()) + 2 * cfg.hidden_size


def _rows(keep, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.asarray(keep, np.int64)).to(like.device)


def _prune_ffn(cfg, lp, scores_l, pct: int):
    w = max(int(cfg.intermediate_size * pct / 100) // 8 * 8, 8)
    keep = _rows(np.sort(np.argsort(-scores_l.ffn)[:w]), lp["mlp.up_proj"])
    new = dict(lp)
    new["mlp.gate_proj"] = lp["mlp.gate_proj"][keep]
    new["mlp.up_proj"] = lp["mlp.up_proj"][keep]
    new["mlp.down_proj"] = lp["mlp.down_proj"][:, keep]
    return dataclasses.replace(cfg, intermediate_size=w), new


def _prune_kv(cfg, lp, scores_l, pct: int):
    nH, nKV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    n_keep = max(int(nKV * pct / 100), 1)
    if n_keep >= nKV:
        return None, None
    rep = nH // nKV
    keep_kv = np.sort(np.argsort(-scores_l.kv)[:n_keep])
    q_heads = np.concatenate([np.arange(g * rep, (g + 1) * rep) for g in keep_kv])
    q_rows = _rows(np.concatenate([np.arange(h * hd, (h + 1) * hd) for h in q_heads]), lp["self_attn.q_proj"])
    kv_rows = _rows(np.concatenate([np.arange(g * hd, (g + 1) * hd) for g in keep_kv]), lp["self_attn.q_proj"])
    new = dict(lp)
    new["self_attn.q_proj"] = lp["self_attn.q_proj"][q_rows]
    new["self_attn.k_proj"] = lp["self_attn.k_proj"][kv_rows]
    new["self_attn.v_proj"] = lp["self_attn.v_proj"][kv_rows]
    new["self_attn.o_proj"] = lp["self_attn.o_proj"][:, q_rows]
    # the head size is kept: hd must not re-derive from the hidden size
    return dataclasses.replace(cfg, num_key_value_heads=n_keep, num_attention_heads=n_keep * rep, head_dim=hd), new


def _slice_layer_candidate(cfg, lp, scores_l, kind: str):
    """One pruned variant of a layer: "full", "ffn<pct>", "kv<pct>" or a
    "+" combination -> (cfg, params), or (None, None) where it does not
    apply."""
    if kind == "full":
        return dataclasses.replace(cfg), dict(lp)
    ccfg, cp = dataclasses.replace(cfg), dict(lp)
    for part in kind.split("+"):
        if part.startswith("ffn"):
            ccfg, cp = _prune_ffn(ccfg, cp, scores_l, int(part[3:]))
        elif part.startswith("kv"):
            r = _prune_kv(ccfg, cp, scores_l, int(part[2:]))
            if r[0] is None:
                return None, None
            ccfg, cp = r
        else:
            return None, None
    return ccfg, cp


def _attn_params(cfg) -> int:
    return sum(o * i for n, (o, i) in llama._layer_shapes(cfg).items() if n.startswith("self_attn"))


def _layer_out(ccfg, x, cp, positions, mask, skip: Optional[str] = None, mamba_cfg=None):
    """One layer, whole, without its attention or MLP, or with its attention
    swapped for a Mamba2 mixer (`mamba_cfg` governs the "mixer.*" params)."""
    lay = llama.QuantLayout(sites=())
    if skip is None:
        return llama._decoder_layer(ccfg, lay, False, x, cp, None, positions, mask)[0]
    if skip == "attn":
        h = llama.rms_norm(x, cp["post_attention_layernorm"], ccfg.rms_norm_eps)
        return x + llama._mlp(h, cp, None, lay, False)[0]
    if skip == "mlp":
        h = llama.rms_norm(x, cp["input_layernorm"], ccfg.rms_norm_eps)
        return x + llama._attention(ccfg, h, cp, None, lay, positions, mask, False)[0]
    if skip == "mamba":
        h = llama.rms_norm(x, cp["input_layernorm"], ccfg.rms_norm_eps)
        x = x + mamba_mod._mixer(mamba_cfg, h, cp, None, lay, None, False)[0]
        h = llama.rms_norm(x, cp["post_attention_layernorm"], ccfg.rms_norm_eps)
        return x + llama._mlp(h, cp, None, lay, False)[0]
    raise ValueError(skip)


@dataclasses.dataclass
class _LayerScores:
    ffn: np.ndarray
    kv: np.ndarray


def _causal(tokens: torch.Tensor):
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device)[None, :].expand(B, T)
    return positions, llama.causal_mask(T, tokens.device)


def _mse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.mean((a - b) ** 2))


DEFAULT_KINDS = ("full", "ffn75", "ffn50", "ffn25", "kv50", "kv25", "ffn50+kv50", "attn_skip", "mlp_skip", "noop")


def build_and_score_library(cfg: llama.LlamaConfig, params: llama.Params, batches: list, kinds=DEFAULT_KINDS,
                            distill_steps: int = 120, init_mixers: Optional[list] = None) -> list[list[Candidate]]:
    """A layer's candidates with their local-output-MSE scores, on the first
    batch. Layer inputs come from the full model's layer-by-layer
    propagation, so each candidate is judged on what it would see.
    "attn2mamba" distils a mixer for `distill_steps` Adam steps from
    `init_mixers[i]` where given, else from a generator seeded with i."""
    imp = minitron.importance(cfg, params, batches, capture_tokens=64)
    tokens = batches[0]
    positions, mask = _causal(tokens)
    lay = llama.QuantLayout(sites=())
    with torch.no_grad():
        x = params["embed_tokens"][tokens].to(cfg.dtype)
    library: list[list[Candidate]] = []
    for i in range(cfg.num_hidden_layers):
        lp = llama.slice_layer(params["layers"], i)
        with torch.no_grad():
            full_out = llama._decoder_layer(cfg, lay, False, x, lp, None, positions, mask)[0]
        cands: list[Candidate] = []
        sc = _LayerScores(ffn=imp.ffn[i], kv=imp.kv_group[i])
        for kind in kinds:
            if kind == "noop":
                cands.append(Candidate("noop", None, None, cost=0, score=_mse(full_out, x)))
                continue
            if kind == "attn2mamba":
                cand = build_mamba_candidate(cfg, lp, x, full_out, positions, mask, distill_steps=distill_steps,
                                             seed=i, init_mixer=None if init_mixers is None else init_mixers[i])
                if cand is not None:
                    cands.append(cand)
                continue
            if kind in ("attn_skip", "mlp_skip"):
                skip = kind.split("_")[0]
                with torch.no_grad():
                    out = _layer_out(cfg, x, lp, positions, mask, skip)
                full_cost = _layer_param_count(cfg)
                cost = full_cost - (_attn_params(cfg) if skip == "attn"
                                    else full_cost - _attn_params(cfg) - 2 * cfg.hidden_size)
                cands.append(Candidate(kind, dataclasses.replace(cfg), dict(lp), cost=cost,
                                       score=_mse(full_out, out), skip=skip))
                continue
            ccfg, cp = _slice_layer_candidate(cfg, lp, sc, kind)
            if ccfg is None:
                continue
            with torch.no_grad():
                out = _layer_out(ccfg, x, cp, positions, mask)
            cands.append(Candidate(kind, ccfg, cp, cost=_layer_param_count(ccfg), score=_mse(full_out, out)))
        library.append(cands)
        x = full_out  # propagate the full model's activations
    return library


def mixer_config(cfg: llama.LlamaConfig) -> mamba_mod.MambaConfig:
    """The Mamba2 mixer that replaces a layer's attention: about 2 h wide
    in heads of >= 8, one B / C group, state min(64, h), chunks of 8."""
    h = cfg.hidden_size
    heads = max(h // 64, 1)
    return mamba_mod.MambaConfig(
        vocab_size=cfg.vocab_size, hidden_size=h, intermediate_size=cfg.intermediate_size,
        num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.num_key_value_heads,
        mamba_num_heads=heads, mamba_head_dim=max(2 * h // heads, 8), ssm_state_size=min(64, h), n_groups=1,
        chunk_size=8, hybrid_pattern="M", dtype=cfg.dtype)


def seeded_mixer(mcfg: mamba_mod.MambaConfig, seed: int, device) -> dict:
    """A fresh mixer's "mixer.*" params from a generator seeded with `seed`
    (`mamba.init_params`' draws; a one-row vocabulary keeps the unused
    embedding small)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mp = mamba_mod.init_params(dataclasses.replace(mcfg, vocab_size=1), gen, device)
    return {k: v[0] for k, v in mp["layers_mamba"].items() if k.startswith("mixer.")}


def build_mamba_candidate(cfg: llama.LlamaConfig, lp: dict, x: torch.Tensor, full_out: torch.Tensor, positions,
                          mask, distill_steps: int = 120, lr: float = 3e-3, seed: int = 0,
                          init_mixer: Optional[dict] = None):
    """The attention of a layer swapped for a fresh Mamba2 mixer, distilled
    locally: the mixer and the layer's two norms train by Adam to match the
    full layer's output on the layer's true input. -> a Candidate
    (skip="mamba"); `init_mixer` ({"mixer.*": tensor}) overrides the seeded
    start."""
    mcfg = mixer_config(cfg)
    mixer = init_mixer if init_mixer is not None else seeded_mixer(mcfg, seed, x.device)
    mixer = {k: v.to(x.device) for k, v in mixer.items()}
    cand_params = {k: v for k, v in lp.items() if not k.startswith("self_attn.")}
    cand_params.update(mixer)
    train_keys = tuple(mixer) + ("input_layernorm", "post_attention_layernorm")
    frozen = {k: v for k, v in cand_params.items() if k not in train_keys}
    trained = {k: cand_params[k] for k in train_keys if k in cand_params}
    target = full_out.detach().float()

    def loss_fn(tr):
        out = _layer_out(cfg, x, {**frozen, **tr}, positions, mask, "mamba", mamba_cfg=mcfg)
        return torch.mean((out.float() - target) ** 2)

    opt = qat.Adam(lr)
    ost = opt.init(trained)
    for _ in range(distill_steps):
        _, grads = qat.value_and_grad(loss_fn, trained)
        updates, ost = opt.update(grads, ost)
        trained = qat.apply_updates(trained, updates)
    cand_params.update(trained)
    with torch.no_grad():
        out = _layer_out(cfg, x, cand_params, positions, mask, "mamba", mamba_cfg=mcfg)
    err = float(torch.mean((target - out.float()) ** 2))
    mixer_params = int(sum(v.numel() for k, v in cand_params.items() if k.startswith("mixer.")))
    cost = _layer_param_count(cfg) - _attn_params(cfg) + mixer_params
    return Candidate("attn2mamba", dataclasses.replace(cfg), cand_params, cost=cost, score=err, skip="mamba",
                     mamba_cfg=mcfg)


def _child_logits(base_cfg, params, statics, layers_list, tokens) -> torch.Tensor:
    positions, mask = _causal(tokens)
    x = params["embed_tokens"][tokens].to(base_cfg.dtype)
    for (name, ccfg, skip, mcfg), cp in zip(statics, layers_list):
        if name == "noop":
            continue
        x = _layer_out(ccfg, x, cp, positions, mask, skip, mamba_cfg=mcfg)
    x = llama.rms_norm(x, params["norm"], base_cfg.rms_norm_eps)
    head_w = params.get("lm_head", params["embed_tokens"])
    return (x @ head_w.t().to(x.dtype)).float()


def heal_child(base_cfg: llama.LlamaConfig, params: llama.Params, result: PuzzleResult, batches: list,
               steps: int = 100, lr: float = 1e-4, temperature: float = 2.0):
    """Distil the stitched child against the parent's logits on the
    calibration stream (KL at `temperature`, Adam); only the chosen
    layers train. -> (healed PuzzleResult, {"kd_loss_first",
    "kd_loss_last"})."""
    statics = [(c.name, c.cfg, c.skip, c.mamba_cfg) for c in result.layers]
    child_layers = [dict(c.params) if c.params is not None else {} for c in result.layers]
    T_ = temperature

    def loss_fn(ls, tokens, teacher):
        lg = _child_logits(base_cfg, params, statics, ls, tokens)
        tp = torch.softmax(teacher / T_, dim=-1)
        lsf = torch.log_softmax(lg / T_, dim=-1)
        return -torch.mean(torch.sum(tp * lsf, dim=-1)) * T_ * T_

    opt = qat.Adam(lr)
    ost = opt.init(child_layers)
    first = last = None
    for i in range(steps):
        tokens = batches[i % len(batches)]
        with torch.no_grad():
            teacher = llama.forward(base_cfg, params, tokens)[0]
        loss, grads = qat.value_and_grad(lambda ls: loss_fn(ls, tokens, teacher), child_layers)
        updates, ost = opt.update(grads, ost)
        child_layers = qat.apply_updates(child_layers, updates)
        if first is None:
            first = float(loss)
        last = float(loss)
    healed = [dataclasses.replace(c, params=(cp if c.params is not None else None))
              for c, cp in zip(result.layers, child_layers)]
    return dataclasses.replace(result, layers=healed), {"kd_loss_first": first, "kd_loss_last": last}


def _result(library, pick) -> PuzzleResult:
    chosen = [library[i][int(pick[i])] for i in range(len(library))]
    full = sum(c.cost for cands in library for c in cands if c.name == "full")
    return PuzzleResult(choices=[c.name for c in chosen], layers=chosen,
                        total_params=int(sum(c.cost for c in chosen)), full_params=int(full))


def _score_matrix(library) -> np.ndarray:
    scores = np.full((len(library), max(len(c) for c in library)), 1e9)
    for i, cands in enumerate(library):
        for j, c in enumerate(cands):
            scores[i, j] = c.score
    return scores


def run_puzzle(library: list[list[Candidate]], param_budget_ratio: float = 0.75) -> PuzzleResult:
    """One-hot MILP: min the summed score, the summed cost within the ratio
    of the full layers' parameters."""
    from ..quant.auto import _solve_ilp

    scores = _score_matrix(library)
    costs = np.zeros_like(scores)
    for i, cands in enumerate(library):
        for j, c in enumerate(cands):
            costs[i, j] = c.cost
    full = sum(c.cost for cands in library for c in cands if c.name == "full")
    return _result(library, _solve_ilp(scores, costs, budget=param_budget_ratio * full))


def forward_hetero(base_cfg: llama.LlamaConfig, params: llama.Params, result: PuzzleResult,
                   tokens: torch.Tensor) -> torch.Tensor:
    """The stitched heterogeneous model (the sewing kit) -> logits f32."""
    statics = [(c.name, c.cfg, c.skip, c.mamba_cfg) for c in result.layers]
    return _child_logits(base_cfg, params, statics, [c.params for c in result.layers], tokens)


# --------------------------------------------------------------------------
# Subblock cost models (parameters, memory, an analytic roofline)
# --------------------------------------------------------------------------

H100_HBM_GBPS = 3350.0  # H100 SXM HBM3
H100_BF16_TFLOPS = 989.0  # H100 SXM dense bf16


@dataclasses.dataclass(frozen=True)
class SubblockStats:
    params: int
    weights_mib: float
    kv_cache_mib: float
    memory_mib: float
    decode_ms: float  # a decode token, this layer
    prefill_ms: float  # the whole prompt


def subblock_stats(cand: Candidate, *, batch: int = 1, seq_len: int = 4096, weight_bytes: float = 2.0,
                   kv_bytes: float = 2.0, hbm_gbps: float = H100_HBM_GBPS,
                   tflops: float = H100_BF16_TFLOPS) -> SubblockStats:
    """Analytic roofline of one candidate layer: a step's time is
    max(bytes / bandwidth, flops / peak)."""
    if cand.cfg is None:
        return SubblockStats(0, 0.0, 0.0, 0.0, 0.0, 0.0)
    cfg = cand.cfg
    sh = llama._layer_shapes(cfg)
    names = []
    if cand.skip != "attn":
        names += ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj"]
    if cand.skip != "mlp":
        names += ["mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"]
    p = sum(int(np.prod(sh[n])) for n in names if n in sh) + 2 * cfg.hidden_size
    weights_b = p * weight_bytes
    kv_b = 0.0
    attn_flops_tok = 0.0
    if cand.skip != "attn":
        kv_b = batch * seq_len * 2 * cfg.num_key_value_heads * cfg.hd * kv_bytes
        attn_flops_tok = 2.0 * 2.0 * cfg.num_attention_heads * cfg.hd * seq_len
    proj_flops_tok = 2.0 * sum(int(np.prod(sh[n])) for n in names if n in sh)
    # decode: every weight and the kv cache read once a step
    decode_ms = max((weights_b + kv_b) / (hbm_gbps * 1e9),
                    batch * (proj_flops_tok + attn_flops_tok) / (tflops * 1e12)) * 1e3
    # prefill: the weights read once, the flops dominate
    pre_flops = batch * seq_len * proj_flops_tok + batch * attn_flops_tok * seq_len / 2
    prefill_ms = max(weights_b / (hbm_gbps * 1e9), pre_flops / (tflops * 1e12)) * 1e3
    return SubblockStats(params=p, weights_mib=weights_b / 2**20, kv_cache_mib=kv_b / 2**20,
                         memory_mib=(weights_b + kv_b) / 2**20, decode_ms=decode_ms, prefill_ms=prefill_ms)


def _solve_multi_ilp(scores, constraint_rows, budgets):
    """One-hot-a-layer MILP under several <= budgets (scores and each row
    [L, ncand]) -> pick [L]; scipy's MILP (HiGHS), else JAX's greedy
    upgrade pass."""
    L, ncand = scores.shape
    try:
        from scipy.optimize import Bounds, LinearConstraint, milp

        cons = [LinearConstraint(row.reshape(1, -1), -np.inf, b) for row, b in zip(constraint_rows, budgets)]
        onehot = np.zeros((L, L * ncand))
        for r in range(L):
            onehot[r, r * ncand: (r + 1) * ncand] = 1.0
        cons.append(LinearConstraint(onehot, 1.0, 1.0))
        res = milp(c=scores.reshape(-1), constraints=cons, integrality=np.ones(L * ncand), bounds=Bounds(0, 1))
        if res.success:
            return np.argmax(res.x.reshape(L, ncand), axis=1)
    except ImportError:
        pass
    # the cheapest (by the first constraint) everywhere, then the best
    # score-gain moves that fit every budget
    pick = np.argmin(constraint_rows[0], axis=1)

    def fits(p):
        return all(row[np.arange(L), p].sum() <= b for row, b in zip(constraint_rows, budgets))

    while True:
        best, best_gain = None, 0.0
        cur = scores[np.arange(L), pick].sum()
        for i in range(L):
            for j in range(ncand):
                if j == pick[i]:
                    continue
                trial = pick.copy()
                trial[i] = j
                if not fits(trial):
                    continue
                gain = cur - scores[np.arange(L), trial].sum()
                if gain > best_gain:
                    best, best_gain = (i, j), gain
        if best is None:
            return pick
        pick[best[0]] = best[1]


def run_puzzle_constrained(library: list[list[Candidate]], *, memory_budget_mib: Optional[float] = None,
                           decode_budget_ms: Optional[float] = None, param_budget_ratio: Optional[float] = None,
                           stats_kw: Optional[dict] = None) -> PuzzleResult:
    """The MILP under memory and / or decode-latency budgets from
    `subblock_stats` (and optionally the parameter ratio)."""
    stats_kw = stats_kw or {}
    L = len(library)
    scores = _score_matrix(library)
    ncand = scores.shape[1]
    stats = [[None] * ncand for _ in range(L)]
    for i, cands in enumerate(library):
        for j, c in enumerate(cands):
            stats[i][j] = subblock_stats(c, **stats_kw)
    rows, budgets = [], []
    if memory_budget_mib is not None:
        rows.append(np.array([[s.memory_mib if s else 1e12 for s in r] for r in stats]))
        budgets.append(memory_budget_mib)
    if decode_budget_ms is not None:
        rows.append(np.array([[s.decode_ms if s else 1e12 for s in r] for r in stats]))
        budgets.append(decode_budget_ms)
    if param_budget_ratio is not None:
        rows.append(np.array([[c.cost for c in cands] + [0] * (ncand - len(cands)) for cands in library],
                             dtype=float))
        budgets.append(param_budget_ratio * sum(c.cost for cands in library for c in cands if c.name == "full"))
    if not rows:
        raise ValueError("give at least one budget")
    return _result(library, _solve_multi_ilp(scores, rows, budgets))


# --------------------------------------------------------------------------
# Checkpoint sewing kit: the stitched child as a standalone checkpoint
# --------------------------------------------------------------------------


def save_child(path: str, base_cfg: llama.LlamaConfig, params: llama.Params, result: PuzzleResult) -> None:
    """Write the child: `puzzle_config.json` (the base config, the choices,
    a layer's name, skip and config) and `model.safetensors` (embed, norm,
    lm_head and `layers.{i}.*`; bf16 as "::bf16" uint16 bits), JAX's
    layout. As JAX's, a layer's mixer config is not written."""
    from ..models.hf_loader import save_safetensors
    from ..opt.state import BF16_SUFFIX, _model_cfg_to_dict

    os.makedirs(path, exist_ok=True)
    manifest = {
        "base_config": _model_cfg_to_dict(base_cfg),
        "choices": result.choices,
        "total_params": result.total_params,
        "full_params": result.full_params,
        "layers": [{"name": c.name, "skip": c.skip,
                    "config": _model_cfg_to_dict(c.cfg) if c.cfg is not None else None} for c in result.layers],
    }
    with open(os.path.join(path, "puzzle_config.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    def cook(name, t):
        t = t.detach()
        return (name + BF16_SUFFIX, t.view(torch.uint16)) if t.dtype == torch.bfloat16 else (name, t)

    named = dict(cook(k, params[k]) for k in ("embed_tokens", "norm", "lm_head") if k in params)
    for i, c in enumerate(result.layers):
        for pname, t in (c.params or {}).items():
            k, v = cook(f"layers.{i}.{pname}", t)
            named[k] = v
    save_safetensors(named, os.path.join(path, "model.safetensors"))


def load_child(path: str, device="cpu") -> tuple[llama.LlamaConfig, llama.Params, PuzzleResult]:
    """A `save_child` checkpoint (either package's) -> (base cfg, params,
    PuzzleResult) for `forward_hetero`, tensors on `device`."""
    from ..opt.state import _model_cfg_from_dict, _named_from_file

    with open(os.path.join(path, "puzzle_config.json")) as f:
        manifest = json.load(f)
    base_cfg = _model_cfg_from_dict(manifest["base_config"])
    arrays = _named_from_file(os.path.join(path, "model.safetensors"), device)
    params = {k: arrays[k] for k in ("embed_tokens", "norm", "lm_head") if k in arrays}
    layers = []
    for i, ent in enumerate(manifest["layers"]):
        prefix = f"layers.{i}."
        lp = {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}
        ccfg = _model_cfg_from_dict(ent["config"]) if ent["config"] else None
        cost = _layer_param_count(ccfg) if ccfg is not None else 0
        layers.append(Candidate(ent["name"], ccfg, lp or None, cost, skip=ent["skip"]))
    result = PuzzleResult(choices=manifest["choices"], layers=layers, total_params=manifest["total_params"],
                          full_params=manifest["full_params"])
    return base_cfg, params, result
