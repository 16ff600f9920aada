"""PTQ orchestration (port of `quant/ptq.py`).

`quantize` builds the site layout and state, then runs the configured
calibration algorithm, as the JAX package's `quantize` dispatches it:

 - "max": weights-only (no batches) collects each projection's weight amax
   directly; with batches, one calibration forward a batch collects weight,
   activation and KV amax. Every other method ends with this max pass, on
   the weights it has changed;
 - "smoothquant" (fixed alpha, "auto_layer", or "auto": the flavor with the
   least calibration KL against the unquantized model), "awq_lite",
   "awq_full" (lite, then clip) and "awq_clip": scale migration and block
   clipping on captured activations (`CAPTURE_GROUPS`);
 - "gptq": Hessian-compensated weights; "svdquant": a low-rank adapter
   branch plus a quantized residual (`QuantizedModel.adapters`);
 - "mse" and "local_hessian": weight amax searches; "nvfp4_act_headroom":
   NVFP4 activation global amax anchored at a per-batch percentile.

The searches run one layer at a time over the stacked [L, ...] weights (the
losses are per layer, so the choices are those of JAX's stacked searches;
at 8B width this keeps a stacked search's f32 temporaries, 7.5 GB each,
off the card). The captures keep the first `capture_tokens` tokens of each
of the first 4 batches.
"""

from __future__ import annotations

import dataclasses
import logging
import warnings
from typing import Iterable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import llama
from ..ops import numerics
from . import quantizer as Q
from .calib import awq as awq_mod
from .calib import gptq as gptq_mod
from .calib import mse as mse_mod
from .calib import smoothquant as sq_mod
from .calib import svdquant as svdq_mod
from .config import QuantizeConfig, get_preset

# capture key -> the projections that consume it (shared-input groups)
CAPTURE_GROUPS: dict[str, tuple[str, ...]] = {
    "attn_in": ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
    "o_in": ("self_attn.o_proj",),
    "mlp_in": ("mlp.gate_proj", "mlp.up_proj"),
    "down_in": ("mlp.down_proj",),
}
MAX_CAPTURES = 4  # batches whose captured tokens the searches see


@dataclasses.dataclass
class QuantizedModel:
    """Params + layout + calibrated state (the converted model's handle);
    `adapters` holds SVDQuant's low-rank branch, else None."""

    model_cfg: llama.LlamaConfig
    params: llama.Params
    layout: llama.QuantLayout
    qstate: llama.QuantState
    quant_cfg: QuantizeConfig
    adapters: Optional[dict] = None

    def forward(self, tokens, **kw):
        return llama.forward(self.model_cfg, self.params, tokens, layout=self.layout,
                             qstate=self.qstate, adapters=self.adapters, **kw)


def _method_of(algo) -> str:
    if algo is None:
        return "max"
    if isinstance(algo, str):
        return algo
    return algo.get("method", "max")


def _opt(algo, key: str, default):
    return algo.get(key, default) if isinstance(algo, dict) else default


def _merge_states(old, new):
    """Keep old entries not re-emitted; new wins where present."""
    out = dict(old)
    out.update(new)
    return out


@torch.no_grad()
def _weights_only_calibrate(model_cfg, params, layout, qstate):
    """Collect weight amax directly from params, one layer at a time."""
    out = dict(qstate)
    L = model_cfg.num_hidden_layers
    for name in llama.PROJ_NAMES:
        wcfg = layout.get(f"{name}.weight")
        if not wcfg.enable:
            continue
        w = params["layers"][name]
        sub = dict(out.get(name, {}))
        st = sub.get("weight")
        sub["weight"] = llama.stack_states(
            [Q.collect(w[i], wcfg, llama.slice_state(st, i)) for i in range(L)])
        out[name] = sub
    lw = layout.get("lm_head.weight")
    if lw.enable and "lm_head" in params:
        out["lm_head.weight"] = Q.collect(params["lm_head"], lw,
                                          out.get("lm_head.weight", Q.QuantizerState()))
    return out


def _calib_kl(model_cfg, params_ref, model: QuantizedModel, batches) -> float:
    """Mean token-level KL(unquantized || fake-quant) over the batches."""
    tot, n = 0.0, 0
    for b in batches:
        pr = torch.log_softmax(llama.forward(model_cfg, params_ref, b)[0].float(), dim=-1)
        pq = torch.log_softmax(model.forward(b)[0].float(), dim=-1)
        tot += float(torch.mean(torch.sum(torch.exp(pr) * (pr - pq), dim=-1)))
        n += 1
        del pr, pq
    return tot / max(n, 1)


def _smoothquant_auto_global(model_cfg, params, qcfg, batches, capture_tokens, dev):
    """alpha="auto": the SmoothQuant flavor (fixed alphas 0.3 .. 1.0, or
    per-layer "auto_layer") whose calibration KL is least. Holds the best
    candidate and the one being tried, no more."""
    candidates = [{"method": "smoothquant", "alpha": a} for a in (0.3, 0.5, 0.7, 0.85, 1.0)]
    candidates += [{"method": "smoothquant", "alpha": "auto_layer"}]
    best = None
    for algo in candidates:
        m = quantize(model_cfg, params, dataclasses.replace(qcfg, algorithm=algo), batches,
                     capture_tokens, device=dev)
        kl = _calib_kl(model_cfg, params, m, batches)
        if best is None or kl < best[0]:
            best = (kl, m, algo)
        del m
    kl, m, algo = best
    logging.getLogger(__name__).info("smoothquant auto: selected %s (calib KL %.3g)", algo, kl)
    # the winning flavor goes on the returned config, so a replay reproduces it
    return dataclasses.replace(m, quant_cfg=dataclasses.replace(qcfg, algorithm=algo))


@torch.no_grad()
def quantize(model_cfg: llama.LlamaConfig, params: llama.Params,
             quant_cfg: QuantizeConfig | str,
             calib_batches: Optional[Iterable[torch.Tensor]] = None,
             capture_tokens: int = 128, device=None) -> QuantizedModel:
    """Quantize: build sites, run the configured calibration, return the
    handle.

    `calib_batches`: token tensors [B, T]. Weight-only max configs need
    none; every other algorithm does. `device` is where the state lives; it
    must be where `params` are.
    """
    dev = resolve_device(device)
    qcfg = get_preset(quant_cfg) if isinstance(quant_cfg, str) else quant_cfg
    layout = llama.build_layout(model_cfg, qcfg)
    qstate = llama.init_quant_state(model_cfg, layout, dev)
    batches = [b.to(dev) for b in calib_batches] if calib_batches is not None else []
    algo = qcfg.algorithm
    method = _method_of(algo)

    if method == "smoothquant" and _opt(algo, "alpha", None) == "auto":
        return _smoothquant_auto_global(model_cfg, params, qcfg, batches, capture_tokens, dev)

    if method in ("smoothquant", "awq_lite", "awq_clip", "awq_full", "gptq") and not batches:
        raise ValueError(f"{method} calibration requires calib_batches")
    if method in ("smoothquant", "awq_lite", "awq_clip", "awq_full"):
        params, qstate = _sequential_calibrate(model_cfg, params, layout, qstate, batches, algo,
                                               capture_tokens)
    if method == "gptq":
        params, qstate = _gptq_calibrate(model_cfg, params, layout, qstate, batches, algo, capture_tokens)
    adapters = None
    if method == "svdquant":
        names = [n for n in llama.PROJ_NAMES if layout.get(f"{n}.weight").enable]
        new_layers, adapters = svdq_mod.svdquant_weights(params["layers"], names, _opt(algo, "rank", 16))
        params = {**params, "layers": new_layers}

    # the max pass, on the weights as changed (the adapters live: deeper
    # layers' activation stats depend on the low-rank branch)
    if batches:
        for b in batches:
            _, new_qs, _ = llama.forward(model_cfg, params, b, layout=layout, qstate=qstate, calib=True,
                                         adapters=adapters)
            qstate = _merge_states(qstate, new_qs)
    else:
        qstate = _weights_only_calibrate(model_cfg, params, layout, qstate)

    if method in ("awq_clip", "awq_full"):
        qstate = _awq_clip_refine(model_cfg, params, layout, qstate, batches, capture_tokens)
    if method == "nvfp4_act_headroom":
        qstate = _nvfp4_headroom_refine(model_cfg, params, layout, qstate, batches, algo, dev)
    if method == "mse":
        qstate = _mse_refine_weights(model_cfg, params, layout, qstate)
    if method == "local_hessian":
        qstate = _local_hessian_refine(model_cfg, params, layout, qstate, batches, capture_tokens)

    for msg in _validate(qstate):
        warnings.warn(f"quantizer validation: {msg}")
    return QuantizedModel(model_cfg, params, layout, qstate, qcfg, adapters)


@torch.no_grad()
def calibrate(model: QuantizedModel, calib_batches: Iterable[torch.Tensor]) -> QuantizedModel:
    """Extra max-calibration passes on an already converted model (the
    forward runs without the adapters, as JAX's `calibrate` does)."""
    dev = model.params["embed_tokens"].device
    qstate = model.qstate
    for b in calib_batches:
        _, new_qs, _ = llama.forward(model.model_cfg, model.params, b.to(dev), layout=model.layout,
                                     qstate=qstate, calib=True)
        qstate = _merge_states(qstate, new_qs)
    return dataclasses.replace(model, qstate=qstate)


def _validate(qstate) -> list[str]:
    """Post-calibration sanity: every amax finite and non-negative."""
    problems = []
    for name, sub in qstate.items():
        states = [(name, sub)] if isinstance(sub, Q.QuantizerState) else [
            (f"{name}.{k}", s) for k, s in sub.items()]
        for site, st in states:
            amaxes = st.amax if isinstance(st.amax, tuple) else (st.amax,)
            for a in amaxes:
                if a is not None and not bool(torch.all(torch.isfinite(a) & (a >= 0))):
                    problems.append(f"{site}: amax has NaN/Inf or negative entries")
    return problems


# --------------------------------------------------------------------------
# Sequential algorithms (SmoothQuant / AWQ) and GPTQ
# --------------------------------------------------------------------------


def _capture_stats(model_cfg, params, layout, qstate, batches, capture_tokens):
    """Capture passes -> (|x| mean [L, d], |x| max [L, d], samples [L, n,
    d]) per capture key; the samples are the first MAX_CAPTURES batches'."""
    absmean, amax, xs = {}, {}, {k: [] for k in CAPTURE_GROUPS}
    n = 0
    for b in batches:
        caps = llama.forward(model_cfg, params, b, layout=layout, qstate=qstate, calib=True,
                             capture_tokens=capture_tokens)[3]
        for key, x in caps.items():
            x32 = torch.abs(x.float())
            m, a = torch.mean(x32, dim=1), torch.amax(x32, dim=1)
            absmean[key] = m if key not in absmean else (absmean[key] * n + m) / (n + 1)
            amax[key] = a if key not in amax else torch.maximum(amax[key], a)
            if len(xs[key]) < MAX_CAPTURES:
                xs[key].append(x)
            del x32
        n += 1
    samples = {k: torch.cat(v, dim=1) for k, v in xs.items() if v}
    return absmean, amax, samples


def _dynamic_like(wcfg: Q.QuantizerConfig) -> Q.QuantizerConfig:
    """A config that derives its scales from the tensor (the search loops')."""
    if wcfg.sequential:
        return wcfg.replace(sequential=tuple(_dynamic_like(c) for c in wcfg.sequential))
    if wcfg.block is not None:
        return wcfg.replace(block=dataclasses.replace(wcfg.block, dynamic=True))
    return wcfg.replace(dynamic=True)


def _weight_qfns(wcfgs):
    """Per-member weight fake-quant closures (identity for disabled sites)
    of one layer's weight [O, K], quantized as a [1, O, K] stack: its
    per-axis scales are those JAX's search over the [L, O, K] stack gives
    each layer. A per-tensor scale (NVFP4's global amax, W4A8's fp8 stage)
    is the layer's own, as in the served model; JAX's stacked search takes
    the whole stack's (ROADMAP.md queue 3)."""
    def one(c):
        return lambda w: Q.quantize(w[None], _dynamic_like(c), None)[0]

    return [one(c) if c.enable else (lambda w: w) for c in wcfgs]


def _set_input_pqs(qstate, members, pqs):
    """pre_quant_scale [L, d_in] onto each member's input site state."""
    for m in members:
        sub = dict(qstate.get(m, {}))
        sub["input"] = sub.get("input", Q.QuantizerState()).replace(pre_quant_scale=pqs)
        qstate[m] = sub


def _sequential_calibrate(model_cfg, params, layout, qstate, batches, algo, capture_tokens):
    method = _method_of(algo)
    if method == "awq_clip":  # no scale migration
        return params, qstate
    absmean, amax, samples = _capture_stats(model_cfg, params, layout, qstate, batches, capture_tokens)
    new_layers = dict(params["layers"])
    qstate = dict(qstate)
    L = model_cfg.num_hidden_layers
    for cap_key, members in CAPTURE_GROUPS.items():
        wcfgs = [layout.get(f"{m}.weight") for m in members]
        if not any(c.enable for c in wcfgs):
            continue
        qfns = _weight_qfns(wcfgs)
        folded = [torch.empty_like(new_layers[m]) for m in members]
        pqs = []
        for i in range(L):
            ws = [new_layers[m][i] for m in members]
            if method == "smoothquant":
                alpha = _opt(algo, "alpha", 1.0)
                if alpha in ("auto", "auto_layer"):  # "auto" reaches here as the KL search's auto_layer
                    fw, p, _ = sq_mod.smoothquant_auto(samples[cap_key][i:i + 1], amax[cap_key][i:i + 1],
                                                       [w[None] for w in ws], [lambda w, f=f: f(w[0])[None]
                                                                               for f in qfns])
                    fw, p = [w[0] for w in fw], p[0]
                else:
                    fw, p = sq_mod.apply_smoothquant(amax[cap_key][i], ws, alpha)
            else:  # awq_lite / awq_full
                _, s = awq_mod.awq_lite_search(samples[cap_key][i], ws, qfns, absmean[cap_key][i],
                                               _opt(algo, "alpha_step", 0.1))
                fw, p = [(w.float() * s[None, :]).to(w.dtype) for w in ws], 1.0 / s
            for dst, w in zip(folded, fw):
                dst[i] = w
            pqs.append(p)
            del fw
        for m, w in zip(members, folded):
            new_layers[m] = w
        _set_input_pqs(qstate, members, torch.stack(pqs))
    return {**params, "layers": new_layers}, qstate


def _pinned_amax(w: torch.Tensor, wcfg: Q.QuantizerConfig) -> torch.Tensor:
    """The weight quantizer's amax of the original weights [L, O, K], in
    the state's compact form."""
    base = wcfg.sequential[0] if wcfg.sequential else wcfg
    w32 = torch.abs(w.float())
    if base.block is not None and base.block.sizes:
        return torch.stack([numerics.block_amax_compact(w32[i], base.block.sizes) for i in range(w.shape[0])])
    if base.axis is not None:
        kept = tuple(a % 2 for a in base.axis)
        red = tuple(1 + i for i in range(2) if i not in kept)
        return torch.amax(w32, dim=red, keepdim=True)
    return torch.amax(w32, dim=(1, 2))


def _gptq_calibrate(model_cfg, params, layout, qstate, batches, algo, capture_tokens):
    """Each weight becomes its GPTQ fake-quantized version; the weight
    quantizer's amax is pinned to the original weights' grid, so quantizing
    again is idempotent. The enabled members of a group with one weight
    config run as one stacked weight (rows are independent; one Hessian)."""
    _, _, samples = _capture_stats(model_cfg, params, layout, qstate, batches, capture_tokens)
    block = _opt(algo, "block_size", 128)
    new_layers = dict(params["layers"])
    qstate = dict(qstate)
    L = model_cfg.num_hidden_layers
    for cap_key, members in CAPTURE_GROUPS.items():
        if cap_key not in samples:
            continue
        on = [m for m in members if layout.get(f"{m}.weight").enable]
        runs = [on] if len({layout.get(f"{m}.weight") for m in on}) == 1 else [[m] for m in on]
        for run in runs:
            wcfg = layout.get(f"{run[0]}.weight")
            out = {m: torch.empty_like(new_layers[m]) for m in run}
            for m in run:
                sub = dict(qstate.get(m, {}))
                amax = _pinned_amax(new_layers[m], wcfg)
                st = sub.get("weight", Q.QuantizerState())
                sub["weight"] = st.replace(amax=(amax,) + (None,) * (len(wcfg.sequential) - 1)
                                           if wcfg.sequential else amax)
                qstate[m] = sub
            for i in range(L):
                ws = [new_layers[m][i] for m in run]
                H = gptq_mod.hessian_from_acts(samples[cap_key][i], 0.01)
                grid = torch.cat([gptq_mod.amax_grid_for(w, wcfg) for w in ws])
                wq = gptq_mod.gptq_quantize(torch.cat(ws), H, gptq_mod.col_quantizer(wcfg), grid, block)
                for m, part in zip(run, torch.split(wq, [w.shape[0] for w in ws])):
                    out[m][i] = part
                del H, grid, wq
            new_layers.update(out)
    return {**params, "layers": new_layers}, qstate


def _refined(st: Q.QuantizerState, best: torch.Tensor) -> Q.QuantizerState:
    """`st` with its (first stage's) amax replaced."""
    if isinstance(st.amax, tuple):
        return st.replace(amax=(best,) + tuple(st.amax[1:]))
    return st.replace(amax=best)


def _awq_clip_refine(model_cfg, params, layout, qstate, batches, capture_tokens):
    """Shrink the per-block weight amax of INT block weights by clip search."""
    _, _, samples = _capture_stats(model_cfg, params, layout, qstate, batches, capture_tokens)
    qstate = dict(qstate)
    for cap_key, members in CAPTURE_GROUPS.items():
        if cap_key not in samples:
            continue
        for m in members:
            wcfg = layout.get(f"{m}.weight")
            base = wcfg.sequential[0] if wcfg.sequential else wcfg
            if not wcfg.enable or base.is_fp or base.block is None:
                continue
            sizes = dict(base.block.sizes)
            bsz = sizes.get(-1) or list(sizes.values())[0]
            w = params["layers"][m]

            def qfn(wx, amax_full, bits=base.num_bits):
                return numerics.fake_quant_int(wx, amax_full, bits)

            best = torch.stack([awq_mod.awq_clip_search(samples[cap_key][i], w[i], bsz, qfn)
                                for i in range(w.shape[0])])
            sub = dict(qstate.get(m, {}))
            st = sub.get("weight", Q.QuantizerState())
            if wcfg.sequential and not isinstance(st.amax, tuple):
                st = st.replace(amax=(None,) * len(wcfg.sequential))
            sub["weight"] = _refined(st, best)
            qstate[m] = sub
    return qstate


def _nvfp4_headroom_refine(model_cfg, params, layout, qstate, batches, algo, dev):
    """NVFP4 activation global amax anchored at a percentile of the
    per-batch amaxes times a headroom factor (robust to one batch's
    outliers); the percentile is numpy's, on the host, as JAX's."""
    pct, headroom = _opt(algo, "percentile", 99.0), _opt(algo, "headroom", 1.5)
    per_batch: dict[str, list] = {}
    fresh = llama.init_quant_state(model_cfg, layout, dev)
    for b in batches:
        qs_b = llama.forward(model_cfg, params, b, layout=layout, qstate=fresh, calib=True)[1]
        for name, sub in qs_b.items():
            if isinstance(sub, dict) and "input" in sub and sub["input"].amax is not None:
                per_batch.setdefault(name, []).append(sub["input"].amax.cpu().numpy())
    qstate = dict(qstate)
    for name, vals in per_batch.items():
        icfg = layout.get(f"{name}.input")
        if not (icfg.enable and icfg.block is not None and icfg.block.scale_bits):
            continue  # only two-level (NVFP4-style) activation sites
        anchored = np.percentile(np.stack(vals), pct, axis=0) * headroom
        sub = dict(qstate.get(name, {}))
        sub["input"] = sub.get("input", Q.QuantizerState()).replace(
            amax=torch.as_tensor(np.asarray(anchored, np.float32), device=dev))
        qstate[name] = sub
    return qstate


def _local_hessian_refine(model_cfg, params, layout, qstate, batches, capture_tokens):
    """Hessian-weighted per-(row, block) amax refinement of INT block weights."""
    _, _, samples = _capture_stats(model_cfg, params, layout, qstate, batches, capture_tokens)
    qstate = dict(qstate)
    for cap_key, members in CAPTURE_GROUPS.items():
        if cap_key not in samples:
            continue
        for m in members:
            wcfg = layout.get(f"{m}.weight")
            base = wcfg.sequential[0] if wcfg.sequential else wcfg
            if not wcfg.enable or base.is_fp or base.block is None:
                continue
            w = params["layers"][m]
            bsz = min(dict(base.block.sizes).get(-1, 128), w.shape[-1])
            st = qstate.get(m, {}).get("weight")
            if st is None or st.amax is None:
                continue
            amax0 = st.amax[0] if isinstance(st.amax, tuple) else st.amax

            def qa(wx, amax_full, b=base.num_bits):
                return numerics.fake_quant_int(wx, amax_full, b)

            best = torch.stack([mse_mod.local_hessian_amax_search(samples[cap_key][i], w[i], amax0[i], qa, bsz)
                                for i in range(w.shape[0])])
            sub = dict(qstate.get(m, {}))
            sub["weight"] = _refined(st, best)
            qstate[m] = sub
    return qstate


def _mse_refine_weights(model_cfg, params, layout, qstate):
    """Per-weight amax MSE sweep, one ratio a layer (the weights are their
    own calibration data)."""
    qstate = dict(qstate)
    for name in llama.PROJ_NAMES:
        wcfg = layout.get(f"{name}.weight")
        base = wcfg.sequential[0] if wcfg.sequential else wcfg
        if not wcfg.enable or base.dynamic or (base.block and base.block.dynamic):
            continue
        sub = dict(qstate.get(name, {}))
        st = sub.get("weight")
        if st is None or st.amax is None:
            continue
        w = params["layers"][name]
        amax0 = st.amax[0] if isinstance(st.amax, tuple) else st.amax
        if base.is_fp:
            e, mb = base.num_bits
            qfn = lambda wx, am: numerics.fake_quant_fp(wx, am, e, mb)  # noqa: E731
        else:
            qfn = lambda wx, am, b=base.num_bits: numerics.fake_quant_int(wx, am, b)  # noqa: E731
        if base.block is not None and base.block.sizes:
            expand = lambda am, shape=tuple(w.shape[1:]), s=base.block.sizes: (  # noqa: E731
                numerics.expand_block_scale(am, shape, s))
        else:
            expand = lambda am: am  # noqa: E731
        best = torch.stack([mse_mod.mse_amax_search(w[i], amax0[i], qfn, expand) for i in range(w.shape[0])])
        sub["weight"] = _refined(st, best)
        qstate[name] = sub
    return qstate


# --------------------------------------------------------------------------
# Introspection
# --------------------------------------------------------------------------


def print_quant_summary(model: QuantizedModel) -> str:
    """Per-site format summary (`mtq.print_quant_summary`)."""
    lines = []
    for site, cfg in model.layout.sites:
        if not cfg.enable:
            continue
        bits = cfg.num_bits if not cfg.sequential else [c.num_bits for c in cfg.sequential]
        lines.append(f"{site:48s} bits={bits} axis={cfg.axis} block={cfg.block and dict(cfg.block.sizes)} "
                     f"dyn={cfg.dynamic or bool(cfg.block and cfg.block.dynamic)}")
    text = "\n".join(lines)
    print(text)
    return text
