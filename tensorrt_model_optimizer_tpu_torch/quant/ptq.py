"""PTQ orchestration, max calibration (port of `quant/ptq.py`).

`quantize` builds the site layout and state, then calibrates: weights-only
(no batches) collects each projection's weight amax directly; with batches,
one calibration forward per batch collects weight, activation and KV amax.
The other algorithms (AWQ, SmoothQuant, GPTQ, MSE, ...) raise
`NotImplementedError`: they come with the calibration-algorithms slice.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterable, Optional

import torch

from .. import resolve_device
from ..models import llama
from . import quantizer as Q
from .config import QuantizeConfig, get_preset


@dataclasses.dataclass
class QuantizedModel:
    """Params + layout + calibrated state (the converted model's handle)."""

    model_cfg: llama.LlamaConfig
    params: llama.Params
    layout: llama.QuantLayout
    qstate: llama.QuantState
    quant_cfg: QuantizeConfig

    def forward(self, tokens, **kw):
        return llama.forward(self.model_cfg, self.params, tokens,
                             layout=self.layout, qstate=self.qstate, **kw)


def _method_of(algo) -> str:
    if algo is None:
        return "max"
    if isinstance(algo, str):
        return algo
    return algo.get("method", "max")


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


@torch.no_grad()
def quantize(model_cfg: llama.LlamaConfig, params: llama.Params,
             quant_cfg: QuantizeConfig | str,
             calib_batches: Optional[Iterable[torch.Tensor]] = None,
             device=None) -> QuantizedModel:
    """Quantize: build sites, run max calibration, return the handle.

    `calib_batches`: token tensors [B, T]. Weight-only configs need none.
    `device` is where the state lives; it must be where `params` are.
    """
    dev = resolve_device(device)
    qcfg = get_preset(quant_cfg) if isinstance(quant_cfg, str) else quant_cfg
    method = _method_of(qcfg.algorithm)
    if method != "max":
        raise NotImplementedError(
            f"{method!r} calibration comes with the calibration-algorithms slice; "
            "this port has max calibration")
    layout = llama.build_layout(model_cfg, qcfg)
    qstate = llama.init_quant_state(model_cfg, layout, dev)
    batches = list(calib_batches) if calib_batches is not None else []
    if batches:
        for b in batches:
            _, new_qs, _ = llama.forward(model_cfg, params, b.to(dev), layout=layout,
                                         qstate=qstate, calib=True)
            qstate = _merge_states(qstate, new_qs)
    else:
        qstate = _weights_only_calibrate(model_cfg, params, layout, qstate)
    for msg in _validate(qstate):
        warnings.warn(f"quantizer validation: {msg}")
    return QuantizedModel(model_cfg, params, layout, qstate, qcfg)


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
