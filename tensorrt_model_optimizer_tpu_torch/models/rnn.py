"""Quantized recurrent networks, LSTM and GRU (port of `models/rnn.py`).

Each layer's input -> hidden (`layers.{i}.wx`) and hidden -> hidden
(`layers.{i}.wh`) projections carry a weight and an input quantizer. The
weights are fake-quantized once a forward, outside the time loop; the
input quantizer of `wx` calibrates and applies on the whole sequence (one
site), and the input projection is one GEMM over all B T rows before the
loop. The cells are JAX's formulas, not `nn.LSTM` / `nn.GRU`:

  LSTM: gates [i, f, g, o] = x Wx^T + h Wh^T + b, in f32;
        c = sig(f) c + sig(i) tanh(g), kept in f32; h = sig(o) tanh(c)
  GRU:  one bias, on the hidden side: [hr, hz, hn] = h Wh^T + b;
        r = sig(xr + hr), z = sig(xz + hz), n = tanh(xn + r hn),
        h = (1 - z) n + z h

The time loop is a Python loop (JAX's `lax.scan`). No TPU kernel runs on
this path in JAX; nothing here launches one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from .. import resolve_device
from ..quant import quantizer as Q
from ..quant.quantizer import QuantizerState
from .llama import QuantLayout


@dataclasses.dataclass(frozen=True)
class RNNConfig:
    input_size: int = 32
    hidden_size: int = 64
    num_layers: int = 2
    cell: str = "lstm"  # "lstm" | "gru"
    dtype: Any = torch.float32

    @property
    def gates(self) -> int:
        return 4 if self.cell == "lstm" else 3

    @staticmethod
    def tiny(**kw) -> "RNNConfig":
        base = dict(input_size=16, hidden_size=32, num_layers=2)
        base.update(kw)
        return RNNConfig(**base)


def init_params(cfg: RNNConfig, generator: torch.Generator, device=None) -> dict:
    """Seeded N(0, 1/fan_in) weights and zero biases on `device` (the card
    unless the caller passes the CPU; `generator` lives there)."""
    dev = resolve_device(device)
    G, H = cfg.gates, cfg.hidden_size
    params = {}
    for i in range(cfg.num_layers):
        d_in = cfg.input_size if i == 0 else H
        for name, fan in (("wx", d_in), ("wh", H)):
            w = torch.randn((G * H, fan), generator=generator, dtype=torch.float32, device=dev)
            params[f"layers.{i}.{name}"] = w.div_(math.sqrt(fan)).to(cfg.dtype)
        params[f"layers.{i}.bias"] = torch.zeros((G * H,), dtype=cfg.dtype, device=dev)
    return params


def build_layout(cfg: RNNConfig, qcfg) -> QuantLayout:
    sites = {}
    for i in range(cfg.num_layers):
        for w in ("wx", "wh"):
            name = f"layers.{i}.{w}"
            sites[f"{name}.weight"] = qcfg.resolve(f"{name}.weight_quantizer")
            sites[f"{name}.input"] = qcfg.resolve(f"{name}.input_quantizer")
    return QuantLayout(sites=tuple(sites.items()))


def _prep_weight(w, name, layout, lstate, calib, sub_out):
    wcfg = layout.get(f"{name}.weight")
    sub = dict((lstate or {}).get(name, {}))
    if wcfg.enable:
        st = sub.get("weight")
        if calib:
            sub["weight"] = Q.collect(w, wcfg, st if st is not None else QuantizerState())
        else:
            w = Q.quantize(w, wcfg, st)
    if sub:
        sub_out[name] = sub
    return w


def _prep_input(x, name, layout, lstate, calib, sub_out):
    icfg = layout.get(f"{name}.input")
    if not (icfg.enable or (lstate or {}).get(name, {}).get("input") is not None):
        return x
    sub = sub_out.setdefault(name, dict((lstate or {}).get(name, {})))
    st = sub.get("input")
    if calib:
        sub["input"] = Q.collect(x.reshape(-1, x.shape[-1]), icfg, st if st is not None else QuantizerState())
        return x
    return Q.quantize(x, icfg, st)


def _lstm(x_proj, wh, b, h, c):
    outs = []
    for xp in x_proj.unbind(1):
        g = (xp + h @ wh.t().to(h.dtype) + b.to(h.dtype)).float()
        ii, ff, gg, oo = torch.chunk(g, 4, dim=-1)
        c = torch.sigmoid(ff) * c + torch.sigmoid(ii) * torch.tanh(gg)
        h = (torch.sigmoid(oo) * torch.tanh(c)).to(xp.dtype)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def _gru(x_proj, wh, b, h):
    outs = []
    for xp in x_proj.unbind(1):
        hp = h @ wh.t().to(h.dtype) + b.to(h.dtype)
        xr, xz, xn = torch.chunk(xp.float(), 3, dim=-1)
        hr, hz, hn = torch.chunk(hp.float(), 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = ((1 - z) * n + z * h.float()).to(xp.dtype)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def forward(cfg: RNNConfig, params: dict, x: torch.Tensor, *, layout: Optional[QuantLayout] = None,
            qstate: Optional[dict] = None, calib: bool = False, h0: Optional[torch.Tensor] = None):
    """x [B, T, input_size] -> (outputs [B, T, H], final hidden [L, B, H],
    new_qstate or None)."""
    layout = layout or QuantLayout(sites=())
    B, T, _ = x.shape
    H = cfg.hidden_size
    sub_out: dict = {}
    seq = x.to(cfg.dtype)
    finals = []
    for i in range(cfg.num_layers):
        wx = _prep_weight(params[f"layers.{i}.wx"], f"layers.{i}.wx", layout, qstate, calib, sub_out)
        wh = _prep_weight(params[f"layers.{i}.wh"], f"layers.{i}.wh", layout, qstate, calib, sub_out)
        b = params[f"layers.{i}.bias"]
        seq = _prep_input(seq, f"layers.{i}.wx", layout, qstate, calib, sub_out)
        x_proj = (seq.reshape(B * T, -1) @ wx.t().to(seq.dtype)).reshape(B, T, -1)
        h = torch.zeros((B, H), dtype=cfg.dtype, device=x.device) if h0 is None else h0[i]
        if cfg.cell == "lstm":
            seq, hT = _lstm(x_proj, wh, b, h, torch.zeros((B, H), dtype=torch.float32, device=x.device))
        else:
            seq, hT = _gru(x_proj, wh, b, h)
        finals.append(hT)
    return seq, torch.stack(finals), (sub_out if sub_out else None)


def quantize_rnn(cfg: RNNConfig, params: dict, quant_cfg, calib_batches):
    """PTQ for RNNs: max calibration over input batches -> (layout, qstate)."""
    from ..quant.config import get_preset

    qcfg = get_preset(quant_cfg) if isinstance(quant_cfg, str) else quant_cfg
    layout = build_layout(cfg, qcfg)
    qstate: dict = {}
    with torch.no_grad():
        for x in calib_batches:
            qstate.update(forward(cfg, params, x, layout=layout, qstate=qstate or None, calib=True)[2] or {})
    return layout, qstate
