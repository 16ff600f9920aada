"""mtq-style API façade (port of `quant/api.py`): the reference's
`modelopt.torch.quantization` entry-point names mapped onto this port
(`quantize`, `calibrate`, `compress`, `fold_weight`, `disable_quantizer`,
`print_quant_summary`, `compute_quantization_mse`, `auto_quantize`)."""

from __future__ import annotations

import dataclasses
import fnmatch

import torch

from ..models import llama
from . import quantizer as Q
from .auto import auto_quantize  # noqa: F401
from .compress import compress  # noqa: F401
from .config import PRESETS, choices, get_preset, make_config  # noqa: F401
from .ptq import QuantizedModel, calibrate, print_quant_summary, quantize  # noqa: F401


def _quantized_weight(model: QuantizedModel, name: str, cfg: Q.QuantizerConfig) -> torch.Tensor:
    """The fake-quantized stacked weight of one projection, a layer at a time."""
    w = model.params["layers"][name]
    st = model.qstate.get(name, {}).get("weight")
    return torch.stack([Q.quantize(w[i], cfg, llama.slice_state(st, i)) for i in range(w.shape[0])])


@torch.no_grad()
def fold_weight(model: QuantizedModel) -> QuantizedModel:
    """Fold the fake-quantized weights into the params and disable the
    weight quantizers (`mtq.fold_weight`): the forward then runs plain
    matmuls on values already on the grid."""
    new_layers = dict(model.params["layers"])
    new_sites = []
    for site, cfg in model.layout.sites:
        if site.endswith(".weight") and cfg.enable and not site.startswith("lm_head"):
            name = site[: -len(".weight")]
            if name in new_layers and not isinstance(new_layers[name], dict):
                new_layers[name] = _quantized_weight(model, name, cfg).to(new_layers[name].dtype)
            new_sites.append((site, Q.DISABLED))
        else:
            new_sites.append((site, cfg))
    params = {**model.params, "layers": new_layers}
    return dataclasses.replace(model, params=params, layout=llama.QuantLayout(sites=tuple(new_sites)))


def disable_quantizer(model: QuantizedModel, pattern: str) -> QuantizedModel:
    """Disable the quantizers whose site matches a wildcard
    (`mtq.disable_quantizer`)."""
    sites = tuple((site, Q.DISABLED if fnmatch.fnmatch(site, pattern) else cfg) for site, cfg in model.layout.sites)
    return dataclasses.replace(model, layout=llama.QuantLayout(sites=sites))


@torch.no_grad()
def compute_quantization_mse(model: QuantizedModel) -> dict[str, float]:
    """Per projection: the mean squared error of its fake-quantized weight."""
    out = {}
    for name in llama.PROJ_NAMES:
        cfg = model.layout.get(f"{name}.weight")
        w = model.params["layers"][name]
        if not cfg.enable or isinstance(w, dict):
            continue
        q = _quantized_weight(model, name, cfg)
        out[name] = float(torch.mean((q.float() - w.float()) ** 2))
    return out
