"""Model registry (port of `models/registry.py`): architecture names (HF
`model_type`) -> the port's model modules, so a registered family goes
through the whole pipeline (PTQ, export, serving).

`llama` (llama, qwen2, qwen3, mistral) and `mixtral` (mixtral, qwen3_moe,
dbrx) are registered as in JAX. JAX's other families are not ported yet:
`get` and `for_hf_model_type` raise `NotImplementedError` naming the
ROADMAP item that brings each.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    config_cls: type
    init_params: Callable
    forward: Callable
    build_layout: Callable
    init_quant_state: Callable
    param_specs: Optional[Callable] = None
    hf_model_types: tuple[str, ...] = ()


_REGISTRY: dict[str, ModelFamily] = {}

# JAX's families the port does not have yet: name -> (HF model types, what brings it)
NOT_PORTED = {
    "llama4": (("llama4", "llama4_text"), "ROADMAP queue 1 item 5 (Llama4: chunked attention, shared expert)"),
    "gpt_oss": (("gpt_oss",), "ROADMAP queue 1 item 5 (GPT-OSS: sinks, sliding windows)"),
    "mamba": (("nemotron_h", "mamba2"), "ROADMAP queue 1 item 10 (models/mamba.py)"),
    "dit": ((), "ROADMAP queue 1 item 10 (models/dit.py)"),
}


def register(family: ModelFamily) -> ModelFamily:
    if family.name in _REGISTRY:
        raise ValueError(f"model family {family.name!r} already registered")
    _REGISTRY[family.name] = family
    return family


def get(name: str) -> ModelFamily:
    if name in NOT_PORTED and name not in _REGISTRY:
        raise NotImplementedError(f"model family {name!r} is not ported yet: {NOT_PORTED[name][1]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown model family {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def for_hf_model_type(model_type: str) -> ModelFamily:
    for fam in _REGISTRY.values():
        if model_type in fam.hf_model_types:
            return fam
    for name, (types, item) in NOT_PORTED.items():
        if model_type in types:
            raise NotImplementedError(f"model_type {model_type!r} ({name}) is not ported yet: {item}")
    raise KeyError(f"no registered family handles model_type={model_type!r}")


def families() -> list[str]:
    return sorted(_REGISTRY)


def _register_builtins():
    from . import llama as llama_mod
    from . import mixtral as mixtral_mod

    register(ModelFamily(
        name="llama", config_cls=llama_mod.LlamaConfig, init_params=llama_mod.init_params,
        forward=llama_mod.forward, build_layout=llama_mod.build_layout,
        init_quant_state=llama_mod.init_quant_state, param_specs=llama_mod.param_specs,
        hf_model_types=("llama", "qwen2", "qwen3", "mistral")))
    register(ModelFamily(
        name="mixtral", config_cls=mixtral_mod.MixtralConfig, init_params=mixtral_mod.init_params,
        forward=mixtral_mod.forward, build_layout=mixtral_mod.build_layout,
        init_quant_state=mixtral_mod.init_quant_state, param_specs=mixtral_mod.param_specs,
        hf_model_types=("mixtral", "qwen3_moe", "dbrx")))


_register_builtins()
