"""Model registry (port of `models/registry.py`): architecture names (HF
`model_type`) -> the port's model modules, so a registered family goes
through the whole pipeline (PTQ, export, serving).

`llama` (llama, qwen2, qwen3, mistral), `mixtral` (mixtral, qwen3_moe,
dbrx), `llama4` (llama4, llama4_text), `gpt_oss`, `mamba` (nemotron_h,
mamba2) and `dit` (no HF model type) are registered as in JAX: every JAX
family is ported.
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


def register(family: ModelFamily) -> ModelFamily:
    if family.name in _REGISTRY:
        raise ValueError(f"model family {family.name!r} already registered")
    _REGISTRY[family.name] = family
    return family


def get(name: str) -> ModelFamily:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model family {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def for_hf_model_type(model_type: str) -> ModelFamily:
    for fam in _REGISTRY.values():
        if model_type in fam.hf_model_types:
            return fam
    raise KeyError(f"no registered family handles model_type={model_type!r}")


def families() -> list[str]:
    return sorted(_REGISTRY)


def _register_builtins():
    from . import dit as dit_mod
    from . import gpt_oss as gpt_oss_mod
    from . import llama as llama_mod
    from . import llama4 as llama4_mod
    from . import mamba as mamba_mod
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
    register(ModelFamily(
        name="llama4", config_cls=llama4_mod.Llama4Config, init_params=llama4_mod.init_params,
        forward=llama4_mod.forward, build_layout=llama4_mod.build_layout,
        init_quant_state=llama4_mod.init_quant_state, param_specs=llama4_mod.param_specs,
        hf_model_types=("llama4", "llama4_text")))
    register(ModelFamily(
        name="gpt_oss", config_cls=gpt_oss_mod.GptOssConfig, init_params=gpt_oss_mod.init_params,
        forward=gpt_oss_mod.forward, build_layout=gpt_oss_mod.build_layout,
        init_quant_state=gpt_oss_mod.init_quant_state, param_specs=gpt_oss_mod.param_specs,
        hf_model_types=("gpt_oss",)))
    register(ModelFamily(
        name="mamba", config_cls=mamba_mod.MambaConfig, init_params=mamba_mod.init_params,
        forward=mamba_mod.forward, build_layout=mamba_mod.build_layout,
        init_quant_state=mamba_mod.init_quant_state, param_specs=mamba_mod.param_specs,
        hf_model_types=("nemotron_h", "mamba2")))
    register(ModelFamily(
        name="dit", config_cls=dit_mod.DiTConfig, init_params=dit_mod.init_params, forward=dit_mod.forward,
        build_layout=dit_mod.build_layout, init_quant_state=dit_mod.init_quant_state, hf_model_types=()))


_register_builtins()
