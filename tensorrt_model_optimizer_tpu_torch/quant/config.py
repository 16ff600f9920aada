"""Quantization configs: ordered wildcard rules + presets (port of
`quant/config.py`).

A `QuantizeConfig` maps wildcard patterns over quantizer-site names to
`QuantizerConfig`s, last matching rule winning, plus a calibration algorithm.
The presets keep their JAX names and fields, the calibration-algorithm
presets (SmoothQuant, AWQ, GPTQ, local Hessian, SVDQuant, NVFP4 activation
headroom, the affine FP8 KV cache) among them. A preset whose format this
port does not have yet (MXFP6, MXFP8, NF4) raises `NotImplementedError`
naming the slice that brings it, both through `get_preset` and as a module
attribute.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, Mapping, Optional, Union

from ..ops.formats import BlockSpec
from .quantizer import DISABLED, QuantizerConfig

AlgorithmSpec = Union[str, dict, None]


@dataclasses.dataclass(frozen=True)
class QuantizeConfig:
    """Top-level PTQ config: ordered (pattern -> quantizer cfg) rules."""

    rules: tuple[tuple[str, QuantizerConfig], ...]
    algorithm: AlgorithmSpec = "max"

    def resolve(self, site: str) -> QuantizerConfig:
        """The effective config for one site name (last matching rule wins)."""
        cfg = DISABLED
        for pattern, rule_cfg in self.rules:
            if _match(pattern, site):
                cfg = rule_cfg
        return cfg

    def with_rules(self, extra: Mapping[str, Any]) -> "QuantizeConfig":
        return QuantizeConfig(
            rules=self.rules + tuple((p, _coerce(c)) for p, c in extra.items()),
            algorithm=self.algorithm,
        )

    def replace(self, **kw) -> "QuantizeConfig":
        return dataclasses.replace(self, **kw)


def _match(pattern: str, site: str) -> bool:
    if any(c in pattern for c in "*?["):
        return fnmatch.fnmatch(site, pattern)
    return pattern == site


def _coerce(c: Any) -> QuantizerConfig:
    if isinstance(c, QuantizerConfig):
        return c
    if isinstance(c, dict):
        d = dict(c)
        if "block_sizes" in d:
            d["block"] = BlockSpec.from_dict(d.pop("block_sizes"))
        if d.pop("enable", True) is False:
            return DISABLED
        if d.get("type") == "dynamic":
            d.pop("type")
            d["dynamic"] = True
        return QuantizerConfig(**d)
    raise TypeError(f"cannot coerce {type(c)} to QuantizerConfig")


def make_config(quant_cfg: Mapping[str, Any], algorithm: AlgorithmSpec = "max") -> QuantizeConfig:
    """Build a QuantizeConfig from a reference-style dict of wildcard rules."""
    return QuantizeConfig(
        rules=tuple((p, _coerce(c)) for p, c in quant_cfg.items()),
        algorithm=algorithm,
    )


# Numerics units (the JAX package's names)
INT8_PER_CHANNEL = QuantizerConfig(num_bits=8, axis=(0,))
INT8_PER_TENSOR = QuantizerConfig(num_bits=8)
INT8_PER_TOKEN_DYNAMIC = QuantizerConfig(num_bits=8, dynamic=True, per_token=True)
INT4_PER_BLOCK_128 = QuantizerConfig(num_bits=4, block=BlockSpec(sizes=((-1, 128),)))
FP8_PER_TENSOR = QuantizerConfig(num_bits=(4, 3))
FP8_PER_CHANNEL = QuantizerConfig(num_bits=(4, 3), axis=(0,))
FP8_PER_TOKEN_DYNAMIC = QuantizerConfig(num_bits=(4, 3), dynamic=True, per_token=True)
FP8_2D_BLOCKWISE_128 = QuantizerConfig(num_bits=(4, 3), block=BlockSpec(sizes=((-2, 128), (-1, 128))))
FP8_KV = QuantizerConfig(num_bits=(4, 3))
FP8_KV_CAST = QuantizerConfig(num_bits=(4, 3), constant_amax=448.0)
W4A8_SEQUENTIAL = QuantizerConfig(sequential=(INT4_PER_BLOCK_128, FP8_PER_TENSOR))
NVFP4_BLOCK16 = QuantizerConfig(
    num_bits=(2, 1), block=BlockSpec(sizes=((-1, 16),), scale_bits=(4, 3), dynamic=True))
MXFP4_BLOCK32 = QuantizerConfig(
    num_bits=(2, 1), block=BlockSpec(sizes=((-1, 32),), scale_bits=(8, 0), dynamic=True))

# Sites disabled in every preset (`units/default_disabled_quantizers.yaml`)
_DEFAULT_DISABLED = {
    "*lm_head*": DISABLED,
    "*output_layer*": DISABLED,
    "*router*": DISABLED,
    "*gate.*": DISABLED,
    "*mlp.gate.*": DISABLED,
    "*embed*": DISABLED,
    "*final_layernorm*": DISABLED,
}


def _preset(weight: QuantizerConfig, act: Optional[QuantizerConfig], algorithm) -> QuantizeConfig:
    rules: dict[str, Any] = {
        "*weight_quantizer": weight,
        "*input_quantizer": act if act is not None else DISABLED,
        "*output_quantizer": DISABLED,
        "*q_bmm_quantizer": DISABLED,
        "*k_bmm_quantizer": DISABLED,
        "*v_bmm_quantizer": DISABLED,
        "*softmax_quantizer": DISABLED,
    }
    rules.update(_DEFAULT_DISABLED)
    return make_config(rules, algorithm)


INT8_DEFAULT_CFG = _preset(INT8_PER_CHANNEL, INT8_PER_TENSOR, "max")
# "auto": the SmoothQuant flavor with the least calibration KL (`quant.ptq`);
# {"method": "smoothquant", "alpha": 1.0} is the reference's default
INT8_SMOOTHQUANT_CFG = _preset(INT8_PER_CHANNEL.replace(), INT8_PER_TENSOR.replace(pre_quant_scale=True),
                               {"method": "smoothquant", "alpha": "auto"})
FP8_DEFAULT_CFG = _preset(FP8_PER_TENSOR, FP8_PER_TENSOR, "max")
FP8_PER_CHANNEL_PER_TOKEN_CFG = _preset(FP8_PER_CHANNEL, FP8_PER_TOKEN_DYNAMIC, "max")
FP8_2D_BLOCKWISE_WEIGHT_ONLY_CFG = _preset(FP8_2D_BLOCKWISE_128, None, "max")
INT4_BLOCKWISE_WEIGHT_ONLY_CFG = _preset(INT4_PER_BLOCK_128, None, "max")
INT4_AWQ_CFG = _preset(INT4_PER_BLOCK_128, None, {"method": "awq_lite", "alpha_step": 0.1})
INT4_GPTQ_CFG = _preset(INT4_PER_BLOCK_128, None, {"method": "gptq", "block_size": 128})
INT4_LOCAL_HESSIAN_CFG = _preset(INT4_PER_BLOCK_128, None, {"method": "local_hessian"})
INT4_SVDQUANT_CFG = _preset(INT4_PER_BLOCK_128, None, {"method": "svdquant", "rank": 16})
NVFP4_SVDQUANT_CFG = _preset(NVFP4_BLOCK16, NVFP4_BLOCK16, {"method": "svdquant", "rank": 32})
W4A8_AWQ_BETA_CFG = _preset(W4A8_SEQUENTIAL, FP8_PER_TENSOR, {"method": "awq_lite", "alpha_step": 0.1})
NVFP4_DEFAULT_CFG = _preset(NVFP4_BLOCK16, NVFP4_BLOCK16, "max")
NVFP4_WEIGHT_ONLY_CFG = _preset(NVFP4_BLOCK16, None, "max")
NVFP4_AWQ_LITE_CFG = _preset(NVFP4_BLOCK16, NVFP4_BLOCK16, {"method": "awq_lite", "alpha_step": 0.1})
NVFP4_ACT_HEADROOM_CFG = _preset(NVFP4_BLOCK16, NVFP4_BLOCK16,
                                 {"method": "nvfp4_act_headroom", "percentile": 99.0, "headroom": 1.5})
W4A16_NVFP4_CFG = NVFP4_WEIGHT_ONLY_CFG
MXFP4_DEFAULT_CFG = _preset(MXFP4_BLOCK32, MXFP4_BLOCK32, "max")
MXFP4_WEIGHT_ONLY_CFG = _preset(MXFP4_BLOCK32, None, "max")

KV_FP8_RULES = {"*k_bmm_quantizer": FP8_KV, "*v_bmm_quantizer": FP8_KV}
KV_FP8_CAST_RULES = {"*k_bmm_quantizer": FP8_KV_CAST, "*v_bmm_quantizer": FP8_KV_CAST}
KV_NVFP4_RULES = {"*k_bmm_quantizer": NVFP4_BLOCK16, "*v_bmm_quantizer": NVFP4_BLOCK16}
KV_INT8_RULES = {"*k_bmm_quantizer": INT8_PER_TENSOR, "*v_bmm_quantizer": INT8_PER_TENSOR}
# affine variant: a calibrated midrange bias and the centered amax
FP8_KV_AFFINE = dataclasses.replace(FP8_KV, bias_corr=True)
KV_FP8_AFFINE_RULES = {"*k_bmm_quantizer": FP8_KV_AFFINE, "*v_bmm_quantizer": FP8_KV_AFFINE}
FP8_KV_CFG = FP8_DEFAULT_CFG.with_rules(KV_FP8_RULES)
FP8_KV_AFFINE_CFG = FP8_DEFAULT_CFG.with_rules(KV_FP8_AFFINE_RULES)
NVFP4_KV_CFG = NVFP4_DEFAULT_CFG.with_rules(KV_NVFP4_RULES)
INT4_AWQ_KV_FP8_CFG = INT4_AWQ_CFG.with_rules(KV_FP8_RULES)

PRESETS: dict[str, QuantizeConfig] = {
    "INT8_DEFAULT_CFG": INT8_DEFAULT_CFG,
    "INT8_SMOOTHQUANT_CFG": INT8_SMOOTHQUANT_CFG,
    "FP8_DEFAULT_CFG": FP8_DEFAULT_CFG,
    "FP8_PER_CHANNEL_PER_TOKEN_CFG": FP8_PER_CHANNEL_PER_TOKEN_CFG,
    "FP8_2D_BLOCKWISE_WEIGHT_ONLY_CFG": FP8_2D_BLOCKWISE_WEIGHT_ONLY_CFG,
    "INT4_BLOCKWISE_WEIGHT_ONLY_CFG": INT4_BLOCKWISE_WEIGHT_ONLY_CFG,
    "INT4_AWQ_CFG": INT4_AWQ_CFG,
    "INT4_GPTQ_CFG": INT4_GPTQ_CFG,
    "INT4_LOCAL_HESSIAN_CFG": INT4_LOCAL_HESSIAN_CFG,
    "INT4_SVDQUANT_CFG": INT4_SVDQUANT_CFG,
    "NVFP4_SVDQUANT_CFG": NVFP4_SVDQUANT_CFG,
    "W4A8_AWQ_BETA_CFG": W4A8_AWQ_BETA_CFG,
    "NVFP4_DEFAULT_CFG": NVFP4_DEFAULT_CFG,
    "NVFP4_WEIGHT_ONLY_CFG": NVFP4_WEIGHT_ONLY_CFG,
    "NVFP4_AWQ_LITE_CFG": NVFP4_AWQ_LITE_CFG,
    "NVFP4_ACT_HEADROOM_CFG": NVFP4_ACT_HEADROOM_CFG,
    "NVFP4_KV_CFG": NVFP4_KV_CFG,
    "W4A16_NVFP4_CFG": W4A16_NVFP4_CFG,
    "MXFP4_DEFAULT_CFG": MXFP4_DEFAULT_CFG,
    "MXFP4_WEIGHT_ONLY_CFG": MXFP4_WEIGHT_ONLY_CFG,
    "FP8_KV_CFG": FP8_KV_CFG,
    "FP8_KV_AFFINE_CFG": FP8_KV_AFFINE_CFG,
    "INT4_AWQ_KV_FP8_CFG": INT4_AWQ_KV_FP8_CFG,
}

# JAX presets whose format is not ported yet, with the slice that brings
# each (ROADMAP.md queue 1)
UNPORTED_PRESETS: dict[str, str] = {
    "MXFP6_DEFAULT_CFG": "the remaining-formats slice (MXFP6 packs)",
    "MXFP8_DEFAULT_CFG": "the remaining-formats slice (MXFP8 packs)",
    "NF4_WEIGHT_ONLY_CFG": "the remaining-formats slice (NF4)",
}


def _unported(name: str) -> NotImplementedError:
    return NotImplementedError(f"preset {name} is not ported yet: it comes with {UNPORTED_PRESETS[name]}")


def __getattr__(name: str):
    if name in UNPORTED_PRESETS:
        raise _unported(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def choices() -> list[str]:
    return sorted(PRESETS)


def get_preset(name) -> QuantizeConfig:
    if isinstance(name, QuantizeConfig):
        return name
    if name in UNPORTED_PRESETS:
        raise _unported(name)
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; choices: {choices()}")
    return PRESETS[name]
