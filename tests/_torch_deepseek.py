"""Shared helpers for the port's DeepSeek parity tests: the same seeded tiny
model (`DeepseekConfig.tiny()`, f32) in both packages, and its quantized
and packed forms, built once a process (JAX compiles each eager op of its
calibration and packing per shape: the files that hold both packages share
them)."""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import tree_map
from tensorrt_model_optimizer_tpu.models import deepseek as jds
from tensorrt_model_optimizer_tpu.serve import deepseek_engine as jdse
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import deepseek as tds

# the presets the DeepSeek path serves: INT4 and NVFP4 weight-only GEMMs
# (NVFP4 under its input quantizers: W4A4), the byte GEMM for FP8 and INT8
# (their static input quantizers), and the latent-cache sites (NVFP4_KV)
PRESETS = ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG", "INT8_DEFAULT_CFG",
           "NVFP4_KV_CFG")
TOKENS = np.random.default_rng(1).integers(0, 256, size=(2, 16)).astype(np.int32)  # calibration and prompts


def pair(seed: int = 0, **kw):
    """(JAX config, JAX params, port config, port params) of
    `DeepseekConfig.tiny(**kw)`: the port's seeded weights, with the norms
    1 + N(0, 0.1^2) and `e_bias` N(0, 0.05^2) (ones and zeros at init would
    leave them untested), the same values in both packages."""
    jcfg = jds.DeepseekConfig.tiny(**kw)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    tp = tds.init_params(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    for key in ("layers_dense", "layers_moe"):
        for name, t in tp.get(key, {}).items():
            if name == "moe.e_bias":
                tp[key][name] = torch.from_numpy((0.05 * rng.standard_normal(tuple(t.shape))).astype(np.float32))
            elif name.endswith(("norm", "layernorm")):
                tp[key][name] = torch.from_numpy((1 + 0.1 * rng.standard_normal(tuple(t.shape))).astype(np.float32))
    return jcfg, tree_map(lambda t: jnp.asarray(t.numpy()), tp), tcfg, tp


@functools.cache
def shared_pair():
    """The shared tiny model: seed 0."""
    return pair(0)


@functools.cache
def quantized(preset: str):
    """(JAX's, the port's) `deepseek.quantize` of `shared_pair()` under
    `preset`, calibrated on TOKENS."""
    jcfg, jp, tcfg, tp = shared_pair()
    jq = jds.quantize(jcfg, jp, preset, [jnp.asarray(TOKENS)])
    tq = tds.quantize(tcfg, tp, preset, [torch.from_numpy(TOKENS)], device="cpu")
    return jq, tq


@functools.cache
def jax_compressed(preset: str):
    """JAX's `deepseek_engine.compress` of `quantized(preset)`'s JAX model."""
    return jdse.compress(quantized(preset)[0])
