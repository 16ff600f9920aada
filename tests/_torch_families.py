"""Shared helpers for the port's GPT-OSS and Llama4 parity tests: the same
seeded tiny model in both packages, the calibrated state of two quantized
models side by side, and the shared models' quantized and packed forms,
built once a process (JAX's calibration and packing compile every op for
its shapes: the files that hold both packages at these shapes share them)."""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import gpt_oss as jgpt
from tensorrt_model_optimizer_tpu.models import llama4 as jl4
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import gpt_oss as tgpt
from tensorrt_model_optimizer_tpu_torch.models import llama4 as tl4
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq

# the shared models' widths: hidden and expert 128 (a whole INT4 block of K,
# which JAX's w48 kernel tiles), head_dim 32; no expert drops a token
SIZE = dict(hidden_size=128, intermediate_size=128, head_dim=32, capacity_factor=4.0)
# one calibration batch of the shared models
CALIB = [np.random.default_rng(1).integers(0, 256, size=(2, 16)).astype(np.int32)]


def gpt_oss_pair(seed: int = 0, **kw):
    """(JAX config, JAX params, port config, port params) of a tiny GPT-OSS
    (`GptOssConfig.tiny(**kw)`): the port's seeded weights, with the sinks
    N(0, 1) and every bias N(0, 0.5^2) (zeros at init would leave those
    paths untested), the same values in both packages."""
    jcfg = jgpt.GptOssConfig.tiny(**kw)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    tp = tgpt.init_params(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    for name, t in tp["layers"].items():
        if name == "self_attn.sinks" or name.endswith("__bias"):
            scale = 1.0 if name == "self_attn.sinks" else 0.5
            tp["layers"][name] = torch.from_numpy((scale * rng.standard_normal(tuple(t.shape))).astype(np.float32))
    return jcfg, tree_map(lambda t: jnp.asarray(t.numpy()), tp), tcfg, tp


def llama4_pair(seed: int = 0, **kw):
    """(JAX config, JAX params, port config, port params) of a tiny Llama4
    (`Llama4Config.tiny(**kw)`), the port's seeded weights in both."""
    jcfg = jl4.Llama4Config.tiny(**kw)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    tp = tl4.init_params(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    return jcfg, tree_map(lambda t: jnp.asarray(t.numpy()), tp), tcfg, tp


def _first(a):
    return a[0] if isinstance(a, tuple) else a


def state_errors(tq, jq) -> dict:
    """Relative error of every amax and pre_quant_scale of the port's
    quantized model against JAX's, by "site.which[.pqs]"; the two state
    trees must have the same sites."""
    assert set(tq.qstate) == set(jq.qstate)
    errs = {}
    for name, sub in tq.qstate.items():
        for which, st in sub.items() if isinstance(sub, dict) else [("", sub)]:
            j = jq.qstate[name][which] if which else jq.qstate[name]
            if st.amax is not None:
                errs[f"{name}.{which}"] = rel_err(_first(st.amax).numpy(), np.asarray(_first(j.amax)))
            if st.pre_quant_scale is not None:
                errs[f"{name}.{which}.pqs"] = rel_err(st.pre_quant_scale.numpy(), np.asarray(j.pre_quant_scale))
    return errs


def bits(a):
    """An array's bits as numpy (one-byte float forms as bytes, bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return (a.view(torch.uint8) if a.element_size() == 1 and a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


@functools.cache
def family_pair(family: str):
    """The shared tiny model of `family` ("gpt_oss" or "llama4"): seed 0 at SIZE."""
    return {"gpt_oss": gpt_oss_pair, "llama4": llama4_pair}[family](0, **SIZE)


@functools.cache
def quantized(family: str, preset: str):
    """(JAX's, the port's) `quantize_family` of `family_pair(family)` under
    `preset` on CALIB."""
    jcfg, jp, tcfg, tp = family_pair(family)
    jq = jptq.quantize_family(family, jcfg, jp, preset, [jnp.asarray(b) for b in CALIB])
    tq = tptq.quantize_family(family, tcfg, tp, preset, [torch.from_numpy(b) for b in CALIB], device="cpu")
    return jq, tq


@functools.cache
def jax_compressed(family: str, preset: str):
    """JAX's `compress` of `quantized(family, preset)`'s JAX model."""
    return jcompress.compress(quantized(family, preset)[0])
