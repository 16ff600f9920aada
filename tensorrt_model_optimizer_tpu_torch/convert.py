"""Carry weights and quantized models across from the JAX package.

`params_from_jax` turns a parameter tree (arrays anywhere numpy can read,
e.g. `jax.tree.map(np.asarray, params)`) into the port's tensors;
`quantized_from_jax` turns a JAX `QuantizedModel` (`ptq.quantize`'s output,
any calibration algorithm's: sequential amax tuples, pre_quant_scale, the
affine KV bias and SVDQuant's adapters come along) into the port's; `compressed_from_jax` turns a JAX `CompressedModel` (canonical kinds, as
`quant.compress.compress` returns them) into the port's, so both packages
compute the same function (the quantizer state comes along, the `k_bmm` /
`v_bmm` amax of a KV preset included); `cache_from_jax` and `paged_from_jax`
do the same for a dense cache (either engine's layout) and a `PagedKV` pool. Objects are read
by their fields: this module imports neither JAX nor the JAX package.

bf16 and fp8 arrays (NVFP4's e4m3 block scales among them) reach numpy as
`ml_dtypes` types, which `torch.from_numpy` rejects; they cross as a
same-width integer view and are viewed back as the torch dtype, bit for bit.
MXFP4's int8 exponents and the f32 global scales cross as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.llama import LlamaConfig, QuantLayout, RopeScaling
from .ops.formats import BlockSpec
from .quant.compress import CompressedModel
from .quant.quantizer import QuantizerConfig, QuantizerState

_VIEWS = {  # numpy dtype name -> (integer view, torch dtype)
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def torch_dtype(d) -> torch.dtype:
    """A JAX/numpy dtype (or scalar type) -> the torch dtype."""
    name = np.dtype(d).name
    if name in _VIEWS:
        return _VIEWS[name][1]
    return torch.from_numpy(np.zeros((), dtype=np.dtype(d))).dtype


def tensor_from_array(a, device="cpu") -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name in _VIEWS:
        view, tdt = _VIEWS[arr.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(arr).view(view).copy()).view(tdt).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree, device="cpu"):
    """Nested dicts/lists/tuples of arrays -> the same structure of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    if tree is None or isinstance(tree, (int, float, str, bool)):
        return tree
    if type(tree).__name__ == "QuantizerState":
        return QuantizerState(amax=params_from_jax(tree.amax, device),
                              pre_quant_scale=params_from_jax(tree.pre_quant_scale, device),
                              bias=params_from_jax(tree.bias, device))
    return tensor_from_array(tree, device)


def _block(b):
    if b is None:
        return None
    return BlockSpec(sizes=tuple(b.sizes), scale_bits=b.scale_bits,
                     scale_block_sizes=b.scale_block_sizes, dynamic=b.dynamic)


def quantizer_cfg_from_jax(c) -> QuantizerConfig:
    kw = {f.name: getattr(c, f.name) for f in dataclasses.fields(QuantizerConfig)}
    kw["block"] = _block(c.block)
    if c.sequential:
        kw["sequential"] = tuple(quantizer_cfg_from_jax(s) for s in c.sequential)
    return QuantizerConfig(**kw)


def layout_from_jax(layout) -> QuantLayout:
    return QuantLayout(sites=tuple((k, quantizer_cfg_from_jax(v)) for k, v in layout.sites))


def llama_cfg_from_jax(cfg) -> LlamaConfig:
    for flag in ("attention_bias", "qk_norm", "clip_qkv"):
        if getattr(cfg, flag, None):
            raise NotImplementedError(f"LlamaConfig.{flag} comes with a later slice")
    if getattr(cfg, "norm_type", "rmsnorm") != "rmsnorm":
        raise NotImplementedError("layernorm blocks come with a later slice")
    rs = cfg.rope_scaling
    if rs is not None:
        if rs.rope_type != "llama3":
            raise NotImplementedError(f"rope_scaling {rs.rope_type!r} comes with the MoE-families slice")
        rs = RopeScaling(rope_type=rs.rope_type, factor=rs.factor, low_freq_factor=rs.low_freq_factor,
                         high_freq_factor=rs.high_freq_factor,
                         original_max_position_embeddings=rs.original_max_position_embeddings)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(LlamaConfig)
          if f.name not in ("rope_scaling", "dtype")}
    return LlamaConfig(rope_scaling=rs, dtype=torch_dtype(cfg.dtype), **kw)


def quantized_from_jax(qm, device="cpu"):
    """A JAX `QuantizedModel` (`quant.ptq.quantize`'s output: raw weights,
    layout, calibrated state, the config) -> the port's, on `device`."""
    from .quant.config import QuantizeConfig
    from .quant.ptq import QuantizedModel

    qc = qm.quant_cfg
    return QuantizedModel(
        model_cfg=llama_cfg_from_jax(qm.model_cfg),
        params=params_from_jax(qm.params, device),
        layout=layout_from_jax(qm.layout),
        qstate=params_from_jax(qm.qstate, device),
        quant_cfg=QuantizeConfig(rules=tuple((p, quantizer_cfg_from_jax(c)) for p, c in qc.rules),
                                 algorithm=qc.algorithm),
        adapters=params_from_jax(qm.adapters, device),
    )


def compressed_from_jax(cm, device="cpu") -> CompressedModel:
    """A JAX `CompressedModel` -> the port's, on `device`."""
    for name, kind in cm.kinds.items():
        if kind not in ("int4", "nvfp4", "mxfp4", "int8", "fp8", "bf16"):
            raise NotImplementedError(
                f"{name}: JAX kind {kind!r} is a TPU serving layout; pass the model as "
                "`quant.compress.compress` returns it (canonical packs)")
    params = params_from_jax(cm.params, device)
    params["layers"].pop("__adapters__", None)  # JAX's copy of the adapters for its layer scan
    return CompressedModel(
        model_cfg=llama_cfg_from_jax(cm.model_cfg),
        params=params,
        kinds=dict(cm.kinds),
        layout=layout_from_jax(cm.layout),
        qstate=params_from_jax(cm.qstate, device),
        adapters=params_from_jax(cm.adapters, device),
    )


def cache_from_jax(cache, device="cpu") -> dict:
    """A JAX dense cache -> the port's: the einsum engine's ("k", "v" [L, B,
    S, n_kv, C], packed NVFP4 as one uint8 row of 9 hd/16 bytes) or the kernel
    engine's ("k", "v" [L, B, n_kv, S, C] and, for NVFP4, "ks", "vs"), and
    "pos", a 0-d int32 tensor on `device` as JAX's is. fp8 rows cross as
    integer views, bit for bit."""
    return {k: (torch.tensor(int(v), dtype=torch.int32, device=device) if k == "pos"
                else tensor_from_array(v, device)) for k, v in cache.items()}


def paged_from_jax(cache, device="cpu"):
    """A JAX `PagedKV` -> the port's, on `device`."""
    from .serve.paged_cache import PagedKV

    return PagedKV(**{f.name: (None if getattr(cache, f.name) is None
                               else tensor_from_array(getattr(cache, f.name), device))
                      for f in dataclasses.fields(PagedKV)})
