"""Carry weights and quantized models across from the JAX package.

`params_from_jax` turns a parameter tree (arrays anywhere numpy can read,
e.g. `jax.tree.map(np.asarray, params)`) into the port's tensors;
`quantized_from_jax` turns a JAX `QuantizedModel` (`ptq.quantize`'s output,
any calibration algorithm's: sequential amax tuples, pre_quant_scale, the
affine KV bias and SVDQuant's adapters come along; the GPT-OSS and Llama4 leaves, sinks,
biases and the shared expert, are layer leaves like any other) into the
port's; `compressed_from_jax` turns a JAX `CompressedModel` (canonical kinds, as
`quant.compress.compress` returns them) into the port's, so both packages
compute the same function (the quantizer state comes along, the `k_bmm` /
`v_bmm` amax of a KV preset included); `cache_from_jax` and `paged_from_jax`
do the same for a dense cache (either engine's layout) and a `PagedKV` pool. JAX's
DeepSeek models cross the same way: `DeepseekConfig` (the port's
`softmax_scale_factor` at its default, JAX's scale), `DeepseekQuantizedModel`
and `DeepseekCompressedModel` (both layer groups, the experts' stacks,
`e_bias` in f32). `drafts_from_jax` carries the speculative drafts (Medusa
heads, EAGLE-1 / EAGLE-3 drafts, DFlash blocks), `adapters_from_jax` LoRA
adapters; a layout's `learn_amax` flags and a trained quantizer state cross
with `quantized_from_jax` / `layout_from_jax` / `params_from_jax` as any
other field and tensor do, and so do sparsity masks (`params_from_jax` of
JAX's bool masks gives the port's). Minitron's importance scores and plans
are numpy in both packages and need no conversion. The diffusion, VLM, RNN and
CV families cross with their configs (`dit_cfg_from_jax`,
`unet_cfg_from_jax`, `vlm_cfg_from_jax`, `rnn_cfg_from_jax`,
`cv_cfg_from_jax`), and so does the hybrid Mamba family
(`mamba_cfg_from_jax`, `quantized_from_jax` of a `MambaQuantizedModel`,
`cache_from_jax` of its cache), `params_from_jax` (DiT's and the ViT's stacked `[depth,
...]` blocks, the UNet's, RNN's, CV model's and DMD discriminator's flat
dicts) and `params_from_jax` / `layout_from_jax` for the calibrated state,
stacked as JAX's scan carries it. Objects are read by their
fields: this module imports neither JAX nor the JAX package.

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


def drafts_from_jax(draft: dict, device="cpu") -> dict:
    """A JAX speculative draft's parameter tree (`init_medusa`, `init_eagle`,
    `init_eagle3`, `init_dflash` or a train step's output) -> the port's, on
    `device`. EAGLE-3's `aux_layer_ids` stays a tuple of ints (JAX's jitted
    train step hands them back as arrays)."""
    out = params_from_jax(draft, device)
    if "aux_layer_ids" in draft:
        out["aux_layer_ids"] = tuple(int(i) for i in np.asarray(draft["aux_layer_ids"]).reshape(-1))
    return out


def adapters_from_jax(adapters, device="cpu") -> dict:
    """JAX LoRA adapters (`peft.lora.init_adapters` or a train step's
    output: {proj: {"A" [L, r, d_in], "B" [L, d_out, r], "scale" [L]}}) ->
    the port's tensors on `device`, dtypes kept (bf16 bit for bit)."""
    return params_from_jax(adapters, device)


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
    """A JAX LlamaConfig, MixtralConfig, GptOssConfig, Llama4Config or
    DeepseekConfig -> the port's class of the same name (every field
    carried, the dtype as the torch dtype; a field the JAX class lacks, as
    DeepSeek's `softmax_scale_factor`, keeps the port's default)."""
    from .models.deepseek import DeepseekConfig
    from .models.gpt_oss import GptOssConfig
    from .models.llama4 import Llama4Config
    from .models.mixtral import MixtralConfig

    by_name = {c.__name__: c for c in (GptOssConfig, Llama4Config, DeepseekConfig)}
    cls = by_name.get(type(cfg).__name__, MixtralConfig if hasattr(cfg, "num_experts") else LlamaConfig)
    rs = cfg.rope_scaling
    if rs is not None:
        rs = RopeScaling(**{f.name: getattr(rs, f.name) for f in dataclasses.fields(RopeScaling)})
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)
          if f.name not in ("rope_scaling", "dtype") and hasattr(cfg, f.name)}
    return cls(rope_scaling=rs, dtype=torch_dtype(cfg.dtype), **kw)


def config_from_jax(cfg, cls):
    """A JAX config dataclass -> the port's `cls` of the same fields (the
    dtype as the torch dtype; a `LlamaConfig` field through
    `llama_cfg_from_jax`, a `ViTConfig` field through this one)."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = torch_dtype(v)
        elif type(v).__name__ == "LlamaConfig":
            v = llama_cfg_from_jax(v)
        elif dataclasses.is_dataclass(v):
            from .models.vlm import ViTConfig

            v = config_from_jax(v, ViTConfig)
        kw[f.name] = v
    return cls(**kw)


def dit_cfg_from_jax(cfg):
    """A JAX `DiTConfig` -> the port's."""
    from .models.dit import DiTConfig

    return config_from_jax(cfg, DiTConfig)


def unet_cfg_from_jax(cfg):
    from .models.unet import UNetConfig

    return config_from_jax(cfg, UNetConfig)


def vlm_cfg_from_jax(cfg):
    """A JAX `VLMConfig` (its ViT and its Llama LM) -> the port's."""
    from .models.vlm import VLMConfig

    return config_from_jax(cfg, VLMConfig)


def rnn_cfg_from_jax(cfg):
    from .models.rnn import RNNConfig

    return config_from_jax(cfg, RNNConfig)


def cv_cfg_from_jax(cfg):
    from .nas.cv import CVConfig

    return config_from_jax(cfg, CVConfig)


def mamba_cfg_from_jax(cfg):
    """A JAX `MambaConfig` -> the port's (every field, the dtype as the
    torch dtype, `time_step_limit` a tuple)."""
    from .models.mamba import MambaConfig

    out = config_from_jax(cfg, MambaConfig)
    return dataclasses.replace(out, time_step_limit=tuple(out.time_step_limit))


def _quant_cfg_from_jax(qc):
    from .quant.config import QuantizeConfig

    return QuantizeConfig(rules=tuple((p, quantizer_cfg_from_jax(c)) for p, c in qc.rules), algorithm=qc.algorithm)


def quantized_from_jax(qm, device="cpu"):
    """A JAX `QuantizedModel` (`quant.ptq.quantize`'s output: raw weights,
    layout, calibrated state, the config), `DeepseekQuantizedModel` or
    `MambaQuantizedModel` (the hybrid stacks and the {"mamba", "attn",
    "mlp"} state; `quantize_family("mamba")`'s `QuantizedModel` gets the
    port's `mamba.forward`) -> the port's, on `device`."""
    from .models import gpt_oss, llama4, mamba, mixtral
    from .quant.ptq import QuantizedModel

    qc = qm.quant_cfg
    if type(qm.model_cfg).__name__ == "MambaConfig":
        mcfg = mamba_cfg_from_jax(qm.model_cfg)
        parts = (mcfg, params_from_jax(qm.params, device), layout_from_jax(qm.layout),
                 params_from_jax(qm.qstate, device), _quant_cfg_from_jax(qc))
        if type(qm).__name__ == "MambaQuantizedModel":
            return mamba.MambaQuantizedModel(*parts)
        return QuantizedModel(*parts, forward_fn=mamba.forward)
    cfg = llama_cfg_from_jax(qm.model_cfg)
    if type(qm).__name__ == "DeepseekQuantizedModel":
        from .models.deepseek import DeepseekQuantizedModel

        return DeepseekQuantizedModel(cfg, params_from_jax(qm.params, device), layout_from_jax(qm.layout),
                                      params_from_jax(qm.qstate, device), _quant_cfg_from_jax(qc))
    forward = {gpt_oss.GptOssConfig: gpt_oss.forward, llama4.Llama4Config: llama4.forward,
               mixtral.MixtralConfig: mixtral.forward}.get(type(cfg))
    return QuantizedModel(
        model_cfg=cfg,
        params=params_from_jax(qm.params, device),
        layout=layout_from_jax(qm.layout),
        qstate=params_from_jax(qm.qstate, device),
        quant_cfg=_quant_cfg_from_jax(qc),
        adapters=params_from_jax(qm.adapters, device),
        forward_fn=forward,
    )


def compressed_from_jax(cm, device="cpu"):
    """A JAX `CompressedModel` (or `DeepseekCompressedModel`: both layer
    groups' packs, the routed experts' stacks, `e_bias` in f32) -> the
    port's, on `device`."""
    for name, kind in cm.kinds.items():
        if kind not in ("int4", "nvfp4", "mxfp4", "int8", "fp8", "bf16"):
            raise NotImplementedError(
                f"{name}: JAX kind {kind!r} is a TPU serving layout; pass the model as "
                "`quant.compress.compress` returns it (canonical packs)")
    params = params_from_jax(cm.params, device)
    if type(cm).__name__ == "DeepseekCompressedModel":
        from .serve.deepseek_engine import DeepseekCompressedModel

        return DeepseekCompressedModel(llama_cfg_from_jax(cm.model_cfg), params, dict(cm.kinds),
                                       layout_from_jax(cm.layout), params_from_jax(cm.qstate, device))
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
    integer views, bit for bit. The hybrid Mamba cache ("conv", "ssm" f32,
    "k", "v", "pos") crosses the same way."""
    return {k: (torch.tensor(int(v), dtype=torch.int32, device=device) if k == "pos"
                else tensor_from_array(v, device)) for k, v in cache.items()}


def paged_from_jax(cache, device="cpu"):
    """A JAX `PagedKV` -> the port's, on `device`."""
    from .serve.paged_cache import PagedKV

    return PagedKV(**{f.name: (None if getattr(cache, f.name) is None
                               else tensor_from_array(getattr(cache, f.name), device))
                      for f in dataclasses.fields(PagedKV)})
