"""Unified HF checkpoint export, dense Llama (port of `export/hf_export.py`).

Writes what the JAX package's `export_hf_checkpoint` writes, byte for byte:
packed quantized weights and their scales under the HF names
(`model.safetensors`, or `model-XXXXX-of-NNNNN.safetensors` shards with
`model.safetensors.index.json`), `hf_quant_config.json` naming the format,
and `config.json`. The layouts are the reference's:
 - NVFP4: two adjacent input-dim elements a byte, (q[..., 1::2] << 4) |
   q[..., 0::2]; `weight_scale` the E4M3 block scales, `weight_scale_2` the
   f32 global amax / (6 * 448); `input_scale` act amax / (6 * 448).
   NVFP4_SVDQUANT is NVFP4 plus the adapters (below).
 - INT4 (W4A16_AWQ, W4A8_AWQ): pairs of output channels a byte, [O/2, K],
   the even row in the low nibble; `weight_scale` f32 [O, K/block]; W4A8_AWQ
   (sequential int4 -> fp8 weight quantizers) adds `weight_scale_2`, the
   fp8 stage's amax / 448.
 - FP8: weights as float8_e4m3fn, `weight_scale` = amax / 448.
 - MXFP4 (and MXFP8): the fake-quantized weight as fp16 (grid values).
 - INT8 and W8A8_SQ_PER_CHANNEL (SmoothQuant): int8 per-channel codes,
   `weight_scale` = amax / 127, and the `pre_quant_scale` of every input.
 - SVDQuant adapters: `svdquant_lora_a` (A) and `svdquant_lora_b` (B times
   the adapter scale) in fp16, `lora_rank` in the quantization config.
 - NONE, embeddings, norms and `lm_head`: fp16 (from f32, as JAX's
   `to_np16`).
KV scales (`<proj>.k_scale` / `v_scale`): INT8 amax / 127, FP8 amax / 448
clamped to >= 1.0 (with the reference's warning above 0.5), NVFP4 amax /
(6 * 448).

The packing runs in torch on the tensors' device; only the finished bytes
go to the host, one shard at a time, through the port's own safetensors
writer (`models/hf_loader.py` `save_safetensors`).

Not ported (each raises `NotImplementedError` naming its slice): GPT-OSS
and VLM exports, and MoE experts.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional

import torch

from ..models import hf_loader, llama
from ..ops import numerics
from ..quant.ptq import QuantizedModel

PROJ_TO_HF = {
    "self_attn.q_proj": "model.layers.{i}.self_attn.q_proj",
    "self_attn.k_proj": "model.layers.{i}.self_attn.k_proj",
    "self_attn.v_proj": "model.layers.{i}.self_attn.v_proj",
    "self_attn.o_proj": "model.layers.{i}.self_attn.o_proj",
    "mlp.gate_proj": "model.layers.{i}.mlp.gate_proj",
    "mlp.up_proj": "model.layers.{i}.mlp.up_proj",
    "mlp.down_proj": "model.layers.{i}.mlp.down_proj",
}

PRODUCER = {"name": "tensorrt_model_optimizer_tpu", "version": "0.1.0"}  # the checkpoints' producer field


def _pack_adjacent_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """(q[..., 1::2] << 4) | q[..., 0::2]: the NVFP4 export layout
    (adjacent input-dim elements share a byte)."""
    return ((codes[..., 1::2] << 4) | (codes[..., 0::2] & 0xF)).to(torch.uint8)


def _pack_outpair_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """INT4-AWQ layout: pairs of output channels share a byte -> [..., O/2,
    K]; low nibble = even output row, high nibble = odd output row."""
    return (((codes[..., 1::2, :] & 0xF) << 4) | (codes[..., 0::2, :] & 0xF)).to(torch.uint8)


def _blocks(w32: torch.Tensor, bsz: int, what: str) -> torch.Tensor:
    """w32 [O, K] as [O, K / bsz, bsz]; a K that is not a multiple of the
    block raises, as the reference's reshape does."""
    if w32.shape[-1] % bsz:
        raise ValueError(f"{what} export: K = {w32.shape[-1]} is not a multiple of the {bsz}-wide blocks "
                         "(the unified layout has no ragged last block)")
    return w32.reshape(w32.shape[0], -1, bsz)


def _nvfp4_quant_pack(w32: torch.Tensor, gs: float, bsz: int):
    """Per-block E4M3 scales, E2M1 rounding and adjacent-nibble packing of
    w32 [O, K] under the global scale `gs` (an f32 value)."""
    g = torch.tensor(gs, dtype=torch.float32, device=w32.device)
    bam = torch.amax(torch.abs(_blocks(w32, bsz, "NVFP4")), dim=-1)
    s_val = numerics.cast_e4m3(bam / (6.0 * g))
    s_val = torch.where(s_val <= 0, torch.ones_like(s_val), s_val)
    sb_full = torch.repeat_interleave(s_val * g, bsz, dim=-1)
    codes = numerics.fp4_to_codes(numerics.fp4_round(w32 / sb_full))
    return _pack_adjacent_nibbles(codes), torch.clamp(s_val, -448, 448).to(torch.float8_e4m3fn)


def _int4_quant_pack(w32: torch.Tensor, bam: torch.Tensor, bsz: int):
    """Int4 block quantization of w32 [O, K] under block amax [O, K/bsz] and
    output-pair nibble packing: (packed [O/2, K] uint8, scales f32)."""
    _blocks(w32, bsz, "INT4")
    # XLA, which runs the reference's packer, divides by the constant 7 as a
    # multiply by its f32 reciprocal; so does this, for the same bits
    scale = torch.where(bam == 0, torch.ones_like(bam), bam * torch.tensor(1.0 / 7.0, dtype=torch.float32))
    s_full = torch.repeat_interleave(scale, bsz, dim=-1)
    q = torch.clamp(torch.round(w32 / s_full), -8, 7).to(torch.int32) & 0xF
    return _pack_outpair_nibbles(q), scale.float()


def _quant_algo(model: QuantizedModel) -> tuple[str, Optional[int]]:
    """(quant_algo, group_size) of the checkpoint, read off down_proj's
    weight quantizer as the reference does."""
    wcfg = model.layout.get("mlp.down_proj.weight")
    base = wcfg.sequential[0] if wcfg.sequential else wcfg
    if not wcfg.enable:
        return "NONE", None
    # MX formats (E8M0 block scales) before NVFP4 / FP8, which share num_bits
    if base.is_fp and base.block is not None and base.block.scale_bits == (8, 0):
        bsz = dict(base.block.sizes).get(-1, 32)
        if base.num_bits == (2, 1):
            return "MXFP4", bsz
        if base.num_bits == (4, 3):
            return "MXFP8", bsz
        return "NONE", None
    if base.is_fp and base.num_bits == (2, 1):
        bsz = dict(base.block.sizes).get(-1, 16) if base.block else 16
        return ("NVFP4_SVDQUANT" if model.adapters else "NVFP4"), bsz
    if base.is_fp and base.num_bits == (4, 3):
        return "FP8", None
    if not base.is_fp and base.num_bits == 4:
        bsz = dict(base.block.sizes).get(-1, 128) if base.block else 128
        return ("W4A8_AWQ" if wcfg.sequential else "W4A16_AWQ"), bsz
    if not base.is_fp and base.num_bits == 8:
        algo = model.quant_cfg.algorithm
        method = algo.get("method") if isinstance(algo, dict) else algo
        return ("W8A8_SQ_PER_CHANNEL" if method == "smoothquant" else "INT8"), None
    return "NONE", None


def _kv_algo(model: QuantizedModel) -> Optional[str]:
    kcfg = model.layout.get("self_attn.k_bmm")
    if not kcfg.enable:
        return None
    if kcfg.is_fp and kcfg.num_bits == (4, 3):
        return "FP8"
    if kcfg.is_fp and kcfg.num_bits == (2, 1):
        return "NVFP4"
    if not kcfg.is_fp and kcfg.num_bits == 8:
        return "INT8"
    return None


def _export_weight(w: torch.Tensor, wcfg, wst, algo: str) -> dict:
    """{suffix: tensor} for one projection weight [O, K], on w's device."""
    w32 = w.float()
    if algo == "NONE" or not wcfg.enable:
        return {"weight": w32.to(torch.float16)}
    base = wcfg.sequential[0] if wcfg.sequential else wcfg
    amax = wst.amax if wst is not None else None
    amax_tuple = amax if isinstance(amax, tuple) else None
    if amax_tuple is not None:
        amax = amax_tuple[0]
    if algo == "NVFP4":
        bsz = dict(base.block.sizes).get(-1, 16)
        g_amax = amax if amax is not None else torch.amax(torch.abs(w32))
        gs = max(float(g_amax) / (6.0 * 448.0), 1e-12)
        packed, s8 = _nvfp4_quant_pack(w32, gs, bsz)
        return {"weight": packed, "weight_scale": s8,
                "weight_scale_2": torch.tensor(gs, dtype=torch.float32, device=w.device)}
    if algo == "FP8":
        a = amax if amax is not None else torch.amax(torch.abs(w32))
        scale = torch.clamp_min(a.float(), 1e-12) / 448.0
        qw = torch.clamp(w32 / (scale.reshape(-1, 1) if scale.ndim else scale), -448, 448).to(torch.float8_e4m3fn)
        return {"weight": qw, "weight_scale": scale}
    if algo in ("W4A16_AWQ", "W4A8_AWQ"):
        bsz = min(dict(base.block.sizes).get(-1, 128), w32.shape[-1])
        bam = amax.float() if amax is not None else torch.amax(torch.abs(_blocks(w32, bsz, "INT4")), dim=-1)
        packed, scale = _int4_quant_pack(w32, bam, bsz)
        out = {"weight": packed, "weight_scale": scale}
        if algo == "W4A8_AWQ":  # the fp8 stage's amax / 448 (the deploy kernel dequantizes int4 into fp8's range)
            fa = amax_tuple[-1] if amax_tuple is not None else torch.amax(torch.abs(w32))
            out["weight_scale_2"] = torch.clamp_min(fa.float().max(), 1e-12) / 448.0
        return out
    if algo in ("MXFP4", "MXFP8"):
        # the fake-quantized weight (exact MX grid points under E8M0 block
        # scales) as fp16: no packed MX layout in the unified contract
        bsz = dict(base.block.sizes).get(-1, 32)
        e, m = base.num_bits
        return {"weight": numerics.fake_quant_mx(w32, e, m, min(bsz, w32.shape[-1])).to(torch.float16)}
    # INT8 per-channel
    a = amax.float() if amax is not None else torch.amax(torch.abs(w32), dim=-1, keepdim=True)
    scale = torch.where(a == 0, torch.ones_like(a), a / 127.0)
    q = torch.clamp(torch.round(w32 / scale), -128, 127).to(torch.int8)
    return {"weight": q, "weight_scale": scale}


class LazyExported(hf_loader.SafetensorsDir):
    """Name -> tensor view over an exported checkpoint, single-file or
    sharded; files are memory-mapped and a tensor is read when asked for
    (fp8 comes back as float8_e4m3fn, bf16 as f32, as the JAX view gives
    them)."""

    def __getitem__(self, name: str) -> torch.Tensor:
        t = super().__getitem__(name)
        return t.float() if t.dtype == torch.bfloat16 else t

    def items(self):
        for k in self.keys():
            yield k, self[k]


def load_exported(path: str) -> LazyExported:
    """Read back an exported checkpoint (lazily)."""
    return LazyExported(path)


def _f16(t: torch.Tensor) -> torch.Tensor:
    """fp16 by way of f32 (the reference's `to_np16`)."""
    return t.float().to(torch.float16)


def _iter_export_tensors(model: QuantizedModel):
    """Yield (name, tensor) for the unified checkpoint, one layer at a time,
    in the reference's order (the shards and the index follow it)."""
    cfg = model.model_cfg
    algo, _ = _quant_algo(model)
    kv_algo = _kv_algo(model)
    layers = model.params["layers"]
    if "moe.gate_proj" in layers:
        raise NotImplementedError("MoE expert export comes with the MoE-families slice")
    unsupported = [k for k in layers if k.startswith("shared.") or k.endswith("__bias") or k == "self_attn.sinks"
                   or k in ("self_attn.q_norm", "self_attn.k_norm")]
    if unsupported:
        raise NotImplementedError(f"unified export of the leaves {unsupported} comes with a later slice")
    yield "model.embed_tokens.weight", _f16(model.params["embed_tokens"])
    yield "model.norm.weight", _f16(model.params["norm"])
    if "lm_head" in model.params:
        yield "lm_head.weight", _f16(model.params["lm_head"])
    for i in range(cfg.num_hidden_layers):
        yield f"model.layers.{i}.input_layernorm.weight", _f16(layers["input_layernorm"][i])
        yield f"model.layers.{i}.post_attention_layernorm.weight", _f16(layers["post_attention_layernorm"][i])
        for name, hf_fmt in PROJ_TO_HF.items():
            prefix = hf_fmt.format(i=i)
            site = model.qstate.get(name, {})
            wst = llama.slice_state(site.get("weight"), i)
            weight_algo = algo.removesuffix("_SVDQUANT")
            for suffix, t in _export_weight(layers[name][i], model.layout.get(f"{name}.weight"), wst,
                                            weight_algo).items():
                yield f"{prefix}.{suffix}", t
            if model.adapters and name in model.adapters:  # the adapter scale folds into lora_b
                ad = model.adapters[name]
                yield f"{prefix}.svdquant_lora_a", _f16(ad["A"][i])
                yield f"{prefix}.svdquant_lora_b", _f16(ad["B"][i].float() * ad["scale"][i])
            ist = llama.slice_state(site.get("input"), i)
            icfg = model.layout.get(f"{name}.input")
            if ist is not None:
                if ist.amax is not None and icfg.enable:
                    div = 6.0 * 448.0 if algo.startswith("NVFP4") else (448.0 if icfg.is_fp else 127.0)
                    yield f"{prefix}.input_scale", ist.amax.float().max() / div
                if ist.pre_quant_scale is not None:
                    yield f"{prefix}.pre_quant_scale", ist.pre_quant_scale.float()
        if kv_algo:  # `get_kv_cache_scaling_factor`, quant_utils.py:371
            for which in ("k", "v"):
                st = model.qstate.get(f"self_attn.{which}_bmm")
                if st is None or st.amax is None:
                    continue
                scale = float(st.amax[i].float().max()) / (
                    448.0 if kv_algo == "FP8" else (127.0 if kv_algo == "INT8" else 6.0 * 448.0))
                if kv_algo == "FP8":
                    if scale > 0.5:
                        warnings.warn(f"Large KV activation detected: {scale}; quantized "
                                      "KV cache may lead to higher accuracy drop.")
                    scale = max(scale, 1.0)
                yield (f"model.layers.{i}.self_attn.{which}_proj.{which}_scale",
                       torch.tensor(scale, dtype=torch.float32, device=st.amax.device))


def _save(tensors: dict, path: str) -> None:
    """One safetensors file of the checkpoint; 0-d scales are stored with
    shape [1], as the reference's writer stores them (it passes each array
    through np.ascontiguousarray, which returns at least one dimension)."""
    hf_loader.save_safetensors({k: (t.reshape(1) if t.ndim == 0 else t) for k, t in tensors.items()}, path)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _write_sharded(it, export_dir: str, max_shard_bytes: int) -> None:
    """Stream (name, tensor) pairs into HF-style shards and the index JSON:
    a shard is written when the next tensor would take it past
    `max_shard_bytes`, under a temporary name, and renamed once the count
    is known (the `-of-NNNNN` suffix needs it)."""
    shard: dict = {}
    shard_bytes = total = 0
    shard_files: list[str] = []
    weight_map: dict[str, str] = {}

    def flush():
        nonlocal shard, shard_bytes
        if not shard:
            return
        tmp = f"__shard_{len(shard_files):05d}.safetensors"
        _save(shard, os.path.join(export_dir, tmp))
        shard_files.append(tmp)
        weight_map.update({k: tmp for k in shard})
        shard, shard_bytes = {}, 0

    for name, t in it:
        if shard_bytes + _nbytes(t) > max_shard_bytes and shard:
            flush()
        shard[name] = t
        shard_bytes += _nbytes(t)
        total += _nbytes(t)
    flush()
    n = len(shard_files)
    rename = {tmp: f"model-{i + 1:05d}-of-{n:05d}.safetensors" for i, tmp in enumerate(shard_files)}
    for tmp, fin in rename.items():
        os.replace(os.path.join(export_dir, tmp), os.path.join(export_dir, fin))
    index = {"metadata": {"total_size": total}, "weight_map": {k: rename[v] for k, v in weight_map.items()}}
    with open(os.path.join(export_dir, "model.safetensors.index.json"), "w") as f:
        json.dump(index, f, indent=2)


def export_hf_checkpoint(model: QuantizedModel, export_dir: str, max_shard_bytes: Optional[int] = None) -> dict:
    """Write the unified quantized HF checkpoint; returns hf_quant_config.
    With `max_shard_bytes`, streams into shards (`model-XXXXX-of-NNNNN.
    safetensors` + `model.safetensors.index.json`), one shard held at a
    time; without it, one `model.safetensors` of the same tensors."""
    if not isinstance(model.model_cfg, llama.LlamaConfig):
        raise NotImplementedError(f"export of {type(model.model_cfg).__name__} comes with a later slice")
    os.makedirs(export_dir, exist_ok=True)
    algo, group_size = _quant_algo(model)
    kv_algo = _kv_algo(model)
    if max_shard_bytes is not None:
        _write_sharded(_iter_export_tensors(model), export_dir, max_shard_bytes)
    else:
        _save(dict(_iter_export_tensors(model)), os.path.join(export_dir, "model.safetensors"))
    hf_quant_config = {
        "producer": dict(PRODUCER),
        "quantization": {
            "quant_algo": algo,
            "kv_cache_quant_algo": kv_algo,
            **({"group_size": group_size} if group_size else {}),
            **({"lora_rank": int(next(iter(model.adapters.values()))["A"].shape[1])} if model.adapters else {}),
            "exclude_modules": ["lm_head"],
        },
    }
    with open(os.path.join(export_dir, "hf_quant_config.json"), "w") as f:
        json.dump(hf_quant_config, f, indent=2)
    hf_cfg = hf_loader.config_to_hf(model.model_cfg)
    hf_cfg["quantization_config"] = hf_quant_config["quantization"]
    with open(os.path.join(export_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return hf_quant_config


def export_gpt_oss_checkpoint(model, export_dir: str, max_shard_bytes: Optional[int] = None) -> dict:
    raise NotImplementedError("GPT-OSS export (native MXFP4 experts) comes with the MoE-families slice")


def export_vlm_checkpoint(cfg, params, layout, qstate, export_dir: str, quant_cfg=None) -> dict:
    raise NotImplementedError("VLM export comes with the slice that ports models/vlm.py")
