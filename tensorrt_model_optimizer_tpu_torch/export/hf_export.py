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

MoE models (Qwen3-MoE, Mixtral) export their router in fp16 and every
expert as its own module under the names of the model type `config.json`
declares (qwen3_moe's `mlp.experts.{e}.{gate,up,down}_proj` for a q/k-norm
config, mixtral's `block_sparse_moe.experts.{e}.{w1,w3,w2}` otherwise),
each with the block's shared `input_scale`, as the reference's fused-MoE
plugins quantize them; Qwen3's q/k norms and Qwen2's attention biases go
out in fp16. An MoE model whose experts carry a `pre_quant_scale` (AWQ,
SmoothQuant) raises: the expert modules have no tensor for it.

GPT-OSS exports in its native format (`export_gpt_oss_checkpoint`, which
`export_hf_checkpoint` dispatches to): the experts' gate / up re-fused and
interleaved, then packed as MXFP4 blocks along the contraction dim with
E8M0 exponents (`_mxfp4_pack_hf`), everything else fp16, byte-equal to
JAX's files; it needs an MXFP4 weight preset, as JAX's does. Llama4's
shared expert has no name in the unified checkpoint: its model raises, as
JAX's does.

`export_vlm_checkpoint` writes the VLM family (`models/vlm.py`) in LLaVA's
naming, byte for byte JAX's file.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional

import torch

from ..models import gpt_oss, hf_loader, llama
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
    weight quantizer as the reference does (an MoE model's expert
    down_proj where the dense one is off)."""
    wcfg = model.layout.get("mlp.down_proj.weight")
    if not wcfg.enable and model.layout.get("moe.down_proj.weight").enable:
        wcfg = model.layout.get("moe.down_proj.weight")
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


def _input_scale(ist, icfg, algo: str):
    """An input site's `input_scale`: its amax over 6 * 448 (NVFP4), 448
    (fp) or 127, or None where the site is off or has no amax."""
    if ist is None or ist.amax is None or not icfg.enable:
        return None
    div = 6.0 * 448.0 if algo.startswith("NVFP4") else (448.0 if icfg.is_fp else 127.0)
    return ist.amax.float().max() / div


def _iter_export_tensors(model: QuantizedModel):
    """Yield (name, tensor) for the unified checkpoint, one layer at a time,
    in the reference's order (the shards and the index follow it)."""
    cfg = model.model_cfg
    algo, _ = _quant_algo(model)
    kv_algo = _kv_algo(model)
    layers = model.params["layers"]
    unsupported = [k for k in layers if k.startswith("shared.") or k == "self_attn.sinks"
                   or (k.endswith("__bias") and not k.startswith("self_attn."))]
    if unsupported:
        raise NotImplementedError(f"unified export does not cover the leaves {unsupported}: they have no "
                                  "checkpoint name in it (Llama4's shared expert), as in JAX")
    yield "model.embed_tokens.weight", _f16(model.params["embed_tokens"])
    yield "model.norm.weight", _f16(model.params["norm"])
    if "lm_head" in model.params:
        yield "lm_head.weight", _f16(model.params["lm_head"])
    for i in range(cfg.num_hidden_layers):
        yield f"model.layers.{i}.input_layernorm.weight", _f16(layers["input_layernorm"][i])
        yield f"model.layers.{i}.post_attention_layernorm.weight", _f16(layers["post_attention_layernorm"][i])
        if "self_attn.q_norm" in layers:  # Qwen3's per-head norms
            yield f"model.layers.{i}.self_attn.q_norm.weight", _f16(layers["self_attn.q_norm"][i])
            yield f"model.layers.{i}.self_attn.k_norm.weight", _f16(layers["self_attn.k_norm"][i])
        for bname in sorted(k for k in layers if k.startswith("self_attn.") and k.endswith("__bias")):
            yield f"model.layers.{i}.{bname.removesuffix('__bias')}.bias", _f16(layers[bname][i])
        for name, hf_fmt in PROJ_TO_HF.items():
            if name not in layers:  # an MoE model has no dense MLP
                continue
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
            in_scale = _input_scale(ist, model.layout.get(f"{name}.input"), algo)
            if in_scale is not None:
                yield f"{prefix}.input_scale", in_scale
            if ist is not None and ist.pre_quant_scale is not None:
                yield f"{prefix}.pre_quant_scale", ist.pre_quant_scale.float()
        if "moe.gate_proj" in layers:
            yield from _iter_experts(model, algo, i)
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


def _iter_experts(model: QuantizedModel, algo: str, i: int):
    """Layer i's router and experts, under the declared model type's names;
    every expert carries the block's shared input_scale."""
    layers = model.params["layers"]
    router_fmt, exp_fmt, projs = hf_loader.moe_names("qwen3_moe" if model.model_cfg.qk_norm else "mixtral")
    yield router_fmt.format(i=i), _f16(layers["moe.router"][i])
    in_scale = _input_scale(llama.slice_state(model.qstate.get("moe.gate_proj", {}).get("input"), i),
                            model.layout.get("moe.gate_proj.input"), algo)
    for name, theirs in projs.items():
        wcfg = model.layout.get(f"{name}.weight")
        wst = llama.slice_state(model.qstate.get(name, {}).get("weight"), i)
        for e in range(layers[name].shape[1]):
            prefix = exp_fmt.format(i=i, e=e, proj=theirs)
            for suffix, t in _export_weight(layers[name][i, e], wcfg, llama.slice_state(wst, e), algo).items():
                yield f"{prefix}.{suffix}", t
            if in_scale is not None:
                yield f"{prefix}.input_scale", in_scale


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
    if isinstance(model.model_cfg, gpt_oss.GptOssConfig):  # GPT-OSS ships MXFP4 natively: that format back
        return export_gpt_oss_checkpoint(model, export_dir, max_shard_bytes)
    folded = sorted(n for n, site in model.qstate.items()
                    if n.startswith("moe.") and getattr(site.get("input"), "pre_quant_scale", None) is not None)
    if folded:
        # AWQ / SmoothQuant fold s into the expert weights and keep 1/s on
        # the block's input: the expert modules have no tensor for it, so
        # a loaded model would serve without it
        raise NotImplementedError(f"MoE export of {folded}' pre_quant_scale is not covered (ROADMAP queue 3, "
                                  "'AWQ / SmoothQuant MoE checkpoints')")
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


def _mxfp4_pack_hf(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w [rows, K] -> HF's native GPT-OSS MXFP4 layout: (blocks [rows, K/32,
    16] uint8, two E2M1 codes a byte, the even element in the low nibble;
    scales [rows, K/32] uint8, the E8M0 exponents biased by 127), the format
    transformers' `convert_moe_packed_tensors` dequantizes."""
    from ..ops.formats import fp_emax

    rows, K = w.shape
    w32 = w.float()
    scale = numerics.e8m0_scale(numerics.block_amax_compact(w32, ((-1, 32),)), fp_emax(2, 1))
    s_full = numerics.expand_block_scale(scale, w32.shape, ((-1, 32),))
    codes = numerics.fp4_to_codes(numerics.fp4_round(w32 / s_full)).to(torch.uint8)
    blocks = (codes[..., 0::2] | (codes[..., 1::2] << 4)).reshape(rows, K // 32, 16)
    exps = torch.clamp(torch.frexp(scale).exponent - 1 + 127, 0, 254).to(torch.uint8)
    return blocks, exps


def _iter_gpt_oss_tensors(model: QuantizedModel):
    """Yield (name, tensor) of GPT-OSS's native checkpoint, one layer at a
    time, in the reference's order."""
    cfg, layers = model.model_cfg, model.params["layers"]
    E, inter, h = cfg.num_experts, cfg.intermediate_size, cfg.hidden_size

    def packed(stack):  # [E, rows, K] -> (blocks [E, rows, K/32, 16], scales [E, rows, K/32])
        pe = [_mxfp4_pack_hf(stack[e]) for e in range(E)]
        return torch.stack([b for b, _ in pe]), torch.stack([s for _, s in pe])

    yield "model.embed_tokens.weight", _f16(model.params["embed_tokens"])
    yield "model.norm.weight", _f16(model.params["norm"])
    if "lm_head" in model.params:
        yield "lm_head.weight", _f16(model.params["lm_head"])
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        yield p + "input_layernorm.weight", _f16(layers["input_layernorm"][i])
        yield p + "post_attention_layernorm.weight", _f16(layers["post_attention_layernorm"][i])
        yield p + "self_attn.sinks", _f16(layers["self_attn.sinks"][i])
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            yield p + f"self_attn.{proj}.weight", _f16(layers[f"self_attn.{proj}"][i])
            yield p + f"self_attn.{proj}.bias", _f16(layers[f"self_attn.{proj}__bias"][i])
        yield p + "mlp.router.weight", _f16(layers["moe.router"][i])
        yield p + "mlp.router.bias", _f16(layers["moe.router__bias"][i])
        # gate / up (ours [E, I, H]) re-fused, interleaved by row: [E, 2I, H]
        gu = torch.stack([layers["moe.gate_proj"][i].float(), layers["moe.up_proj"][i].float()], dim=-2)
        blocks, scales = packed(gu.reshape(E, 2 * inter, h))
        yield p + "mlp.experts.gate_up_proj_blocks", blocks
        yield p + "mlp.experts.gate_up_proj_scales", scales
        gub = torch.stack([layers["moe.gate_proj__bias"][i], layers["moe.up_proj__bias"][i]], dim=-1)
        yield p + "mlp.experts.gate_up_proj_bias", _f16(gub.reshape(E, 2 * inter))
        # HF's down_proj blocks run along its contraction dim I: the packed
        # rows are the H outputs, our [E, H, I] as it is
        blocks, scales = packed(layers["moe.down_proj"][i].float())
        yield p + "mlp.experts.down_proj_blocks", blocks
        yield p + "mlp.experts.down_proj_scales", scales
        yield p + "mlp.experts.down_proj_bias", _f16(layers["moe.down_proj__bias"][i])


def export_gpt_oss_checkpoint(model: QuantizedModel, export_dir: str, max_shard_bytes: Optional[int] = None) -> dict:
    """GPT-OSS's export in the architecture's native shipped format: the
    experts' `gate_up_proj_blocks` / `_scales` and `down_proj_blocks` /
    `_scales` (MXFP4, blocks along the contraction dim), everything else
    fp16 under the HF names, JAX's `config.json` and `hf_quant_config.json`;
    the directory loads through `hf_loader.load_hf_moe_checkpoint`. Byte-
    equal to JAX's files, single-file or sharded (`max_shard_bytes`).
    Needs an MXFP4 weight preset, as JAX's does."""
    cfg = model.model_cfg
    algo, _ = _quant_algo(model)
    if algo != "MXFP4":
        raise NotImplementedError(f"GPT-OSS export writes the native MXFP4 format; got {algo}. "
                                  "Quantize with MXFP4_DEFAULT_CFG / MXFP4_WEIGHT_ONLY_CFG.")
    os.makedirs(export_dir, exist_ok=True)
    if max_shard_bytes is not None:
        _write_sharded(_iter_gpt_oss_tensors(model), export_dir, max_shard_bytes)
    else:
        _save(dict(_iter_gpt_oss_tensors(model)), os.path.join(export_dir, "model.safetensors"))
    hf_quant_config = {"producer": dict(PRODUCER),
                       "quantization": {"quant_algo": "MXFP4", "group_size": 32, "exclude_modules": ["lm_head"]}}
    with open(os.path.join(export_dir, "hf_quant_config.json"), "w") as f:
        json.dump(hf_quant_config, f, indent=2)
    hf_cfg = {
        "architectures": ["GptOssForCausalLM"], "model_type": "gpt_oss",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers, "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads, "head_dim": cfg.hd, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps, "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings, "num_local_experts": cfg.num_experts,
        "num_experts_per_tok": cfg.top_k, "sliding_window": cfg.sliding_window,
        "layer_types": list(cfg.resolved_layer_types()), "attention_bias": cfg.attention_bias,
        "quantization_config": {"quant_method": "mxfp4", "modules_to_not_convert": []},
        "torch_dtype": "bfloat16",
    }
    if cfg.rope_scaling is not None:
        hf_cfg["rope_scaling"] = hf_loader.config_to_hf(cfg)["rope_scaling"]
    with open(os.path.join(export_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return hf_quant_config


def _iter_vlm_tensors(cfg, params, layout, qstate, lm_model: QuantizedModel, algo: str):
    """The VLM checkpoint's tensors in JAX's order: the LM tower under
    `language_model.`, the ViT's blocks (each stacked site a block at a
    time), its patch and position embeddings and final norm, then the
    projector."""
    for k, t in _iter_export_tensors(lm_model):
        yield f"language_model.{k}", t
    v, vp = cfg.vision, params["vision"]
    for name in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
        wcfg = layout.get(f"vision.{name}.weight")
        wst_all = (qstate or {}).get(f"vision.{name}", {}).get("weight")
        for i in range(v.depth):
            for suf, t in _export_weight(vp["blocks"][name][i], wcfg, llama.slice_state(wst_all, i), algo).items():
                yield f"vision_tower.blocks.{i}.{name}.{suf}", t
            yield f"vision_tower.blocks.{i}.{name}.bias", _f16(vp["blocks"][name + "__bias"][i])
    yield "vision_tower.patch_embed.weight", _f16(vp["patch_embed"])
    yield "vision_tower.pos_embed", _f16(vp["pos_embed"])
    yield "vision_tower.ln_f.weight", _f16(vp["ln_f"])
    for i, name in enumerate(("fc1", "fc2"), start=1):
        wst = (qstate or {}).get(f"proj.{name}", {}).get("weight")
        for suf, t in _export_weight(params["proj"][name], layout.get(f"proj.{name}.weight"), wst, algo).items():
            yield f"multi_modal_projector.linear_{i}.{suf}", t


def export_vlm_checkpoint(cfg, params, layout, qstate, export_dir: str, quant_cfg=None) -> dict:
    """The VLM (`models/vlm.py`) as one unified checkpoint in LLaVA's naming:
    `language_model.*` (the LM tower through the unified exporter),
    `vision_tower.blocks.{i}.*` and `multi_modal_projector.linear_{1,2}.*`
    (each site through the same per-format weight export), plus
    `hf_quant_config.json` and a `config.json` with `model_type`
    "llava-style-vlm" and the ViT's `vision_config`. File for file and byte
    for byte JAX's. `quant_cfg` (a QuantizeConfig or preset name) gives the
    algorithm tag where the weights are INT8. Returns hf_quant_config."""
    from ..quant.config import get_preset

    os.makedirs(export_dir, exist_ok=True)
    qcfg = get_preset(quant_cfg) if isinstance(quant_cfg, str) else quant_cfg
    lm_state = {k: st for k, st in (qstate or {}).items() if not k.startswith(("vision.", "proj."))}
    lm_model = QuantizedModel(cfg.lm, params["lm"], layout, lm_state, qcfg)
    algo, group_size = _quant_algo(lm_model)
    _save(dict(_iter_vlm_tensors(cfg, params, layout, qstate, lm_model, algo)),
          os.path.join(export_dir, "model.safetensors"))
    hf_quant_config = {
        "producer": dict(PRODUCER),
        "quantization": {
            "quant_algo": algo,
            "kv_cache_quant_algo": _kv_algo(lm_model),
            **({"group_size": group_size} if group_size else {}),
            "exclude_modules": ["lm_head"],
        },
    }
    with open(os.path.join(export_dir, "hf_quant_config.json"), "w") as f:
        json.dump(hf_quant_config, f, indent=2)
    v = cfg.vision
    hf_cfg = hf_loader.config_to_hf(cfg.lm)
    hf_cfg["model_type"] = "llava-style-vlm"
    hf_cfg["vision_config"] = {"img_size": v.img_size, "patch_size": v.patch_size, "hidden_size": v.hidden_size,
                               "depth": v.depth, "num_heads": v.num_heads}
    hf_cfg["quantization_config"] = hf_quant_config["quantization"]
    with open(os.path.join(export_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return hf_quant_config
