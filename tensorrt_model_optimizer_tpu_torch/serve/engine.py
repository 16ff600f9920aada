"""Quantized serving engine: prefill + decode over packed weights (port of
`serve/engine.py`).

Ported paths:
 - projections: weight-only INT4 block-128, NVFP4, MXFP4, INT8 per-channel
   and FP8 per-tensor under bf16 activations (`ops/cuda/qmm_wo.py`; the
   site's input quantizer, where the preset has one, fake-quantizes the
   activations first), W4A8 ("int4a8": per-token int8 activations x int4
   block weights, `ops/cuda/qmm.py`), W8A8 (int8 weights under an int input
   quantizer: int8 activations, per token or from the static amax, times
   the int8 weights into int32, `int8_mm`) and bf16
   (`quant.compress.compress_bf16` wraps a raw model so). A model with
   SVDQuant adapters adds each projection's low-rank branch, unquantized,
   on the x JAX's engine uses: after pre_quant_scale on the W4A8 path,
   after the input quantizer on the others; W8A8 has none;
 - the dense-cache einsum engine (`kv_attention_kernel=False`, the default):
   cache `[L, B, S, n_kv, C]` of stored rows (bf16, int8 codes with scale
   amax/127, fp8 e4m3 with scale amax/448, "nvfp4_fake" grid values, or
   packed NVFP4 as ONE uint8 row of 9 hd/16 bytes: the E2M1 nibbles, even
   index low, then the E4M3 block-scale bytes). Prefill writes the stored
   rows at `pos` and attends over the whole cache, dequantized, with the
   causal mask -1e9 and the probabilities rounded to the activation dtype
   before P.V; decode (T = 1) is split attention: scores over the old cache
   with slot `pos` patched with the current token's QDQ'd k, that weight
   taken out of the probabilities and added back with its QDQ'd v. With
   `attn_sparsity` set, a prefill of T > 1 tokens attends through the
   skip-softmax kernel (`ops/cuda/sparse_attention.py`) over the fresh
   tokens' pre-store k/v, and `Engine.last_prefill_keep_frac` holds each
   layer's kept share of all tiles (the causally skipped ones count);
 - the kernel-attention engine (`kv_attention_kernel=True`): cache
   kv-head-major `[L, B, n_kv, S, hd]` in stored form (bf16, int8 codes, fp8
   e4m3; an uncalibrated amax is 448), or packed NVFP4: plane-packed E2M1
   bytes `[.., hd/2]` in "k"/"v" with the E4M3 block scales' bytes
   `[.., hd/16]` in "ks"/"vs" (`kv_dtype="nvfp4"`, chosen by an NVFP4 `k_bmm`
   site when the caller names no dtype); "nvfp4_fake" stores the
   fake-quantized values. Prefill is causal GQA flash attention over the fresh
   tokens' QDQ'd k/v (`ops/cuda/flash_gqa.py`) into an empty cache (pos ==
   0); decode is split attention over the cached rows < pos plus the current
   token's code-domain k/v (`ops/cuda/kv_attention.py`). It refuses
   `attn_sparsity`, as JAX's does;
 - paged serving (`Engine.serve`): continuous batching over a page pool
   (`serve/paged_cache.py`, `serve/scheduler.py`). A fresh request prefills
   densely (on either dense engine, sparsely where a threshold is set) and
   its cache rows are copied into its pages (`prefill_into_slot`); a request
   that shares cached prefix pages streams its tail through
   `prefill_chunked`; decode steps run all slots at once. With
   `paged_attention_kernel=True` attention reads the pages through the two
   kernels of `ops/cuda/paged_attention.py`; without it, it gathers each
   sequence's pages and runs plain PyTorch (the JAX engine's gather path).
   The paged path folds k's scale into q and casts back to the activation
   dtype, and casts the context again after v's scale: two roundings the
   dense path (f32 q, f32 context) does not have. Both are ported as written.

There is no jit, scan or buffer donation: layers and steps are Python loops,
and the KV cache and the page pool are updated in place (the paged entry
points return logits or tokens, not a new cache; `decode_step` returns the
cache it was given). A decode step writes each layer's new cache row right
after that layer's attention has read the old rows (JAX batches the same
writes after its layer scan); the values are the same. The dense cache's
`pos` is a 0-d int32 tensor on the engine's device, as JAX's is, read only
there (rope positions, the row writes, the attention masks, the kv-decode
kernel) and advanced in place. The host keeps its own copy of pos for each
cache, set by every public call, to check the room without waiting for the
card; it reads the card only for a cache whose pos changed in another way.

On the card the fused decode steps (`decode_step(tok, cache, unroll)` and
`paged_decode_step`) are CUDA graphs (`serve/step_graph.py`): the first
call for a cache, batch and `unroll` runs the steps eagerly and captures
them, every later call is one replay. A cache's graphs, and their memory
pools, are dropped with the cache. The greedy `decode`, `generate_host` and
`serve` decode through them; sampled decoding stays eager.

Every TPU layout name of a format maps to the one port layout of that format
(`quant/compress.py` `word_convert_site`): `bd2_supported`'s quiet fall back
from bd2 to word2 has no counterpart, because both names are one kernel here.

Not ported (each raises `NotImplementedError` naming its slice):
`int4_layout="xla"`, `nvfp4_layout="i8"`, the tensor-parallel, MoE and
speculative paths.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import llama
from ..ops.cuda import flash_gqa as flash_mod
from ..ops import numerics
from ..ops.cuda import kv_attention as kva
from ..ops.cuda import paged_attention as pa
from ..ops.cuda import qmm, qmm_wo
from ..ops.cuda import sparse_attention as ssa
from ..quant import quantizer as Q
from ..quant.compress import CompressedModel, convert_packed_layouts, layer_arrays
from . import paged_cache as pc
from . import step_graph
from .sampling import SamplingConfig, sample
from .scheduler import Scheduler

_KV_DTYPES = (None, torch.bfloat16, torch.int8, torch.float8_e4m3fn, "nvfp4", "nvfp4_fake")
_SERVED_KINDS = ("int4a8", "int4wo", "nvfp4wo", "mxfp4wo", "int8", "fp8", "bf16")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_seq_len: int = 2048
    # None = model dtype (an NVFP4 k_bmm site then selects "nvfp4");
    # torch.int8 / torch.float8_e4m3fn / torch.bfloat16; "nvfp4" (packed
    # planes + E4M3 block scales) / "nvfp4_fake" (fake-quantized values)
    kv_dtype: Any = None
    # INT4 serving layout, by its TPU name: "bd2" | "word" | "word2" |
    # "blockdot" are weight-only (one port layout, "int4wo"; "blockdot" keeps
    # the f32 block scales, the others round them to bf16 as JAX's packs do),
    # "a8" is W4A8 ("int4a8")
    int4_layout: str = "bd2"
    # NVFP4 serving layout, by its TPU name: "word2" | "word" | "perm" |
    # "blockdot" | "bd4", all one port layout ("nvfp4wo"); MXFP4 follows it
    nvfp4_layout: str = "word2"
    # the stored-form kv-head-major cache with the attention kernels; False:
    # the dense-cache einsum engine
    kv_attention_kernel: bool = False
    # paged serving attends through the paged-attention kernels (False: the
    # gather path, plain PyTorch over each sequence's gathered pages)
    paged_attention_kernel: bool = False
    # kernels (names of `PLAIN_ALL`) whose plain PyTorch versions run
    # instead, on any device, to hold the kernel path against them
    plain_ops: tuple = ()
    # prefill skip-softmax attention sparsity (einsum engine, T > 1): score
    # tiles of `attn_sparsity_blocks` rows whose max lies more than
    # log(threshold) below the running max of the kept tiles are skipped.
    # None = dense. Calibrate with `sparsity.attention_sparsity.
    # calibrate_threshold` or `sparsity.ruler.calibrate_threshold_ruler`.
    attn_sparsity: Optional[float] = None
    attn_sparsity_blocks: tuple = (128, 128)


_KERNELS = {  # plain_ops name -> (kernel wrapper, plain version)
    "w4a8": (qmm.w4a8_matmul, qmm.w4a8_matmul_plain),
    "kv_attention": (kva.kv_decode_attention, kva.kv_decode_attention_plain),
    "flash": (flash_mod.flash_attention_gqa, flash_mod.flash_attention_gqa_plain),
    "int4_wo": (qmm_wo.int4_wo_matmul, qmm_wo.int4_wo_matmul_plain),
    "fp4_wo": (qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain),
    "byte_wo": (qmm_wo.byte_wo_matmul, qmm_wo.byte_wo_matmul_plain),
    "paged_decode": (pa.paged_attention_decode, pa.paged_attention_decode_plain),
    "paged_prefill": (pa.paged_attention_prefill, pa.paged_attention_prefill_plain),
    "skip_softmax": (ssa.skip_softmax_flash, ssa.skip_softmax_flash_plain),
}
PLAIN_ALL = tuple(_KERNELS)


def _ops(plain: tuple) -> dict:
    """name -> callable for this engine: the kernel's wrapper, or its plain
    version for the names in `plain`."""
    if set(plain) - set(PLAIN_ALL):
        raise ValueError(f"plain_ops: unknown kernels {sorted(set(plain) - set(PLAIN_ALL))}")
    return {name: pair[name in plain] for name, pair in _KERNELS.items()}


INT_MM_MIN_ROWS = 17  # torch._int_mm takes more than 16 rows; fewer are padded with zero rows


def int8_mm(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """x8 [N, K] int8 times w8 [O, K] int8 transposed, accumulated in int32
    -> [N, O]: `torch._int_mm` on the card (the JAX engine's is XLA's
    dot_general, no Pallas kernel; N <= 16 is padded with zero rows to
    INT_MM_MIN_ROWS, a shape known before a graph capture), an exact int32
    product on the CPU."""
    if x8.device.type != "cuda":
        return x8.to(torch.int32) @ w8.to(torch.int32).t()
    n = x8.shape[0]
    if n < INT_MM_MIN_ROWS:
        x8 = torch.nn.functional.pad(x8, (0, 0, 0, INT_MM_MIN_ROWS - n))
    return torch._int_mm(x8, w8.t())[:n]


def _int8_acts(x: torch.Tensor, a_amax: torch.Tensor, lo: int):
    """(int8 codes of x under a_amax / 127, clipped to [lo, 127], the scale)."""
    a_scale = torch.where(a_amax == 0, torch.ones_like(a_amax), a_amax / 127.0)
    return torch.clamp(torch.round(x.float() / a_scale), lo, 127).to(torch.int8), a_scale


def _lora(x, y, adapter):
    """y plus the adapter's low-rank branch (x @ A^T) @ B^T * scale."""
    if adapter is None:
        return y
    lo = (x @ adapter["A"].t().to(x.dtype)) @ adapter["B"].t().to(x.dtype)
    return y + lo * adapter["scale"].to(y.dtype)


def _qlinear(x, name, kind, arrays, cm: CompressedModel, ist, ops, adapter=None):
    """y = q_act(x) @ dequant(W)^T for x [N, K] (2-D), plus the adapter's
    low-rank branch where there is one."""
    icfg = cm.layout.get(f"{name}.input")
    if kind == "int4a8":
        # per-token dynamic int8 activations, clipped to +-127
        if ist is not None and ist.pre_quant_scale is not None:
            x = x * ist.pre_quant_scale.to(x.dtype)
        x8, a_scale = _int8_acts(x, torch.amax(torch.abs(x.float()), dim=-1, keepdim=True), -127)
        y = ops["w4a8"](x8, arrays["packed"], arrays["scales"])
        return _lora(x, (y * a_scale).to(x.dtype), adapter)
    if kind == "int8" and icfg.enable and not icfg.is_fp:
        # W8A8: per-token int8 activations (the static amax's first element
        # where the site is static), clipped to [-128, 127]; int32 products,
        # then (acc * a_scale) * w_scale in f32
        if ist is not None and ist.pre_quant_scale is not None:
            x = x * ist.pre_quant_scale.to(x.dtype)
        if icfg.dynamic or icfg.per_token or ist is None or ist.amax is None:
            a_amax = torch.amax(torch.abs(x.float()), dim=-1, keepdim=True)
        else:
            a_amax = ist.amax.float().reshape(1, -1)[:, :1].expand(x.shape[0], 1)
        x8, a_scale = _int8_acts(x, a_amax, -128)
        y = int8_mm(x8, arrays["q"]).float() * a_scale * arrays["scale"].reshape(1, -1)
        return y.to(x.dtype)
    if icfg.enable or (ist is not None and ist.pre_quant_scale is not None):
        x = Q.quantize(x, icfg, ist)
    if kind == "int4wo":
        y = ops["int4_wo"](x, arrays["packed"], arrays["scales"])
    elif kind in ("nvfp4wo", "mxfp4wo"):
        y = ops["fp4_wo"](x, arrays["packed"], arrays["scales"], arrays.get("global_scale"))
    elif kind in ("int8", "fp8"):
        y = ops["byte_wo"](x, arrays["q"], arrays["scale"])
    elif kind == "bf16":
        y = x @ arrays["w"].to(x.dtype).t()
    else:
        raise NotImplementedError(f"weight kind {kind!r} is served by a later slice")
    return _lora(x, y, adapter)


def _kv_pack_width(hd: int) -> int:
    """Bytes of one packed NVFP4 row of the einsum cache: hd/2 nibble bytes
    and hd/16 E4M3 block-scale bytes."""
    return hd * 9 // 16


def _kv_store(v: torch.Tensor, dtype, amax: torch.Tensor) -> torch.Tensor:
    """Quantize k/v for cache storage (stored form). Packed "nvfp4" is the
    einsum cache's one-row form; the kernel cache's planes come from
    `_kv_store_kvh`."""
    if dtype == "nvfp4":  # nibbles (even index low) then the block-scale bytes
        packed, s8, _ = numerics.real_quant_nvfp4(v, 16, amax)
        return torch.cat([packed, s8.view(torch.uint8)], dim=-1)
    if dtype == "nvfp4_fake":  # E2M1 block-quantized values in the model dtype
        return numerics.fake_quant_nvfp4(v, 16, amax, axis=-1)
    if dtype is None or v.dtype == dtype:
        return v
    if dtype == torch.int8:
        scale = amax / 127.0
        return torch.clamp(torch.round(v.float() / scale), -128, 127).to(torch.int8)
    if dtype == torch.float8_e4m3fn:
        scale = torch.clamp_min(amax.float(), 1e-12) / 448.0
        return torch.clamp(v.float() / scale, -448, 448).to(torch.float8_e4m3fn)
    return v.to(dtype)


def _kv_load(stored: torch.Tensor, out_dtype, kv_dtype, amax: torch.Tensor) -> torch.Tensor:
    """Stored form -> dequantized values (the einsum cache, the gather path's
    pages). `amax` broadcasts against the rows' leading axes."""
    if kv_dtype == "nvfp4":  # one-row packed NVFP4 (see `_kv_store`)
        p = stored.shape[-1] * 16 // 9 // 2
        vals = numerics.codes_to_fp4(numerics.unpack_nibbles(stored[..., :p]))
        s8 = stored[..., p:].contiguous().view(torch.float8_e4m3fn).float()
        sb = torch.where(s8 <= 0.0, torch.ones_like(s8), s8) * numerics.nvfp4_global_scale(amax)
        return (vals * torch.repeat_interleave(sb, 16, dim=-1)).to(out_dtype)
    if kv_dtype == torch.int8 and stored.dtype != out_dtype:
        return (stored.float() * (amax / 127.0)).to(out_dtype)
    if kv_dtype == torch.float8_e4m3fn and stored.dtype != out_dtype:
        return (stored.float() * (torch.clamp_min(amax.float(), 1e-12) / 448.0)).to(out_dtype)
    return stored.to(out_dtype)


def _kv_scales(kv_dtype, k_amax, v_amax):
    """Per-layer global dequant scales (k's folds into q, v's into the
    context; NVFP4's block scales stay with the kernels), or (None, None)
    for a cache of plain values."""
    def one(amax):
        if kv_dtype == torch.int8:
            return amax / 127.0
        if kv_dtype == torch.float8_e4m3fn:
            return torch.clamp_min(amax.float(), 1e-12) / 448.0
        if kv_dtype == "nvfp4":
            return numerics.nvfp4_global_scale(amax)
        return None

    return one(k_amax), one(v_amax)


def _kv_globals(kv_dtype, k_amax, v_amax):
    """`_kv_scales` for the dense kernel path: 1 where there is no scale."""
    one = torch.ones((), dtype=torch.float32, device=k_amax.device)
    kg, vg = _kv_scales(kv_dtype, k_amax, v_amax)
    return (one if kg is None else kg), (one if vg is None else vg)


def _kv_fmt(kv_dtype) -> str:
    """EngineConfig.kv_dtype -> the dense attention kernel's format; None,
    the model dtype and "nvfp4_fake" are plain values."""
    if kv_dtype == "nvfp4":
        return "nvfp4"
    if kv_dtype == torch.int8:
        return "int8"
    if kv_dtype == torch.float8_e4m3fn:
        return "fp8"
    return "bf16"


def _kv_store_kvh(v: torch.Tensor, kv_dtype, amax):
    """k/v [B, T, n_kv, hd] -> the kv-head-major kernel cache form: (stored
    [B, n_kv, T, C], block-scale bytes [B, n_kv, T, hd/16] or None)."""
    vt = v.transpose(1, 2)
    if kv_dtype == "nvfp4":
        planes, sbits, _ = numerics.real_quant_nvfp4_planes(vt, 16, amax)
        return planes, sbits
    return _kv_store(vt, kv_dtype, amax), None


def _kv_code_new(stored: torch.Tensor, scales, kv_dtype, out_dtype) -> torch.Tensor:
    """Stored form -> code-domain values (global scale not applied)."""
    if kv_dtype == "nvfp4":
        return numerics.nvfp4_planes_code_load(stored, scales, out_dtype)
    if kv_dtype in (torch.int8, torch.float8_e4m3fn):
        return stored.float().to(out_dtype)
    return stored.to(out_dtype)


def _kv_amax_from(qstate, which: str) -> Optional[torch.Tensor]:
    st = (qstate or {}).get(f"self_attn.{which}_bmm")
    if st is None or st.amax is None:
        return None
    a = st.amax
    return a.reshape(a.shape[0], -1).amax(dim=-1)  # [L]


def _layer(cfg, cm, x, lp, lstate, kinds, positions, ops, attend, adapters=None):
    """One decoder layer on packed weights: projections and rope, then
    `attend(q [B, T, nH, hd], k, v [B, T, nKV, hd]) -> ctx [B*T, nH*hd]`,
    then the output projection and the MLP. `adapters`: this layer's
    low-rank branches by projection, or None."""
    B, T, H = x.shape
    hd, nH, nKV = cfg.hd, cfg.num_attention_heads, cfg.num_key_value_heads

    def lin(inp, name):
        ist = (lstate or {}).get(name, {}).get("input")
        return _qlinear(inp, name, kinds[name], lp[name], cm, ist, ops, (adapters or {}).get(name))

    h2 = llama.norm(cfg, x, lp["input_layernorm"]).reshape(B * T, H)
    q = llama.rope(lin(h2, "self_attn.q_proj").reshape(B, T, nH, hd), positions,
                   cfg.rope_theta, cfg.rope_scaling)
    k = llama.rope(lin(h2, "self_attn.k_proj").reshape(B, T, nKV, hd), positions,
                   cfg.rope_theta, cfg.rope_scaling)
    v = lin(h2, "self_attn.v_proj").reshape(B, T, nKV, hd)
    ctx = attend(q, k, v)
    x = x + lin(ctx, "self_attn.o_proj").reshape(B, T, H)
    h2 = llama.norm(cfg, x, lp["post_attention_layernorm"]).reshape(B * T, H)
    g = lin(h2, "mlp.gate_proj")
    u = lin(h2, "mlp.up_proj")
    y = (torch.nn.functional.silu(g.float()) * u.float()).to(h2.dtype)
    return x + lin(y, "mlp.down_proj").reshape(B, T, H)


def _dense_attn(cfg, ecfg, q, k, v, ck, cv, cks, cvs, pos, ka, va, ops):
    """Attention of one layer over its dense cache ck/cv [B, n_kv, S, C]
    (cks/cvs: NVFP4's block-scale bytes, else None), written in place at
    rows pos .. pos + T - 1 (pos: the cache's 0-d int32 tensor; a prefill
    needs pos == 0, which the public entry points check)."""
    B, T, nH, hd = q.shape
    kv_dtype = ecfg.kv_dtype
    kg, vg = _kv_globals(kv_dtype, ka, va)
    k_st, k_sc = _kv_store_kvh(k, kv_dtype, ka)
    v_st, v_sc = _kv_store_kvh(v, kv_dtype, va)
    if T == 1:
        kn = _kv_code_new(k_st, k_sc, kv_dtype, cfg.dtype)
        vn = _kv_code_new(v_st, v_sc, kv_dtype, cfg.dtype)
        q_eff = q.reshape(B, nH, hd).float() * (kg.float() / math.sqrt(hd))
        ctx = ops["kv_attention"](q_eff, ck, cv, kn, vn, pos, _kv_fmt(kv_dtype), cks, cvs)
        ctx = (ctx * vg).to(cfg.dtype).reshape(B * T, nH * hd)
    else:
        kq = (_kv_code_new(k_st, k_sc, kv_dtype, torch.float32) * kg).to(cfg.dtype)
        vq = (_kv_code_new(v_st, v_sc, kv_dtype, torch.float32) * vg).to(cfg.dtype)
        ctx = ops["flash"](q.transpose(1, 2), kq, vq, True)
        ctx = ctx.transpose(1, 2).reshape(B * T, nH * hd).to(cfg.dtype)
    # the new rows land after attention has read rows < pos
    rows = _rows_at(pos, T)
    _write_rows(ck, 2, rows, k_st)
    _write_rows(cv, 2, rows, v_st)
    if cks is not None:
        _write_rows(cks, 2, rows, k_sc)
        _write_rows(cvs, 2, rows, v_sc)
    return ctx


def _rows_at(pos: torch.Tensor, T: int) -> torch.Tensor:
    """The cache rows pos .. pos + T - 1 as an index tensor, on pos's device."""
    return pos.long() + torch.arange(T, device=pos.device)


def _write_rows(cache: torch.Tensor, dim: int, rows: torch.Tensor, src: torch.Tensor) -> None:
    """cache[rows] = src along `dim`, in place (one-byte forms as bytes:
    index_copy_ has no fp8 kernel)."""
    src = src.to(cache.dtype)
    if cache.element_size() == 1:
        cache, src = cache.view(torch.uint8), src.view(torch.uint8)
    cache.index_copy_(dim, rows, src)


def _einsum_attn(cfg, ecfg, q, k, v, ck, cv, pos, ka, va, ops, keep_fracs):
    """Attention of one layer of the einsum engine over its dense cache ck/cv
    [B, S, n_kv, C], written in place at rows pos .. pos + T - 1 (pos: the
    cache's 0-d int32 tensor). `keep_fracs` is a list for a sparse prefill
    (the layer's kept share of tiles is appended), else None. Returns ctx
    [B*T, nH*hd]."""
    B, T, nH, hd = q.shape
    nKV, S = cfg.num_key_value_heads, ck.shape[1]
    rep, dt, kv_dtype = nH // nKV, cfg.dtype, ecfg.kv_dtype
    k_st = _kv_store(k, kv_dtype, ka).to(ck.dtype)
    v_st = _kv_store(v, kv_dtype, va).to(cv.dtype)
    qg = q.reshape(B, T, nKV, rep, hd).float()
    mask = torch.where(torch.arange(S, device=q.device)[None, :]
                       <= pos + torch.arange(T, device=q.device)[:, None], 0.0, -1e9)

    def probs_of(scores):  # [B, nKV, rep, T, S] f32 -> probabilities in the activation dtype
        scores = scores.reshape(B, nH, T, S).div_(math.sqrt(hd)).add_(mask)
        return torch.softmax(scores, dim=-1).to(dt).reshape(B, nKV, rep, T, S)

    rows = _rows_at(pos, T)
    if T == 1:
        # split attention: the old cache with slot pos patched with the
        # current token's QDQ'd k; its weight comes out of the probabilities
        # and returns with its QDQ'd v; the row lands after the read. The
        # patch and the weight's removal select slot pos on the device
        # (where / gather: the same values as a slice at pos)
        k_q, v_q = _kv_load(k_st, dt, kv_dtype, ka), _kv_load(v_st, dt, kv_dtype, va)
        at_pos = torch.arange(S, device=q.device) == pos
        scores = torch.einsum("btgrd,bsgd->bgrts", qg, _kv_load(ck, dt, kv_dtype, ka).float())
        scores = torch.where(at_pos, torch.einsum("btgrd,bugd->bgrtu", qg, k_q.float()), scores)
        probs = probs_of(scores)
        w_new = probs.gather(-1, rows.expand(*probs.shape[:-1], 1))
        probs = probs.masked_fill(at_pos, 0)
        ctx = torch.einsum("bgrts,bsgd->btgrd", probs.float(), _kv_load(cv, dt, kv_dtype, va).float()).to(dt)
        ctx = ctx + torch.einsum("bgrtu,bugd->btgrd", w_new.float(), v_q.float()).to(dt)
        _write_rows(ck, 1, rows, k_st)
        _write_rows(cv, 1, rows, v_st)
        return ctx.reshape(B * T, nH * hd)
    _write_rows(ck, 1, rows, k_st)
    _write_rows(cv, 1, rows, v_st)
    if keep_fracs is not None:
        # skip-softmax over the fresh tokens' pre-store k/v (an empty cache:
        # the attention span is the prompt); heads folded into the batch
        def fold(t):
            return t.transpose(1, 2).reshape(B * nH, T, hd)

        bq, bk = ecfg.attn_sparsity_blocks
        ctx, keep = ops["skip_softmax"](fold(q), fold(k.repeat_interleave(rep, dim=2)),
                                        fold(v.repeat_interleave(rep, dim=2)), ecfg.attn_sparsity, bq, bk, True)
        keep_fracs.append(keep.float().mean())
        return ctx.reshape(B, nH, T, hd).transpose(1, 2).reshape(B * T, nH * hd).to(dt)
    probs = probs_of(torch.einsum("btgrd,bsgd->bgrts", qg, _kv_load(ck, dt, kv_dtype, ka).float()))
    ctx = torch.einsum("bgrts,bsgd->btgrd", probs.float(), _kv_load(cv, dt, kv_dtype, va).float())
    return ctx.to(dt).reshape(B * T, nH * hd)


def _paged_layer_attn(cfg, ecfg, q, k_new, v_new, kp, vp, ksc, vsc, cache, ka, va, write_mask, ops):
    """Paged attention of one layer, T tokens per slot (T = 1 decode, T > 1
    chunked prefill): writes the tokens' k/v into this layer's pages kp/vp
    [n_pages, n_kv, page, C] (ksc/vsc: the NVFP4 scale pools, else None) in
    place at positions seq_lens .. seq_lens + T - 1, then attends. Slots whose
    `write_mask` is False write to the scratch page 0 (several of them to
    the same rows, in no order: nothing reads those rows as live).
    Returns ctx [B*T, nH*hd]."""
    B, T, nH, hd = q.shape
    nKV = cfg.num_key_value_heads
    page = kp.shape[2]
    packed4 = ksc is not None
    kv_dtype = ecfg.kv_dtype
    if kv_dtype == "nvfp4" and not packed4:
        kv_dtype = "nvfp4_fake"
    pos = cache.seq_lens
    tok_pos = pos.long()[:, None] + torch.arange(T, device=q.device)[None, :]  # [B, T]
    pidx = (tok_pos // page).clamp_max(cache.block_table.shape[1] - 1)
    page_ids = torch.gather(cache.block_table, 1, pidx).clamp_min(0).long()
    page_ids = torch.where(write_mask[:, None], page_ids, torch.zeros_like(page_ids))
    ids, offs = page_ids.reshape(-1), (tok_pos % page).reshape(-1)
    if packed4:
        ks, ks_sc, _ = numerics.real_quant_nvfp4_planes(k_new, 16, ka)
        vs, vs_sc, _ = numerics.real_quant_nvfp4_planes(v_new, 16, va)
        ksc[ids, :, offs] = ks_sc.reshape(B * T, nKV, hd // 16)
        vsc[ids, :, offs] = vs_sc.reshape(B * T, nKV, hd // 16)
    else:
        ks = _kv_store(k_new, kv_dtype, ka).to(kp.dtype)
        vs = _kv_store(v_new, kv_dtype, va).to(vp.dtype)
        ks_sc = vs_sc = None
    Cw = kp.shape[-1]
    kp[ids, :, offs] = ks.reshape(B * T, nKV, Cw)
    vp[ids, :, offs] = vs.reshape(B * T, nKV, Cw)
    fmt = "nvfp4" if packed4 else "raw"
    k_sc, v_sc = _kv_scales("nvfp4" if packed4 else kv_dtype, ka, va)

    if ecfg.paged_attention_kernel:
        # the scales fold exactly: k's into q (scores are linear in k), v's
        # into the context; each fold rounds to the activation dtype
        qk = q if k_sc is None else (q.float() * k_sc).to(q.dtype)
        if T > 1:
            # the chunk's kv goes in stored form, so one fold of k's scale
            # covers the context's and the chunk's scores
            ctx = ops["paged_prefill"](qk, kp, vp, cache.block_table, pos, ks, vs, fmt, ksc, vsc, ks_sc, vs_sc)
        else:
            ctx = ops["paged_decode"](qk[:, 0], kp, vp, cache.block_table, pos + T, fmt, ksc, vsc)
        if v_sc is not None:
            ctx = (ctx.float() * v_sc).to(q.dtype)
        return ctx.reshape(B * T, nH * hd).to(q.dtype)

    # gather path: every table column's pages, dequantized, masked by position
    bt = cache.block_table.clamp_min(0).long()

    def gathered(pages, last):
        return pages[bt].transpose(2, 3).reshape(B, -1, nKV, last)

    if packed4:
        k_all = (numerics.nvfp4_planes_code_load(gathered(kp, hd // 2), gathered(ksc, hd // 16),
                                                 torch.float32) * k_sc).to(cfg.dtype)
        v_all = (numerics.nvfp4_planes_code_load(gathered(vp, hd // 2), gathered(vsc, hd // 16),
                                                 torch.float32) * v_sc).to(cfg.dtype)
    else:
        k_all = _kv_load(gathered(kp, hd), cfg.dtype, kv_dtype, ka)
        v_all = _kv_load(gathered(vp, hd), cfg.dtype, kv_dtype, va)
    S = k_all.shape[1]
    # query t (global position pos + t) sees keys at positions <= pos + t
    mask = torch.where(torch.arange(S, device=q.device)[None, None, :] <= tok_pos[:, :, None], 0.0, -1e9)
    rep = nH // nKV
    scores = torch.einsum("btgrd,bsgd->bgrts", q.reshape(B, T, nKV, rep, hd).float(), k_all.float())
    scores = scores.reshape(B, nH, T, S) / math.sqrt(hd) + mask[:, None].float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype).reshape(B, nKV, rep, T, S)
    ctx = torch.einsum("bgrts,bsgd->btgrd", probs.float(), v_all.float()).to(q.dtype)
    return ctx.reshape(B * T, nH * hd)


class _CacheState:
    """What an engine keeps about one cache: the dense cache's pos as the
    host last set it (None: not known) and the tensor's version then, and
    the cache's captured decode steps (step_graph.StepGraph) by tensors,
    batch and unroll."""

    def __init__(self):
        self.pos: Optional[int] = None
        self.version: Optional[int] = None
        self.graphs: dict = {}


def _version(t: torch.Tensor) -> Optional[int]:
    """t's in-place write count (None for an inference tensor, which keeps
    none)."""
    return None if t.is_inference() else t._version


def _forget_cache(engine_ref, key: int) -> None:
    """A cache's owner tensor is gone: drop what its engine kept about it."""
    eng = engine_ref()
    if eng is not None:
        eng._caches.pop(key, None)


class Engine:
    """Generation engine over a compressed model, on `device` (cuda unless
    the caller passes device="cpu"); the model must already live there."""

    def __init__(self, cm: CompressedModel, config: EngineConfig = EngineConfig(), device=None):
        self.device = resolve_device(device)
        if cm.params["embed_tokens"].device.type != self.device.type:
            raise ValueError(f"model lives on {cm.params['embed_tokens'].device}, engine on {self.device}")
        if config.kv_attention_kernel and config.attn_sparsity is not None:
            raise NotImplementedError(
                "kv_attention_kernel: prefill attention sparsity unsupported (flash prefill path owns attention)")
        if config.kv_dtype not in _KV_DTYPES:
            raise ValueError(f"kv_dtype {config.kv_dtype!r}: one of {_KV_DTYPES}")
        # an NVFP4 KV preset selects the packed NVFP4 cache when the caller
        # picked no storage dtype
        kcfg = cm.layout.get("self_attn.k_bmm")
        if config.kv_dtype is None and kcfg.enable and kcfg.is_fp and kcfg.num_bits == (2, 1):
            config = dataclasses.replace(config, kv_dtype="nvfp4")
        if config.kv_dtype in ("nvfp4", "nvfp4_fake") and cm.model_cfg.hd % 16:
            raise ValueError(f"NVFP4 KV needs head_dim % 16 == 0, got {cm.model_cfg.hd}")
        cm = convert_packed_layouts(cm, nvfp4=config.nvfp4_layout, int4=config.int4_layout,
                                    mxfp4=config.nvfp4_layout)
        for name, kind in cm.kinds.items():
            if kind not in _SERVED_KINDS:
                raise NotImplementedError(f"{name}: weight kind {kind!r} is served by a later slice")
        self.cm = cm
        self.cfg = cm.model_cfg
        self.ecfg = config
        self._ops = _ops(config.plain_ops)
        L = self.cfg.num_hidden_layers
        default = torch.full((L,), 448.0, dtype=torch.float32, device=self.device)
        ka, va = _kv_amax_from(cm.qstate, "k"), _kv_amax_from(cm.qstate, "v")
        self._ka = ka if ka is not None else default
        self._va = va if va is not None else default
        self._act_state = {name: {"input": sub["input"]} for name, sub in (cm.qstate or {}).items()
                           if isinstance(sub, dict) and "input" in sub}
        self.last_prefill_keep_frac = None  # [L] after a sparse prefill
        self._caches: dict = {}  # id(a cache's owner tensor) -> _CacheState, dropped with the owner
        self._graph_stream = None  # the side stream the decode steps are captured on
        self._eager = False  # True: the decode steps launch eagerly on the card too (the graphs' reference)

    def _state(self, owner: torch.Tensor) -> "_CacheState":
        """What the engine keeps about the cache `owner` stands for (the
        dense cache's pos, the pool's seq_lens): dropped when `owner` is."""
        st = self._caches.get(id(owner))
        if st is None:
            st = self._caches[id(owner)] = _CacheState()
            weakref.finalize(owner, _forget_cache, weakref.ref(self), id(owner))
        return st

    def release_graphs(self) -> None:
        """Drop every captured decode-step graph (and its memory pool)."""
        for st in self._caches.values():
            st.graphs.clear()

    def _replay(self, owner: torch.Tensor, key: tuple, fn, *inputs) -> torch.Tensor:
        """fn(*inputs) on the card as one replay of the graph captured for
        `key` of the cache `owner` stands for (captured on the first call,
        whose eager run is its result)."""
        graphs = self._state(owner).graphs
        g = graphs.get(key)
        if g is None:
            if self._graph_stream is None:
                self._graph_stream = torch.cuda.Stream(device=self.device)
            g = graphs[key] = step_graph.StepGraph(fn, inputs, self._graph_stream)
            return g.first
        return g(*inputs)

    def init_cache(self, batch: int, max_len: Optional[int] = None) -> dict:
        """The dense cache. Einsum engine: stored rows [L, B, S, n_kv, C]
        (packed NVFP4: C = 9 hd/16 bytes). Kernel engine: kv-head-major
        stored form [L, B, n_kv, S, C]; NVFP4 keeps its nibble planes in
        "k"/"v" and its block-scale bytes in "ks"/"vs"."""
        cfg = self.cfg
        max_len = max_len or self.ecfg.max_seq_len
        kvk = self.ecfg.kv_attention_kernel
        dtype, last = self.ecfg.kv_dtype or cfg.dtype, cfg.hd
        if dtype == "nvfp4":
            dtype, last = torch.uint8, (cfg.hd // 2 if kvk else _kv_pack_width(cfg.hd))
        elif dtype == "nvfp4_fake":
            dtype = cfg.dtype

        def rows(width, dt):
            lead = (cfg.num_key_value_heads, max_len) if kvk else (max_len, cfg.num_key_value_heads)
            return torch.zeros((cfg.num_hidden_layers, batch, *lead, width), dtype=dt, device=self.device)

        cache = {"k": rows(last, dtype), "v": rows(last, dtype),
                 "pos": torch.zeros((), dtype=torch.int32, device=self.device)}
        if kvk and self.ecfg.kv_dtype == "nvfp4":
            cache["ks"], cache["vs"] = rows(cfg.hd // 16, torch.uint8), rows(cfg.hd // 16, torch.uint8)
        self._set_pos(cache, 0)
        return cache

    def _layers(self, x, positions, attend_of):
        """Every layer in turn; `attend_of(i)` gives layer i's attention."""
        layers = self.cm.params["layers"]
        for i in range(self.cfg.num_hidden_layers):
            lp = {k: (layer_arrays(v, i) if isinstance(v, dict) else v[i]) for k, v in layers.items()}
            ad = None if self.cm.adapters is None else {
                n: {k: a[i] for k, a in f.items()} for n, f in self.cm.adapters.items()}
            x = _layer(self.cfg, self.cm, x, lp, llama.slice_state(self._act_state, i), self.cm.kinds,
                       positions, self._ops, attend_of(i), ad)
        return x

    def _logits(self, x: torch.Tensor, full: bool = False) -> torch.Tensor:
        """The last position's logits [B, V] f32, or every position's [B, T, V]."""
        params = self.cm.params
        x = llama.norm(self.cfg, x, params["norm"])
        head_w = params.get("lm_head", params["embed_tokens"])
        return ((x if full else x[:, -1, :]) @ head_w.t().to(x.dtype)).float()

    def _set_pos(self, cache: dict, pos: int) -> None:
        """Record the dense cache's pos as a public call left it."""
        st = self._state(cache["pos"])
        st.pos, st.version = pos, _version(cache["pos"])

    def _room(self, cache: dict, T: int, empty: bool = False) -> int:
        """The host's check of a dense cache before a public call writes T
        rows, never inside a decode step; returns pos. Pos comes from the
        host's record (`_set_pos`); the card is read only for a cache the
        engine has not recorded, or whose pos tensor was written since (its
        version moved: a fill, a direct `_model_step`)."""
        p = cache["pos"]
        st = self._state(p)
        if st.pos is None or st.version is None or st.version != _version(p):
            self._set_pos(cache, int(p))
        pos = st.pos
        rows = cache["k"].shape[3 if self.ecfg.kv_attention_kernel else 2]
        if empty and pos != 0:
            raise ValueError(f"prefill needs an empty cache (pos == 0), got pos {pos}")
        if pos + T > rows:
            raise ValueError(f"cache holds {rows} rows, step needs {pos + T}")
        return pos

    @torch.inference_mode()
    def _model_step(self, tokens: torch.Tensor, cache: dict, full_logits: bool = False,
                    keep_fracs: Optional[list] = None) -> torch.Tensor:
        """Forward over packed weights; updates `cache` in place, its pos
        included. Returns the last position's logits [B, V] f32 (every
        position's with `full_logits`). A list `keep_fracs` runs the einsum
        engine's sparse prefill and receives each layer's kept share of
        tiles. Reads nothing back to the host: the caller checks the room
        (`_room`)."""
        cfg = self.cfg
        B, T = tokens.shape
        pos = cache["pos"]
        kvk = self.ecfg.kv_attention_kernel
        if kvk and keep_fracs is not None:
            raise NotImplementedError("kv_attention_kernel does not support sparse-prefill steps")
        x = self.cm.params["embed_tokens"][tokens].to(cfg.dtype)
        positions = (pos + torch.arange(T, device=self.device, dtype=torch.int32))[None].expand(B, T)
        packed4 = "ks" in cache

        def attend_of(i):
            if not kvk:
                return lambda q, k, v: _einsum_attn(cfg, self.ecfg, q, k, v, cache["k"][i], cache["v"][i], pos,
                                                    self._ka[i], self._va[i], self._ops, keep_fracs)
            cks, cvs = (cache["ks"][i], cache["vs"][i]) if packed4 else (None, None)
            return lambda q, k, v: _dense_attn(cfg, self.ecfg, q, k, v, cache["k"][i], cache["v"][i], cks, cvs,
                                               pos, self._ka[i], self._va[i], self._ops)

        x = self._layers(x, positions, attend_of)
        pos.add_(T)
        return self._logits(x, full_logits)

    def prefill(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """Prefill an empty cache with tokens [B, T]; returns logits [B, V].
        With `attn_sparsity` set and T > 1 the einsum engine attends through
        the skip-softmax kernel and records each layer's kept share of tiles
        in `last_prefill_keep_frac` [L]."""
        self._room(cache, tokens.shape[1], empty=True)
        keep = [] if self.ecfg.attn_sparsity is not None and tokens.shape[1] > 1 else None
        logits = self._model_step(tokens, cache, keep_fracs=keep)
        self._set_pos(cache, tokens.shape[1])
        if keep is not None:
            self.last_prefill_keep_frac = torch.stack(keep)
        return logits

    def _greedy_steps(self, tok: torch.Tensor, cache: dict, unroll: int) -> torch.Tensor:
        """`unroll` chained greedy steps, the argmax on the device."""
        for _ in range(unroll):
            tok = torch.argmax(self._model_step(tok, cache), dim=-1).to(torch.int32)[:, None]
        return tok

    @torch.inference_mode()
    def decode_step(self, tok: torch.Tensor, cache: dict, unroll: int = 1) -> tuple[torch.Tensor, dict]:
        """Fused greedy decode: (tok [B, 1], cache) -> (next [B, 1] int32,
        cache), JAX's `decode_step`. Runs `unroll` chained greedy steps, the
        argmax on the device and each step's token feeding the next, and
        returns the last token; the cache is updated in place (JAX donates
        it) and returned. On the card one call is one CUDA-graph replay (see
        the module docstring); on the CPU the steps run eagerly."""
        if unroll < 1:
            raise ValueError(f"unroll {unroll} < 1")
        pos = self._room(cache, unroll)
        tok = tok.to(device=self.device, dtype=torch.int32)
        if self.device.type != "cuda" or self._eager:
            tok = self._greedy_steps(tok, cache, unroll)
        else:
            key = ("dense", step_graph.tensor_key(*(cache[k] for k in sorted(cache))), tok.shape, unroll)
            tok = self._replay(cache["pos"], key, lambda t: self._greedy_steps(t, cache, unroll), tok)
        self._set_pos(cache, pos + unroll)
        return tok, cache

    def decode(self, first_token: torch.Tensor, cache: dict, steps: int,
               sampling: Optional[SamplingConfig] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Decode `steps` tokens after `first_token` [B, 1] -> [B, steps]:
        greedy through `decode_step` (one replay a step on the card),
        sampled eagerly."""
        sampling = sampling or SamplingConfig()
        greedy = sampling.temperature <= 0.0
        tok, out = first_token, []
        pos = self._room(cache, steps)
        for _ in range(steps):
            if greedy:
                tok, cache = self.decode_step(tok, cache)
            else:
                tok = sample(self._model_step(tok, cache), sampling, generator)[:, None]
            out.append(tok)
        self._set_pos(cache, pos + steps)
        if not out:
            return first_token[:, :0]
        return torch.cat(out, dim=1)

    def generate(self, prompt: torch.Tensor, max_new_tokens: int = 32,
                 sampling: Optional[SamplingConfig] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """prompt [B, T] -> [B, max_new_tokens] (greedy unless `sampling`)."""
        cache = self.init_cache(prompt.shape[0])
        logits = self.prefill(prompt.to(self.device), cache)
        first = sample(logits, sampling or SamplingConfig(), generator)[:, None]
        toks = self.decode(first, cache, max_new_tokens - 1, sampling, generator)
        return torch.cat([first, toks], dim=1)

    def generate_host(self, prompt: torch.Tensor, max_new_tokens: int = 32) -> torch.Tensor:
        """Greedy generation stepped from the host through the fused
        `decode_step` (JAX's `generate_host`): prompt [B, T] ->
        [B, max_new_tokens]."""
        cache = self.init_cache(prompt.shape[0])
        logits = self.prefill(prompt.to(self.device), cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out = [tok]
        for _ in range(max_new_tokens - 1):
            tok, cache = self.decode_step(tok, cache)
            out.append(tok)
        return torch.cat(out, dim=1)

    # ---------------- paged KV + continuous batching ----------------

    def init_paged_cache(self, n_pages: int, page_size: int, max_slots: int,
                         max_pages_per_seq: int) -> pc.PagedKV:
        cfg = self.cfg
        dtype = self.ecfg.kv_dtype or cfg.dtype
        packed4 = dtype == "nvfp4"  # nibble planes + E4M3 scale pools
        if dtype in ("nvfp4", "nvfp4_fake"):
            dtype = cfg.dtype
        return pc.init_paged(cfg.num_hidden_layers, n_pages, page_size, cfg.num_key_value_heads, cfg.hd,
                             max_slots, max_pages_per_seq, dtype, packed_nvfp4=packed4, device=self.device)

    @torch.inference_mode()
    def prefill_into_slot(self, cache: pc.PagedKV, slot: int, tokens: torch.Tensor) -> torch.Tensor:
        """Prefill one sequence [1, T] densely (`prefill`: flash attention, the
        einsum engine's attention, or its sparse route) and copy its
        stored-form cache rows into the slot's pages; the slot's length
        becomes T. Returns the logits [1, V]."""
        T = tokens.shape[1]
        dense = self.init_cache(1, max_len=T)
        logits = self.prefill(tokens.to(self.device), dense)
        page = cache.page_size
        pos = torch.arange(T, device=self.device)
        page_ids = cache.block_table[slot].clamp_min(0).long()[pos // page]
        poff = pos % page
        # the advanced indices (pages axis 1, offsets axis 3) put T first:
        # every source goes in as [T, L, n_kv, C]
        if self.ecfg.kv_attention_kernel:  # [L, n_kv, T, C], the pages' stored form
            k, v = dense["k"][:, 0], dense["v"][:, 0]
            if self.ecfg.kv_dtype == "nvfp4" and not cache.packed_nvfp4:
                # unpacked pages hold the grid values: the planes decoded,
                # times the global scale of the amax they were stored under
                L = self.cfg.num_hidden_layers

                def grid(planes, scales, amax):
                    code = numerics.nvfp4_planes_code_load(planes, scales[:, 0], torch.float32)
                    return (code * numerics.nvfp4_global_scale(amax).reshape(L, 1, 1, 1)).to(cache.k_pages.dtype)

                k, v = grid(k, dense["ks"], self._ka), grid(v, dense["vs"], self._va)
            pools = [(cache.k_pages, k), (cache.v_pages, v)]
            if cache.packed_nvfp4:
                pools += [(cache.k_scales, dense["ks"][:, 0]), (cache.v_scales, dense["vs"][:, 0])]
            pools = [(pool, rows.permute(2, 0, 1, 3)) for pool, rows in pools]
        else:  # [L, T, n_kv, C]
            k, v = dense["k"][:, 0].transpose(0, 1), dense["v"][:, 0].transpose(0, 1)
            hd = self.cfg.hd
            if cache.packed_nvfp4:
                # the one-row NVFP4 form -> nibble planes and E4M3 scale bytes
                def planes(stored):
                    codes = numerics.unpack_nibbles(stored[..., :hd // 2])
                    return codes[..., :hd // 2] | (codes[..., hd // 2:] << 4), stored[..., hd // 2:]

                (kpl, ksc), (vpl, vsc) = planes(k), planes(v)
                pools = [(cache.k_pages, kpl), (cache.v_pages, vpl), (cache.k_scales, ksc), (cache.v_scales, vsc)]
            else:
                if self.ecfg.kv_dtype == "nvfp4":  # unpacked pages hold the grid values
                    L = self.cfg.num_hidden_layers
                    k = _kv_load(k, self.cfg.dtype, "nvfp4", self._ka.reshape(1, L, 1, 1))
                    v = _kv_load(v, self.cfg.dtype, "nvfp4", self._va.reshape(1, L, 1, 1))
                pools = [(cache.k_pages, k), (cache.v_pages, v)]
        for pool, rows in pools:
            pool[:, page_ids, :, poff] = rows.to(pool.dtype)
        cache.seq_lens[slot] = T
        return logits

    @torch.inference_mode()
    def paged_step(self, tokens: torch.Tensor, cache: pc.PagedKV, active: torch.Tensor) -> torch.Tensor:
        """One continuous-batching step over all slots: tokens [B, T] (T = 1
        decode; T > 1 a prefill chunk) land at positions seq_lens ..
        seq_lens + T - 1 of the slots named by `active` [B] bool, whose
        lengths advance by T; the other slots are computed too, write to the
        scratch page and keep their length. Returns the last position's
        logits [B, V] f32; the pool is updated in place."""
        if "self_attn.sinks" in self.cm.params["layers"]:
            raise NotImplementedError("paged serving does not support attention sinks / sliding windows")
        cfg = self.cfg
        B, T = tokens.shape
        tokens, active = tokens.to(self.device), active.to(self.device)
        x = self.cm.params["embed_tokens"][tokens].to(cfg.dtype)
        positions = cache.seq_lens[:, None] + torch.arange(T, device=self.device, dtype=torch.int32)[None, :]
        packed4 = cache.packed_nvfp4

        def attend_of(i):
            ksc, vsc = (cache.k_scales[i], cache.v_scales[i]) if packed4 else (None, None)
            return lambda q, k, v: _paged_layer_attn(cfg, self.ecfg, q, k, v, cache.k_pages[i], cache.v_pages[i],
                                                     ksc, vsc, cache, self._ka[i], self._va[i], active, self._ops)

        x = self._layers(x, positions, attend_of)
        cache.seq_lens += T * active.to(torch.int32)
        return self._logits(x)

    def _paged_greedy_steps(self, tok, cache: pc.PagedKV, active, unroll: int, return_all: bool):
        toks = []
        for _ in range(unroll):
            tok = torch.argmax(self.paged_step(tok, cache, active), dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
        return torch.cat(toks, dim=1) if return_all else tok

    @torch.inference_mode()
    def paged_decode_step(self, tok: torch.Tensor, cache: pc.PagedKV, active: torch.Tensor,
                          unroll: int = 1, return_all: bool = False) -> torch.Tensor:
        """`unroll` chained greedy paged steps: each step's argmax stays on
        the device and feeds the next, with no host sync between them. The
        caller guarantees every active slot page capacity through seq_len +
        unroll. Returns the block [B, unroll] int32 with `return_all`, else
        its last column [B, 1]. On the card one call is one CUDA-graph
        replay, keyed by the pool's and the tables' tensors, B, `unroll` and
        `return_all`: the scheduler updates the block table and the lengths
        in place, so the graph reads what it wrote there."""
        tok = tok.to(device=self.device, dtype=torch.int32)
        active = active.to(self.device)
        if self.device.type != "cuda" or self._eager:
            return self._paged_greedy_steps(tok, cache, active, unroll, return_all)
        key = ("paged", step_graph.tensor_key(cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales,
                                              cache.block_table), tok.shape, unroll, return_all)
        return self._replay(cache.seq_lens, key,
                            lambda t, a: self._paged_greedy_steps(t, cache, a, unroll, return_all), tok, active)

    def prefill_chunked(self, cache: pc.PagedKV, slot: int, tokens: torch.Tensor, chunk: int = 64) -> torch.Tensor:
        """Paged chunked prefill: stream the prompt [1, T] into the slot's
        pages in chunks of `chunk` tokens, then single-token steps for the
        remainder; positions continue at the slot's length, so the tokens
        attend to whatever its pages already hold (a shared prefix). All
        slots are computed, only `slot` writes. Returns the last logits [V]."""
        B = cache.block_table.shape[0]
        T = tokens.shape[1]
        tokens = tokens.to(self.device)
        onehot = torch.zeros((B,), dtype=torch.bool, device=self.device)
        onehot[slot] = True
        logits, done = None, 0
        while done < T:
            step_t = chunk if T - done >= chunk else 1
            toks = torch.zeros((B, step_t), dtype=tokens.dtype, device=self.device)
            toks[slot] = tokens[0, done:done + step_t]
            logits = self.paged_step(toks, cache, onehot)
            done += step_t
        return logits[slot]

    def serve(self, requests, n_pages=64, page_size=16, max_slots=4, max_pages_per_seq=16,
              prefix_cache=False, unroll=1, collect_metrics=False):
        """Continuous batching over a request list. Returns {rid: tokens}
        (or (outs, metrics) with `collect_metrics`).

        `prefix_cache=True` shares full prompt-prefix pages across requests
        (an admission with a cached prefix prefills only its tail, through
        `prefill_chunked`). `unroll > 1` is multi-step scheduling: one call
        emits an `unroll`-token block per slot with no host sync inside
        (overshoot past EOS is dropped; needs unroll <= page_size so the
        admit-time page reservation absorbs the cache overshoot). Metrics:
        per-request TTFT from the start of `serve` (queueing included) as
        p50 / p95, total tok/s, slot utilization (active-slot-steps over
        slots x steps), the number of decode dispatches and of each prefill
        route, and the scheduler's free pages at the end."""
        if unroll > page_size:
            raise ValueError(f"unroll {unroll} > page_size {page_size}")
        sched = Scheduler(max_slots, n_pages, page_size, max_pages_per_seq, prefix_cache=prefix_cache)
        for r in requests:
            sched.submit(r)
        cache = self.init_paged_cache(n_pages, page_size, max_slots, max_pages_per_seq)
        last_tok = np.zeros((max_slots, 1), np.int32)
        t0 = time.time()
        ttft = {}
        steps = active_slot_steps = dense_prefills = chunked_prefills = 0
        while sched.has_work:
            cache, admissions = sched.admit(cache)
            for slot, req in admissions:
                skip = int(cache.seq_lens[slot])  # cached prefix
                prompt = torch.from_numpy(np.asarray(req.prompt))[None]
                if skip > 0:
                    # the tail attends to the shared prefix pages
                    logits = self.prefill_chunked(cache, slot, prompt[:, skip:])
                    chunked_prefills += 1
                else:
                    logits = self.prefill_into_slot(cache, slot, prompt)[0]
                    dense_prefills += 1
                sched.register_prefix(slot)
                first = int(torch.argmax(logits))
                ttft[req.rid] = time.time() - t0
                req.output.append(first)
                last_tok[slot, 0] = first
                if len(req.output) >= req.max_new_tokens or (req.eos_token is not None and first == req.eos_token):
                    req.done = True
            active = sched.active_mask()
            if not active.any():
                cache = sched.retire(cache)
                continue
            tok, act = torch.from_numpy(last_tok).to(self.device), torch.from_numpy(active).to(self.device)
            blk = self.paged_decode_step(tok, cache, act, unroll=unroll, return_all=True).cpu().numpy()
            if unroll > 1:
                sched.record_token_block(blk)
            else:
                sched.record_tokens(blk[:, 0])
            nxt = blk[:, -1]
            steps += 1
            active_slot_steps += int(active.sum())
            last_tok[active, 0] = nxt[active]
            cache = sched.retire(cache)
        outs = {r.rid: r.output for r in requests}
        if not collect_metrics:
            return outs
        wall = time.time() - t0
        tt = sorted(ttft.values())

        def pct(q):
            return tt[min(len(tt) - 1, int(q * len(tt)))] if tt else 0.0

        total_new = sum(len(v) for v in outs.values())
        return outs, {
            "wall_s": wall,
            "tok_s": total_new / wall if wall else 0.0,
            "ttft_p50_s": pct(0.50),
            "ttft_p95_s": pct(0.95),
            "slot_utilization": active_slot_steps / (steps * max_slots) if steps else 0.0,
            "decode_dispatches": steps,
            "unroll": unroll,
            "dense_prefills": dense_prefills,
            "chunked_prefills": chunked_prefills,
            "free_pages": len(sched.free_pages),
        }
