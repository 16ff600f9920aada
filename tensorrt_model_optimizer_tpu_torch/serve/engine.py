"""Quantized serving engine: prefill + decode over packed weights (port of
`serve/engine.py`).

Ported path (the JAX engine's `kv_attention_kernel=True` branch):
 - projections: weight-only INT4 block-128, NVFP4, MXFP4, INT8 per-channel
   and FP8 per-tensor under bf16 activations (`ops/cuda/qmm_wo.py`; the
   site's input quantizer, where the preset has one, fake-quantizes the
   activations first), W4A8 ("int4a8": per-token int8 activations x int4
   block weights, `ops/cuda/qmm.py`) and bf16;
 - KV cache kv-head-major `[L, B, n_kv, S, hd]` in stored form (bf16, int8
   codes with scale amax/127, or fp8 e4m3 with scale amax/448; an
   uncalibrated amax is 448);
 - prefill: causal GQA flash attention over the fresh tokens' QDQ'd k/v
   (`ops/cuda/flash_gqa.py`); the cache must be empty (pos == 0);
 - decode: split attention over the cached rows < pos plus the current
   token's code-domain k/v (`ops/cuda/kv_attention.py`).

There is no jit, scan or buffer donation: layers and steps are Python loops,
and the KV cache is updated in place. A decode step writes each layer's new
cache row right after that layer's attention has read the old rows (JAX
batches the same writes after its layer scan); the values are the same.

Every TPU layout name of a format maps to the one port layout of that format
(`quant/compress.py` `word_convert_site`): `bd2_supported`'s quiet fall back
from bd2 to word2 has no counterpart, because both names are one kernel here.

Not ported (each raises `NotImplementedError` naming its slice):
`int4_layout="xla"`, `nvfp4_layout="i8"` and W8A8 (int8 weights under an int
input quantizer), `kv_attention_kernel=False`, NVFP4 KV, the paged,
tensor-parallel, MoE, sparsity and speculative paths.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from .. import resolve_device
from ..models import llama
from ..ops.cuda import flash_gqa as flash_mod
from ..ops.cuda import kv_attention as kva
from ..ops.cuda import qmm, qmm_wo
from ..quant import quantizer as Q
from ..quant.compress import CompressedModel, convert_packed_layouts, layer_arrays
from .sampling import SamplingConfig, sample

_KV_DTYPES = (None, torch.bfloat16, torch.int8, torch.float8_e4m3fn)
_SERVED_KINDS = ("int4a8", "int4wo", "nvfp4wo", "mxfp4wo", "int8", "fp8", "bf16")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_seq_len: int = 2048
    # None = model dtype; torch.int8 / torch.float8_e4m3fn / torch.bfloat16
    kv_dtype: Any = None
    # INT4 serving layout, by its TPU name: "bd2" | "word" | "word2" |
    # "blockdot" are weight-only (one port layout, "int4wo"; "blockdot" keeps
    # the f32 block scales, the others round them to bf16 as JAX's packs do),
    # "a8" is W4A8 ("int4a8")
    int4_layout: str = "bd2"
    # NVFP4 serving layout, by its TPU name: "word2" | "word" | "perm" |
    # "blockdot" | "bd4", all one port layout ("nvfp4wo"); MXFP4 follows it
    nvfp4_layout: str = "word2"
    # the stored-form kv-head-major cache with the attention kernels
    kv_attention_kernel: bool = False
    # kernels (names of `PLAIN_ALL`) whose plain PyTorch versions run
    # instead, on any device, to hold the kernel path against them
    plain_ops: tuple = ()


_KERNELS = {  # plain_ops name -> (kernel wrapper, plain version)
    "w4a8": (qmm.w4a8_matmul, qmm.w4a8_matmul_plain),
    "kv_attention": (kva.kv_decode_attention, kva.kv_decode_attention_plain),
    "flash": (flash_mod.flash_attention_gqa, flash_mod.flash_attention_gqa_plain),
    "int4_wo": (qmm_wo.int4_wo_matmul, qmm_wo.int4_wo_matmul_plain),
    "fp4_wo": (qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain),
    "byte_wo": (qmm_wo.byte_wo_matmul, qmm_wo.byte_wo_matmul_plain),
}
PLAIN_ALL = tuple(_KERNELS)


def _ops(plain: tuple) -> dict:
    """name -> callable for this engine: the kernel's wrapper, or its plain
    version for the names in `plain`."""
    if set(plain) - set(PLAIN_ALL):
        raise ValueError(f"plain_ops: unknown kernels {sorted(set(plain) - set(PLAIN_ALL))}")
    return {name: pair[name in plain] for name, pair in _KERNELS.items()}


def _qlinear(x, name, kind, arrays, cm: CompressedModel, ist, ops):
    """y = q_act(x) @ dequant(W)^T for x [N, K] (2-D)."""
    if kind == "int4a8":
        # per-token dynamic int8 activations, clipped to +-127
        if ist is not None and ist.pre_quant_scale is not None:
            x = x * ist.pre_quant_scale.to(x.dtype)
        x32 = x.float()
        a_amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
        a_scale = torch.where(a_amax == 0, torch.ones_like(a_amax), a_amax / 127.0)
        x8 = torch.clamp(torch.round(x32 / a_scale), -127, 127).to(torch.int8)
        y = ops["w4a8"](x8, arrays["packed"], arrays["scales"])
        return (y * a_scale).to(x.dtype)
    icfg = cm.layout.get(f"{name}.input")
    if icfg.enable or (ist is not None and ist.pre_quant_scale is not None):
        x = Q.quantize(x, icfg, ist)
    if kind == "int4wo":
        return ops["int4_wo"](x, arrays["packed"], arrays["scales"])
    if kind in ("nvfp4wo", "mxfp4wo"):
        return ops["fp4_wo"](x, arrays["packed"], arrays["scales"], arrays.get("global_scale"))
    if kind in ("int8", "fp8"):
        return ops["byte_wo"](x, arrays["q"], arrays["scale"])
    if kind == "bf16":
        return x @ arrays["w"].to(x.dtype).t()
    raise NotImplementedError(f"weight kind {kind!r} is served by a later slice")


def _kv_store(v: torch.Tensor, dtype, amax: torch.Tensor) -> torch.Tensor:
    """Quantize k/v for cache storage (stored form)."""
    if dtype is None or v.dtype == dtype:
        return v
    if dtype == torch.int8:
        scale = amax / 127.0
        return torch.clamp(torch.round(v.float() / scale), -128, 127).to(torch.int8)
    if dtype == torch.float8_e4m3fn:
        scale = torch.clamp_min(amax.float(), 1e-12) / 448.0
        return torch.clamp(v.float() / scale, -448, 448).to(torch.float8_e4m3fn)
    return v.to(dtype)


def _kv_globals(kv_dtype, k_amax, v_amax):
    """Per-layer global dequant scales (k's fold into q, v's into ctx)."""
    def one(amax):
        if kv_dtype == torch.int8:
            return amax / 127.0
        if kv_dtype == torch.float8_e4m3fn:
            return torch.clamp_min(amax.float(), 1e-12) / 448.0
        return torch.ones((), dtype=torch.float32, device=amax.device)

    return one(k_amax), one(v_amax)


def _kv_fmt(kv_dtype) -> str:
    if kv_dtype == torch.int8:
        return "int8"
    if kv_dtype == torch.float8_e4m3fn:
        return "fp8"
    return "bf16"


def _kv_store_kvh(v: torch.Tensor, kv_dtype, amax) -> torch.Tensor:
    """k/v [B, T, n_kv, hd] -> stored kv-head-major [B, n_kv, T, hd]."""
    return _kv_store(v.transpose(1, 2), kv_dtype, amax)


def _kv_code_new(stored: torch.Tensor, kv_dtype, out_dtype) -> torch.Tensor:
    """Stored form -> code-domain values (global scale not applied)."""
    if kv_dtype in (torch.int8, torch.float8_e4m3fn):
        return stored.float().to(out_dtype)
    return stored.to(out_dtype)


def _kv_amax_from(qstate, which: str) -> Optional[torch.Tensor]:
    st = (qstate or {}).get(f"self_attn.{which}_bmm")
    if st is None or st.amax is None:
        return None
    a = st.amax
    return a.reshape(a.shape[0], -1).amax(dim=-1)  # [L]


def _layer_forward(cfg, ecfg, cm, x, lp, lstate, kinds, positions, ck, cv, pos, ka, va, ops):
    """One decoder layer on packed weights; ck/cv are this layer's
    [B, n_kv, S, hd] cache, written in place."""
    kv_attn, flash = ops["kv_attention"], ops["flash"]
    B, T, H = x.shape
    hd, nH, nKV = cfg.hd, cfg.num_attention_heads, cfg.num_key_value_heads

    def lin(inp, name):
        ist = (lstate or {}).get(name, {}).get("input")
        return _qlinear(inp, name, kinds[name], lp[name], cm, ist, ops)

    h2 = llama.norm(cfg, x, lp["input_layernorm"]).reshape(B * T, H)
    q = llama.rope(lin(h2, "self_attn.q_proj").reshape(B, T, nH, hd), positions,
                   cfg.rope_theta, cfg.rope_scaling)
    k = llama.rope(lin(h2, "self_attn.k_proj").reshape(B, T, nKV, hd), positions,
                   cfg.rope_theta, cfg.rope_scaling)
    v = lin(h2, "self_attn.v_proj").reshape(B, T, nKV, hd)

    kv_dtype = ecfg.kv_dtype
    kg, vg = _kv_globals(kv_dtype, ka, va)
    k_st = _kv_store_kvh(k, kv_dtype, ka)
    v_st = _kv_store_kvh(v, kv_dtype, va)
    if T == 1:
        kn = _kv_code_new(k_st, kv_dtype, cfg.dtype)
        vn = _kv_code_new(v_st, kv_dtype, cfg.dtype)
        q_eff = q.reshape(B, nH, hd).float() * (kg.float() / math.sqrt(hd))
        ctx = kv_attn(q_eff, ck, cv, kn, vn, pos, _kv_fmt(kv_dtype))
        ctx = (ctx * vg).to(x.dtype).reshape(B * T, nH * hd)
        # the new row lands after attention has read rows < pos
        ck[:, :, pos] = k_st[:, :, 0].to(ck.dtype)
        cv[:, :, pos] = v_st[:, :, 0].to(cv.dtype)
    else:
        if pos != 0:
            raise ValueError(f"prefill needs an empty cache (pos == 0), got pos {pos}")
        ck[:, :, :T] = k_st.to(ck.dtype)
        cv[:, :, :T] = v_st.to(cv.dtype)
        kq = (_kv_code_new(k_st, kv_dtype, torch.float32) * kg).to(cfg.dtype)
        vq = (_kv_code_new(v_st, kv_dtype, torch.float32) * vg).to(cfg.dtype)
        ctx = flash(q.transpose(1, 2), kq, vq, True)
        ctx = ctx.transpose(1, 2).reshape(B * T, nH * hd).to(x.dtype)
    x = x + lin(ctx, "self_attn.o_proj").reshape(B, T, H)
    h2 = llama.norm(cfg, x, lp["post_attention_layernorm"]).reshape(B * T, H)
    g = lin(h2, "mlp.gate_proj")
    u = lin(h2, "mlp.up_proj")
    y = (torch.nn.functional.silu(g.float()) * u.float()).to(h2.dtype)
    return x + lin(y, "mlp.down_proj").reshape(B, T, H)


class Engine:
    """Generation engine over a compressed model, on `device` (cuda unless
    the caller passes device="cpu"); the model must already live there."""

    def __init__(self, cm: CompressedModel, config: EngineConfig = EngineConfig(), device=None):
        self.device = resolve_device(device)
        if cm.params["embed_tokens"].device.type != self.device.type:
            raise ValueError(f"model lives on {cm.params['embed_tokens'].device}, engine on {self.device}")
        if not config.kv_attention_kernel:
            raise NotImplementedError(
                "kv_attention_kernel=False (the dense-cache einsum path) comes with the "
                "paged-serving slice")
        if config.kv_dtype not in _KV_DTYPES:
            raise NotImplementedError(f"kv_dtype {config.kv_dtype!r}: NVFP4 KV comes with the NVFP4-KV slice")
        cm = convert_packed_layouts(cm, nvfp4=config.nvfp4_layout, int4=config.int4_layout,
                                    mxfp4=config.nvfp4_layout)
        for name, kind in cm.kinds.items():
            if kind not in _SERVED_KINDS:
                raise NotImplementedError(f"{name}: weight kind {kind!r} is served by a later slice")
            icfg = cm.layout.get(f"{name}.input")
            if kind == "int8" and icfg.enable and not icfg.is_fp:
                raise NotImplementedError(
                    f"{name}: int8 weights under an int input quantizer are W8A8 (int8 x int8 "
                    "products), which comes with the W8A8 slice; weight-only int8 is served")
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

    def init_cache(self, batch: int, max_len: Optional[int] = None) -> dict:
        cfg = self.cfg
        max_len = max_len or self.ecfg.max_seq_len
        dtype = self.ecfg.kv_dtype or cfg.dtype
        shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "pos": 0}

    @torch.inference_mode()
    def _model_step(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """Forward over packed weights; updates `cache` in place. Returns the
        last position's logits [B, V] f32."""
        cfg, params = self.cfg, self.cm.params
        B, T = tokens.shape
        pos = cache["pos"]
        if pos + T > cache["k"].shape[3]:
            raise ValueError(f"cache holds {cache['k'].shape[3]} rows, step needs {pos + T}")
        x = params["embed_tokens"][tokens].to(cfg.dtype)
        positions = (pos + torch.arange(T, device=self.device, dtype=torch.int32))[None].expand(B, T)
        layers = params["layers"]
        for i in range(cfg.num_hidden_layers):
            lp = {k: (layer_arrays(v, i) if isinstance(v, dict) else v[i]) for k, v in layers.items()}
            lstate = llama.slice_state(self._act_state, i)
            x = _layer_forward(cfg, self.ecfg, self.cm, x, lp, lstate, self.cm.kinds, positions,
                               cache["k"][i], cache["v"][i], pos, self._ka[i], self._va[i], self._ops)
        x = llama.norm(cfg, x, params["norm"])
        head_w = params.get("lm_head", params["embed_tokens"])
        cache["pos"] = pos + T
        return (x[:, -1, :] @ head_w.t().to(x.dtype)).float()

    def prefill(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """Prefill an empty cache with tokens [B, T]; returns logits [B, V]."""
        if cache["pos"] != 0:
            raise ValueError("prefill needs an empty cache (pos == 0)")
        return self._model_step(tokens, cache)

    def decode_step(self, tok: torch.Tensor, cache: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """One greedy step: tok [B, 1] -> (next [B, 1] int32, logits [B, V])."""
        logits = self._model_step(tok, cache)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], logits

    def decode(self, first_token: torch.Tensor, cache: dict, steps: int,
               sampling: Optional[SamplingConfig] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Decode `steps` tokens after `first_token` [B, 1] -> [B, steps]."""
        tok, out = first_token, []
        for _ in range(steps):
            logits = self._model_step(tok, cache)
            tok = sample(logits, sampling or SamplingConfig(), generator)[:, None]
            out.append(tok)
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
