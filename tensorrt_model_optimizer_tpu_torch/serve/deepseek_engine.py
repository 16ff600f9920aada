"""DeepSeek serving over the MLA latent cache (port of
`serve/deepseek_engine.py`).

`compress` packs every projection of both layer groups (attention, dense
MLP, routed and shared experts) into the canonical kinds of
`quant.compress.compress_weight`, one layer (and expert) at a time.
`DeepseekEngine` serves them:

 - projections go through the ported GEMMs (`_lin`): the site's input
   quantizer (fake-quantized activations, as JAX's `_lin` applies it), then
   INT4 -> `qmm_int4_wo` (the f32 block scales of JAX's `qmm_int4`),
   NVFP4 -> `qmm_fp4_wo`, INT8 / FP8 -> `qmm_byte_wo` (`engine._qlinear`
   with the input already quantized). JAX reaches the Pallas `qmm_int4` /
   `qmm_nvfp4` there and XLA's dot for the byte formats;
 - attention is the absorbed form over the latent cache at prefill and
   decode alike (JAX's engine prefills through `_mla_decode` too), in f32
   with plain PyTorch einsums as JAX's are XLA's: the new latent goes
   through `ckv_bmm`, then kv_b's input quantizer, then into the cache at
   pos, and every query attends over the whole cache under the -1e9 mask of
   the positions after its own. kv_b is dequantized once, when the engine
   is built, in the model dtype (JAX dequantizes it on every call: the same
   values); the scores are computed a group of heads at a time where the
   whole [B, nH, T, S] would pass `SCORE_BYTES` (no sum crosses heads, so
   the grouping changes no value);
 - the FFN is the kernel engine's (`engine._ffn`) with `_lin` for the
   dense MLP and the shared experts: the routed experts take the model's
   routing and index dispatch (`DeepseekConfig.route_dispatch`) and run
   each expert's C rows through the ported GEMMs (`engine._expert_linear`),
   not JAX's dequantized expert stacks (22.5 GB of bf16 a layer at V3's
   widths); the expert input quantizer is applied per expert's rows, as
   JAX's vmap does;
 - `_model_step` returns the last position's logits and updates the cache
   in place, its device `pos` included; `decode_step(tok, cache, unroll)`
   is one CUDA-graph replay on the card (`engine.StepEngine`), the steps
   eagerly on the CPU.

`DeepseekEngine(cm, mesh=..., tp_axis=...)` serves one rank's shard of the
model (`serve/deepseek_tp.py`: MLA over heads, the routed experts over the
same axis, the shared experts and the dense MLPs column / row parallel; a
whole model is sharded at construction): the row sites SUM their partial
outputs (the routed and the shared expert's partials in one SUM, as JAX's),
a dynamic per-token amax at their input is MAX-reduced first, and the
latent cache is replicated. On the card the decode step is a CUDA graph
only under an nccl group; under gloo it raises unless `_eager` is set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import resolve_device
from ..models import deepseek as ds
from ..models import llama
from ..quant import quantizer as Q
from ..parallel.mesh import Axis
from ..quant.compress import convert_layers, decompress_weight, layer_arrays, pack_stack
from . import deepseek_tp as dtp
from . import engine as eng_mod

SCORE_BYTES = 2 << 30  # f32 scores of one head group at most (a prefill at V3's widths: 16 heads of 128)
# the serving layout of each canonical 4-bit kind: INT4 keeps its f32 block
# scales ("blockdot", JAX's `qmm_int4` reads them so), NVFP4 its one layout
SERVING_LAYOUTS = {"int4": "blockdot", "nvfp4": "word2"}
SERVED_KINDS = ("int4wo", "nvfp4wo", "int8", "fp8", "bf16")


@dataclasses.dataclass
class DeepseekCompressedModel:
    """Packed-weight DeepSeek: each group's projections (`layers_dense`,
    `layers_moe`) replaced by packed dicts; `kinds` maps a site name to its
    kind (the same in both groups)."""

    model_cfg: ds.DeepseekConfig
    params: dict
    kinds: dict
    layout: llama.QuantLayout
    qstate: dict
    shard: Optional[tuple] = None  # (axis, n_shards, rank) of one rank's shard (`deepseek_tp.shard_deepseek`)

    @property
    def packed_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for _, pkey in ds.GROUPS if pkey in self.params
                   for name in self.kinds if name in self.params[pkey]
                   for a in self.params[pkey][name].values() if isinstance(a, torch.Tensor))


def _group_sites(cfg: ds.DeepseekConfig, key: str) -> tuple:
    return ds.attn_names(cfg) + (ds.DENSE_NAMES if key == "dense" else ds.MOE_NAMES + ds.SHARED_NAMES)


@torch.no_grad()
def compress(qm: ds.DeepseekQuantizedModel) -> DeepseekCompressedModel:
    """Pack every projection of both groups (attention, dense MLP, shared
    and routed experts) under its calibrated state; the packs are JAX's by
    value."""
    cfg = qm.model_cfg
    kinds: dict = {}
    params = dict(qm.params)
    for key, pkey in ds.GROUPS:
        if pkey not in params:
            continue
        group, gstate = dict(params[pkey]), qm.qstate.get(key, {})
        for name in _group_sites(cfg, key):
            if name in group:
                st = gstate.get(name, {}).get("weight")
                kinds[name], group[name] = pack_stack(group[name], qm.layout.get(f"{name}.weight"), st)
        params[pkey] = group
    return DeepseekCompressedModel(cfg, params, kinds, qm.layout, qm.qstate)


def _lin(cm, lstate, name: str, x: torch.Tensor, lp: dict, ops, tp: Optional[Axis] = None,
         reduce: bool = True) -> torch.Tensor:
    """y = q_act(x) @ dequant(W)^T for x [N, K]: the site's input quantizer,
    then the weight's ported GEMM. Under tensor parallelism (`tp`) a row
    site MAX-reduces a dynamic per-token amax before quantizing and SUMs
    its partial output (unless `reduce` is False)."""
    row = tp is not None and tp.size > 1 and name in dtp.DS_ROW
    icfg = cm.layout.get(f"{name}.input")
    ist = (lstate or {}).get(name, {}).get("input")
    if icfg.enable or (ist is not None and ist.pre_quant_scale is not None):
        x = Q.quantize(x, icfg, ist, amax_reduce=tp.max if row else None)
    return eng_mod._qlinear(x, name, cm.kinds[name], lp[name], cm, None, ops, skip_input_quant=True, tp=tp,
                            row=row, reduce_out=reduce)


def _mla_decode(cfg: ds.DeepseekConfig, cm, x, lp, lstate, positions, mask, ckv, kpe, pos, wkb, ops, tp=None):
    """Absorbed MLA of one layer over its latent cache ckv [B, S, r], kpe
    [B, S, dr] (written in place at rows pos .. pos + T - 1 before the
    attention reads them); x [B, T, H] -> [B * T, H]. `wkb` [nH, dn + dv, r]
    is the layer's dequantized kv_b. Under tensor parallelism cfg's heads
    are this rank's and o_proj SUMs over `tp`."""
    B, T, H = x.shape
    nH = cfg.num_attention_heads
    dn, dr, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    x2 = x.reshape(B * T, H)
    if cfg.q_lora_rank:
        cq = llama.rms_norm(_lin(cm, lstate, "self_attn.q_a_proj", x2, lp, ops), lp["self_attn.q_a_norm"],
                            cfg.rms_norm_eps)
        q = _lin(cm, lstate, "self_attn.q_b_proj", cq, lp, ops)
    else:
        q = _lin(cm, lstate, "self_attn.q_proj", x2, lp, ops)
    q = q.reshape(B, T, nH, dn + dr)
    q_nope = q[..., :dn]
    q_pe = llama.rope(q[..., dn:], positions, cfg.rope_theta, cfg.rope_scaling)
    ckv_full = _lin(cm, lstate, "self_attn.kv_a_proj", x2, lp, ops).reshape(B, T, r + dr)
    c_kv = llama.rms_norm(ckv_full[..., :r], lp["self_attn.kv_a_norm"], cfg.rms_norm_eps)
    k_pe = llama.rope(ckv_full[..., None, r:], positions, cfg.rope_theta, cfg.rope_scaling)[:, :, 0]

    lst = lstate or {}
    ccfg, pcfg = cm.layout.get("self_attn.ckv_bmm"), cm.layout.get("self_attn.kpe_bmm")
    if ccfg.enable:  # the latent-cache quantizers, as the model's forward applies them
        c_kv = Q.quantize(c_kv, ccfg, lst.get("self_attn.ckv_bmm"))
    if pcfg.enable:
        k_pe = Q.quantize(k_pe, pcfg, lst.get("self_attn.kpe_bmm"))
    # kv_b's input quantizer before the cache write: the model's forward
    # caches the quantized latent
    kvb_icfg = cm.layout.get("self_attn.kv_b_proj.input")
    c_q = Q.quantize(c_kv, kvb_icfg, lst.get("self_attn.kv_b_proj", {}).get("input")) if kvb_icfg.enable else c_kv
    rows = eng_mod._rows_at(pos, T)
    eng_mod._write_rows(ckv, 1, rows, c_q)
    eng_mod._write_rows(kpe, 1, rows, k_pe)

    ctx = absorbed_attention(cfg, q_nope, q_pe, ckv, kpe, wkb, mask)
    return _lin(cm, lstate, "self_attn.o_proj", ctx, lp, ops, tp)


def absorbed_attention(cfg: ds.DeepseekConfig, q_nope, q_pe, ckv, kpe, wkb, mask) -> torch.Tensor:
    """The absorbed form in f32 (JAX's einsums, plain PyTorch): q_nope [B, T,
    nH, dn] through kv_b's key half into the latent space, scores against
    the latent cache ckv [B, S, r] plus the rope scores against kpe [B, S,
    dr], scaled, masked (mask [1, 1, T, S]), softmax, the context taken
    back through kv_b's value half -> [B * T, nH * dv] in q's dtype. A group
    of heads at a time where the whole scores would pass SCORE_BYTES."""
    B, T, nH, dn = q_nope.shape
    S, dv = ckv.shape[1], cfg.v_head_dim
    scale = ds.softmax_scale(cfg)
    ckv32, kpe32 = ckv.float(), kpe.float()
    ctx = torch.empty((B, T, nH, dv), dtype=torch.float32, device=q_nope.device)
    group = max(1, min(nH, SCORE_BYTES // (B * T * S * 4)))
    for h0 in range(0, nH, group):
        hs = slice(h0, min(nH, h0 + group))
        wk, wv = wkb[hs, :dn].float(), wkb[hs, dn:].float()
        q_lat = torch.einsum("btnd,ndr->btnr", q_nope[:, :, hs].float(), wk)
        scores = (torch.einsum("btnr,bsr->bnts", q_lat, ckv32)
                  + torch.einsum("btnd,bsd->bnts", q_pe[:, :, hs].float(), kpe32)) * scale + mask
        probs = torch.softmax(scores, dim=-1)
        del scores
        ctx[:, :, hs] = torch.einsum("btnr,ndr->btnd", torch.einsum("bnts,bsr->btnr", probs, ckv32), wv)
        del probs
    return ctx.to(q_nope.dtype).reshape(B * T, nH * dv)


def _served_state(gstate: dict) -> dict:
    """What serving reads of a group's state: the input quantizers' and the
    latent-cache sites' states."""
    out = {}
    for name, sub in (gstate or {}).items():
        if isinstance(sub, dict) and "input" in sub:
            out[name] = {"input": sub["input"]}
        elif name in ds.CACHE_SITES:
            out[name] = sub
    return out


class DeepseekEngine(eng_mod.StepEngine):
    """Greedy serving of a `DeepseekCompressedModel` over the latent cache,
    on `device` (cuda unless the caller passes device="cpu"; the model must
    live there). `plain_ops` names kernels (`engine.PLAIN_ALL`) whose plain
    PyTorch versions run instead, on any device, to hold the kernel path
    against them."""

    def __init__(self, cm: DeepseekCompressedModel, max_seq_len: int = 2048, device=None, plain_ops: tuple = (),
                 mesh=None, tp_axis: str = "tp"):
        super().__init__(resolve_device(mesh.device if device is None and mesh is not None else device), mesh)
        self._tp = Axis(mesh, tp_axis) if mesh is not None else None
        if mesh is not None:
            d, r = self._tp.size, self._tp.index
            if cm.shard is None:
                cm = dtp.shard_deepseek(cm, d, r, tp_axis)
            elif tuple(cm.shard) != (tp_axis, d, r):
                raise ValueError(f"the model is shard {cm.shard}, this rank serves ({tp_axis!r}, {d}, {r})")
        elif cm.shard is not None:
            raise ValueError(f"the model is shard {cm.shard} of a mesh: give the engine the mesh")
        if cm.params["embed_tokens"].device.type != self.device.type:
            raise ValueError(f"model lives on {cm.params['embed_tokens'].device}, engine on {self.device}")
        cfg = cm.model_cfg
        params, kinds = dict(cm.params), dict(cm.kinds)
        self._kvb, self._layers, self._lstates = {}, {}, {}
        nH, dn, dv, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
        for key, pkey in ds.GROUPS:
            if pkey not in params:
                continue
            group = params[pkey]
            kvb = group["self_attn.kv_b_proj"]
            L = group["input_layernorm"].shape[0]
            self._kvb[key] = [decompress_weight(cm.kinds["self_attn.kv_b_proj"], layer_arrays(kvb, i), cfg.dtype)
                              .reshape(nH, dn + dv, r) for i in range(L)]
            group, converted = convert_layers(group, cm.kinds, SERVING_LAYOUTS)
            kinds.update({n: kd for n, kd in converted.items() if n in group})
            params[pkey] = group
            self._layers[key] = [{n: (layer_arrays(v, i) if isinstance(v, dict) else v[i]) for n, v in group.items()}
                                 for i in range(L)]
            served = _served_state(cm.qstate.get(key))
            self._lstates[key] = [llama.slice_state(served, i) for i in range(L)]
        for name, kind in kinds.items():
            if kind not in SERVED_KINDS:
                raise NotImplementedError(f"{name}: weight kind {kind!r} is not served by the DeepSeek engine")
        self.cm = dataclasses.replace(cm, params=params, kinds=kinds)
        self.cfg = cfg
        self.max_seq_len = max_seq_len
        self._ops = eng_mod._ops(plain_ops)

    def _cache_rows(self, cache: dict) -> int:
        return cache["ckv_moe"].shape[2]

    def init_cache(self, batch: int, max_len: Optional[int] = None) -> dict:
        """`models.deepseek.init_cache`'s latent cache on the engine's device
        (model dtype), pos 0."""
        cache = ds.init_cache(self.cfg, batch, max_len or self.max_seq_len, device=self.device)
        self._set_pos(cache, 0)
        return cache

    @torch.inference_mode()
    def _model_step(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """tokens [B, T] at the cache's pos -> the last position's logits
        [B, V] f32; writes the tokens' latent rows and advances pos in place.
        Reads nothing back to the host: the caller checks the room."""
        cfg = self.cfg
        B, T = tokens.shape
        pos = cache["pos"]
        positions = (pos + torch.arange(T, device=self.device, dtype=torch.int32))[None].expand(B, T)
        mask = llama.cache_mask(cache["ckv_moe"].shape[2], positions)
        x = self.cm.params["embed_tokens"][tokens].to(cfg.dtype)
        for key, _ in ds.GROUPS:
            for i, lp in enumerate(self._layers.get(key, ())):
                lstate = self._lstates[key][i]
                h = llama.rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
                x = x + _mla_decode(cfg, self.cm, h, lp, lstate, positions, mask, cache[f"ckv_{key}"][i],
                                    cache[f"kpe_{key}"][i], pos, self._kvb[key][i], self._ops, self._tp).reshape(x.shape)
                h2 = llama.rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps).reshape(B * T, -1)

                def lin(v, name, reduce=True, lp=lp, lstate=lstate):
                    return _lin(self.cm, lstate, name, v, lp, self._ops, self._tp, reduce)

                x = x + eng_mod._ffn(cfg, self.cm, h2, lp, lstate, self.cm.kinds, self._ops, lin, self._tp,
                                     one_sum=True).reshape(x.shape)
        pos.add_(T)
        x = llama.rms_norm(x, self.cm.params["norm"], cfg.rms_norm_eps)
        head_w = self.cm.params.get("lm_head", self.cm.params["embed_tokens"])
        return (x[:, -1, :] @ head_w.t().to(x.dtype)).float()

    def prefill(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """Prefill an empty cache with tokens [B, T] -> logits [B, V]."""
        self._room(cache, tokens.shape[1], empty=True)
        logits = self._model_step(tokens.to(self.device), cache)
        self._set_pos(cache, tokens.shape[1])
        return logits
