"""Diffusion transformer (DiT) with quantization sites (port of
`models/dit.py`).

Patchify, adaLN-zero transformer blocks and unpatchify, with the sites named
as JAX names them (`blocks.{i}.attn.qkv` / `attn.proj` / `mlp.fc1` /
`mlp.fc2`, and `adaLN.mod`, which every preset leaves unquantized). The
parameters are JAX's tree as tensors: block weights stacked `[depth, out,
in]`, their biases `[depth, out]`; the quantizer state is JAX's dict of
`QuantizerState`s with stacked `[depth, ...]` amaxes. JAX's `lax.scan` over
the blocks is a Python loop here.

`forward` is the fake-quant model (calibration with `calib=True`, the
discriminator's features with `return_features=True`); `compress_dit` packs
the block weights as `quant.compress.compress_weight` packs a projection
(JAX's canonical packs, bit for bit); `forward_packed` is the real-quant
denoise step: every block GEMM goes through the serving engine's
`_qlinear`, so INT4 block-128, NVFP4, MXFP4 and FP8 weights run the
weight-only GEMM kernels (`ops/cuda/qmm_wo.py`) and INT8 under its int input
quantizer runs W8A8 (`engine.int8_mm`), as JAX's runs its Pallas kernels and
XLA's int8 dot. The canonical packs are turned into the kernels' layouts
(`serving_layouts`) once; `forward_packed` takes either.

Attention is a plain f32 einsum, softmax and the probabilities rounded to
the activation dtype before P.V, as JAX's XLA einsums compute it (no TPU
kernel runs there). JAX's GELU is the tanh approximation.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..quant import quantizer as Q
from ..quant.config import QuantizeConfig
from ..quant.quantizer import QuantizerState
from .llama import QuantLayout, _map_state, slice_state, stack_states


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    img_size: int = 32
    patch_size: int = 4
    in_channels: int = 4
    hidden_size: int = 256
    depth: int = 6
    num_heads: int = 4
    mlp_ratio: float = 4.0
    dtype: Any = torch.float32

    @property
    def n_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.patch_size ** 2

    @staticmethod
    def tiny(**kw) -> "DiTConfig":
        base = dict(img_size=16, patch_size=4, in_channels=4, hidden_size=64, depth=2, num_heads=4)
        base.update(kw)
        return DiTConfig(**base)

    @staticmethod
    def xl_2(**kw) -> "DiTConfig":
        """DiT-XL/2 (facebookresearch/DiT `models.py` `DiT_XL_2`: hidden 1152,
        depth 28, 16 heads, patch 2) on 32 x 32 x 4 latents (256 px)."""
        base = dict(img_size=32, patch_size=2, in_channels=4, hidden_size=1152, depth=28, num_heads=16)
        base.update(kw)
        return DiTConfig(**base)


PROJ_NAMES = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2", "adaLN.mod")


def _shapes(cfg: DiTConfig) -> dict[str, tuple[int, int]]:
    h = cfg.hidden_size
    m = int(h * cfg.mlp_ratio)
    return {"attn.qkv": (3 * h, h), "attn.proj": (h, h), "mlp.fc1": (m, h), "mlp.fc2": (h, m),
            "adaLN.mod": (6 * h, h)}


def init_params(cfg: DiTConfig, generator: torch.Generator, device=None) -> dict:
    """Seeded N(0, 1/fan_in) weights in `cfg.dtype` on `device` (the card
    unless the caller passes the CPU; `generator` lives there), with JAX's
    adaLN-zero init: `adaLN.mod`, `final_mod` and `final_proj` are zeros and
    every bias is zero."""
    dev = resolve_device(device)
    h = cfg.hidden_size

    def winit(shape, fan):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=dev).div_(math.sqrt(fan)).to(cfg.dtype)

    blocks: dict[str, Any] = {}
    for name, (o, inp) in _shapes(cfg).items():
        w = torch.empty((cfg.depth, o, inp), dtype=cfg.dtype, device=dev)
        for i in range(cfg.depth):  # one block's f32 transient at a time
            w[i] = winit((o, inp), inp)
        blocks[name] = w.zero_() if name == "adaLN.mod" else w
        blocks[name + "__bias"] = torch.zeros((cfg.depth, o), dtype=cfg.dtype, device=dev)
    return {
        "patch_embed": winit((h, cfg.patch_dim), cfg.patch_dim),
        "pos_embed": winit((cfg.n_patches, h), h) * 0.02,
        "t_mlp1": winit((h, 256), 256),
        "t_mlp2": winit((h, h), h),
        "blocks": blocks,
        "final_mod": torch.zeros((2 * h, h), dtype=cfg.dtype, device=dev),
        "final_proj": torch.zeros((cfg.patch_dim, h), dtype=cfg.dtype, device=dev),
    }


def build_layout(cfg: DiTConfig, qcfg: QuantizeConfig) -> QuantLayout:
    sites = {}
    for name in PROJ_NAMES:
        full = f"blocks.0.{name}"
        sites[f"{name}.weight"] = qcfg.resolve(f"{full}.weight_quantizer")
        sites[f"{name}.input"] = qcfg.resolve(f"{full}.input_quantizer")
    # the modulation layers stay unquantized (like norms and routers)
    sites["adaLN.mod.weight"] = Q.DISABLED
    sites["adaLN.mod.input"] = Q.DISABLED
    return QuantLayout(sites=tuple(sites.items()))


def init_quant_state(cfg: DiTConfig, layout: QuantLayout, device=None) -> dict:
    def stacked(site_cfg, shape):
        st = Q.init_state(site_cfg, shape, device)
        return _map_state(lambda a: a.expand((cfg.depth,) + tuple(a.shape)).clone(), st)

    state: dict = {}
    for name, (o, inp) in _shapes(cfg).items():
        wcfg, icfg = layout.get(f"{name}.weight"), layout.get(f"{name}.input")
        sub = {}
        if wcfg.enable:
            sub["weight"] = stacked(wcfg, (o, inp))
        if icfg.enable:
            sub["input"] = stacked(icfg, (1, 1, inp))
        if sub:
            state[name] = sub
    return state


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, n_patches, p*p*C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(x: torch.Tensor, img: int, p: int, c: int) -> torch.Tensor:
    B = x.shape[0]
    g = img // p
    x = x.reshape(B, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, img, img, c)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation, in f32, back in x's dtype."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def layer_norm(z: torch.Tensor) -> torch.Tensor:
    """Affine-free LayerNorm, eps 1e-6, statistics in f32."""
    z32 = z.float()
    mu = z32.mean(dim=-1, keepdim=True)
    var = (z32 - mu).square().mean(dim=-1, keepdim=True)
    return ((z32 - mu) * torch.rsqrt(var + 1e-6)).to(z.dtype)


def attention(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, N, 3 h] -> [B, N, h]: f32 scores, softmax, probabilities in the
    activation dtype times v (JAX's two einsums)."""
    B, N, three_h = qkv.shape
    h = three_h // 3
    hd = h // n_heads
    qkv = qkv.reshape(B, N, 3, n_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    att = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    att = torch.softmax(att / math.sqrt(hd), dim=-1).to(qkv.dtype)
    return torch.einsum("bnqk,bknd->bqnd", att, v).reshape(B, N, h)


def _silu(x: torch.Tensor, dtype) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _qlin(x, w, b, name, layout, lstate, calib):
    """Quantized linear with bias on [B, N, K] tokens -> (y, the site's state or None)."""
    wcfg = layout.get(f"{name}.weight")
    icfg = layout.get(f"{name}.input")
    sub = dict(lstate.get(name, {})) if lstate else {}
    if icfg.enable or sub.get("input") is not None:
        st = sub.get("input")
        if calib:
            sub["input"] = Q.collect(x, icfg, st if st is not None else QuantizerState())
        else:
            x = Q.quantize(x, icfg, st)
    w_eff = w
    if wcfg.enable:
        st = sub.get("weight")
        if calib:
            sub["weight"] = Q.collect(w, wcfg, st if st is not None else QuantizerState())
        else:
            w_eff = Q.quantize(w, wcfg, st)
    y = x @ w_eff.t().to(x.dtype) + b.to(x.dtype)
    return y, (sub if sub else None)


def _embed(cfg: DiTConfig, params: dict, x: torch.Tensor, t: torch.Tensor):
    """(patch tokens [B, N, h], the conditioning c [B, h]) in cfg.dtype."""
    tokens = patchify(x.to(cfg.dtype), cfg.patch_size)
    s = tokens @ params["patch_embed"].t().to(cfg.dtype) + params["pos_embed"][None]
    c = F.silu(timestep_embedding(t) @ params["t_mlp1"].t().float())
    c = (c @ params["t_mlp2"].t().float()).to(cfg.dtype)
    return s, c


def _final(cfg: DiTConfig, params: dict, s: torch.Tensor, c: torch.Tensor):
    """(eps [B, H, W, C], the final modulated tokens [B, N, h])."""
    fin = _silu(c, cfg.dtype) @ params["final_mod"].t().to(cfg.dtype)
    fsh, fsc = torch.chunk(fin, 2, dim=-1)
    s = _modulate(layer_norm(s), fsh, fsc)
    out = s @ params["final_proj"].t().to(cfg.dtype)
    return unpatchify(out, cfg.img_size, cfg.patch_size, cfg.in_channels), s


def _block(cfg, s, c, mod_of, lin):
    """One adaLN-zero block: `mod_of(silu(c))` -> [B, 6 h], `lin(z, name)` the
    quantized projection with its bias."""
    sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(mod_of(_silu(c, cfg.dtype)), 6, dim=-1)
    z = _modulate(layer_norm(s), sh1, sc1)
    ctx = attention(lin(z, "attn.qkv"), cfg.num_heads)
    s = s + g1[:, None, :] * lin(ctx, "attn.proj")
    z = _modulate(layer_norm(s), sh2, sc2)
    f1 = gelu(lin(z, "mlp.fc1"))
    return s + g2[:, None, :] * lin(f1, "mlp.fc2")


def forward(cfg: DiTConfig, params: dict, x: torch.Tensor, t: torch.Tensor, *,
            layout: Optional[QuantLayout] = None, qstate: Optional[dict] = None, calib: bool = False,
            return_features: bool = False):
    """Noise prediction for latents x [B, H, W, C] at timesteps t [B] ->
    (eps [B, H, W, C], new_qstate), or with `return_features` (eps, state,
    feats [B, N, h]): the final modulated tokens, the DMD discriminator's
    capture point. The state is None unless calibrating or given one."""
    lay = layout or QuantLayout(sites=())
    s, c = _embed(cfg, params, x, t)
    blocks = params["blocks"]
    new_states = []
    for i in range(cfg.depth):
        lstate = slice_state(qstate, i)
        new_state: dict = {}

        def lin(z, name):
            y, st = _qlin(z, blocks[name][i], blocks[name + "__bias"][i], name, lay, lstate, calib)
            if st:
                new_state[name] = st
            return y

        def mod_of(m):
            return m @ blocks["adaLN.mod"][i].t().to(cfg.dtype) + blocks["adaLN.mod__bias"][i]

        s = _block(cfg, s, c, mod_of, lin)
        new_states.append(new_state)
    eps, s = _final(cfg, params, s, c)
    st = stack_states(new_states) if (calib or qstate) else None
    if return_features:
        return eps, st, s
    return eps, st


def compress_dit(cfg: DiTConfig, params: dict, layout: QuantLayout, qstate: Optional[dict]):
    """Pack every block site per its calibrated quantizer -> (kinds {site:
    kind}, packed {site: arrays stacked [depth, ...]}), JAX's canonical packs
    ("int4", "nvfp4", "mxfp4", "int8", "fp8"; "bf16" for `adaLN.mod`)."""
    from ..quant.compress import pack_stack

    kinds, packed = {}, {}
    for name in PROJ_NAMES:
        wst = (qstate or {}).get(name, {}).get("weight")
        kinds[name], packed[name] = pack_stack(params["blocks"][name], layout.get(f"{name}.weight"), wst)
    return kinds, packed


# the port's kernel layout for each canonical 4-bit pack: INT4 keeps JAX's
# f32 block scales ("blockdot"), as JAX's `qmm_int4` reads them
SERVING_LAYOUTS = {"int4": "blockdot", "nvfp4": "word2", "mxfp4": "word2"}


@torch.no_grad()
def serving_layouts(kinds: dict, packed: dict) -> tuple[dict, dict]:
    """`compress_dit`'s canonical packs -> (kinds, packs) in the weight-only
    kernels' layouts ("int4wo", "nvfp4wo", "mxfp4wo"; the byte and bf16 packs
    as they are), one block at a time."""
    from ..quant.compress import convert_layers

    new_packed, new_kinds = convert_layers(packed, kinds, SERVING_LAYOUTS)
    return new_kinds, new_packed


def packed_refusal(cfg: DiTConfig, kinds: dict, layout: QuantLayout, device: torch.device,
                   plain_ops: tuple = ()) -> Optional[str]:
    """Why `forward_packed` on `device` cannot run these packs (served
    kinds), or None: the engine's rule (`engine.weight_only_refusal`), on
    the model's dtype."""
    from ..serve import engine as E

    return E.weight_only_refusal(types.SimpleNamespace(kinds=kinds, layout=layout, model_cfg=cfg), device,
                                 tuple(plain_ops))


def forward_packed(cfg: DiTConfig, params: dict, kinds: dict, packed: dict, x: torch.Tensor, t: torch.Tensor, *,
                   layout: QuantLayout, qstate: Optional[dict] = None, plain_ops: tuple = ()) -> torch.Tensor:
    """Real-quant denoise step -> eps [B, H, W, C]: `forward`'s math with
    every block GEMM, `adaLN.mod` included, dispatched through the engine's
    `_qlinear` on the packs (canonical, as `compress_dit` gives them, or
    already in `serving_layouts`). `plain_ops` names kernels whose plain
    versions run instead, as `EngineConfig.plain_ops` does. On the card the
    weight-only kernels take bf16 activations only: an f32 model raises the
    engine's TypeError (`engine.weight_only_refusal`) unless `plain_ops`
    names them."""
    from ..quant.compress import layer_arrays
    from ..serve import engine as E

    if any(k in SERVING_LAYOUTS for k in kinds.values()):
        kinds, packed = serving_layouts(kinds, packed)
    refusal = packed_refusal(cfg, kinds, layout, x.device, plain_ops)
    if refusal is not None:
        raise TypeError(refusal)
    cm = types.SimpleNamespace(layout=layout)
    ops = E._ops(tuple(plain_ops))
    blocks = params["blocks"]
    s, c = _embed(cfg, params, x, t)
    for i in range(cfg.depth):
        def lin(z, name):
            ist = (qstate or {}).get(name, {}).get("input")
            ist = None if ist is None else slice_state(ist, i)
            B_, N_, K_ = z.shape
            y = E._qlinear(z.reshape(B_ * N_, K_), name, kinds[name], layer_arrays(packed[name], i), cm, ist, ops)
            return y.reshape(B_, N_, -1) + blocks[name + "__bias"][i].to(y.dtype)

        s = _block(cfg, s, c, lambda m: lin(m[:, None, :], "adaLN.mod")[:, 0], lin)
    return _final(cfg, params, s, c)[0]


def quantize_dit(cfg: DiTConfig, params: dict, quant_cfg, calib_batches):
    """PTQ for DiT: max calibration over (latents, timesteps) batches ->
    (layout, qstate)."""
    from ..quant.config import get_preset

    qcfg = get_preset(quant_cfg) if isinstance(quant_cfg, str) else quant_cfg
    layout = build_layout(cfg, qcfg)
    dev = params["patch_embed"].device
    qstate = init_quant_state(cfg, layout, dev)
    with torch.no_grad():
        for x, t in calib_batches:
            new = forward(cfg, params, x, t, layout=layout, qstate=qstate, calib=True)[1]
            qstate = {**qstate, **new}
    return layout, qstate
