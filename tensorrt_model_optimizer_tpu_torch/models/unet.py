"""Latent-diffusion UNet with quantized convolutions (port of
`models/unet.py`).

ResBlocks, a mid attention block and skip connections, every convolution
and linear carrying a weight and an input quantizer named as JAX names
them (`down.{l}.res{r}.conv1`, `mid.attn.q`, `conv_out`, ...), so the
presets' wildcards apply. Activations keep JAX's `[B, H, W, C]` interface:
group norm, the input quantizers' amax (over `x.reshape(-1, C)`) and the
skip concatenation see JAX's channel order; each convolution runs as
`F.conv2d` on an NCHW view of it, with the weight in its stored `[O, I,
kh, kw]` layout, quantized on the flattened `[O, I kh kw]` view as JAX
quantizes it. Padding is XLA's "SAME": a stride-2 3x3 convolution on an
even size pads one row and column at the high end only.

The quantizer state is a flat dict {site: {"weight", "input"}} (no stacked
blocks). `quantize_unet` is max calibration over (latents, timesteps)
batches. Nothing here runs a kernel of its own: JAX's convolutions are
XLA's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..quant import quantizer as Q
from ..quant.quantizer import QuantizerState
from . import dit
from .llama import QuantLayout


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    base_channels: int = 32
    ch_mult: tuple = (1, 2)
    num_res_blocks: int = 1
    time_dim: int = 64
    groups: int = 8
    num_heads: int = 2
    dtype: Any = torch.float32

    @staticmethod
    def tiny(**kw) -> "UNetConfig":
        base = dict(in_channels=4, base_channels=16, ch_mult=(1, 2), num_res_blocks=1, time_dim=32, groups=4,
                    num_heads=2)
        base.update(kw)
        return UNetConfig(**base)

    @staticmethod
    def sd15(**kw) -> "UNetConfig":
        """Stable Diffusion 1.5's channel widths (runwayml/stable-diffusion-v1-5
        `unet/config.json`: block_out_channels 320/640/1280/1280, 2 layers a
        block, 32 norm groups), 8 heads, time_dim 1280."""
        base = dict(in_channels=4, base_channels=320, ch_mult=(1, 2, 4, 4), num_res_blocks=2, time_dim=1280,
                    groups=32, num_heads=8)
        base.update(kw)
        return UNetConfig(**base)

    @property
    def chs(self) -> tuple:
        return tuple(self.base_channels * m for m in self.ch_mult)


def _plan(cfg: UNetConfig) -> list:
    """(name, kind, shape) of every learnable op in forward order; kind
    conv3 (3x3), conv1 (1x1) or dense; shapes [O, I(, kh, kw)]."""
    p: list = []
    C = cfg.base_channels
    p.append(("time.fc1", "dense", (cfg.time_dim, cfg.time_dim)))
    p.append(("time.fc2", "dense", (cfg.time_dim, cfg.time_dim)))
    p.append(("conv_in", "conv3", (C, cfg.in_channels, 3, 3)))

    def res(name, cin, cout):
        p.append((f"{name}.conv1", "conv3", (cout, cin, 3, 3)))
        p.append((f"{name}.temb", "dense", (cout, cfg.time_dim)))
        p.append((f"{name}.conv2", "conv3", (cout, cout, 3, 3)))
        if cin != cout:
            p.append((f"{name}.skip", "conv1", (cout, cin, 1, 1)))

    chs = cfg.chs
    cur = C
    for lv, c in enumerate(chs):
        for r in range(cfg.num_res_blocks):
            res(f"down.{lv}.res{r}", cur, c)
            cur = c
        if lv < len(chs) - 1:
            p.append((f"down.{lv}.downsample", "conv3", (c, c, 3, 3)))
    res("mid.res0", cur, cur)
    for nm in ("q", "k", "v", "o"):
        p.append((f"mid.attn.{nm}", "dense", (cur, cur)))
    res("mid.res1", cur, cur)
    for lv in reversed(range(len(chs))):
        c = chs[lv]
        for r in range(cfg.num_res_blocks + 1):
            res(f"up.{lv}.res{r}", cur + _skip_channels(cfg, lv, r), c)  # the skip concat adds its channels
            cur = c
        if lv > 0:
            p.append((f"up.{lv}.upsample", "conv3", (c, c, 3, 3)))
    p.append(("conv_out", "conv3", (cfg.in_channels, cur, 3, 3)))
    return p


def _skip_channels(cfg: UNetConfig, level: int, r: int) -> int:
    """Channels of the skip tensor that up-block (level, r) pops."""
    chs = cfg.chs
    stack = [cfg.base_channels]
    for lv, c in enumerate(chs):
        stack += [c] * cfg.num_res_blocks
        if lv < len(chs) - 1:
            stack.append(c)
    pops = 0
    for lv in reversed(range(len(chs))):
        for rr in range(cfg.num_res_blocks + 1):
            pops += 1
            if lv == level and rr == r:
                return stack[-pops]
    raise AssertionError((level, r))


def init_params(cfg: UNetConfig, generator: torch.Generator, device=None) -> dict:
    """Seeded N(0, 1/fan_in) weights, zero biases and JAX's zero `conv_out`
    (diffusers' zero-module convention), on `device` (the card unless the
    caller passes the CPU; `generator` lives there)."""
    dev = resolve_device(device)
    params: dict = {}
    for name, _, shape in _plan(cfg):
        fan_in = math.prod(shape[1:])
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev).div_(math.sqrt(fan_in))
        params[name] = w.to(cfg.dtype)
        params[f"{name}__bias"] = torch.zeros((shape[0],), dtype=cfg.dtype, device=dev)
    params["conv_out"].zero_()
    return params


def build_layout(cfg: UNetConfig, qcfg) -> QuantLayout:
    """One weight and one input quantizer a convolution or linear."""
    sites = {}
    for name, _, _ in _plan(cfg):
        sites[f"{name}.weight"] = qcfg.resolve(f"{name}.weight_quantizer")
        sites[f"{name}.input"] = qcfg.resolve(f"{name}.input_quantizer")
    return QuantLayout(sites=tuple(sites.items()))


def group_norm(x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """[B, H, W, C] over (H, W, C / groups) per group, in f32."""
    B, H, W, C = x.shape
    g = x.reshape(B, H, W, groups, C // groups).float()
    mu = g.mean(dim=(1, 2, 4), keepdim=True)
    var = (g - mu).square().mean(dim=(1, 2, 4), keepdim=True)
    return ((g - mu) * torch.rsqrt(var + eps)).reshape(B, H, W, C).to(x.dtype)


def _silu(x: torch.Tensor, dtype) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


def fake_quant_site(x, w, name, layout, lstate, calib, sub_out):
    """Fake-quantize (or, calibrating, collect) a site's input and weight ->
    (x, w_eff); the weight is quantized on its [O, -1] view."""
    icfg = layout.get(f"{name}.input")
    wcfg = layout.get(f"{name}.weight")
    sub = dict((lstate or {}).get(name, {}))
    wq = w.reshape(w.shape[0], -1)
    if icfg.enable or sub.get("input") is not None:
        st = sub.get("input")
        if calib:
            sub["input"] = Q.collect(x.reshape(-1, x.shape[-1]), icfg, st if st is not None else QuantizerState())
        else:
            x = Q.quantize(x, icfg, st)
    if wcfg.enable:
        st = sub.get("weight")
        if calib:
            sub["weight"] = Q.collect(wq, wcfg, st if st is not None else QuantizerState())
        else:
            wq = Q.quantize(wq, wcfg, st)
    if sub:
        sub_out[name] = sub
    return x, wq.reshape(w.shape)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high), the odd one high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, params, name, layout, lstate, calib, sub_out, stride: int = 1):
    """NHWC convolution with the site's quantizers, "SAME" padding for 3x3
    ("VALID" for 1x1), plus the bias."""
    w = params[name]
    x, w = fake_quant_site(x, w, name, layout, lstate, calib, sub_out)
    xc = x.permute(0, 3, 1, 2)
    k = w.shape[-1]
    if k > 1:
        (hl, hh), (wl, wh) = _same_pads(xc.shape[2], k, stride), _same_pads(xc.shape[3], k, stride)
        xc = F.pad(xc, (wl, wh, hl, hh))
    y = F.conv2d(xc, w.to(x.dtype), stride=stride).permute(0, 2, 3, 1)
    return y + params[f"{name}__bias"].to(y.dtype)


def dense(x, params, name, layout, lstate, calib, sub_out):
    w = params[name]
    x, w = fake_quant_site(x, w, name, layout, lstate, calib, sub_out)
    return x @ w.t().to(x.dtype) + params[f"{name}__bias"].to(x.dtype)


def _resblock(x, temb, params, name, cfg, layout, lstate, calib, sub_out):
    cout = params[f"{name}.conv1"].shape[0]
    h = conv(_silu(group_norm(x, cfg.groups), x.dtype), params, f"{name}.conv1", layout, lstate, calib, sub_out)
    h = h + dense(_silu(temb, x.dtype), params, f"{name}.temb", layout, lstate, calib, sub_out)[:, None, None, :]
    h = conv(_silu(group_norm(h, cfg.groups), h.dtype), params, f"{name}.conv2", layout, lstate, calib, sub_out)
    if x.shape[-1] != cout:
        x = conv(x, params, f"{name}.skip", layout, lstate, calib, sub_out)
    return x + h


def _mid_attention(x, params, cfg, layout, lstate, calib, sub_out):
    B, H, W, C = x.shape
    n, hd = cfg.num_heads, C // cfg.num_heads
    h = group_norm(x, cfg.groups).reshape(B, H * W, C)
    q, k, v = (dense(h, params, f"mid.attn.{nm}", layout, lstate, calib, sub_out).reshape(B, H * W, n, hd)
               for nm in ("q", "k", "v"))
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    p = torch.softmax(s / math.sqrt(hd), dim=-1).to(x.dtype)
    o = torch.einsum("bnqk,bknd->bqnd", p, v).reshape(B, H * W, C)
    o = dense(o, params, "mid.attn.o", layout, lstate, calib, sub_out)
    return x + o.reshape(B, H, W, C)


def resize_nearest(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """`jax.image.resize(x, (B, H, W, C), "nearest")`: output pixel i reads
    input floor((i + 0.5) in / out)."""
    def idx(n_in, n_out):
        return ((torch.arange(n_out, device=x.device, dtype=torch.float64) + 0.5) * n_in / n_out).floor().long()

    return x[:, idx(x.shape[1], H)][:, :, idx(x.shape[2], W)]


def forward(cfg: UNetConfig, params: dict, x: torch.Tensor, t: torch.Tensor, *,
            layout: Optional[QuantLayout] = None, qstate: Optional[dict] = None, calib: bool = False):
    """Noise prediction for NHWC latents x [B, H, W, C_in] at integer
    timesteps t [B] -> (eps [B, H, W, C_in], new_qstate or None)."""
    layout = layout or QuantLayout(sites=())
    sub_out: dict = {}
    temb = dit.timestep_embedding(t, cfg.time_dim).to(cfg.dtype)
    temb = dense(temb, params, "time.fc1", layout, qstate, calib, sub_out)
    temb = dense(_silu(temb, cfg.dtype), params, "time.fc2", layout, qstate, calib, sub_out)

    h = conv(x.to(cfg.dtype), params, "conv_in", layout, qstate, calib, sub_out)
    skips = [h]
    chs = cfg.chs
    for lv in range(len(chs)):
        for r in range(cfg.num_res_blocks):
            h = _resblock(h, temb, params, f"down.{lv}.res{r}", cfg, layout, qstate, calib, sub_out)
            skips.append(h)
        if lv < len(chs) - 1:
            h = conv(h, params, f"down.{lv}.downsample", layout, qstate, calib, sub_out, stride=2)
            skips.append(h)

    h = _resblock(h, temb, params, "mid.res0", cfg, layout, qstate, calib, sub_out)
    h = _mid_attention(h, params, cfg, layout, qstate, calib, sub_out)
    h = _resblock(h, temb, params, "mid.res1", cfg, layout, qstate, calib, sub_out)

    for lv in reversed(range(len(chs))):
        for r in range(cfg.num_res_blocks + 1):
            sk = skips.pop()
            if sk.shape[1] != h.shape[1]:  # a spatial mismatch after an odd-sized downsample
                h = resize_nearest(h, sk.shape[1], sk.shape[2])
            h = _resblock(torch.cat([h, sk], dim=-1), temb, params, f"up.{lv}.res{r}", cfg, layout, qstate,
                          calib, sub_out)
        if lv > 0:
            h = resize_nearest(h, 2 * h.shape[1], 2 * h.shape[2])
            h = conv(h, params, f"up.{lv}.upsample", layout, qstate, calib, sub_out)

    h = _silu(group_norm(h, cfg.groups), h.dtype)
    eps = conv(h, params, "conv_out", layout, qstate, calib, sub_out)
    return eps, (sub_out if sub_out else None)


def quantize_unet(cfg: UNetConfig, params: dict, quant_cfg, calib_batches):
    """PTQ for the UNet: max calibration over (latents, timesteps) batches
    -> (layout, qstate)."""
    from ..quant.config import get_preset

    qcfg = get_preset(quant_cfg) if isinstance(quant_cfg, str) else quant_cfg
    layout = build_layout(cfg, qcfg)
    qstate: dict = {}
    with torch.no_grad():
        for x, t in calib_batches:
            new = forward(cfg, params, x, t, layout=layout, qstate=qstate or None, calib=True)[1]
            qstate.update(new or {})
    return layout, qstate
