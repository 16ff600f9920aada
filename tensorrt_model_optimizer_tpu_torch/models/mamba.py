"""Hybrid Mamba2 model (Nemotron-H style): SSM, attention and MLP blocks
(port of `models/mamba.py`).

 - The layer pattern is a string over {"M": Mamba2 mixer, "*": attention,
   "-": MLP}; parameters are stacked per block type (`layers_mamba`,
   `layers_attn`, `layers_mlp`, each `[L_type, ...]`) and the forward walks
   the pattern in Python, as JAX's does.
 - Prefill runs the chunked SSD form of Mamba2: within a chunk, quadratic
   products; across chunks, a loop over the chunks that carries the
   `[B, H, P, N]` state in f32 (JAX's `lax.scan`). Decode (one token with a
   cache) runs the O(1) recurrent update.
 - Quantizer sites are `llama._linear`'s ("mixer.in_proj" /
   "mixer.out_proj" and the llama attention / MLP names), so every preset's
   max calibration applies. As in JAX, the embedding lookup and `lm_head`
   run unquantized although `build_layout` resolves both sites.

Numerics follow HF `Mamba2Mixer` / NemotronH: in_proj -> [z, xBC, dt];
causal depthwise conv + SiLU on xBC; dt = softplus(dt + dt_bias) with
softplus = logaddexp(x, 0); A = -exp(A_log), a scalar a head; y = SSD(x dt,
A dt, B, C) + D x; gated RMSNorm(y silu(z)); out_proj. The MLP block is
NemotronH's squared ReLU; attention blocks carry no RoPE.

Dtypes as JAX's: prefill's SSD output is cast to the activation dtype
before D x is added in f32; the recurrent branch stays f32 up to the gated
norm. Head h reads B / C group h // (H / G) (`repeat_interleave`).

SSD memory: the within-chunk product is contracted pairwise, C.B in group
space `[B, nC, G, Q, Q]`, widened to heads `[B, nC, H, Q, Q]` (the peak:
537 MB in f32 at Nemotron-H-8B's widths on an 8 x 2048 prefill), times the
decay, then against x dt; the chunk states and the off-diagonal term are
made one chunk at a time inside the loop (`[B, H, P, N]` each), so no
`[B, nC, H, P, N]` stack is held.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from .. import resolve_device
from ..quant import quantizer as Q
from ..quant.config import QuantizeConfig
from . import llama
from .llama import QuantLayout, _grab, _linear, _map_state, _qsite, rms_norm, slice_layer

MAMBA, ATTN, MLP = "M", "*", "-"
GROUP_KEY = {MAMBA: "mamba", ATTN: "attn", MLP: "mlp"}
PARAM_KEY = {MAMBA: "layers_mamba", ATTN: "layers_attn", MLP: "layers_mlp"}


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    vocab_size: int = 32000
    hidden_size: int = 1024
    # block pattern over {"M", "*", "-"}; len(pattern) = depth
    hybrid_pattern: str = "MM*M-"
    # Mamba2 mixer
    mamba_num_heads: int = 16
    mamba_head_dim: int = 64
    ssm_state_size: int = 128
    n_groups: int = 2
    conv_kernel: int = 4
    chunk_size: int = 64
    time_step_limit: tuple = (0.0, float("inf"))
    # attention blocks
    num_attention_heads: int = 8
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None
    # MLP blocks (squared ReLU, no gate: NemotronH's MLP)
    intermediate_size: int = 4096
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 4096
    dtype: Any = torch.bfloat16

    @property
    def d_inner(self) -> int:
        return self.mamba_num_heads * self.mamba_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.ssm_state_size

    @property
    def d_in_proj(self) -> int:
        # [z (d_inner), xBC (conv_dim), dt (heads)]
        return 2 * self.d_inner + 2 * self.n_groups * self.ssm_state_size + self.mamba_num_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def n_blocks(self, kind: str) -> int:
        return self.hybrid_pattern.count(kind)

    @staticmethod
    def tiny(**kw) -> "MambaConfig":
        base = dict(vocab_size=256, hidden_size=64, hybrid_pattern="MM*M-", mamba_num_heads=4, mamba_head_dim=16,
                    ssm_state_size=16, n_groups=2, conv_kernel=4, chunk_size=8, num_attention_heads=4,
                    num_key_value_heads=2, intermediate_size=128, dtype=torch.float32)
        base.update(kw)
        return MambaConfig(**base)

    @staticmethod
    def nemotron_h_8b(**kw) -> "MambaConfig":
        """Nemotron-H-8B's shapes (52 blocks: 24 mixers, 24 MLPs, 4 attention)."""
        base = dict(vocab_size=131072, hidden_size=4096,
                    hybrid_pattern="M-M-M-M-M-M-M-M*-M-M-M-M*-M-M-M-M*-M-M-M-M*-M-M-M-M-",
                    mamba_num_heads=128, mamba_head_dim=64, ssm_state_size=128, n_groups=8,
                    num_attention_heads=32, num_key_value_heads=8, head_dim=128, intermediate_size=21504)
        base.update(kw)
        return MambaConfig(**base)


MIXER_NAMES = ("mixer.in_proj", "mixer.out_proj")
ATTN_NAMES = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj")
MLP_NAMES = ("mlp.up_proj", "mlp.down_proj")


def _shapes(cfg: MambaConfig) -> dict[str, tuple[int, int]]:
    h, hd = cfg.hidden_size, cfg.hd
    return {
        "mixer.in_proj": (cfg.d_in_proj, h),
        "mixer.out_proj": (h, cfg.d_inner),
        "self_attn.q_proj": (cfg.num_attention_heads * hd, h),
        "self_attn.k_proj": (cfg.num_key_value_heads * hd, h),
        "self_attn.v_proj": (cfg.num_key_value_heads * hd, h),
        "self_attn.o_proj": (h, cfg.num_attention_heads * hd),
        "mlp.up_proj": (cfg.intermediate_size, h),
        "mlp.down_proj": (h, cfg.intermediate_size),
    }


def init_params(cfg: MambaConfig, generator: torch.Generator, device=None) -> dict:
    """Seeded random weights, N(0, 1/fan_in) in `cfg.dtype`, made on the
    device one block at a time; A_log = log(1..H), D = 1, dt_bias = -2 (JAX's
    init). `generator` must live on the same device."""
    dev = resolve_device(device)
    h = cfg.hidden_size
    shapes = _shapes(cfg)

    def winit(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(fan_in)).to(cfg.dtype)

    def stacked(L, shape, fan_in):
        out = torch.empty((L,) + tuple(shape), dtype=cfg.dtype, device=dev)
        for i in range(L):  # one block's f32 transient at a time
            out[i] = winit(shape, fan_in)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    params: dict = {"embed_tokens": winit((cfg.vocab_size, h), h), "norm": ones(h)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = winit((cfg.vocab_size, h), h)
    Lm, La, Lf = cfg.n_blocks(MAMBA), cfg.n_blocks(ATTN), cfg.n_blocks(MLP)
    if Lm:
        H = cfg.mamba_num_heads
        f32 = dict(dtype=torch.float32, device=dev)
        params["layers_mamba"] = {
            "norm": ones(Lm, h),
            "mixer.in_proj": stacked(Lm, (cfg.d_in_proj, h), h),
            "mixer.out_proj": stacked(Lm, (h, cfg.d_inner), cfg.d_inner),
            "mixer.conv_w": stacked(Lm, (cfg.conv_dim, cfg.conv_kernel), cfg.conv_kernel),
            "mixer.conv_b": torch.zeros((Lm, cfg.conv_dim), dtype=cfg.dtype, device=dev),
            "mixer.A_log": torch.log(torch.arange(1, H + 1, **f32)).expand(Lm, H).clone(),
            "mixer.D": torch.ones((Lm, H), **f32),
            "mixer.dt_bias": torch.full((Lm, H), -2.0, **f32),
            "mixer.gnorm": ones(Lm, cfg.d_inner),
        }
    if La:
        params["layers_attn"] = {"norm": ones(La, h),
                                 **{n: stacked(La, shapes[n], shapes[n][1]) for n in ATTN_NAMES}}
    if Lf:
        params["layers_mlp"] = {"norm": ones(Lf, h),
                                **{n: stacked(Lf, shapes[n], shapes[n][1]) for n in MLP_NAMES}}
    return params


def param_specs(cfg: MambaConfig) -> dict:
    """The JAX package's PartitionSpecs as tuples of mesh-axis names (None:
    not sharded): in_proj column-parallel (heads and groups both live on its
    output dim), out_proj row-parallel, attention / MLP megatron column /
    row, the conv and the per-head vectors on their channel dim. No engine
    serves the hybrid under a mesh: JAX's tensor-parallel engine takes the
    Llama and MoE families and DeepSeek only."""
    col, row = (None, "tensor", None), (None, None, "tensor")
    specs: dict = {"embed_tokens": ("tensor", None), "norm": (None,)}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = ("tensor", None)
    if cfg.n_blocks(MAMBA):
        specs["layers_mamba"] = {
            "norm": (None, None), "mixer.in_proj": col, "mixer.out_proj": row,
            "mixer.conv_w": (None, "tensor", None), "mixer.conv_b": (None, "tensor"),
            "mixer.A_log": (None, "tensor"), "mixer.D": (None, "tensor"), "mixer.dt_bias": (None, "tensor"),
            "mixer.gnorm": (None, "tensor")}
    if cfg.n_blocks(ATTN):
        specs["layers_attn"] = {"norm": (None, None), "self_attn.q_proj": col, "self_attn.k_proj": col,
                                "self_attn.v_proj": col, "self_attn.o_proj": row}
    if cfg.n_blocks(MLP):
        specs["layers_mlp"] = {"norm": (None, None), "mlp.up_proj": col, "mlp.down_proj": row}
    return specs


def build_layout(cfg: MambaConfig, qcfg: QuantizeConfig) -> QuantLayout:
    sites = {}
    for name in MIXER_NAMES + ATTN_NAMES + MLP_NAMES:
        full = f"model.layers.0.{name}"
        sites[f"{name}.weight"] = qcfg.resolve(f"{full}.weight_quantizer")
        sites[f"{name}.input"] = qcfg.resolve(f"{full}.input_quantizer")
    for name in llama.BMM_NAMES:
        sites[name] = qcfg.resolve(f"model.layers.0.{name}_quantizer")
    # resolved as JAX's, and applied by neither package's forward
    sites["lm_head.weight"] = qcfg.resolve("lm_head.weight_quantizer")
    sites["embed_tokens.weight"] = qcfg.resolve("model.embed_tokens.weight_quantizer")
    return QuantLayout(sites=tuple(sites.items()))


def init_quant_state(cfg: MambaConfig, layout: QuantLayout, device=None) -> dict:
    """{"mamba", "attn", "mlp"}: each block type's sites, stacked over its count."""
    shapes = _shapes(cfg)

    def stacked(site_cfg, shape, L):
        st = Q.init_state(site_cfg, shape, device)
        return _map_state(lambda a: a.expand((L,) + tuple(a.shape)).clone(), st)

    def group(names, L):
        st: dict = {}
        for name in names:
            o, inp = shapes[name]
            wcfg, icfg = layout.get(f"{name}.weight"), layout.get(f"{name}.input")
            sub = {}
            if wcfg.enable:
                sub["weight"] = stacked(wcfg, (o, inp), L)
            if icfg.enable:
                sub["input"] = stacked(icfg, (1, 1, inp), L)
            if sub:
                st[name] = sub
        return st

    state: dict = {}
    if cfg.n_blocks(MAMBA):
        state["mamba"] = group(MIXER_NAMES, cfg.n_blocks(MAMBA))
    if cfg.n_blocks(ATTN):
        a = group(ATTN_NAMES, cfg.n_blocks(ATTN))
        for name in llama.BMM_NAMES:
            bcfg = layout.get(name)
            if bcfg.enable:
                a[name] = stacked(bcfg, (1, 1, cfg.num_key_value_heads, cfg.hd), cfg.n_blocks(ATTN))
        state["attn"] = a
    if cfg.n_blocks(MLP):
        state["mlp"] = group(MLP_NAMES, cfg.n_blocks(MLP))
    return state


# --------------------------------------------------------------------------
# Mamba2 mixer
# --------------------------------------------------------------------------


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    with no switch to x at large x (`F.softplus` has one above 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{k=j+1..i} a_k
    (a difference of cumsums, -inf above the diagonal)."""
    Qn = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Qn, Qn), dtype=torch.bool, device=a.device))
    return torch.where(mask, d, torch.tensor(-math.inf, dtype=d.dtype, device=d.device))


def _ssd(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD (Mamba2) -> (y [B, T, H, P] in x's dtype, final state
    [B, H, P, N] f32). x [B, T, H, P], dt [B, T, H] (after softplus), A [H]
    (negative), Bm / Cm [B, T, G, N]. T is padded to a multiple of `chunk`
    with dt = 0 (decay 1: the final state is unaffected). All state math in
    f32."""
    Bsz, T, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    pad = (-T) % chunk
    if pad:  # F.pad lists dims last-first: (.., .., T before, T after)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
    Tp = T + pad
    nC = Tp // chunk
    rep = H // G
    f32 = torch.float32
    head_group = torch.arange(H, device=x.device) // rep  # head h reads group h // rep

    xb = x.reshape(Bsz, nC, chunk, H, Pd).to(f32)
    dtb = dt.reshape(Bsz, nC, chunk, H).to(f32)
    Bg = Bm.reshape(Bsz, nC, chunk, G, N).to(f32)
    Cg = Cm.reshape(Bsz, nC, chunk, G, N).to(f32)

    a = (dtb * A.to(f32)[None, None, None, :]).permute(0, 1, 3, 2)  # [B, nC, H, Q]
    A_cum = torch.cumsum(a, dim=-1)
    Lmat = torch.exp(_segsum(a))  # [B, nC, H, Q, Q]
    xdt = xb * dtb[..., None]  # [B, nC, Q, H, P]

    # y_diag = einsum("bclhn,bcshn,bchls,bcshp->bclhp", C, B, L, x dt), pairwise
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cg, Bg)  # [B, nC, G, Q, Q]
    W = CB[:, :, head_group] * Lmat  # [B, nC, H, Q, Q]
    del CB, Lmat
    y = torch.einsum("bchls,bcshp->bclhp", W, xdt)  # [B, nC, Q, H, P]
    del W
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)  # [B, nC, H, Q]
    chunk_decay = torch.exp(A_cum[..., -1])  # [B, nC, H]
    in_decay = torch.exp(A_cum)  # [B, nC, H, Q]
    S = (torch.zeros((Bsz, H, Pd, N), dtype=f32, device=x.device) if init_state is None
         else init_state.to(f32))
    for c in range(nC):  # JAX's lax.scan over the chunks
        # y_off = einsum("bclhn,bchpn,bchl->bclhp", C, S_prev, exp(A_cum))
        Cc, Bc = Cg[:, c][:, :, head_group], Bg[:, c][:, :, head_group]  # [B, Q, H, N]
        y[:, c] += torch.einsum("blhn,bhpn->blhp", Cc, S) * in_decay[:, c].permute(0, 2, 1)[..., None]
        # states = einsum("bclhn,bchl,bclhp->bchpn", B, decay_states, x dt)
        st = torch.einsum("blhn,blhp->bhpn", Bc, xdt[:, c] * decay_states[:, c].permute(0, 2, 1)[..., None])
        S = S * chunk_decay[:, c][..., None, None] + st
    y = y.reshape(Bsz, Tp, H, Pd)[:, :T]
    return y.to(x.dtype), S


def _causal_conv(xBC, w, b, conv_state):
    """Depthwise causal conv by shifted adds (K = 4). xBC [B, T, C], w [C,
    K], b [C], conv_state [B, K-1, C] (the trailing context) or None ->
    (y [B, T, C], new state [B, K-1, C]: the last K-1 rows of concat(state,
    xBC), at T = 1 too)."""
    K = w.shape[-1]
    Bsz, T, Cd = xBC.shape
    if conv_state is None:
        conv_state = torch.zeros((Bsz, K - 1, Cd), dtype=xBC.dtype, device=xBC.device)
    full = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    y = torch.zeros((Bsz, T, Cd), dtype=torch.float32, device=xBC.device)
    for k in range(K):
        y = y + full[:, k:k + T].float() * w[:, k].float()
    y = y + b.float()
    new_state = full[:, -(K - 1):] if K > 1 else torch.zeros((Bsz, 0, Cd), dtype=xBC.dtype, device=xBC.device)
    return y.to(xBC.dtype), new_state


def _mixer(cfg, x, lp, lstate, layout, cache_m, calib, capture=False):
    """The Mamba2 mixer -> (out, new_state, new (conv, ssm) or None,
    captures). cache_m = (conv_state, ssm_state) or None."""
    Bsz, T, _ = x.shape
    H, Pd, G, N = cfg.mamba_num_heads, cfg.mamba_head_dim, cfg.n_groups, cfg.ssm_state_size
    d_inner = cfg.d_inner
    new_state = {}

    proj, s = _linear(x, lp["mixer.in_proj"], "mixer.in_proj", layout, lstate, calib)
    if s:
        new_state["mixer.in_proj"] = s
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:d_inner + cfg.conv_dim]
    dt = proj[..., d_inner + cfg.conv_dim:]

    conv_state = cache_m[0] if cache_m is not None else None
    xBC, new_conv = _causal_conv(xBC, lp["mixer.conv_w"], lp["mixer.conv_b"], conv_state)
    xBC = torch.nn.functional.silu(xBC.float()).to(xBC.dtype)

    xs = xBC[..., :d_inner].reshape(Bsz, T, H, Pd)
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(Bsz, T, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(Bsz, T, G, N)

    dt = softplus(dt.float() + lp["mixer.dt_bias"].float())
    lo, hi = cfg.time_step_limit
    if lo > 0.0 or hi != float("inf"):
        dt = torch.clamp(dt, lo, hi)
    A = -torch.exp(lp["mixer.A_log"].float())  # [H]

    init_state = cache_m[1] if cache_m is not None else None
    if T == 1 and cache_m is not None:
        # the O(1) recurrent step: h' = h exp(dt A) + dt (B x); y = C h' (f32 throughout)
        rep = H // G
        dt1 = dt[:, 0]  # [B, H]
        dA = torch.exp(dt1 * A[None, :])
        Bh = torch.repeat_interleave(Bm[:, 0], rep, dim=1).float()  # [B, H, N]
        Ch = torch.repeat_interleave(Cm[:, 0], rep, dim=1).float()
        x1 = xs[:, 0].float()  # [B, H, P]
        h = init_state.float() * dA[..., None, None] + (dt1[..., None] * x1)[..., None] * Bh[:, :, None, :]
        y = torch.einsum("bhpn,bhn->bhp", h, Ch)[:, None]  # [B, 1, H, P]
        new_ssm = h
    else:
        y, new_ssm = _ssd(xs, dt, A, Bm, Cm, cfg.chunk_size, init_state)
    y = y + xs.float() * lp["mixer.D"].float()[None, None, :, None]
    y = y.reshape(Bsz, T, d_inner)

    # gated RMSNorm (Mamba2 RMSNormGated: norm(y silu(z)) weight), f32, cast, then the weight
    g = y.float() * torch.nn.functional.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    g = (g * torch.rsqrt(var + cfg.rms_norm_eps)).to(x.dtype) * lp["mixer.gnorm"]

    out, s = _linear(g, lp["mixer.out_proj"], "mixer.out_proj", layout, lstate, calib)
    if s:
        new_state["mixer.out_proj"] = s
    caps = {"mixer_out_in": _grab(g, 128)} if capture else {}
    new_cache = (new_conv, new_ssm) if cache_m is not None else None
    return out, new_state, new_cache, caps


def _attention(cfg, x, lp, lstate, layout, positions, mask, cache_kv, calib):
    """No-RoPE GQA attention (NemotronH: the SSM carries position); only the
    k_bmm / v_bmm quantizers apply. -> (out, new_state, new (k, v) or None,
    the o_proj input)."""
    hd, nH, nKV = cfg.hd, cfg.num_attention_heads, cfg.num_key_value_heads
    Bsz, T, _ = x.shape
    new_state = {}

    def lin(name, inp):
        y, s = _linear(inp, lp[name], name, layout, lstate, calib)
        if s:
            new_state[name] = s
        return y

    q = lin("self_attn.q_proj", x).reshape(Bsz, T, nH, hd)
    k = lin("self_attn.k_proj", x).reshape(Bsz, T, nKV, hd)
    v = lin("self_attn.v_proj", x).reshape(Bsz, T, nKV, hd)
    k, kst = _qsite(k, layout.get("self_attn.k_bmm"), (lstate or {}).get("self_attn.k_bmm"), calib)
    if kst is not None:
        new_state["self_attn.k_bmm"] = kst
    v, vst = _qsite(v, layout.get("self_attn.v_bmm"), (lstate or {}).get("self_attn.v_bmm"), calib)
    if vst is not None:
        new_state["self_attn.v_bmm"] = vst

    new_cache = None
    if cache_kv is not None:
        ck, cv, pos = cache_kv
        k, v = llama._write_at(ck, k, pos), llama._write_at(cv, v, pos)
        new_cache = (k, v)
    rep = nH // nKV
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())  # preferred_element_type=f32
    scores = scores / math.sqrt(hd) + mask
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs, v.to(x.dtype)).reshape(Bsz, T, nH * hd)
    out = lin("self_attn.o_proj", ctx)
    return out, new_state, new_cache, ctx


def _mlp(x, lp, lstate, layout, calib):
    """NemotronH's MLP: down(relu(up(x))^2) -> (out, new_state, down's input)."""
    new_state = {}
    u, s = _linear(x, lp["mlp.up_proj"], "mlp.up_proj", layout, lstate, calib)
    if s:
        new_state["mlp.up_proj"] = s
    a = torch.square(torch.relu(u.float())).to(x.dtype)
    d, s = _linear(a, lp["mlp.down_proj"], "mlp.down_proj", layout, lstate, calib)
    if s:
        new_state["mlp.down_proj"] = s
    return d, new_state, a


def init_cache(cfg: MambaConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """{"pos" (0-d int32), "conv" [Lm, B, K-1, conv_dim], "ssm" [Lm, B, H,
    P, N] f32, "k" / "v" [La, B, max_len, n_kv, hd]}."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    Lm, La = cfg.n_blocks(MAMBA), cfg.n_blocks(ATTN)
    cache: dict = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if Lm:
        cache["conv"] = torch.zeros((Lm, batch, cfg.conv_kernel - 1, cfg.conv_dim), dtype=dtype, device=dev)
        cache["ssm"] = torch.zeros((Lm, batch, cfg.mamba_num_heads, cfg.mamba_head_dim, cfg.ssm_state_size),
                                   dtype=torch.float32, device=dev)
    if La:
        cache["k"] = torch.zeros((La, batch, max_len, cfg.num_key_value_heads, cfg.hd), dtype=dtype, device=dev)
        cache["v"] = torch.zeros_like(cache["k"])
    return cache


def _restack(lst):
    if not lst or all(s is None or s == {} for s in lst):
        return None
    return llama.stack_states(lst)


def forward(cfg: MambaConfig, params: dict, tokens: torch.Tensor, *, layout: Optional[QuantLayout] = None,
            qstate: Optional[dict] = None, calib: bool = False, cache: Optional[dict] = None,
            positions: Optional[torch.Tensor] = None, capture: bool = False):
    """-> (logits f32 [B, T, V], new_qstate, new_cache[, captures]).

    qstate follows `init_quant_state`'s {"mamba", "attn", "mlp"} split.
    `cache` (`init_cache`) runs the cached forward (the given cache is not
    written); a one-token step with a cache takes the recurrent branch.
    `capture=True` adds {"block_in", "mixer_out_in", "down_in", "o_in"}:
    the first 128 rows of each block's normed input and of the out_proj /
    down_proj / o_proj inputs, stacked over the blocks that have them."""
    layout = layout or QuantLayout(sites=())
    B, T = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = llama._positions(B, T, cache, dev)

    x = params["embed_tokens"][tokens].to(cfg.dtype)
    if cache is not None and "k" in cache:
        mask = llama.cache_mask(cache["k"].shape[2], positions)
    else:
        mask = llama.causal_mask(T, dev)

    qs = qstate or {}
    new_qs: dict = {k: [] for k in GROUP_KEY.values()}
    new_conv, new_ssm, new_k, new_v = [], [], [], []
    captures: dict = {"block_in": [], "mixer_out_in": [], "down_in": [], "o_in": []}
    counters = {MAMBA: 0, ATTN: 0, MLP: 0}
    for ch in cfg.hybrid_pattern:
        i = counters[ch]
        counters[ch] += 1
        lp = slice_layer(params[PARAM_KEY[ch]], i)
        gstate = qs.get(GROUP_KEY[ch])
        lstate = llama.slice_state(gstate, i) if gstate else None

        h = rms_norm(x, lp["norm"], cfg.rms_norm_eps)
        if capture:
            captures["block_in"].append(_grab(h, 128))
        if ch == MAMBA:
            cache_m = (cache["conv"][i], cache["ssm"][i]) if cache is not None else None
            out, st, new_cache_m, caps = _mixer(cfg, h, lp, lstate, layout, cache_m, calib, capture)
            if capture:
                captures["mixer_out_in"].append(caps["mixer_out_in"])
            if new_cache_m is not None:
                new_conv.append(new_cache_m[0])
                new_ssm.append(new_cache_m[1])
        elif ch == ATTN:
            cache_kv = (cache["k"][i], cache["v"][i], cache["pos"]) if cache is not None else None
            out, st, new_cache_kv, o_in = _attention(cfg, h, lp, lstate, layout, positions, mask, cache_kv, calib)
            if capture:
                captures["o_in"].append(_grab(o_in, 128))
            if new_cache_kv is not None:
                new_k.append(new_cache_kv[0])
                new_v.append(new_cache_kv[1])
        else:
            out, st, down_in = _mlp(h, lp, lstate, layout, calib)
            if capture:
                captures["down_in"].append(_grab(down_in, 128))
        x = x + out
        new_qs[GROUP_KEY[ch]].append(st)

    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    head_w = params.get("lm_head", params["embed_tokens"])
    logits = (x @ head_w.t().to(x.dtype)).float()

    out_qstate = None
    if calib or qstate:
        out_qstate = {}
        for k in GROUP_KEY.values():
            st = _restack(new_qs[k])
            if st is not None:
                out_qstate[k] = st

    new_cache = None
    if cache is not None:
        new_cache = {"pos": cache["pos"] + T}
        if new_conv:
            new_cache["conv"] = torch.stack(new_conv)
            new_cache["ssm"] = torch.stack(new_ssm)
        if new_k:
            new_cache["k"] = torch.stack(new_k)
            new_cache["v"] = torch.stack(new_v)

    if capture:
        return logits, out_qstate, new_cache, {k: torch.stack(v) for k, v in captures.items() if v}
    return logits, out_qstate, new_cache


@dataclasses.dataclass
class MambaQuantizedModel:
    model_cfg: MambaConfig
    params: dict
    layout: QuantLayout
    qstate: dict
    quant_cfg: Any

    def forward(self, tokens, **kw):
        return forward(self.model_cfg, self.params, tokens, layout=self.layout, qstate=self.qstate, **kw)


@torch.no_grad()
def quantize(cfg: MambaConfig, params: dict, quant_cfg, calib_batches, device=None) -> MambaQuantizedModel:
    """Max-calibration PTQ over the hybrid stack: each batch's calibrating
    forward folds its amax into the state, as JAX's jitted step does. The
    params stay where they are; the state and the batches go to `device`."""
    from ..quant.config import get_preset

    dev = resolve_device(device)
    if isinstance(quant_cfg, str):
        quant_cfg = get_preset(quant_cfg)
    layout = build_layout(cfg, quant_cfg)
    qstate = init_quant_state(cfg, layout, dev)
    for batch in calib_batches:
        qstate = forward(cfg, params, torch.as_tensor(batch).to(dev), layout=layout, qstate=qstate, calib=True)[1]
    return MambaQuantizedModel(cfg, params, layout, qstate, quant_cfg)


@torch.no_grad()
def generate(cfg, params, prompt: torch.Tensor, max_new_tokens: int = 8, max_len: int = 64, **kw) -> torch.Tensor:
    """Greedy generation: prefill, then recurrent decode (a host loop) ->
    [B, max_new_tokens] int32 on the prompt's device."""
    cache = init_cache(cfg, prompt.shape[0], max_len, device=prompt.device)
    logits, _, cache = forward(cfg, params, prompt, cache=cache, **kw)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, _, cache = forward(cfg, params, tok, cache=cache, **kw)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)
