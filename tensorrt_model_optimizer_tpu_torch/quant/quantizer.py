"""The quantizer: static config + state + functions (port of
`quant/quantizer.py`).

`QuantizerConfig` is the same frozen, hashable description of one
quantization site; `QuantizerState` holds its calibrated tensors. The
functions are pure: `collect` returns a new state, `quantize` a new tensor.
Covered: the int and fp8 formats (static, dynamic per-token or per-tensor,
static blocks, generic dynamic blocks), NVFP4 (dynamic E4M3 block scales
under a calibrated global amax), the MX float formats and MXINT (E8M0 block
scales) and the Hadamard rotation (`rotate`). A static block with integer
`scale_bits` (NF4_BLOCK64) quantizes as JAX's does: an int grid under the
calibrated per-block amax; the scale bits are not applied. Custom backends raise `NotImplementedError`.
Gradients flow as JAX's do: every format goes through its straight-through
estimator (`ops/ste.py`), and a `learn_amax` int site gives its amax the
LSQ gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import numerics, ste
from ..ops.hadamard import blocked_fwht
from ..ops.formats import BlockSpec, NumBits


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """Static description of one quantization site (fields as in JAX)."""

    enable: bool = True
    num_bits: NumBits = 8
    axis: Optional[tuple[int, ...]] = None
    block: Optional[BlockSpec] = None
    dynamic: bool = False
    per_token: bool = False
    unsigned: bool = False
    narrow_range: bool = False
    pre_quant_scale: bool = False
    bias_corr: bool = False
    constant_amax: Optional[float] = None
    pass_through_bwd: bool = False
    learn_amax: bool = False
    rotate: bool = False
    calibrator: str = "max"
    sequential: Optional[tuple["QuantizerConfig", ...]] = None
    backend: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.num_bits, list):
            object.__setattr__(self, "num_bits", tuple(self.num_bits))
        if isinstance(self.axis, int):
            object.__setattr__(self, "axis", (self.axis,))
        elif isinstance(self.axis, list):
            object.__setattr__(self, "axis", tuple(self.axis))
        if isinstance(self.block, dict):
            object.__setattr__(self, "block", BlockSpec.from_dict(self.block))

    @property
    def is_fp(self) -> bool:
        return isinstance(self.num_bits, tuple)

    @property
    def fake_bits(self) -> float:
        """Effective bits with the block scales' share (AutoQuantize's cost)."""
        if self.sequential:
            return min(c.fake_bits for c in self.sequential)
        if not self.enable:
            return 16.0
        bits = sum(self.num_bits) + 1 if self.is_fp else self.num_bits
        if self.block is not None and self.block.scale_bits is not None:
            sb = self.block.scale_bits
            sbits = sum(sb) + 1 if isinstance(sb, tuple) else sb
            bsz = self.block.sizes[0][1] if self.block.sizes else 1
            if bsz > 0:
                bits = bits + sbits / bsz
        return float(bits)

    def replace(self, **kw) -> "QuantizerConfig":
        return dataclasses.replace(self, **kw)


DISABLED = QuantizerConfig(enable=False)


@dataclasses.dataclass
class QuantizerState:
    """Per-site calibrated state; `amax` is a tuple for sequential sites."""

    amax: Optional[object] = None
    pre_quant_scale: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    aux: Optional[dict] = None

    def replace(self, **kw) -> "QuantizerState":
        return dataclasses.replace(self, **kw)


def _block_dynamic(cfg: QuantizerConfig) -> bool:
    return cfg.dynamic or (cfg.block is not None and cfg.block.dynamic)




def _resolve_axes(axis: tuple[int, ...], ndim: int) -> tuple[int, ...]:
    return tuple(sorted(a % ndim for a in axis))


def amax_shape(cfg: QuantizerConfig, x_shape: tuple[int, ...]) -> Optional[tuple[int, ...]]:
    """Shape of the calibrated amax buffer for a tensor of `x_shape`."""
    if not cfg.enable:
        return None
    if cfg.sequential:
        raise ValueError("amax_shape on sequential parent; query children")
    if _block_dynamic(cfg):
        if cfg.block is not None and cfg.block.scale_bits is not None:
            return ()
        return None
    if cfg.constant_amax is not None:
        return ()
    if cfg.block is not None and cfg.block.sizes:
        n = len(x_shape)
        axmap = dict((a % n, min(b, x_shape[a % n])) for a, b in cfg.block.sizes)
        return tuple(-(-d // axmap[i]) if i in axmap else d for i, d in enumerate(x_shape))
    if cfg.axis is not None:
        kept = _resolve_axes(cfg.axis, len(x_shape))
        return tuple(d if i in kept else 1 for i, d in enumerate(x_shape))
    return ()


def init_state(cfg: QuantizerConfig, x_shape: tuple[int, ...], device=None) -> QuantizerState:
    if cfg.sequential:
        amaxes = tuple(init_state(c, x_shape, device).amax for c in cfg.sequential)
        return QuantizerState(amax=amaxes if any(a is not None for a in amaxes) else None)
    if not cfg.enable:
        return QuantizerState()
    shp = amax_shape(cfg, x_shape)
    amax = None
    if shp is not None:
        fill = cfg.constant_amax if cfg.constant_amax is not None else 0.0
        amax = torch.full(shp, fill, dtype=torch.float32, device=device)
    pqs = None
    if cfg.pre_quant_scale:
        pqs = torch.ones((x_shape[-1],), dtype=torch.float32, device=device)
    return QuantizerState(amax=amax, pre_quant_scale=pqs)


# --------------------------------------------------------------------------
# Calibration collect (max calibrator)
# --------------------------------------------------------------------------


def local_amax(x: torch.Tensor, cfg: QuantizerConfig) -> Optional[torch.Tensor]:
    """This batch's amax in the buffer's shape."""
    shp = amax_shape(cfg, tuple(x.shape))
    if shp is None:
        return None
    x32 = torch.abs(x.float())
    if cfg.block is not None and cfg.block.sizes and not _block_dynamic(cfg):
        return numerics.block_amax_compact(x32, cfg.block.sizes)
    if _block_dynamic(cfg) and shp == ():
        return torch.amax(x32)
    if cfg.constant_amax is not None:
        return torch.full((), cfg.constant_amax, dtype=torch.float32, device=x.device)
    if cfg.axis is not None:
        kept = _resolve_axes(cfg.axis, x.ndim)
        red = tuple(i for i in range(x.ndim) if i not in kept)
        return torch.amax(x32, dim=red, keepdim=True)
    return torch.amax(x32)


def collect(x: torch.Tensor, cfg: QuantizerConfig, state: QuantizerState) -> QuantizerState:
    """Max-calibrator collect: running max into state.amax."""
    if not cfg.enable or cfg.constant_amax is not None:
        return state
    if state.pre_quant_scale is not None:
        x = x * state.pre_quant_scale.to(x.dtype)
    if cfg.rotate:
        x = blocked_fwht(x, -1)
    if cfg.sequential:
        old = state.amax if isinstance(state.amax, tuple) else (None,) * len(cfg.sequential)
        new = tuple(collect(x, sub, QuantizerState(amax=prev)).amax
                    for sub, prev in zip(cfg.sequential, old))
        return state.replace(amax=new)
    if cfg.bias_corr:
        x32 = x.float()
        hi, lo = torch.amax(x32), torch.amin(x32)
        if state.bias is None:
            new_hi, new_lo = hi, lo
        else:
            prev = state.amax if state.amax is not None else 0.0
            new_hi = torch.maximum(hi, state.bias + prev)
            new_lo = torch.minimum(lo, state.bias - prev)
        return state.replace(amax=(new_hi - new_lo) / 2.0, bias=(new_hi + new_lo) / 2.0)
    la = local_amax(x, cfg)
    if la is None:
        return state
    amax = la if state.amax is None else torch.maximum(state.amax, la)
    return state.replace(amax=amax)


# --------------------------------------------------------------------------
# Quantize (fake-quant forward)
# --------------------------------------------------------------------------


def _dynamic_amax(x: torch.Tensor, cfg: QuantizerConfig) -> torch.Tensor:
    x32 = torch.abs(x.float())
    if cfg.per_token:
        return torch.amax(x32, dim=-1, keepdim=True)
    if cfg.axis is not None:
        kept = _resolve_axes(cfg.axis, x.ndim)
        red = tuple(i for i in range(x.ndim) if i not in kept)
        return torch.amax(x32, dim=red, keepdim=True)
    return torch.amax(x32)


def _fake_quant(x, cfg: QuantizerConfig, amax):
    if cfg.is_fp:
        e, m = cfg.num_bits
        return numerics.fake_quant_fp(x, amax, e, m)
    return numerics.fake_quant_int(x, amax, cfg.num_bits, cfg.unsigned, cfg.narrow_range)


def quantize(x: torch.Tensor, cfg: QuantizerConfig,
             state: Optional[QuantizerState] = None, amax_reduce=None) -> torch.Tensor:
    """Fake-quantize `x` per the config: pre_quant_scale multiply, the
    Hadamard rotation where `rotate` (exact when the paired weight site
    rotates its input dim too: (xH)(WH)^T = xW^T), then the format's fake
    quant. `amax_reduce` (a function) reduces a DYNAMIC per-token or
    per-tensor amax across ranks: the tensor-parallel engine passes a MAX
    over its axis for a row-parallel site's input, whose K is sharded (the
    block formats' scales are local to each shard and need none)."""
    state = state or QuantizerState()
    if state.pre_quant_scale is not None:
        x = x * state.pre_quant_scale.to(x.dtype)
    if cfg.rotate:
        x = blocked_fwht(x, -1)
    if not cfg.enable:
        return x
    if cfg.sequential:
        amaxes = state.amax if isinstance(state.amax, tuple) else (None,) * len(cfg.sequential)
        for sub, am in zip(cfg.sequential, amaxes):
            if sub.enable:
                x = _dispatch(x, sub, QuantizerState(amax=am), amax_reduce)
        return x
    if cfg.bias_corr and state.bias is not None:
        b = state.bias.to(x.dtype)
        return _dispatch(x - b, cfg, state, amax_reduce) + b
    return _dispatch(x, cfg, state, amax_reduce)


def _mxint(x: torch.Tensor, num_bits: int, ax: int, bsz: int) -> torch.Tensor:
    """MXINT: an int grid under a power-of-two (E8M0) shared block scale."""
    sizes = ((ax, bsz),)
    scale = numerics.e8m0_scale(numerics.block_amax_compact(x.float(), sizes), 0)
    amax_full = numerics.expand_block_scale(scale, x.shape, sizes) * float(2 ** (num_bits - 1) - 1)
    return numerics.fake_quant_int(x, amax_full, num_bits)


def _dispatch(x, cfg: QuantizerConfig, state: QuantizerState, amax_reduce=None):
    """One format's fake quant with its straight-through gradient, routed as
    JAX's `_fake_quant_dispatch` routes it (`ops/ste.py`)."""
    if cfg.backend is not None:
        raise NotImplementedError("custom quant backends are not ported")
    blk = cfg.block
    if blk is not None and _block_dynamic(cfg) and blk.sizes:
        ax, bsz = blk.sizes[0]
        if blk.scale_bits == (4, 3) and cfg.num_bits == (2, 1):
            return ste.fake_quant_nvfp4_ste(x, bsz, state.amax, ax)
        if blk.scale_bits == (8, 0):
            if not cfg.is_fp:
                return ste.pass_through(lambda t: _mxint(t, cfg.num_bits, ax, bsz), x)
            e, m = cfg.num_bits
            return ste.fake_quant_mx_ste(x, e, m, bsz, ax)
        return ste.pass_through(lambda t: _fake_quant(t, cfg, numerics.block_reduce_amax(t.float(), blk.sizes)), x)
    if cfg.dynamic:
        def dyn(t):
            am = _dynamic_amax(t, cfg)
            return _fake_quant(t, cfg, am if amax_reduce is None else amax_reduce(am))

        return ste.pass_through(dyn, x)
    amax = state.amax
    if amax is None and cfg.constant_amax is not None:
        amax = torch.full((), cfg.constant_amax, dtype=torch.float32, device=x.device)  # no host copy
    if amax is None:
        raise ValueError(f"static quantizer used before calibration (amax is None); cfg={cfg}")
    if blk is not None and blk.sizes:
        amax = numerics.expand_block_scale(amax, x.shape, blk.sizes)
    if cfg.pass_through_bwd:
        return ste.pass_through(lambda t: _fake_quant(t, cfg, amax), x)
    if cfg.is_fp:
        e, m = cfg.num_bits
        return ste.fake_quant_fp_ste(x, amax, e, m)
    if cfg.learn_amax:
        return ste.fake_quant_int_lsq(x, amax, cfg.num_bits)
    return ste.fake_quant_int_ste(x, amax, cfg.num_bits, cfg.unsigned, cfg.narrow_range)
