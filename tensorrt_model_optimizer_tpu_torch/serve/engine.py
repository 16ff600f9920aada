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

`int4_layout="xla"` ("int4x") and `nvfp4_layout="i8"` ("int8a8") are the
layouts JAX computes with XLA, not Pallas; here too they are plain PyTorch:
a dequantize and matmul (`int4x_matmul`, JAX's `qmm_int4_xla` step for step)
and `int8_mm` under per-token int8 activations.

MoE models (`models.mixtral`: Mixtral, Qwen3-MoE, DBRX) serve through every
entry point: each layer's FFN routes its tokens to the experts (`_moe_ffn`),
each expert's rows through the same GEMM kernels as the dense projections.
At decode S is the batch (every slot under paging), so the capacity C =
max(int(2 S k / E), 1) can be 1, and an expert then keeps only the first of
the step's tokens that pick it, as JAX's does. Biases and DBRX's qkv clamp
apply where the model's layers carry them, q/k norms and rope as the
config's `rope_qk` says.

GPT-OSS and Llama4 (`models/gpt_oss.py`, `models/llama4.py`) serve on the
einsum engine, as in JAX: each layer's flag (the config's `layer_flags()`:
GPT-OSS's sliding layers, Llama4's rope layers) selects its mask, the
sliding window or the chunk (the config's `span()`), built from the cache's
device pos; GPT-OSS's sinks join the softmax of the prefill and of the split
decode before the current token's weight is read out; Llama4's layers take
`llama4.rope_or_temperature` in place of rope, and its shared expert adds to
the routed output. The kernel engine refuses windows, sinks and Llama4, as
JAX's does; paged serving refuses all three and a sparse prefill refuses
them too: JAX's paged step runs Llama4 as if it were Llama and its sparse
prefill drops the sinks and the masks (ROADMAP queue 3).

DeepSeek serves on its own engine (`serve/deepseek_engine.py`, over the MLA
latent cache), which shares `StepEngine` with `Engine`: the host's record
of a cache's pos and the graphed `decode_step`.

Tree-speculative decoding (`Engine.generate_speculative`, JAX's, batch 1,
the einsum engine): Medusa heads on the last accepted hidden state propose a
candidate tree; one verify forward writes its N nodes at cache rows pos ..
pos + N - 1 at positions pos + depth under a mask over cache rows (the
prompt and each node's ancestors: `_model_step(positions=, mask=)`); the
accepted nodes' stored rows (int8 codes, fp8 or packed NVFP4 bytes as they
are) move to pos .. pos + a - 1 in place and pos becomes pos + a. A tree
that would run past the cache raises (JAX fails there on its host-side
mask), and so does a model with a window or chunk (GPT-OSS, Llama4): JAX's
tree mask replaces it in every layer, and its speculative tokens then leave
its greedy ones (ROADMAP queue 3).

Tensor, expert and data parallelism (`EngineConfig.mesh`, a
`parallel.mesh.Mesh` of one process per rank): the engine serves the
rank's shard (`serve/tp.py`: a whole model is sharded at construction, a
shard from `tp.shard_compressed` is taken as it is), every kernel at its
local shapes. A row-parallel projection (o / down / the shared expert's
down) all-reduces (SUM) its partial output over `tp_axis` in the output
dtype, after the cast, as JAX's psum; before it quantizes its input, a
dynamic per-token amax (W4A8's and int8a8's int8 activations, W8A8's, a
dynamic input quantizer) is all-reduced (MAX), JAX's `reduce_amax`, so
every shard quantizes against the single-device scale.
`overlap_collectives` is taken and changes nothing: JAX splits such a
projection into two output halves, each with its own SUM, for its
scheduler to overlap; the halves' SUMs give the one SUM's values, and a
collective here runs in turn with the compute (gloo's on the host, nccl's
on the one stream), so the port serves it through the one SUM. MoE
layers are expert-parallel over the same axis: the routing runs on the
replicated activations, each rank runs its E/d experts' rows and SUMs
the combined partial (`mixtral.combine_local`). `dp_axis`
shards the batch: the dense entry points take and return the whole batch
(each replica serves its rows and the results are gathered over the axis),
and `serve` gives each replica every n-th request, its share of the pages
and slots and its own scheduler, then gathers the outputs. On the card a
decode step is a CUDA graph only under an nccl group (its collectives are
captured with it, a route written but not run on more than one card);
under gloo, whose collectives run on the host, `decode_step` and
`paged_decode_step` raise unless the engine's `_eager` is set.
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
from ..models import llama, mixtral
from ..ops.cuda import flash_gqa as flash_mod
from ..ops import numerics
from ..ops.cuda import kv_attention as kva
from ..ops.cuda import paged_attention as pa
from ..ops.cuda import qmm, qmm_wo
from ..ops.cuda import sparse_attention as ssa
from ..quant import quantizer as Q
from ..parallel.mesh import Axis, all_gather_object
from ..quant.compress import CompressedModel, convert_packed_layouts, layer_arrays
from . import paged_cache as pc
from . import step_graph
from . import tp as tp_mod
from .sampling import SamplingConfig, sample
from .scheduler import Scheduler

_KV_DTYPES = (None, torch.bfloat16, torch.int8, torch.float8_e4m3fn, "nvfp4", "nvfp4_fake")
_SERVED_KINDS = ("int4a8", "int4wo", "nvfp4wo", "mxfp4wo", "int8", "fp8", "bf16", "int4x", "int8a8")


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
    # "a8" is W4A8 ("int4a8"), "xla" a plain dequantize + matmul ("int4x")
    int4_layout: str = "bd2"
    # NVFP4 serving layout, by its TPU name: "word2" | "word" | "perm" |
    # "blockdot" | "bd4", all one port layout ("nvfp4wo"); MXFP4 follows it.
    # "i8": W8A8 over the values re-encoded as int8 ("int8a8"; MXFP4 stays
    # weight-only)
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
    # tensor / expert parallelism over the mesh axis `tp_axis` of a
    # `parallel.mesh.Mesh` (the engine then serves this rank's shard, see
    # serve/tp.py); data parallelism over `dp_axis` where set (the batch,
    # the page pool and the slots shard over it)
    mesh: Any = None
    tp_axis: str = "tp"
    dp_axis: Optional[str] = None
    # JAX's: row-parallel projections as two output halves, each with its
    # own SUM, for its scheduler to overlap; the same values as the one SUM,
    # which is what the port runs (see the module docstring)
    overlap_collectives: bool = False


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


_WEIGHT_ONLY_OPS = {"int4wo": "int4_wo", "nvfp4wo": "fp4_wo", "mxfp4wo": "fp4_wo", "int8": "byte_wo",
                    "fp8": "byte_wo"}


def weight_only_kernels(cm: CompressedModel, plain_ops: tuple = ()) -> dict:
    """Projection -> the weight-only GEMM kernel (`plain_ops` name) that
    serves it, for the projections whose kernel this engine launches (an
    INT8 projection under an int input quantizer is W8A8, `int8_mm`)."""
    out = {}
    for name, kind in cm.kinds.items():
        op = _WEIGHT_ONLY_OPS.get(kind)
        icfg = cm.layout.get(f"{name}.input")
        if op is None or op in plain_ops or (kind == "int8" and icfg.enable and not icfg.is_fp):
            continue
        out[name] = op
    return out


def weight_only_refusal(cm: CompressedModel, device: torch.device, plain_ops: tuple = ()) -> Optional[str]:
    """Why an engine on `device` cannot serve `cm`, or None: on the card the
    weight-only GEMM kernels take bf16 activations only, and the engine's
    activations are the model's dtype. JAX's kernels take any dtype (ROADMAP
    queue 3, a deliberate difference): the port refuses at construction,
    where the model would otherwise fail at its first GEMM."""
    kernels = weight_only_kernels(cm, plain_ops)
    if device.type != "cuda" or not kernels or cm.model_cfg.dtype == torch.bfloat16:
        return None
    return (f"the weight-only GEMM kernels ({', '.join(sorted(set(kernels.values())))}) take bf16 activations, "
            f"and this model's activations are {cm.model_cfg.dtype}: serve it in bf16, or name the kernels "
            "in EngineConfig.plain_ops")


_NO_KERNEL_MASK = ("kv_attention_kernel does not support a mask over cache rows (tree-speculative verification): "
                   "use the einsum engine")

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


INT4X_DECODE_ROWS = 64  # JAX's qmm_int4_xla: more rows dequantize once, fewer take grouped sums


def int4x_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [N, K] times the "int4x" arrays (codes q [O, Kp] int8, K padded to
    whole blocks; block scales [O, G] f32) -> [N, O] in x's dtype, as JAX's
    `qmm_int4_xla` computes it: N > 64 dequantizes the weight in f32, rounds
    it to x's dtype and runs one matmul; N <= 64 sums each block's products
    in f32, then the blocks' sums times their scales. Plain PyTorch: JAX
    serves it with XLA, no Pallas kernel."""
    x = torch.nn.functional.pad(x, (0, q.shape[-1] - x.shape[-1]))
    N, K = x.shape
    O, G = scale.shape
    bsz = K // G
    if N > INT4X_DECODE_ROWS:
        w = (q.float().reshape(O, G, bsz) * scale.float()[..., None]).reshape(O, K)
        return x @ w.to(x.dtype).t()
    t = torch.einsum("bgk,ogk->gbo", x.float().reshape(N, G, bsz), q.float().reshape(O, G, bsz))
    return torch.einsum("gbo,og->bo", t, scale.float()).to(x.dtype)


def _int8_acts(x: torch.Tensor, a_amax: torch.Tensor, lo: int):
    """(int8 codes of x under a_amax / 127, clipped to [lo, 127], the scale)."""
    a_scale = torch.where(a_amax == 0, torch.ones_like(a_amax), a_amax / 127.0)
    return torch.clamp(torch.round(x.float() / a_scale), lo, 127).to(torch.int8), a_scale


def _token_int8_acts(x: torch.Tensor, red: Optional[Axis] = None):
    """W4A8's (and int8a8's) activations: per-token dynamic int8 codes of x
    (any leading axes) under each row's amax / 127, clipped to +-127, and
    the scale. `red`: the axis a row-parallel site's K is sharded over,
    whose MAX of each row's amax is taken first (JAX's `reduce_amax`)."""
    amax = torch.amax(torch.abs(x.float()), dim=-1, keepdim=True)
    return _int8_acts(x, amax if red is None else red.max(amax), -127)


def _lora(x, y, adapter):
    """y plus the adapter's low-rank branch (x @ A^T) @ B^T * scale."""
    if adapter is None:
        return y
    lo = (x @ adapter["A"].t().to(x.dtype)) @ adapter["B"].t().to(x.dtype)
    return y + lo * adapter["scale"].to(y.dtype)


def _qlinear(x, name, kind, arrays, cm: CompressedModel, ist, ops, adapter=None, skip_input_quant=False,
             tp: Optional[Axis] = None, row: bool = False, reduce_out: bool = True):
    """y = q_act(x) @ dequant(W)^T for x [N, K] (2-D), plus the adapter's
    low-rank branch where there is one. `skip_input_quant`: the caller has
    applied the input quantizer (an expert block's one shared site), so
    neither it nor its pre_quant_scale applies here.

    Under tensor parallelism `row` marks a row-parallel site, whose K is
    sharded over `tp`: a dynamic per-token activation amax is MAX-reduced
    over the axis before quantizing, and the partial output (the adapter's
    partial with it) is SUM-reduced in the output dtype, unless
    `reduce_out` is False (the caller folds it into a later SUM)."""
    red = tp if (tp is not None and row and tp.size > 1) else None

    def out(y):
        return red.sum(y) if red is not None and reduce_out else y

    icfg = cm.layout.get(f"{name}.input")
    if skip_input_quant:
        icfg, ist = Q.DISABLED, None
    if kind == "int4a8":
        # per-token dynamic int8 activations, clipped to +-127
        if ist is not None and ist.pre_quant_scale is not None:
            x = x * ist.pre_quant_scale.to(x.dtype)
        x8, a_scale = _token_int8_acts(x, red)
        y = ops["w4a8"](x8, arrays["packed"], arrays["scales"])
        return out(_lora(x, (y * a_scale).to(x.dtype), adapter))
    if kind == "int8" and icfg.enable and not icfg.is_fp:
        # W8A8: per-token int8 activations (the static amax's first element
        # where the site is static), clipped to [-128, 127]; int32 products,
        # then (acc * a_scale) * w_scale in f32
        if ist is not None and ist.pre_quant_scale is not None:
            x = x * ist.pre_quant_scale.to(x.dtype)
        if icfg.dynamic or icfg.per_token or ist is None or ist.amax is None:
            a_amax = torch.amax(torch.abs(x.float()), dim=-1, keepdim=True)
            if red is not None:
                a_amax = red.max(a_amax)
        else:
            a_amax = ist.amax.float().reshape(1, -1)[:, :1].expand(x.shape[0], 1)
        x8, a_scale = _int8_acts(x, a_amax, -128)
        y = int8_mm(x8, arrays["q"]).float() * a_scale * arrays["scale"].reshape(1, -1)
        return out(y.to(x.dtype))
    if kind == "int8a8":
        # NVFP4's values as per-channel int8 under per-token int8
        # activations clipped to +-127; the input quantizer is not applied
        if ist is not None and ist.pre_quant_scale is not None:
            x = x * ist.pre_quant_scale.to(x.dtype)
        x8, a_scale = _token_int8_acts(x, red)
        y = int8_mm(x8, arrays["q"]).float() * a_scale * arrays["scale"].reshape(1, -1)
        return out(_lora(x, y.to(x.dtype), adapter))
    if icfg.enable or (ist is not None and ist.pre_quant_scale is not None):
        x = Q.quantize(x, icfg, ist, amax_reduce=None if red is None else red.max)
    if kind == "int4wo":
        y = ops["int4_wo"](x, arrays["packed"], arrays["scales"])
    elif kind in ("nvfp4wo", "mxfp4wo"):
        y = ops["fp4_wo"](x, arrays["packed"], arrays["scales"], arrays.get("global_scale"))
    elif kind in ("int8", "fp8"):
        y = ops["byte_wo"](x, arrays["q"], arrays["scale"])
    elif kind == "int4x":
        y = int4x_matmul(x, arrays["q"], arrays["scale"])
    elif kind == "bf16":
        y = x @ arrays["w"].to(x.dtype).t()
    else:
        raise NotImplementedError(f"weight kind {kind!r} is served by a later slice")
    return out(_lora(x, y, adapter))


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


def _expert_linear(x, name, kind, arrays, cm, ops):
    """Every expert's projection at once: x [E, C, K] -> [E, C, O], each
    expert's packed slice through `_qlinear` (the input quantizer already
    applied). W4A8's per-token int8 activations and its output scale are
    row-wise (`_token_int8_acts`, as `_qlinear` takes them), so they are
    taken for all experts' rows in one pass and only the GEMM runs per
    expert."""
    E = x.shape[0]
    if kind != "int4a8":
        return torch.stack([_qlinear(x[e], name, kind, layer_arrays(arrays, e), cm, None, ops, skip_input_quant=True)
                            for e in range(E)])
    x8, a_scale = _token_int8_acts(x)
    y = torch.stack([ops["w4a8"](x8[e], arrays["packed"][e], arrays["scales"][e]) for e in range(E)])
    return (y * a_scale).to(x.dtype)


def _n_experts(arrays: dict) -> int:
    return next(v for v in arrays.values() if isinstance(v, torch.Tensor)).shape[0]


def _moe_ffn(cfg, cm, h2, lp, lstate, kinds, ops, ep: Optional[Axis] = None, reduce: bool = True):
    """The routed-expert FFN on packed weights, h2 [S, H] -> [S, H]:
    routing and dispatch are the model's (`cfg.route_dispatch`: mixtral's,
    or DeepSeek's group-limited router), the activation `mixtral`'s, so
    serving computes the calibrated forward's function; each expert's C
    rows (C = max(int(capacity_factor S k / E), 1), JAX's) go through the
    ported GEMMs (`_expert_linear`). Gate and up share one input quantizer,
    applied once per expert's rows; down's input is not quantized.

    Expert parallelism (the layer's stacks hold E/d experts, `ep` the axis
    they shard over): the routing runs on the replicated activations over
    all E experts, this rank runs its own experts' rows, combines its
    tokens' pairs with those experts and SUMs the partial over the axis
    (unless `reduce` is False: the caller folds it into a later SUM)."""
    S, H = h2.shape
    d = cfg.route_dispatch(h2, lp)
    E, k = d.experts, d.dest.shape[0] // S
    El = _n_experts(lp["moe.gate_proj"])
    e0 = (ep.index if ep is not None else 0) * El
    xe = mixtral.dispatch_tokens(d, h2, E)[e0:e0 + El]
    ist = (lstate or {}).get("moe.gate_proj", {}).get("input")
    icfg = cm.layout.get("moe.gate_proj.input")
    if icfg.enable or (ist is not None and ist.pre_quant_scale is not None):
        # one site for the block, quantized per expert's rows as JAX's
        # engine does (a dynamic scale sees only that expert's rows)
        xe = torch.stack([Q.quantize(xe[e], icfg, ist) for e in range(El)])

    def lin(x, name):
        y = _expert_linear(x, name, kinds[name], lp[name], cm, ops)
        return y if not cfg.moe_bias else y + lp[name + "__bias"][:, None].to(y.dtype)

    y = mixtral.expert_act(cfg, lin(xe, "moe.gate_proj"), lin(xe, "moe.up_proj")).to(h2.dtype)
    return mixtral.combine_local(d, lin(y, "moe.down_proj"), e0, S, k, h2.dtype, ep if reduce else None)


def _ffn(cfg, cm, h2, lp, lstate, kinds, ops, lin, ep: Optional[Axis] = None, one_sum: bool = False):
    """The layer's FFN: routed experts where the layer has them (and the
    shared expert, Llama4's or DeepSeek's, added to their output through
    `lin`), else the dense MLP through `lin(x, name)`. Under expert
    parallelism over `ep` the routed and the shared partials take a SUM each
    (JAX's engine), or with `one_sum` one SUM of both (JAX's DeepSeek
    engine); `lin(x, name, reduce=False)` leaves a row site's partial
    unreduced."""
    if "moe.gate_proj" in lp:
        y = _moe_ffn(cfg, cm, h2, lp, lstate, kinds, ops, ep, reduce=not one_sum)
        if "shared.gate_proj" in lp:
            ys = (torch.nn.functional.silu(lin(h2, "shared.gate_proj").float())
                  * lin(h2, "shared.up_proj").float()).to(h2.dtype)
            y = y + lin(ys, "shared.down_proj", reduce=not one_sum)
        return ep.sum(y) if (one_sum and ep is not None) else y
    y = (torch.nn.functional.silu(lin(h2, "mlp.gate_proj").float()) * lin(h2, "mlp.up_proj").float()).to(h2.dtype)
    return lin(y, "mlp.down_proj")


def _layer(cfg, cm, x, lp, lstate, kinds, positions, ops, attend, adapters=None, flag: bool = False,
           tp: Optional[Axis] = None):
    """One decoder layer on packed weights: projections (their biases, the
    qkv clamp and the per-head q/k norms where the model has them) and
    rope (the config's `rope_qk`; Llama4's by the layer's `flag`), then
    `attend(q [B, T, nH, hd], k, v [B, T, nKV, hd]) -> ctx [B*T, nH*hd]`,
    then the output projection and the FFN. `adapters`: this layer's
    low-rank branches by projection, or None. Under tensor parallelism
    (`tp`, the layer being this rank's shard: cfg's heads are the local
    ones) the row sites reduce over the axis (`_qlinear`) and the experts
    are expert-parallel over it."""
    B, T, H = x.shape
    hd, nH, nKV = cfg.hd, cfg.num_attention_heads, cfg.num_key_value_heads

    def lin(inp, name, reduce=True):
        ist = (lstate or {}).get(name, {}).get("input")
        y = _qlinear(inp, name, kinds[name], lp[name], cm, ist, ops, (adapters or {}).get(name), tp=tp,
                     row=name in tp_mod.ROW_SITES, reduce_out=reduce)
        return y if name + "__bias" not in lp else y + lp[name + "__bias"].to(y.dtype)

    h2 = llama.norm(cfg, x, lp["input_layernorm"]).reshape(B * T, H)
    q, k, v = (lin(h2, f"self_attn.{p}_proj") for p in "qkv")
    if cfg.clip_qkv is not None:
        q, k, v = (torch.clamp(t, -cfg.clip_qkv, cfg.clip_qkv) for t in (q, k, v))
    q, k, v = q.reshape(B, T, nH, hd), k.reshape(B, T, nKV, hd), v.reshape(B, T, nKV, hd)
    q, k = cfg.rope_qk(q, k, positions, lp, flag)  # the model's own, as JAX's engine uses it
    ctx = attend(q, k, v)
    x = x + lin(ctx, "self_attn.o_proj").reshape(B, T, H)
    h2 = llama.norm(cfg, x, lp["post_attention_layernorm"]).reshape(B * T, H)
    return x + _ffn(cfg, cm, h2, lp, lstate, kinds, ops, lin, tp).reshape(B, T, H)


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


def _einsum_attn(cfg, ecfg, q, k, v, ck, cv, pos, ka, va, ops, keep_fracs, span=None, sinks=None, mask=None):
    """Attention of one layer of the einsum engine over its dense cache ck/cv
    [B, S, n_kv, C], written in place at rows pos .. pos + T - 1 (pos: the
    cache's 0-d int32 tensor). `keep_fracs` is a list for a sparse prefill
    (the layer's kept share of tiles is appended), else None. `span`: the
    layer's window or chunk (the config's `span()`) where it is flagged, else None
    (causal); `sinks` [nH]: GPT-OSS's sink logits, which join the softmax
    (`llama.sink_softmax`). `mask` ([1, 1, T, S] additive over cache rows,
    JAX's `mask_override`) replaces the causal or span mask, and every T
    then attends over the whole cache as a prefill does (tree
    verification). Returns ctx [B*T, nH*hd]."""
    B, T, nH, hd = q.shape
    nKV, S = cfg.num_key_value_heads, ck.shape[1]
    rep, dt, kv_dtype = nH // nKV, cfg.dtype, ecfg.kv_dtype
    k_st = _kv_store(k, kv_dtype, ka).to(ck.dtype)
    v_st = _kv_store(v, kv_dtype, va).to(cv.dtype)
    qg = q.reshape(B, T, nKV, rep, hd).float()
    split = T == 1 and mask is None
    if mask is None:
        mask = llama.span_mask(S, pos + torch.arange(T, device=q.device), span)

    def probs_of(scores):  # [B, nKV, rep, T, S] f32 -> probabilities in the activation dtype
        scores = scores.reshape(B, nH, T, S).div_(math.sqrt(hd)).add_(mask)
        if sinks is not None:
            return llama.sink_softmax(scores, sinks, dt).reshape(B, nKV, rep, T, S)
        return torch.softmax(scores, dim=-1).to(dt).reshape(B, nKV, rep, T, S)

    rows = _rows_at(pos, T)
    if split:
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


class StepEngine:
    """What an engine over a dense cache with a device `pos` needs for its
    greedy decode: the host's record of each cache's pos (`_set_pos`,
    `_room`), the fused `decode_step` (one CUDA-graph replay on the card,
    the steps eagerly on the CPU or with `_eager`), `decode`, `generate`
    and `generate_host`. A subclass gives `init_cache`, `prefill`,
    `_model_step(tokens, cache) -> logits [B, V]` (updates the cache in
    place, its pos included) and `_cache_rows(cache)`."""

    def __init__(self, device, mesh=None):
        self.device = device
        self._mesh = mesh
        self._caches: dict = {}  # id(a cache's owner tensor) -> _CacheState, dropped with the owner
        self._graph_stream = None  # the side stream the decode steps are captured on
        self._eager = False  # True: the decode steps launch eagerly on the card too (the graphs' reference)

    def _dp_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This data-parallel replica's rows of a whole-batch tensor (all of
        it without a data-parallel axis)."""
        return t

    def _dp_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every replica's rows, in replica order (t without the axis)."""
        return t

    def _graphable(self) -> None:
        """A decode step on the card is a CUDA graph, which holds a
        collective only where the card runs it (nccl): under a gloo mesh
        (the collectives run on the host) it raises, unless `_eager`."""
        m = self._mesh
        if m is not None and m.world > 1 and m.backend != "nccl":
            raise RuntimeError(
                f"decode steps on the card are captured as CUDA graphs, which cannot hold the {m.backend} "
                "backend's collectives (they run on the host): set the engine's _eager = True to launch the steps "
                "eagerly, or serve over an nccl group")

    def _cache_rows(self, cache: dict) -> int:
        raise NotImplementedError

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
        rows = self._cache_rows(cache)
        if empty and pos != 0:
            raise ValueError(f"prefill needs an empty cache (pos == 0), got pos {pos}")
        if pos + T > rows:
            raise ValueError(f"cache holds {rows} rows, step needs {pos + T}")
        return pos

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
        tok = self._dp_rows(tok.to(device=self.device, dtype=torch.int32))
        if self.device.type != "cuda" or self._eager:
            tok = self._greedy_steps(tok, cache, unroll)
        else:
            self._graphable()
            key = ("dense", step_graph.tensor_key(*(cache[k] for k in sorted(cache))), tok.shape, unroll)
            tok = self._replay(cache["pos"], key, lambda t: self._greedy_steps(t, cache, unroll), tok)
        self._set_pos(cache, pos + unroll)
        return self._dp_gather(tok), cache

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
                tok = sample(self._dp_gather(self._model_step(self._dp_rows(tok), cache)), sampling, generator)[:, None]
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


class Engine(StepEngine):
    """Generation engine over a compressed model, on `device` (cuda unless
    the caller passes device="cpu"); the model must already live there."""

    def __init__(self, cm: CompressedModel, config: EngineConfig = EngineConfig(), device=None):
        mesh = config.mesh
        super().__init__(resolve_device(mesh.device if device is None and mesh is not None else device), mesh)
        self._tp = Axis(mesh, config.tp_axis) if mesh is not None else None
        self._dp = Axis(mesh, config.dp_axis) if mesh is not None and config.dp_axis else None
        if mesh is not None:
            d, r = self._tp.size, self._tp.index
            if config.nvfp4_layout == "i8" and "nvfp4" in cm.kinds.values():  # a shard given as it is, too
                raise NotImplementedError(tp_mod.I8_UNDER_MESH)
            if cm.shard is None:
                cm = tp_mod.shard_compressed(cm, d, r, config.tp_axis, config.nvfp4_layout)
            elif tuple(cm.shard) != (config.tp_axis, d, r):
                raise ValueError(f"the model is shard {cm.shard}, this rank serves ({config.tp_axis!r}, {d}, {r})")
        elif cm.shard is not None:
            raise ValueError(f"the model is shard {cm.shard} of a mesh: give the engine the mesh")
        if cm.params["embed_tokens"].device.type != self.device.type:
            raise ValueError(f"model lives on {cm.params['embed_tokens'].device}, engine on {self.device}")
        if config.kv_attention_kernel and config.attn_sparsity is not None:
            raise NotImplementedError(
                "kv_attention_kernel: prefill attention sparsity unsupported (flash prefill path owns attention)")
        mcfg, sinks = cm.model_cfg, "self_attn.sinks" in cm.params["layers"]
        span = mcfg.span()
        if config.kv_attention_kernel and (span is not None or sinks):
            # JAX refuses them too: its kernels attend causally, without sinks
            raise NotImplementedError(
                "kv_attention_kernel: " + ("Llama4's rope / nope chunked attention" if span and span[0] == "chunk"
                                           else "sliding windows" if span else "attention sinks")
                + " use the dense-cache einsum engine (kv_attention_kernel=False)")
        if config.attn_sparsity is not None and (span is not None or sinks):
            # JAX's sparse prefill attends causally over the fresh tokens and
            # so drops the window, the chunk, the sinks and Llama4's
            # temperature-tuned q (ROADMAP queue 3): the port refuses
            raise NotImplementedError(
                "attn_sparsity: the skip-softmax prefill attends causally, without sliding windows, Llama4's "
                "chunks or attention sinks")
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
        refusal = weight_only_refusal(cm, self.device, config.plain_ops)
        if refusal is not None:
            raise TypeError(refusal)
        self.cm = cm
        self.cfg = cm.model_cfg
        self.ecfg = config
        self._ops = _ops(config.plain_ops)
        self._flags = self.cfg.layer_flags()
        L = self.cfg.num_hidden_layers
        default = torch.full((L,), 448.0, dtype=torch.float32, device=self.device)
        ka, va = _kv_amax_from(cm.qstate, "k"), _kv_amax_from(cm.qstate, "v")
        self._ka = ka if ka is not None else default
        self._va = va if va is not None else default
        self._act_state = {name: {"input": sub["input"]} for name, sub in (cm.qstate or {}).items()
                           if isinstance(sub, dict) and "input" in sub}
        self.last_prefill_keep_frac = None  # [L] after a sparse prefill

    def _cache_rows(self, cache: dict) -> int:
        return cache["k"].shape[3 if self.ecfg.kv_attention_kernel else 2]

    def _dp_rows(self, t: torch.Tensor) -> torch.Tensor:
        if self._dp is None or self._dp.size == 1:
            return t
        n = self._dp.size
        if t.shape[0] % n:
            raise ValueError(f"batch {t.shape[0]} does not divide over the {n} data-parallel replicas")
        b = t.shape[0] // n
        return t[self._dp.index * b:(self._dp.index + 1) * b]

    def _dp_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t if self._dp is None else self._dp.gather(t, 0)

    def init_cache(self, batch: int, max_len: Optional[int] = None, replica: bool = False) -> dict:
        """The dense cache (this rank's shard of it under a mesh: its kv heads,
        and its replica's rows of the `batch` unless `replica` says the batch
        is the replica's already; `tp.cache_specs`). Einsum engine: stored
        rows [L, B, S, n_kv, C] (packed NVFP4: C = 9 hd/16 bytes). Kernel
        engine: kv-head-major stored form [L, B, n_kv, S, C]; NVFP4 keeps its
        nibble planes in "k"/"v" and its block-scale bytes in "ks"/"vs"."""
        cfg = self.cfg
        max_len = max_len or self.ecfg.max_seq_len
        kvk = self.ecfg.kv_attention_kernel
        dtype, last = self.ecfg.kv_dtype or cfg.dtype, cfg.hd
        if dtype == "nvfp4":
            dtype, last = torch.uint8, (cfg.hd // 2 if kvk else _kv_pack_width(cfg.hd))
        elif dtype == "nvfp4_fake":
            dtype = cfg.dtype
        n_kv = cfg.num_key_value_heads * (self._tp.size if self._tp is not None else 1)  # the whole model's
        spec = tp_mod.cache_specs(self.ecfg.tp_axis, None if replica else self.ecfg.dp_axis, kvk)["k"]

        def rows(width, dt):
            lead = (n_kv, max_len) if kvk else (max_len, n_kv)
            shape = tp_mod.local_shape((cfg.num_hidden_layers, batch, *lead, width), spec, self._mesh)
            return torch.zeros(shape, dtype=dt, device=self.device)

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
                       positions, self._ops, attend_of(i), ad, self._flags[i], self._tp)
        return x

    def _logits(self, x: torch.Tensor, full: bool = False, hidden: bool = False):
        """The last position's logits [B, V] f32, or every position's [B, T, V];
        with `hidden` also the post-norm hidden state [B, T, H]."""
        params = self.cm.params
        x = llama.norm(self.cfg, x, params["norm"])
        head_w = params.get("lm_head", params["embed_tokens"])
        logits = ((x if full else x[:, -1, :]) @ head_w.t().to(x.dtype)).float()
        return (logits, x) if hidden else logits

    @torch.inference_mode()
    def _model_step(self, tokens: torch.Tensor, cache: dict, full_logits: bool = False,
                    keep_fracs: Optional[list] = None, positions: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None, return_hidden: bool = False):
        """Forward over packed weights; updates `cache` in place, its pos
        included. Returns the last position's logits [B, V] f32 (every
        position's with `full_logits`), and with `return_hidden` also the
        post-norm hidden state [B, T, H]. A list `keep_fracs` runs the einsum
        engine's sparse prefill and receives each layer's kept share of
        tiles. `positions` [1, T] (default pos .. pos + T - 1) are the rope
        positions; `mask` [1, 1, T, S] (JAX's `mask_override`: additive over
        cache rows) replaces the causal or span mask in every layer (the
        einsum engine only; tree verification, where a row's cache slot is
        not its position). Reads nothing back to the host: the caller checks
        the room (`_room`)."""
        cfg = self.cfg
        B, T = tokens.shape
        pos = cache["pos"]
        kvk = self.ecfg.kv_attention_kernel
        if kvk and keep_fracs is not None:
            raise NotImplementedError("kv_attention_kernel does not support sparse-prefill steps")
        if kvk and mask is not None:
            raise NotImplementedError(_NO_KERNEL_MASK)
        x = self.cm.params["embed_tokens"][tokens].to(cfg.dtype)
        if positions is None:
            positions = (pos + torch.arange(T, device=self.device, dtype=torch.int32))[None]
        positions = positions.expand(B, T)
        packed4 = "ks" in cache

        sinks = self.cm.params["layers"].get("self_attn.sinks")

        def attend_of(i):
            if not kvk:
                span = cfg.span() if self._flags[i] else None
                return lambda q, k, v: _einsum_attn(cfg, self.ecfg, q, k, v, cache["k"][i], cache["v"][i], pos,
                                                    self._ka[i], self._va[i], self._ops, keep_fracs, span,
                                                    None if sinks is None else sinks[i], mask)
            cks, cvs = (cache["ks"][i], cache["vs"][i]) if packed4 else (None, None)
            return lambda q, k, v: _dense_attn(cfg, self.ecfg, q, k, v, cache["k"][i], cache["v"][i], cks, cvs,
                                               pos, self._ka[i], self._va[i], self._ops)

        x = self._layers(x, positions, attend_of)
        pos.add_(T)
        return self._logits(x, full_logits, return_hidden)

    def prefill(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """Prefill an empty cache with tokens [B, T]; returns logits [B, V].
        With `attn_sparsity` set and T > 1 the einsum engine attends through
        the skip-softmax kernel and records each layer's kept share of tiles
        in `last_prefill_keep_frac` [L]. Under a data-parallel axis the
        tokens and the logits are the whole batch's, the cache the replica's."""
        return self._dp_gather(self._prefill(self._dp_rows(tokens), cache))

    def _prefill(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        self._room(cache, tokens.shape[1], empty=True)
        keep = [] if self.ecfg.attn_sparsity is not None and tokens.shape[1] > 1 else None
        logits = self._model_step(tokens, cache, keep_fracs=keep)
        self._set_pos(cache, tokens.shape[1])
        if keep is not None:
            self.last_prefill_keep_frac = torch.stack(keep)
        return logits

    # ---------------- tree-speculative decoding ----------------

    def _check_speculative(self, batch: int) -> None:
        if batch != 1:
            raise ValueError(f"tree-speculative decoding is single-sequence, got batch {batch}")
        if self.ecfg.kv_attention_kernel:
            raise NotImplementedError(_NO_KERNEL_MASK)
        if self.cfg.span() is not None:
            # JAX's verify mask replaces the window / chunk in every layer, so
            # its speculative tokens leave its own greedy ones (ROADMAP queue 3)
            raise NotImplementedError(
                "tree-speculative decoding does not support sliding windows or Llama4's chunked attention: "
                "the tree mask would replace the layers' window / chunk")

    def _spec_prefill(self, prompt: torch.Tensor) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """A fresh cache prefilled with prompt [1, T] -> (cache, every
        position's logits [1, T, V], the post-norm hidden state [1, T, H])."""
        cache = self.init_cache(1)
        self._room(cache, prompt.shape[1], empty=True)
        logits, hidden = self._model_step(prompt.to(self.device), cache, full_logits=True, return_hidden=True)
        self._set_pos(cache, prompt.shape[1])
        return cache, logits, hidden

    def _verify_round(self, cache: dict, cand: np.ndarray, tree) -> tuple[torch.Tensor, torch.Tensor, int]:
        """One verify forward of the tree's N candidate tokens `cand` at cache
        rows pos .. pos + N - 1 and positions pos + depth, each node seeing
        the rows before pos and its ancestors' rows -> (logits [N, V],
        post-norm hidden [N, H], pos). Leaves the cache's pos at pos + N
        until `_compact`."""
        N = tree.n_nodes
        pos = self._room(cache, N)
        allow = np.zeros((N, self._cache_rows(cache)), bool)
        allow[:, :pos] = True
        allow[:, pos:pos + N] = tree.attn_mask
        mask = torch.from_numpy(np.where(allow, 0.0, -1e9).astype(np.float32)).to(self.device)[None, None]
        positions = torch.tensor([[pos + d for d in tree.depth]], dtype=torch.int32, device=self.device)
        logits, hidden = self._model_step(torch.from_numpy(np.asarray(cand, np.int32)[None]).to(self.device),
                                          cache, full_logits=True, positions=positions, mask=mask,
                                          return_hidden=True)
        return logits[0], hidden[0], pos

    def _compact(self, cache: dict, pos: int, nodes: list) -> None:
        """The stored k/v rows of the accepted `nodes` (slots pos + node) to
        rows pos .. pos + a - 1, in place in their stored form, and pos =
        pos + a."""
        a = len(nodes)
        take = torch.tensor([pos + i for i in nodes], device=self.device)
        dst = torch.arange(pos, pos + a, device=self.device)
        for name in ("k", "v"):
            c = cache[name]
            c = c.view(torch.uint8) if c.element_size() == 1 else c  # index_copy_ has no fp8 kernel
            c.index_copy_(2, dst, c.index_select(2, take))
        cache["pos"].fill_(pos + a)
        self._set_pos(cache, pos + a)

    @torch.inference_mode()
    def generate_speculative(self, prompt: torch.Tensor, medusa_params: dict, max_new_tokens: int = 32,
                             tree=None) -> tuple[list, float]:
        """Greedy Medusa tree-speculative decoding on the engine's cache
        (JAX's, step for step): prompt [1, T] -> (max_new_tokens greedy
        tokens as ints, acceptance rate: accepted / proposed draft tokens).
        Each round: the heads on the last accepted hidden state, their top-k
        by depth laid on `tree` (default `speculative.tree.build_tree()`),
        one verify forward (`_verify_round`), greedy acceptance along the
        tree, the accepted rows compacted (`_compact`). The tokens are plain
        greedy decoding's; speculation changes the number of forwards."""
        from ..speculative import medusa as med_mod
        from ..speculative import tree as tree_mod

        self._check_speculative(prompt.shape[0])
        tree = tree or tree_mod.build_tree()
        cache, logits, hidden = self._spec_prefill(prompt)
        head_w = self.cm.params.get("lm_head", self.cm.params["embed_tokens"])
        base_tok = int(torch.argmax(logits[0, -1]))
        h_last = hidden[:, -1, :]
        k_needed = max(tree.choice) + 1
        # the base token is emitted once here; each round then emits its
        # accepted draft tokens and the bonus (the next round's base)
        out = [base_tok]
        n_acc_total = n_prop_total = 0
        while len(out) < max_new_tokens:
            head_lg = med_mod.apply_heads(medusa_params, h_last, head_w.to(h_last.dtype))
            head_topk = np.stack([tree_mod.top_k_ids(head_lg[d][0], k_needed) for d in range(tree.max_depth)])
            cand = tree_mod.assemble_candidates(tree, base_tok, head_topk)
            v_logits, v_hidden, pos = self._verify_round(cache, cand, tree)
            nodes, bonus = tree_mod.accept_nodes(tree, cand, torch.argmax(v_logits, dim=-1).cpu().numpy())
            n_acc_total += len(nodes) - 1
            n_prop_total += tree.n_nodes - 1
            self._compact(cache, pos, nodes)
            out.extend([int(cand[i]) for i in nodes[1:]] + [bonus])
            base_tok = bonus
            h_last = v_hidden[nodes[-1]][None]
        return out[:max_new_tokens], n_acc_total / max(n_prop_total, 1)

    # ---------------- paged KV + continuous batching ----------------

    def _check_paged(self) -> None:
        """Paged serving attends causally, with split-half rope and no sinks:
        a model with sinks or a sliding window (GPT-OSS; JAX refuses sinks)
        or a Llama4 model (JAX serves it as if it were Llama, ROADMAP queue 3)
        raises."""
        if "self_attn.sinks" in self.cm.params["layers"] or self.cfg.span() is not None:
            raise NotImplementedError(
                "paged serving does not support attention sinks, sliding windows or Llama4's rope / nope chunked "
                "attention: serve the model on the dense-cache engine")

    def init_paged_cache(self, n_pages: int, page_size: int, max_slots: int,
                         max_pages_per_seq: int) -> pc.PagedKV:
        """The page pool: this rank's shard under a mesh (its kv heads; its
        replica's share of the pages and slots, `tp.paged_cache_specs`)."""
        self._check_paged()
        cfg = self.cfg
        dtype = self.ecfg.kv_dtype or cfg.dtype
        packed4 = dtype == "nvfp4"  # nibble planes + E4M3 scale pools
        if dtype in ("nvfp4", "nvfp4_fake"):
            dtype = cfg.dtype
        spec = tp_mod.paged_cache_specs(packed4, self.ecfg.tp_axis, self.ecfg.dp_axis)
        n_kv = cfg.num_key_value_heads * (self._tp.size if self._tp is not None else 1)
        _, n_pages, n_kv, _, _ = tp_mod.local_shape((1, n_pages, n_kv, page_size, 1), spec["k_pages"], self._mesh)
        (max_slots,) = tp_mod.local_shape((max_slots,), spec["seq_lens"], self._mesh)
        return pc.init_paged(cfg.num_hidden_layers, n_pages, page_size, n_kv, cfg.hd,
                             max_slots, max_pages_per_seq, dtype, packed_nvfp4=packed4, device=self.device)

    @torch.inference_mode()
    def prefill_into_slot(self, cache: pc.PagedKV, slot: int, tokens: torch.Tensor) -> torch.Tensor:
        """Prefill one sequence [1, T] densely (`prefill`: flash attention, the
        einsum engine's attention, or its sparse route) and copy its
        stored-form cache rows into the slot's pages; the slot's length
        becomes T. Returns the logits [1, V]."""
        self._check_paged()
        T = tokens.shape[1]
        dense = self.init_cache(1, max_len=T, replica=True)
        logits = self._prefill(tokens.to(self.device), dense)
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
        self._check_paged()
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
        self._graphable()
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
        if self._dp is not None and self._dp.size > 1:
            return self._serve_replicas(requests, n_pages, page_size, max_slots, max_pages_per_seq, prefix_cache,
                                        unroll, collect_metrics)
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

    def _serve_replicas(self, requests, n_pages, page_size, max_slots, max_pages_per_seq, prefix_cache, unroll,
                        collect_metrics):
        """`serve` under a data-parallel axis: replica i serves requests i,
        i + n, ... with its own scheduler over its share of the pages and
        slots (`init_paged_cache`'s); the outputs are gathered over the axis
        (every request's `output` set). Metrics are this replica's."""
        n, i = self._dp.size, self._dp.index
        for what, v in (("n_pages", n_pages), ("max_slots", max_slots)):
            if v % n:
                raise ValueError(f"{what} {v} does not divide over the {n} data-parallel replicas")
        requests = list(requests)
        dp, ecfg = self._dp, self.ecfg
        # the replica serves its own requests alone, over its own share of the pool
        self._dp, self.ecfg = None, dataclasses.replace(ecfg, dp_axis=None)
        try:
            res = self.serve(requests[i::n], n_pages // n, page_size, max_slots // n, max_pages_per_seq,
                             prefix_cache, unroll, collect_metrics)
        finally:
            self._dp, self.ecfg = dp, ecfg
        outs, metrics = res if collect_metrics else (res, None)
        merged = {}
        for part in all_gather_object(outs, self._mesh, ecfg.dp_axis):
            merged.update(part)
        for r in requests:
            r.output = list(merged[r.rid])
        merged = {r.rid: merged[r.rid] for r in requests}
        return (merged, {**metrics, "replicas": n}) if collect_metrics else merged
