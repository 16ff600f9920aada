#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py                 # all phases, needs one CUDA card
    python3 chip_smoke.py --phases build,kernels

Phases (any failure raises, and the script exits non-zero):
  build    nvcc-builds every kernel of `tensorrt_model_optimizer_tpu_torch/csrc`
           (one process per source, in parallel) and prints the build time.
  kernels  each kernel against its plain PyTorch version on the card, at the
           Llama-3.1-8B shapes of the served path, with CUDA-event timings,
           the bound (bytes or operations) and, where PyTorch has one call for
           the same function (flash, int4 and int8 weight-only, SDPA for the
           bf16 format of the three KV attention kernels and for skip-softmax
           at threshold 1e-30), its time. Flash (tensor cores) also runs with
           q as the engine passes it, at a ragged T and at head_dim 64 and 32.
           Paged prefill runs through both routes: the tensor cores (bf16 q)
           in every stored form at T = 64 and T = 5, the CUDA cores (f32 q)
           at T = 64; KV decode (split over the cache) at the 8B pos and at
           pos 0, 1 and one past its first split; paged decode (split over
           each sequence's rows) at 2048 rows, at ragged lengths and at
           lengths on each side of its splits' edges. The W4A8 and the
           weight-only GEMMs run at gate_proj, down_proj and k_proj, N = 8
           (the decode route, split over K) and N = 16384; W4A8 is held to
           its plain version bit for bit on both routes, with torch._int_mm
           (int8 x int8, no block scales) timed beside it at N = 16384. A
           second call of each split kernel (paged decode, the GEMMs) on
           the same inputs must give the first call's bits.
           Skip-softmax runs through both routes: the tensor cores at the 8B
           shape (128- and 64-tiles), on spiked inputs and at a calibrated
           threshold; the CUDA cores at the RULER anchor's shape (f32) and at
           ragged tile sizes. Both report the share of bf16 outputs one ulp
           from the plain version's; flash holds it to ULP_OFF_MAX at the
           anchor's prefill shape. Their phase rows also carry the time of
           the CUDA-core kernels they replaced (`cuda_core_ms`, a constant,
           not printed in the kernels line).
  anchor   the in-repo trained checkpoint `artifacts/anchor-llama` through
           load -> PTQ -> compress -> int8-KV engine, once for each served
           path (W4A8; INT4, NVFP4, MXFP4, INT8 weight-only; FP8 and NVFP4 with
           their activation quantizers), the
           kernels against the plain versions: each projection's GEMM at the
           checkpoint's shapes, the logits at every greedy step against an
           f32 yardstick, and for W4A8 equal tokens. Then `Engine.serve` over
           int8 pages and over packed NVFP4 pages (NVFP4_KV_CFG): page 8, 2
           slots, 4 requests behind a shared prefix, prefix cache, unroll 1 and
           4; the paged kernels against their plain versions in lock step, and
           every served token against the dense-cache engine. Then the einsum
           engine (kv_attention_kernel=False) with int8 and packed NVFP4
           caches, dense and sparse prefill and decode, kernel against plain;
           and the RULER threshold curve on `artifacts/anchor-ruler` through
           the skip-softmax kernel and its plain version.
  full     Llama-3.1-8B at full width (seeded random bf16 weights on the
           card, made once): for each path of `FULL_PATHS`, PTQ -> compress ->
           engine, batch 8 x 2048-token prompts then 32 decode steps. W4A8,
           INT4 and NVFP4 run at full depth (32 layers), the other four paths
           on the first 4 layers. Launch counts are set to 0 before each path
           and read after it; the prefill logits are held against the plain
           version of that path's GEMM at depths 1 and 2, and for W4A8 at
           depths 1, 2, 4, 8 and 32 against the all-plain engine and an engine
           that runs only flash attention on its plain version. The INT4 path
           then serves 12 requests (1024-token prompts behind a 256-token
           shared prefix) through `Engine.serve` over int8 pages: 8 slots,
           page 16, prefix cache, unroll 4, all 32 layers; runs the einsum
           engine on all 32 layers with dense and sparse prefill of 8 x 2048
           tokens and 32 decode steps; and on 4 layers NVFP4_KV_CFG serves
           packed NVFP4 pages and generates over the dense NVFP4 KV cache at
           batch 8 x 2048.
The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}  # dense tensor-core peaks; f32 off the tensor cores
ANCHOR = os.path.join(HERE, "artifacts", "anchor-llama")
ANCHOR_RULER = os.path.join(HERE, "artifacts", "anchor-ruler")
RULER_CURVE = os.path.join(HERE, "artifacts", "ruler_curve.json")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of each phase; `full` is the served configuration."""

    qmm_shapes: tuple = ((14336, 4096, "gate_proj"), (4096, 14336, "down_proj"), (1024, 4096, "k_proj"))
    qmm_rows: tuple = (8, 16384)
    kv: tuple = (8, 8, 4, 128, 2560, 2048)  # B, n_kv, rep, hd, S, pos
    flash: tuple = (8, 32, 8, 2048, 128)  # B, H, Hkv, T, d
    skip: tuple = (256, 2048, 128, 128)  # BH (8 sequences x 32 heads), S, d, tile
    page: int = 16      # rows of a KV page
    chunk: int = 64     # tokens of a paged prefill chunk (`Engine.prefill_chunked`)
    batch: int = 8
    prompt: int = 2048
    decode_steps: int = 32
    max_seq: int = 2560
    reps: int = 20


def log(*a):
    print(*a, flush=True)


def bound(bytes_moved: float, ops: float, op_type: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median CUDA-event time of `fn` over `reps` launches after warm-up,
    with the 50 MB L2 flushed before each launch (the served path meets
    every layer's weights and cache cold).

    The device is held back by a spin kernel while the host enqueues all
    the timed launches: without it a launch shorter than its wrapper's host
    time (the KV kernels' 20-70 us against ~0.1 ms of Python) is timed from
    an event the idle device stamped before the launch arrived, so its
    reading is the host's enqueue time (on an H100 the same kv decode read
    0.035 and 0.066 ms in two runs of this script before the spin)."""

    CLOCK_HZ = 2.0e9  # at least the card's clock: the spin lasts at least as long as asked

    def __init__(self, torch, device):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.flush_buf.add_(1)
        fn()
        host_s = time.perf_counter() - t0  # one rep's enqueue on the host
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(2.0 * reps * host_s + 1e-3, 0.2) * self.CLOCK_HZ))
        pairs = []
        for _ in range(reps):
            self.flush_buf.add_(1)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_build():
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    log(json.dumps({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
                    "per_source_s": {k: round(v["seconds"], 3) for k, v in report.items()}}))
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def phase_kernels(torch, dev, sz: Sizes, timer: Timer, rows: dict):
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm

    g = torch.Generator(device=dev).manual_seed(0)
    # --- W4A8 GEMM: bit-exact with its plain version on both routes (exact
    # int32 block sums; the same f32 fold order, the decode route's split of
    # K included, which the plain version takes too), held with torch.equal;
    # a second call of the split route must give the first call's bits. At
    # N = 16384 `torch._int_mm` on the same M, N, K with the int8 weights
    # unpacked in advance is timed beside it: int8 x int8 with no block
    # scales, not the same function (library_ms stays null).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for O, K, label in sz.qmm_shapes:
        nblk = K // 128
        packed = torch.randint(0, 256, (O, K // 2), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
        scales = (torch.rand((nblk, O), generator=g, device=dev) * 1.5 + 0.5).to(torch.bfloat16)
        for N in sz.qmm_rows:
            x8 = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
            n_split = qmm.w4a8_decode_splits(N, nblk * 128, O, sms)
            out = qmm.w4a8_matmul(x8, packed, scales)
            torch.cuda.synchronize()
            ref = qmm.w4a8_matmul_plain(x8, packed, scales, n_split=n_split)
            err = float((out - ref).abs().max())
            rel = _rel(out, ref)
            if not torch.equal(out, ref):
                raise AssertionError(f"w4a8 {label} N={N} ({n_split} splits): not bit-exact with the plain "
                                     f"version, max abs err {err}, rel err {rel}")
            if N <= 16:
                _same_again(torch, f"w4a8 {label} N={N}", out, qmm.w4a8_matmul(x8, packed, scales))
            ms = timer(lambda: qmm.w4a8_matmul(x8, packed, scales), sz.reps)
            plain_ms = timer(lambda: qmm.w4a8_matmul_plain(x8, packed, scales), max(2, sz.reps // 8))
            b_ms, b_by = bound(N * K + O * K / 2 + nblk * O * 2 + N * O * 4, 2.0 * N * O * K, "int8")
            row = {"shape": f"{label} N={N} O={O} K={K}", "route": "decode" if N <= 16 else "prefill",
                   "n_split": n_split, "max_abs_err": err, "rel_err": rel, "bit_exact": True, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                   "library_ms": None}
            if N > 16:
                del ref
                w8 = qmm.int4_a8_codes(packed)[:, :K].t()  # [K, O] int8, column-major
                row["int8_mm_ref_ms"] = timer(lambda: torch._int_mm(x8, w8), sz.reps)
                row["int8_mm_ref"] = "torch._int_mm, int8 x int8, no block scales: not the same function"
                del w8
            shapes.append(row)
            log(json.dumps({"kernel": "qmm_w4a8", **row}))
            del x8, out
        del packed, scales
    rows["qmm_w4a8"] = dict(shapes[0], shapes=shapes)

    _phase_kernels_wo(torch, dev, sz, timer, rows, g)

    _phase_kernels_kv(torch, dev, sz, timer, rows, g)

    _phase_kernels_flash(torch, dev, sz, timer, rows, g)
    _phase_kernels_skip(torch, dev, sz, timer, rows, g)


# The times of the CUDA-core kernels that flash and skip-softmax ran before
# their tensor-core redesign, at the shapes both were measured at (PERF.md's
# kernel table, rows 3 and 17; H100 80GB HBM3, 700.00 W), printed beside
# this run's in the phase rows as `cuda_core_ms`: constants, not re-measured.
CUDA_CORE_MS = {"flash 8B": 10.72, "skip 8B": 12.34, "skip 8B spike": 10.82, "skip anchor-ruler": 1.713,
                "skip ragged S=131": 55.00, "skip ragged S=200": 2.193}
# The largest share of flash's outputs at the anchor's prefill shape that
# may round to another bf16 than the plain version's f32 result. P split
# exactly into three bf16 terms reads 2.1e-4 there on an H100; two terms
# (~16 bits of p) read 4.4e-3, and such an ulp, carried through int8
# activation codes, gave a W4A8 token on the anchor other than the plain
# engine's. Over 2048 keys the share is ~2e-3 with P exact as well (the
# mma's own f32 accumulation, it seems: PERF.md section 7), so it is
# reported there, not held.
ULP_OFF_MAX = 1e-3
ANCHOR_FLASH = (4, 8, 4, 32, 32)  # artifacts/anchor-llama's prefill: B, H, Hkv, T, d


def _ulp_off(torch, out, ref32) -> float:
    """The share of bf16 outputs that differ from ref32 rounded to bf16."""
    return float((out != ref32.to(torch.bfloat16)).float().mean())


def _phase_kernels_flash(torch, dev, sz: Sizes, timer: Timer, rows: dict, g):
    """flash GQA (tensor cores) against its plain version: the 8B prefill
    shape with q contiguous and as the engine passes it (a [B, T, H, d]
    tensor seen as [B, H, T, d], read in place), a ragged T = 1000, and
    head_dim 64 and 32; SDPA causal GQA is the library call.

    bf16 out. Each element is held against the plain version's f32 result
    (bf16 inputs, f32 softmax, before the bf16 cast): rounding to bf16
    moves a value by at most half an ulp, 2^-8 of itself, and the two f32
    results differ by ~1e-6 of the row's sum of |p.v| (f32 sums in another
    order; the kernel's P is split exactly into three bf16 terms), covered
    by 1e-3 of the output's rms. The limit is per element,
    so a late row (|out| ~ 0.03) is held to ~1e-4, not to the largest
    output's scale. A value just above a power of two rounds by up to 2^-8
    of itself, so the worst err/limit of a right kernel comes near 1; the
    rms term is its headroom for the f32 gap. At the anchor's prefill shape
    at most ULP_OFF_MAX of the outputs may round to another bf16 than the
    plain version's."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, Hkv, T, d = sz.flash
    cases = [("8B", (B, H, Hkv, T, d), False), ("8B, q as the engine's [B, T, H, d] view", (B, H, Hkv, T, d), True),
             ("ragged T=1000", (B, H, Hkv, 1000, d), False), ("d=64", (B, H, Hkv, T, 64), False),
             ("d=32", (B, H, Hkv, T, 32), False), ("anchor prefill", ANCHOR_FLASH, False)]
    shapes = []
    for label, (b, h, hkv, t, dd), view in cases:
        q = torch.randn((b, t, h, dd) if view else (b, h, t, dd), generator=g, device=dev).to(torch.bfloat16)
        q = q.transpose(1, 2) if view else q
        k, v = (torch.randn((b, hkv, t, dd), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        n0 = flash_gqa.launches
        out = flash_gqa.flash_attention_gqa(q, k, v)
        torch.cuda.synchronize()
        if flash_gqa.launches != n0 + 1 or out.stride() != q.stride():
            raise AssertionError(f"flash_gqa {label}: launches {flash_gqa.launches - n0}, out strides "
                                 f"{out.stride()} for q's {q.stride()}")
        ref32 = flash_gqa.flash_attention_gqa_plain(q.float(), k.float(), v.float())
        diff = (out.float() - ref32).abs()
        tol = 2.0 ** -8 * ref32.abs() + 1e-3 * float(ref32.square().mean().sqrt())
        worst = float((diff / tol).max())
        err = float(diff.max())
        ulp_off = _ulp_off(torch, out, ref32)
        if not worst <= 1.0:
            bad = int((diff > tol).sum())
            raise AssertionError(f"flash_gqa {label}: {bad} elements beyond 2^-8|ref| + 1e-3 rms(ref); "
                                 f"worst err/limit {worst}, max abs err {err}, "
                                 f"max |ref| {float(ref32.abs().max())}")
        if (b, h, hkv, t, dd) == ANCHOR_FLASH and not ulp_off <= ULP_OFF_MAX:
            raise AssertionError(f"flash_gqa {label}: {ulp_off} of the outputs round to another bf16 than the plain "
                                 f"version's, the limit is {ULP_OFF_MAX}")
        del ref32, diff, tol
        ms = timer(lambda: flash_gqa.flash_attention_gqa(q, k, v), sz.reps)
        plain_ms = timer(lambda: flash_gqa.flash_attention_gqa_plain(q, k, v), max(2, sz.reps // 8))
        lib_ms = timer(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), sz.reps)
        b_ms, b_by = bound(2 * (2 * q.numel() + 2 * k.numel()), 4.0 * b * h * dd * t * (t + 1) / 2, "bf16")
        shapes.append({"shape": f"{label} B={b} H={h} Hkv={hkv} T={t} d={dd}", "route": "tensor_core",
                       "max_abs_err": err, "worst_err_over_limit": worst, "ulp_off_share": ulp_off, "ms": ms,
                       "cuda_core_ms": CUDA_CORE_MS.get(f"flash {label}"),
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                       "library_ms": lib_ms, "x_library": ms / lib_ms})
        log(json.dumps({"kernel": "flash_gqa", **shapes[-1]}))
        del q, k, v, out
    rows["flash_gqa"] = dict(shapes[0], shapes=shapes)


SKIP_KERNELS = {"tensor_core": "skip_softmax_flash_tc", "cuda_core": "skip_softmax_flash_cuda_core"}  # route -> KERNELS
SKIP_MARGIN = 1e-4  # |tile max - (running max + log threshold)|, in scaled-score units, where a keep may flip


def _phase_kernels_skip(torch, dev, sz: Sizes, timer: Timer, rows: dict, g):
    """skip_softmax_flash against its plain version, through both routes.
    The tensor-core route: the 8B prefill shape (BH 256, S 2048, d 128, bf16,
    causal 128-tiles) at threshold 1e-30 (only the causal tiles skipped), on
    spiked inputs at 1e-2 (most tiles skipped), at the threshold
    `calibrate_threshold` gives for a 0.4 block sparsity, and with 64-tiles
    at 1e-30. The CUDA-core route: the RULER anchor's shape (f32, d 32, S
    448, 64-tiles, BH 64 x 8 heads); ragged S = 131 (tiles of 1) and S = 200
    (tiles of 8).

    Keep maps are held equal, except tiles whose decision lies within
    SKIP_MARGIN of its limit in the plain version (the kernel's f32 dot sums
    in another order), which are counted and printed; the outputs of the q
    tiles whose keep rows agree are held per element to 2^-8 |ref| + 1e-3
    rms(ref) against the plain version's f32 result; in bf16 the share
    that rounds to another bf16 is reported. SDPA causal, timed at
    threshold 1e-30 where it computes the same function, is the library
    call."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import sparse_attention as ssa
    from tensorrt_model_optimizer_tpu_torch.sparsity.attention_sparsity import calibrate_threshold

    sdpa = torch.nn.functional.scaled_dot_product_attention
    BH, S, d, blk = sz.skip

    def inputs(bh, s, dd, dtype, spike=False):
        q, k, v = (torch.randn((bh, s, dd), generator=g, device=dev) for _ in range(3))
        if spike:  # attention concentrated on the first 16 keys
            q[:, :, 0] = 8.0
            k[:, :16, 0] = 8.0
        return tuple(t.to(dtype) for t in (q, k, v))

    q8, k8, v8 = inputs(BH, S, d, torch.bfloat16)
    x = q8[0, :512].float()[None, :, None, :]  # as tools/bench_sparse_prefill.py: q = k = v
    calibrated = calibrate_threshold(x, x, x, 0.4)
    # (label, inputs, threshold, tile, the route it must take)
    cases = [("8B", (q8, k8, v8), 1e-30, blk, "tensor_core"),
             ("8B spike", inputs(BH, S, d, torch.bfloat16, True), 1e-2, blk, "tensor_core"),
             ("8B calibrated 0.4", (q8, k8, v8), calibrated, blk, "tensor_core"),
             ("8B 64-tiles", (q8, k8, v8), 1e-30, 64, "tensor_core"),
             ("anchor-ruler", inputs(512, 448, 32, torch.float32), 1e-2, 64, "cuda_core"),
             ("ragged S=131", inputs(32, 131, d, torch.bfloat16), 1e-2, blk, "cuda_core"),
             ("ragged S=200", inputs(32, 200, d, torch.bfloat16), 0.5, blk, "cuda_core")]
    shapes = {"tensor_core": [], "cuda_core": []}
    for label, (q, k, v), th, b, want in cases:
        bh, s, dd = q.shape
        bq, bk = ssa.tile_sizes(s, b, b)
        r0 = ssa.route_launches[want]
        out, keep = ssa.skip_softmax_flash(q, k, v, th, b, b, True)
        torch.cuda.synchronize()
        if ssa.route(q.dtype, dd, bq, bk) != want or ssa.route_launches[want] != r0 + 1:
            raise AssertionError(f"skip_softmax_flash {label}: the {want} route did not launch "
                                 f"({ssa.route_launches})")
        ref32, rkeep = ssa.skip_softmax_flash_plain(q.float(), k.float(), v.float(), th, b, b, True)
        _, margin = ssa.tile_decisions(ssa.block_max(q, k, bq, bk, True), ssa.log_threshold(th), bq, bk, True)
        flips = keep != rkeep
        far = flips & (margin.abs() > SKIP_MARGIN)
        if bool(far.any()):
            raise AssertionError(f"skip_softmax_flash {label}: {int(far.sum())} keep decisions differ from the plain "
                                 f"version away from the decision limit (margins {margin[far][:8].tolist()})")
        agree = ~flips.any(dim=-1)  # [bh, nq]: q tiles whose whole keep row agrees
        rows_ok = agree[:, :, None].expand(bh, s // bq, bq).reshape(bh, s)
        diff = (out.float() - ref32).abs()[rows_ok]
        tol = (2.0 ** -8 * ref32.abs() + 1e-3 * float(ref32.square().mean().sqrt()))[rows_ok]
        worst = float((diff / tol).max()) if diff.numel() else 0.0
        err = float(diff.max()) if diff.numel() else 0.0
        if not worst <= 1.0:
            raise AssertionError(f"skip_softmax_flash {label}: worst err/limit {worst} > 1 (2^-8|ref| + 1e-3 "
                                 f"rms(ref)), max abs err {err}")
        ulp_off = _ulp_off(torch, out[rows_ok], ref32[rows_ok]) if q.dtype == torch.bfloat16 else None
        kept = float(keep.float().mean())
        ms = timer(lambda: ssa.skip_softmax_flash(q, k, v, th, b, b, True), sz.reps)
        plain_ms = timer(lambda: ssa.skip_softmax_flash_plain(q, k, v, th, b, b, True), 2)
        lib_ms = lib_rel = None
        if th == 1e-30:
            lib = lambda: sdpa(q[None], k[None], v[None], is_causal=True)[0]  # noqa: E731
            lib_rel = _rel(lib().float(), ref32)
            if not lib_rel <= 1e-2:
                raise AssertionError(f"skip_softmax_flash {label}: SDPA is {lib_rel} of the output's scale from the "
                                     "plain version: not the same function")
            lib_ms = timer(lib, sz.reps)
        # operations: q.k and p.v (2 x 2 d) for each score the kept tiles need:
        # in a tile the causal edge cuts, only the keys at or below each row;
        # bytes: q, k and v read, out written
        b_ms, b_by = bound(4 * q.numel() * q.element_size(), 4.0 * dd * _live_scores(torch, keep, s, bq, bk),
                           "bf16" if q.dtype == torch.bfloat16 else "f32")
        shapes[want].append({
            "shape": f"{label} BH={bh} S={s} d={dd} {str(q.dtype)[6:]} tiles={bq}x{bk} causal", "route": want,
            "threshold": th, "kept_share": kept, "keep_flips": int(flips.sum()), "q_tiles_excluded": int((~agree).sum()),
            "max_abs_err": err, "worst_err_over_limit": worst, "ulp_off_share": ulp_off, "ms": ms,
            "cuda_core_ms": CUDA_CORE_MS.get(f"skip {label}"),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": lib_ms,
            "x_library": None if lib_ms is None else ms / lib_ms, "library_rel_err": lib_rel})
        log(json.dumps({"kernel": "skip_softmax_flash", **shapes[want][-1]}))
        del out, keep, ref32, rkeep, margin, diff, tol
    for which, sh in shapes.items():
        rows[SKIP_KERNELS[which]] = dict(sh[0], shapes=sh)


def _live_scores(torch, keep, s: int, bq: int, bk: int) -> float:
    """The causal scores the kept tiles of `keep` [bh, s / bq, s / bk] hold:
    row r of a q tile sees the keys c <= r of each k tile."""
    rows = torch.arange(s, device=keep.device, dtype=torch.float64)
    starts = torch.arange(0, s, bk, device=keep.device, dtype=torch.float64)
    live = (rows[:, None] - starts[None, :] + 1).clamp(0, bk).reshape(s // bq, bq, -1).sum(1)  # [nq, nk]
    return float((keep.double() * live).sum())


def _stored_rows(torch, dev, g, shape, fmt):
    """Seeded random K or V rows [..., hd] in stored form: (rows, NVFP4
    block-scale bytes or None, a factor that brings q.k to a few units)."""
    if fmt == "int8":
        return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int32).to(torch.int8), None, 1 / 40.0
    if fmt == "nvfp4":
        *lead, hd = shape
        planes = torch.randint(0, 256, (*lead, hd // 2), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
        # e4m3 block scales 2^-3 .. 2^2 with random mantissas
        scales = (torch.randint(0, 48, (*lead, hd // 16), generator=g, device=dev, dtype=torch.int32) + 0x20).to(torch.uint8)
        return planes, scales, 1 / 4.0
    dtype = torch.bfloat16 if fmt == "bf16" else torch.float8_e4m3fn
    return (torch.randn(shape, generator=g, device=dev) * 2).to(dtype), None, 1.0


def _kv_row_bytes(fmt: str, hd: int) -> float:
    """Stored bytes of one K or V row (NVFP4: planes and block scales)."""
    return {"bf16": 2 * hd, "int8": hd, "fp8": hd, "nvfp4": hd // 2 + hd // 16}[fmt]


def _paged_pool(torch, dev, g, sz: Sizes, fmt: str, lens: list, max_pages: int):
    """A seeded page pool of the 8B shape (`sz.kv`, pages of `sz.page` rows):
    (K pages, V pages, their NVFP4 scale pages or None, q's factor, a block
    table of shuffled pages with -1 past each length, the lengths)."""
    B, n_kv, _, hd, _, _ = sz.kv
    n_pages = 1 + B * max_pages
    kp, ksp, qf = _stored_rows(torch, dev, g, (n_pages, n_kv, sz.page, hd), fmt)
    vp, vsp, _ = _stored_rows(torch, dev, g, (n_pages, n_kv, sz.page, hd), fmt)
    perm = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1).to(torch.int32).reshape(B, max_pages)
    live = torch.arange(max_pages, device=dev)[None] * sz.page < torch.tensor(lens, device=dev)[:, None]
    table = torch.where(live, perm, torch.full_like(perm, -1))
    return kp, vp, ksp, vsp, qf, table, torch.tensor(lens, dtype=torch.int32, device=dev)


KV_FORMATS = ("int8", "bf16", "fp8", "nvfp4")
# route -> KERNELS
PAGED_PREFILL_KERNELS = {"tensor_core": "paged_attention_prefill_tc", "cuda_core": "paged_attention_prefill_cuda_core"}


def _phase_kernels_kv(torch, dev, sz: Sizes, timer: Timer, rows: dict, g):
    """The three KV-cache attention kernels against their plain versions at
    the 8B shapes (32 heads over 8 kv heads of 128, pages of 16 rows), in
    every stored form, and the NVFP4 decoder on every code."""
    from tensorrt_model_optimizer_tpu_torch.ops import numerics
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import kv_attention, paged_attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, n_kv, rep, hd, S, pos = sz.kv
    nH, page = n_kv * rep, sz.page

    # --- the NVFP4 decoder, exactly: V rows that hold all 16 E2M1 codes under
    # every non-negative finite E4M3 scale byte (0x00 .. 0x7e; 0x7f, NaN, never
    # occurs) go through each kernel as the only live row, where softmax gives
    # it the weight 1 (the dense kernel's current token scores -1e4, and
    # exp(-1e4) is 0), so the output is the decoded row bit for bit.
    nrow = 2 * n_kv
    planes = (torch.arange(hd // 2, device=dev) % 16 * 0x11).to(torch.uint8).expand(nrow, hd // 2)
    sbytes = torch.arange(nrow * hd // 16, device=dev).reshape(nrow, hd // 16)
    sbytes = torch.where(sbytes > 0x7E, torch.zeros_like(sbytes), sbytes).to(torch.uint8)
    want = numerics.nvfp4_planes_code_load(planes, sbytes).reshape(2, n_kv, 1, hd).expand(2, n_kv, rep, hd)
    want = want.reshape(2, nH, hd)
    q = torch.zeros((2, nH, hd), device=dev)
    q[..., 0] = 1.0
    dense = lambda t, last: t.reshape(2, n_kv, 1, last).expand(2, n_kv, 4, last).contiguous()  # noqa: E731
    kn = torch.zeros((2, n_kv, 1, hd), device=dev)
    kn[..., 0] = -1e4
    pool = lambda t, last: torch.cat([torch.zeros((1, n_kv, page, last), dtype=torch.uint8, device=dev),  # noqa: E731
                                      t.reshape(2, n_kv, 1, last).expand(2, n_kv, page, last)]).contiguous()
    one = torch.ones(2, dtype=torch.int32, device=dev)
    table = torch.tensor([[1], [2]], dtype=torch.int32, device=dev)
    chunk = lambda t, last: t.reshape(2, 1, n_kv, last).contiguous()  # noqa: E731
    got = {
        "kv_decode_attention": kv_attention.kv_decode_attention(
            q, dense(planes, hd // 2), dense(planes, hd // 2), kn, torch.zeros_like(kn), 1, "nvfp4",
            dense(sbytes, hd // 16), dense(sbytes, hd // 16)),
        "paged_attention_decode": paged_attention.paged_attention_decode(
            q, pool(planes, hd // 2), pool(planes, hd // 2), table, one, "nvfp4",
            pool(sbytes, hd // 16), pool(sbytes, hd // 16)),
    }
    for route, qd in (("cuda cores", torch.float32), ("tensor cores", torch.bfloat16)):
        # f32 q takes the CUDA-core route, bf16 q the tensor cores, whose bf16
        # output holds the decoded values exactly (at most 6 significant bits)
        got[f"paged_attention_prefill ({route})"] = paged_attention.paged_attention_prefill(
            q[:, None].to(qd), pool(planes, hd // 2), pool(planes, hd // 2), table, torch.zeros_like(one),
            chunk(planes, hd // 2), chunk(planes, hd // 2), "nvfp4", pool(sbytes, hd // 16), pool(sbytes, hd // 16),
            chunk(sbytes, hd // 16), chunk(sbytes, hd // 16))[:, 0].float()
    torch.cuda.synchronize()
    for name, y in got.items():
        if not torch.equal(y, want):
            bad = torch.nonzero(y != want)
            raise AssertionError(f"{name}: NVFP4 decode differs from nvfp4_planes_code_load at {len(bad)} of "
                                 f"{want.numel()} values, first (row, head, dim) {bad[0].tolist()}")
    log(json.dumps({"kernel": "kv_decode_attention, paged_attention_decode, paged_attention_prefill (both routes)",
                    "check": "NVFP4 decode: 16 E2M1 codes x 127 E4M3 scale bytes exact"}))

    # --- dense decode attention (split over the cache, then merged): f32 vs
    # torch.softmax; 1e-5 of the output's scale (f32 rounding of sums taken
    # in another order), at the 8B pos and at pos 0 (the current token
    # alone), 1 and one past the first split. The bf16 format has a library
    # call: SDPA over the valid rows and the current token, concatenated
    # outside the timed call; it takes q, the current token and the output in
    # bf16, so it is held to 1e-2 of the output's scale.
    shapes = []
    for fmt in KV_FORMATS:
        kc, ks, qf = _stored_rows(torch, dev, g, (B, n_kv, S, hd), fmt)
        vc, vs, _ = _stored_rows(torch, dev, g, (B, n_kv, S, hd), fmt)
        q = torch.randn((B, nH, hd), generator=g, device=dev) / math.sqrt(hd) * qf
        kn, vn = (torch.randn((B, n_kv, 1, hd), generator=g, device=dev) for _ in range(2))
        edges = {}
        for p_ in (0, 1, kv_attention.SPLIT_ROWS + 1):
            e_args = (q, kc, vc, kn, vn, p_, fmt, ks, vs)
            edges[p_] = _rel(kv_attention.kv_decode_attention(*e_args), kv_attention.kv_decode_attention_plain(*e_args))
            if not edges[p_] <= 1e-5:
                raise AssertionError(f"kv_decode_attention {fmt} pos {p_}: rel err {edges[p_]} > 1e-5")
        args = (q, kc, vc, kn, vn, pos, fmt, ks, vs)
        out = kv_attention.kv_decode_attention(*args)
        ref = kv_attention.kv_decode_attention_plain(*args)
        rel = _rel(out, ref)
        if not rel <= 1e-5:
            raise AssertionError(f"kv_decode_attention {fmt}: rel err {rel} > 1e-5")
        ms = timer(lambda: kv_attention.kv_decode_attention(*args), sz.reps)
        plain_ms = timer(lambda: kv_attention.kv_decode_attention_plain(*args), max(2, sz.reps // 4))
        lib_ms = lib_rel = None
        if fmt == "bf16":
            qb = q.to(torch.bfloat16)[:, :, None]
            kk = torch.cat([kc[:, :, :pos], kn.to(torch.bfloat16)], dim=2)
            vv = torch.cat([vc[:, :, :pos], vn.to(torch.bfloat16)], dim=2)
            lib = lambda: sdpa(qb, kk, vv, scale=1.0, enable_gqa=True)  # noqa: E731
            lib_rel = _rel(lib()[:, :, 0].float(), ref)
            if not lib_rel <= 1e-2:
                raise AssertionError(f"kv_decode_attention bf16: SDPA is {lib_rel} of the output's scale from the "
                                     "plain version: not the same function")
            lib_ms = timer(lib, sz.reps)
        nbytes = 2 * B * n_kv * pos * _kv_row_bytes(fmt, hd) + 2 * B * n_kv * hd * 4 + 2 * q.numel() * 4
        b_ms, b_by = bound(nbytes, 4.0 * B * nH * (pos + 1) * hd, "bf16")
        shapes.append({"shape": f"{fmt} B={B} n_kv={n_kv} rep={rep} S={S} pos={pos}",
                       "splits": kv_attention.n_splits(pos), "max_abs_err": float((out - ref).abs().max()),
                       "rel_err": rel, "rel_err_at_pos": edges, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": lib_ms,
                       "x_library": None if lib_ms is None else ms / lib_ms, "library_rel_err": lib_rel})
        log(json.dumps({"kernel": "kv_decode_attention", **shapes[-1]}))
        del kc, vc, ks, vs
    rows["kv_decode_attention"] = dict(shapes[0], shapes=shapes)

    # --- the paged kernels: bf16 queries and outputs as the engine gives and
    # takes them, held per element against the plain version's f32 result
    # (`_held`: the bf16 rounding of the output plus the f32 sums' order).
    # Pages come from a shuffled pool; table entries past a sequence's live
    # pages are -1. The bf16 format's library call is SDPA over K/V gathered
    # outside the timed call, with the lengths as a mask; it rounds its
    # probabilities to bf16, so it is held to 1e-2 of the output's scale (rows
    # of a sequence with no live row apart: SDPA gives NaN there, the kernels 0).
    def gathered(pages, table):
        return pages[table.clamp_min(0).long()].permute(0, 2, 1, 3, 4).reshape(B, n_kv, -1, hd)

    # The table spans 2080 rows (130 pages): 9 splits of 256 rows, the last
    # one past every length but in "edges", which ends on the table's last
    # row and puts lengths on each side of the first splits' edges.
    shapes = []
    paged_lens = (("uniform", [2048] * B), ("ragged", [2048, 1153, 1024, 513, 17, 16, 1, 0][:B]),
                  ("edges", [0, 1, 255, 256, 257, 511, 513, 2080][:B]))
    for fmt in KV_FORMATS:
        for what, lens in paged_lens:
            kp, vp, ksp, vsp, qf, table, tl = _paged_pool(torch, dev, g, sz, fmt, lens, 2048 // page + 2)
            q = (torch.randn((B, nH, hd), generator=g, device=dev) * qf).to(torch.bfloat16)
            kind = "nvfp4" if fmt == "nvfp4" else "raw"
            args = (q, kp, vp, table, tl, kind, ksp, vsp)
            out = paged_attention.paged_attention_decode(*args)
            ref32 = paged_attention.paged_attention_decode_plain(*args, out_dtype=torch.float32)
            worst, err = _held(out, ref32)
            if not worst <= 1.0:
                raise AssertionError(f"paged_attention_decode {fmt} {what}: worst err/limit {worst} > 1 "
                                     f"(2^-8|ref| + 1e-3 rms(ref)), max abs err {err}")
            _same_again(torch, f"paged_attention_decode {fmt} {what}", out,
                        paged_attention.paged_attention_decode(*args))
            ms = timer(lambda: paged_attention.paged_attention_decode(*args), sz.reps)
            plain_ms = timer(lambda: paged_attention.paged_attention_decode_plain(*args), max(2, sz.reps // 4))
            lib_ms = lib_rel = None
            if fmt == "bf16":
                kk, vv = gathered(kp, table), gathered(vp, table)
                mask = (torch.arange(kk.shape[2], device=dev)[None] < tl[:, None])[:, None, None, :]
                lib = lambda: sdpa(q[:, :, None], kk, vv, attn_mask=mask, enable_gqa=True)  # noqa: E731
                some = tl > 0
                lib_rel = _rel(lib()[:, :, 0].float()[some], ref32[some])
                if not lib_rel <= 1e-2:
                    raise AssertionError(f"paged_attention_decode bf16 {what}: SDPA is {lib_rel} of the output's "
                                         "scale from the plain version: not the same function")
                lib_ms = timer(lib, sz.reps)
                del kk, vv
            nbytes = 2 * n_kv * sum(lens) * _kv_row_bytes(fmt, hd) + 2 * q.numel() * 2 + table.numel() * 4
            b_ms, b_by = bound(nbytes, 4.0 * nH * sum(lens) * hd, "bf16")
            shapes.append({"shape": f"{fmt} {what} B={B} n_kv={n_kv} rep={rep} page={page} lens={lens}",
                           "splits": paged_attention.n_splits(table.shape[1], page), "max_abs_err": err,
                           "worst_err_over_limit": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": lib_ms,
                           "x_library": None if lib_ms is None else ms / lib_ms, "library_rel_err": lib_rel})
            log(json.dumps({"kernel": "paged_attention_decode", **shapes[-1]}))
            del kp, vp, ksp, vsp, ref32
    rows["paged_attention_decode"] = dict(shapes[0], shapes=shapes)

    # paged prefill through both routes. The tensor cores (bf16 q, the engine's
    # activations): every format at the chunk's T = 64 and at T = 5 (a q tile
    # mostly padding), held per element by `_held`, with the share of bf16
    # outputs that round to another bf16 than the plain version's f32 result
    # reported. The CUDA cores (f32 q, the anchor's f32 engine): every format
    # at T = 64, f32 out, held to 1e-5 of the output's scale.
    shapes = {"tensor_core": [], "cuda_core": []}
    full_ctx, short_ctx = [1024, 960, 256, 70, 64, 1, 0, 0][:B], [1024, 37, 256, 70, 64, 1, 0, 0][:B]
    cases = [("tensor_core", fmt, sz.chunk, full_ctx) for fmt in KV_FORMATS]
    cases += [("tensor_core", fmt, 5, short_ctx) for fmt in KV_FORMATS]  # T not a multiple of 8
    cases += [("cuda_core", fmt, sz.chunk, full_ctx) for fmt in KV_FORMATS]
    for want, fmt, T, ctx in cases:
        kp, vp, ksp, vsp, qf, table, tl = _paged_pool(torch, dev, g, sz, fmt, ctx, 1024 // page + 2)
        ck, cks, _ = _stored_rows(torch, dev, g, (B, T, n_kv, hd), fmt)
        cv, cvs, _ = _stored_rows(torch, dev, g, (B, T, n_kv, hd), fmt)
        qdt = torch.bfloat16 if want == "tensor_core" else torch.float32
        q = (torch.randn((B, T, nH, hd), generator=g, device=dev) * qf).to(qdt)
        kind = "nvfp4" if fmt == "nvfp4" else "raw"
        args = (q, kp, vp, table, tl, ck, cv, kind, ksp, vsp, cks, cvs)
        n0 = paged_attention.prefill_route_launches[want]
        out = paged_attention.paged_attention_prefill(*args)
        torch.cuda.synchronize()
        if paged_attention.prefill_route(q.dtype, hd, rep) != want or \
                paged_attention.prefill_route_launches[want] != n0 + 1:
            raise AssertionError(f"paged_attention_prefill {fmt} T={T}: the {want} route did not launch "
                                 f"({paged_attention.prefill_route_launches})")
        ref32 = paged_attention.paged_attention_prefill_plain(*args, out_dtype=torch.float32)
        ulp_off = None
        if want == "tensor_core":
            worst, err = _held(out, ref32)
            ulp_off = _ulp_off(torch, out, ref32)
            if not worst <= 1.0:
                raise AssertionError(f"paged_attention_prefill {fmt} T={T}: worst err/limit {worst} > 1 "
                                     f"(2^-8|ref| + 1e-3 rms(ref)), max abs err {err}")
        else:
            worst, err = _rel(out, ref32), float((out - ref32).abs().max())
            if not worst <= 1e-5:
                raise AssertionError(f"paged_attention_prefill f32 {fmt} T={T}: rel err {worst} > 1e-5")
        ms = timer(lambda: paged_attention.paged_attention_prefill(*args), sz.reps)
        plain_ms = timer(lambda: paged_attention.paged_attention_prefill_plain(*args), max(2, sz.reps // 4))
        lib_ms = lib_rel = None
        if fmt == "bf16" and want == "tensor_core" and T == sz.chunk:
            kk = torch.cat([gathered(kp, table), ck.transpose(1, 2)], dim=2)
            vv = torch.cat([gathered(vp, table), cv.transpose(1, 2)], dim=2)
            Sc = kk.shape[2] - T
            t = torch.arange(T, device=dev)
            mask = torch.cat([(torch.arange(Sc, device=dev)[None] < tl[:, None])[:, None, :].expand(B, T, Sc),
                              (t[None, :] <= t[:, None])[None].expand(B, T, T)], dim=-1)[:, None]
            lib = lambda: sdpa(q.transpose(1, 2), kk, vv, attn_mask=mask, enable_gqa=True)  # noqa: E731
            lib_rel = _rel(lib().transpose(1, 2).float(), ref32)
            if not lib_rel <= 1e-2:
                raise AssertionError(f"paged_attention_prefill bf16: SDPA is {lib_rel} of the output's scale from "
                                     "the plain version: not the same function")
            lib_ms = timer(lib, sz.reps)
            del kk, vv, mask
        rows_read = sum(ctx) + B * T
        nbytes = 2 * n_kv * rows_read * _kv_row_bytes(fmt, hd) + 2 * q.numel() * q.element_size() + table.numel() * 4
        b_ms, b_by = bound(nbytes, 4.0 * nH * T * hd * sum(c + T for c in ctx), "bf16" if want == "tensor_core" else "f32")
        shapes[want].append({
            "shape": f"{fmt} B={B} T={T} n_kv={n_kv} rep={rep} page={page} ctx={ctx} q {str(q.dtype)[6:]}",
            "route": want, "max_abs_err": err, "worst_err_over_limit" if want == "tensor_core" else "rel_err": worst,
            "ulp_off_share": ulp_off, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms, "library_ms": lib_ms, "x_library": None if lib_ms is None else ms / lib_ms,
            "library_rel_err": lib_rel})
        log(json.dumps({"kernel": "paged_attention_prefill", **shapes[want][-1]}))
        del kp, vp, ksp, vsp, ref32
    for which, sh in shapes.items():
        rows[PAGED_PREFILL_KERNELS[which]] = dict(sh[0], shapes=sh)


def _held(out, ref32) -> tuple[float, float]:
    """A bf16 kernel output against its plain version's f32 result (before
    the bf16 cast), per element: |out - ref| <= 2^-8 |ref| + 1e-3 rms(ref).
    Rounding to bf16 moves a value by at most 2^-8 of itself; the rms term
    covers the f32 sums taken in another order (the tensor cores' against
    torch.matmul's), about 1e-6 of the row's sum of |x w|. Returns (worst
    err/limit, max abs err); a right kernel's worst ratio comes near 1."""
    diff = (out.float() - ref32).abs()
    tol = 2.0 ** -8 * ref32.abs() + 1e-3 * float(ref32.square().mean().sqrt())
    return float((diff / tol).max()), float(diff.max())


def _same_again(torch, what: str, first, again) -> None:
    """A second call on the same inputs must give the first call's bits: the
    split kernels add their partials in a fixed order, and the weight-only
    GEMMs' fix-up leaves its arrival counters at 0 for the next call."""
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError(f"{what}: a second call on the same inputs differs from the first at "
                             f"{int((first != again).sum())} of {first.numel()} outputs")


def _wo_cases(torch, dev, g, O: int, K: int):
    """(kernel name, label, wrapper, plain, weight arrays, weight bytes,
    library call) for each weight-only format at one projection shape, from
    seeded random codes and scales. The library call is `x -> y` through the
    one PyTorch function that computes the same GEMM from the same codes and
    scales (repacked to its layout outside the timed call), or None: PyTorch
    has a bf16 x int4 group-wise call and a bf16 x int8 per-channel call, and
    none that multiplies bf16 activations by NVFP4, MXFP4 or e4m3 weights
    (`_scaled_mm` wants both operands in fp8). It is timed and used nowhere
    in the port."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm_wo
    from tensorrt_model_optimizer_tpu_torch.ops.cuda.qmm import int4_a8_codes

    def rand_bytes(shape):
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.int32).to(torch.uint8)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    nib = rand_bytes((O, K // 2))
    s4 = (torch.rand((K // 128, O), generator=g, device=dev) * 0.02 + 0.005).to(torch.bfloat16).float()

    def lib_int4():
        # codes + 8 as unsigned nibbles, even k in the high nibble; the call
        # computes (u - 8) * scale + zero with [K/128, O, 2] bf16 scale / zero
        u = int4_a8_codes(nib).to(torch.int32) + 8
        w = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack([s4, torch.zeros_like(s4)], dim=-1).to(torch.bfloat16).contiguous()
        return lambda x: torch._weight_int4pack_mm(x, w, 128, sz)

    # the block scales are bf16 values (the default layout rounds them so), held
    # in the kernel's f32 array: the function must move 2 bytes of each
    yield ("qmm_int4_wo", "int4", qmm_wo.int4_wo_matmul, qmm_wo.int4_wo_matmul_plain, (nib, s4),
           nbytes(nib) + 2 * s4.numel(), lib_int4)
    # e4m3 block scales 2^-3 .. 2^2 with random mantissas; exponents -8 .. 0
    s_nv = (rand_bytes((O, K // 16)) % 48 + 0x20).view(torch.float8_e4m3fn)
    gs = torch.tensor(0.0137, dtype=torch.float32, device=dev)
    yield ("qmm_fp4_wo", "nvfp4", qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain, (nib, s_nv, gs),
           nbytes(nib, s_nv, gs), None)
    s_mx = (rand_bytes((O, K // 32)) % 9).to(torch.int8) - 8
    yield "qmm_fp4_wo", "mxfp4", qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain, (nib, s_mx), nbytes(nib, s_mx), None
    q8 = rand_bytes((O, K)).view(torch.int8)
    sc8 = (torch.rand((O, 1), generator=g, device=dev) * 0.01 + 0.001).to(torch.bfloat16).float()

    def lib_int8():
        sc = sc8.reshape(-1).to(torch.bfloat16)  # exact: sc8 holds bf16 values
        return lambda x: torch._weight_int8pack_mm(x, q8, sc)

    yield ("qmm_byte_wo", "int8", qmm_wo.byte_wo_matmul, qmm_wo.byte_wo_matmul_plain, (q8, sc8),
           nbytes(q8, sc8), lib_int8)
    qb = rand_bytes((O, K))
    qf8 = torch.where((qb & 0x7F) == 0x7F, qb & 0x80, qb).view(torch.float8_e4m3fn)  # no NaN codes
    scf = torch.tensor(0.0021, dtype=torch.float32, device=dev)
    yield "qmm_byte_wo", "fp8", qmm_wo.byte_wo_matmul, qmm_wo.byte_wo_matmul_plain, (qf8, scf), nbytes(qf8, scf), None


def _phase_kernels_wo(torch, dev, sz: Sizes, timer: Timer, rows: dict, g):
    """The three weight-only GEMMs against their plain versions at the 8B
    shapes, and the e4m3 decode of the byte kernel on every code."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm, qmm_wo

    # every e4m3 code through the kernel's decoder, exactly: y = I . q^T
    # with one code per k, through the prefill tiles (N = 256) and the
    # decode tiles (16 rows of I at a time); the two NaN codes apart
    codes = torch.arange(256, device=dev, dtype=torch.int32).to(torch.uint8)
    finite = (codes & 0x7F) != 0x7F
    q = torch.where(finite, codes, codes & 0x80).view(torch.float8_e4m3fn).expand(16, 256).contiguous()
    want = q[0].float()
    one = torch.ones((), dtype=torch.float32, device=dev)
    eye = torch.eye(256, dtype=torch.bfloat16, device=dev)
    got = {"prefill tiles": qmm_wo.byte_wo_matmul(eye, q, one)[:, 0].float(),
           "decode tiles": torch.cat([qmm_wo.byte_wo_matmul(eye[i:i + 16], q, one)[:, 0].float()
                                      for i in range(0, 256, 16)])}
    for what, y in got.items():
        if not torch.equal(y, want):
            raise AssertionError(f"qmm_byte_wo ({what}): e4m3 decode differs from torch at codes "
                                 f"{torch.nonzero(y != want).flatten().tolist()[:16]}")
    nan = torch.full((16, 16), 0x7F, dtype=torch.uint8, device=dev).view(torch.float8_e4m3fn)
    if not bool(torch.isnan(qmm_wo.byte_wo_matmul(eye[:16, :16].contiguous(), nan, one).float()).all()):
        raise AssertionError("qmm_byte_wo: the e4m3 NaN code does not decode to NaN")
    log(json.dumps({"kernel": "qmm_byte_wo", "check": "e4m3 decode: 254 finite codes exact, NaN code NaN"}))

    # every E2M1 code under every scale through the fp4 kernel's decoder,
    # exactly: row o of the weight holds codes 0..15 in k 0..15 and again in
    # k 16..31 under scale o (every non-NaN e4m3 byte; MXFP4 exponents -125
    # .. 125, whose products are finite bf16 normals: an inf weight would make
    # the zero terms NaN), and y = I . w^T picks them,
    # through the decode route (16 rows of I) and the prefill tiles (32)
    k_codes = torch.arange(32, device=dev, dtype=torch.int32) % 16
    row = (k_codes[0::2] | k_codes[1::2] << 4).to(torch.uint8)
    eye = torch.eye(32, 64, dtype=torch.bfloat16, device=dev)
    e4m3 = torch.arange(256, device=dev, dtype=torch.int32)
    e4m3 = e4m3[(e4m3 & 0x7F) != 0x7F].to(torch.uint8)
    scale_sets = {"nvfp4": e4m3.view(torch.float8_e4m3fn)[:, None].expand(-1, 4),
                  "mxfp4": torch.arange(-125, 126, device=dev, dtype=torch.int32).to(torch.int8)[:, None].expand(-1, 2)}
    for fmt, sc in scale_sets.items():
        sc = sc.contiguous()
        packed = torch.nn.functional.pad(row, (0, 16)).expand(sc.shape[0], 32).contiguous()
        w = qmm_wo.fp4_rows_values(packed) * torch.repeat_interleave(qmm_wo.fp4_rows_scales(sc), 64 // sc.shape[1], 1)
        for what, n in (("decode route", 16), ("prefill tiles", 32)):
            y = qmm_wo.fp4_wo_matmul(eye[:n].contiguous(), packed, sc)
            want = w[:, :n].t().to(torch.bfloat16)
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                bad = torch.nonzero(y != want)
                raise AssertionError(f"qmm_fp4_wo {fmt} ({what}): E2M1 x scale decode differs at {len(bad)} of "
                                     f"{want.numel()} (k, scale row) pairs, first {bad[0].tolist()}")
    log(json.dumps({"kernel": "qmm_fp4_wo", "check": "E2M1 decode: 16 codes x 254 e4m3 scales (NVFP4) and x 251 "
                    "exponents (MXFP4) exact, decode route and prefill tiles"}))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def splits(N, O, K):  # the decode route's split over K (every format's rows pad K to 128 or less)
        return qmm.decode_splits(O, -(-K // 128) * 128, N, sms) if N <= 16 else None

    shapes: dict = {name: [] for name in qmm_wo.launches}
    for O, K, label in sz.qmm_shapes:
        for N in sz.qmm_rows:
            x = torch.randn((N, K), generator=g, device=dev).to(torch.bfloat16)
            for name, fmt, fn, plain, w, wbytes, lib in _wo_cases(torch, dev, g, O, K):
                out = fn(x, *w)
                torch.cuda.synchronize()
                ref32 = plain(x, *w, out_dtype=torch.float32)
                worst, err = _held(out, ref32)
                if not worst <= 1.0:
                    raise AssertionError(f"{name} {fmt} {label} N={N}: worst err/limit {worst} > 1 "
                                         f"(2^-8|ref| + 1e-3 rms(ref)), max abs err {err}")
                _same_again(torch, f"{name} {fmt} {label} N={N}", out, fn(x, *w))
                ms = timer(lambda: fn(x, *w), sz.reps)
                plain_ms = timer(lambda: plain(x, *w), 2)
                lib_ms = lib_rel = None
                if lib is not None:
                    # the library rounds (u - 8) * s to bf16 per weight, so it
                    # is held only as far as shows it is the same function: 1e-2
                    # of the output's scale (a wrong nibble order reads ~1)
                    call = lib()
                    lib_rel = _rel(call(x), ref32)
                    if not lib_rel <= 1e-2:
                        raise AssertionError(f"{name} {fmt} {label} N={N}: the library call is {lib_rel} of the "
                                             f"output's scale from the plain version: not the same function")
                    lib_ms = timer(lambda: call(x), sz.reps if N <= 16 or fmt == "int4" else 2)
                    del call
                del ref32
                b_ms, b_by = bound(N * K * 2 + wbytes + N * O * 2, 2.0 * N * O * K, "bf16")
                shapes[name].append({"shape": f"{fmt} {label} N={N} O={O} K={K}", "max_abs_err": err,
                                     "worst_err_over_limit": worst, "splits": splits(N, O, K), "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                     "bound_share": b_ms / ms, "library_ms": lib_ms,
                                     "x_library": None if lib_ms is None else ms / lib_ms,
                                     "library_rel_err": lib_rel})
                log(json.dumps({"kernel": name, **shapes[name][-1]}))
                del out, w
            del x
    for name, sh in shapes.items():
        rows[name] = dict(sh[0], shapes=sh)


def _engine(torch, cm, max_seq: int, dev, plain: tuple = (), kv="int8", **fields):
    """The kernel-attention engine unless `fields` sets kv_attention_kernel=
    False (the einsum engine); `kv` "int8", "nvfp4" or None (the model's
    dtype, or packed NVFP4 where the preset quantizes the k_bmm site so);
    `fields` are further EngineConfig fields (layouts, paged_attention_kernel,
    attn_sparsity)."""
    from tensorrt_model_optimizer_tpu_torch.serve.engine import Engine, EngineConfig

    fields = {"kv_attention_kernel": True, **fields}
    return Engine(cm, EngineConfig(max_seq_len=max_seq, kv_dtype=torch.int8 if kv == "int8" else kv,
                                   plain_ops=plain, **fields), device=dev)


@dataclasses.dataclass(frozen=True)
class Path:
    """One served path of the engine: a PTQ config, the engine's layout
    fields, the depth of its full-width run, and its GEMM kernel."""

    label: str
    preset: str          # preset name; "" = weight-only INT8 (INT8_DEFAULT_CFG without input quantizers)
    gemm: str            # the path's GEMM kernel (a key of KERNELS)
    depth: int = 32      # layers of the full-width run (the model has 32)
    layouts: tuple = ()  # EngineConfig layout fields, as (name, value) pairs
    calib: bool = False  # the preset has static input quantizers: calibrate on one batch

    def quant_cfg(self):
        from tensorrt_model_optimizer_tpu_torch.quant import config

        if self.preset:
            return config.get_preset(self.preset)
        return config.INT8_DEFAULT_CFG.with_rules({"*input_quantizer": {"enable": False}})


# W4A8, INT4 and NVFP4 at full depth; the formats that share a kernel with
# them (MXFP4, and NVFP4 with its activation quantizers: dynamic block scales
# under a calibrated global amax, fake-quantized before the GEMM) or that
# move twice the weight bytes (INT8, FP8) on 4 layers, which launches every
# kernel at every full-width shape all the same. The anchor runs every path
# at its own depth (6 layers).
FULL_PATHS = (
    Path("w4a8", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_w4a8", layouts=(("int4_layout", "a8"),)),
    Path("int4", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_int4_wo"),
    Path("nvfp4", "NVFP4_WEIGHT_ONLY_CFG", "qmm_fp4_wo"),
    Path("mxfp4", "MXFP4_WEIGHT_ONLY_CFG", "qmm_fp4_wo", depth=4),
    Path("int8", "", "qmm_byte_wo", depth=4),
    Path("fp8", "FP8_DEFAULT_CFG", "qmm_byte_wo", depth=4, calib=True),
    Path("nvfp4_w4a4", "NVFP4_DEFAULT_CFG", "qmm_fp4_wo", depth=4, calib=True),
)

# kernel name (KERNELS) -> the engine's `plain_ops` name
PLAIN_NAME = {"qmm_w4a8": "w4a8", "kv_decode_attention": "kv_attention", "flash_gqa": "flash",
              "qmm_int4_wo": "int4_wo", "qmm_fp4_wo": "fp4_wo", "qmm_byte_wo": "byte_wo",
              "paged_attention_decode": "paged_decode", "paged_attention_prefill_tc": "paged_prefill",
              "paged_attention_prefill_cuda_core": "paged_prefill",
              "skip_softmax_flash_tc": "skip_softmax", "skip_softmax_flash_cuda_core": "skip_softmax"}
PAGED_PLAIN = ("paged_decode", "paged_prefill")


def _counts(reset: bool = False) -> dict:
    """Launch counts of every kernel's wrapper; `reset` sets them to 0."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa, kv_attention, paged_attention, qmm, qmm_wo
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import sparse_attention

    if reset:
        qmm.launches = kv_attention.launches = flash_gqa.launches = sparse_attention.launches = 0
        for counts in (qmm_wo.launches, paged_attention.launches, paged_attention.prefill_route_launches,
                       sparse_attention.route_launches):
            for k in counts:
                counts[k] = 0
    return {"qmm_w4a8": qmm.launches, "kv_decode_attention": kv_attention.launches,
            "flash_gqa": flash_gqa.launches, **qmm_wo.launches, **paged_attention.launches,
            **{PAGED_PREFILL_KERNELS[r]: n for r, n in paged_attention.prefill_route_launches.items()},
            **{SKIP_KERNELS[r]: n for r, n in sparse_attention.route_launches.items()}}


def _compressed(torch, path: Path, cfg, params, dev, seed: int):
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq

    batches = None
    if path.calib:
        g = torch.Generator(device=dev).manual_seed(seed)
        batches = [torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=dev)]
    return compress.compress(ptq.quantize(cfg, params, path.quant_cfg(), batches, device=dev))


def _anchor_projections(torch, dev, path: Path, cm, g) -> float:
    """This path's GEMM kernel against its plain version at every projection
    shape of the checkpoint (hd 32, the ragged K = 704 of down_proj), decode
    and prefill rows, on random activations; the limit of `_held`. Returns
    the worst err/limit."""
    from tensorrt_model_optimizer_tpu_torch.models.llama import slice_state
    from tensorrt_model_optimizer_tpu_torch.quant.compress import convert_packed_layouts, layer_arrays
    from tensorrt_model_optimizer_tpu_torch.serve import engine

    layouts = dict(path.layouts)
    served = convert_packed_layouts(cm, nvfp4=layouts.get("nvfp4_layout", "word2"),
                                    int4=layouts.get("int4_layout", "bd2"), mxfp4=layouts.get("nvfp4_layout", "word2"))
    worst = 0.0
    for name, kind in served.kinds.items():
        arrays = layer_arrays(served.params["layers"][name], 0)
        ist = slice_state(served.qstate.get(name, {}).get("input"), 0)
        K = arrays.get("in_features") or arrays["q"].shape[-1]
        for n in (4, 128):
            x = torch.randn((n, K), generator=g, device=dev).to(torch.bfloat16)
            if kind == "int4a8":
                x8 = torch.clamp(torch.round(x.float() * 40), -127, 127).to(torch.int8)
                args = (x8, arrays["packed"], arrays["scales"])
                out, ref = engine.qmm.w4a8_matmul(*args), engine.qmm.w4a8_matmul_plain(*args)
                ratio = 0.0 if torch.equal(out, ref) else float("inf")
            else:
                def run(ops, **kw):
                    return engine._qlinear(x, name, kind, arrays, served, ist,
                                           {k: (lambda *a, f=f: f(*a, **kw)) for k, f in ops.items()})
                out = run(engine._ops(()))
                ref = run(engine._ops(engine.PLAIN_ALL), out_dtype=torch.float32)
                ratio, _ = _held(out, ref)
            if not ratio <= 1.0:
                raise AssertionError(f"anchor {path.label}: {name} ({kind}) N={n} K={K}: kernel against plain "
                                     f"version, worst err/limit {ratio}")
            worst = max(worst, ratio)
    return worst


def phase_anchor(torch, dev, sz: Sizes) -> dict:
    """The trained checkpoint through every path, kernels against plain
    versions: first each projection's GEMM alone at the checkpoint's shapes,
    then 4 prompts x 32 tokens and 16 greedy steps end to end.

    End to end the kernel engine picks each token and every engine is fed
    it, so all stay on one sequence and their logits are compared at every
    step. Kernel and plain GEMM round the same f32 sums, taken in another
    order, to bf16, so isolated outputs land one ulp apart; the int8 KV
    cache turns some of those into a flipped code (1/127 of the cache's
    range), which the layers carry on. How far that moves the logits is the
    model's property (at some positions of the anchor's data several tokens
    are about equally likely, and bf16 rounding alone moves the logits by
    much of their scale there), so the yardstick is measured, not assumed: a
    third engine runs the plain versions on f32 activations. Each engine's
    distance from it is taken per prompt and step (largest logit difference
    as a share of the f32 logits' largest magnitude); the median of the
    kernel engine's 64 distances may be at most twice the median of the plain
    bf16 engine's. That catches what the projection check cannot: a scale,
    a layer or a layout wired wrongly into the engine. The kernel engine is
    also held against the plain bf16 engine directly, activation quantizers
    on: the median of their 64 distances may be at most 1e-2 of the logits'
    scale (two bf16 ulps of the largest logit, and twice the largest median a
    right kernel reads here), and wherever their argmax differs, the kernel's
    token must lie within 1e-2 of the scale of the plain engine's best
    logit: a near tie, not another answer. W4A8, whose GEMM is bit-exact with
    its plain version, is held to equal tokens in free-running generation
    as before. Flash splits P exactly into three bf16 terms, so at this
    prefill's shape its outputs round like the plain version's up to f32
    summation order (the kernels phase holds the share an ulp apart to
    ULP_OFF_MAX): with two terms, an H100 run read an ulp carried through
    int8 codes into a W4A8 token that differed at a plain-logit margin of
    0.069.
    Returns the launch counts of the two CUDA-core routes it alone takes:
    skip-softmax's in the RULER curve, the paged prefill's in the f32 serve
    runs."""
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    cfg, params = hf_loader.load_hf_checkpoint(ANCHOR, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=g, device=dev)
    for path in FULL_PATHS:
        cm = _compressed(torch, path, cfg, params, dev, seed=3)
        layouts = dict(path.layouts)
        worst_proj = _anchor_projections(torch, dev, path, cm, g)
        cm32 = dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, dtype=torch.float32))
        engines = (_engine(torch, cm, 64, dev, **layouts), _engine(torch, cm, 64, dev, PLAIN_ALL, **layouts),
                   _engine(torch, cm32, 64, dev, PLAIN_ALL, **layouts))
        _counts(reset=True)
        caches = [e.init_cache(4) for e in engines]
        logits, ref, truth = (e.prefill(prompts, c) for e, c in zip(engines, caches))
        gaps_kernel, gaps_plain, gaps_kp, flips = [], [], [], []
        for step in range(16):
            scale = truth.abs().max(dim=-1).values
            gaps_kernel += ((logits - truth).abs().max(dim=-1).values / scale).tolist()
            gaps_plain += ((ref - truth).abs().max(dim=-1).values / scale).tolist()
            gaps_kp += ((logits - ref).abs().max(dim=-1).values / scale).tolist()
            tok = torch.argmax(logits, dim=-1)
            margin = (ref.max(dim=-1).values - ref.gather(1, tok[:, None])[:, 0]) / scale
            flips += [(step, float(m)) for m in margin[tok != torch.argmax(ref, dim=-1)]]
            tok = tok.to(torch.int32)[:, None]
            logits, ref, truth = (e.decode_step(tok, c)[1] for e, c in zip(engines, caches))
        launched = _counts()[path.gemm]
        gap_kernel, gap_plain = statistics.median(gaps_kernel), statistics.median(gaps_plain)
        free = engines[0].generate(prompts, 16)
        same = bool(torch.equal(free, engines[1].generate(prompts, 16)))
        log(json.dumps({"phase": "anchor", "path": path.label, "prompts": list(prompts.shape),
                        "new_tokens": 16, "projections_worst_err_over_limit": worst_proj,
                        "median_logits_gap_kernel_vs_f32": gap_kernel, "median_logits_gap_plain_vs_f32": gap_plain,
                        "worst_logits_gap_kernel_vs_f32": max(gaps_kernel), "worst_logits_gap_plain_vs_f32": max(gaps_plain),
                        "median_logits_gap_kernel_vs_plain": statistics.median(gaps_kp),
                        "worst_logits_gap_kernel_vs_plain": max(gaps_kp), "argmax_flips_vs_plain": flips, "free_running_tokens_equal_plain": same,
                        "gemm_launches": launched, "tokens_row0": free[0].tolist()}))
        if not gap_kernel <= 2 * gap_plain:
            raise AssertionError(f"anchor {path.label}: the kernel engine's logits lie {gap_kernel} of their scale "
                                 f"(median) from the f32 plain engine's, the bf16 plain engine's {gap_plain}")
        gap_kp = statistics.median(gaps_kp)
        if not gap_kp <= 1e-2:
            raise AssertionError(f"anchor {path.label}: the kernel engine's logits lie {gap_kp} of their scale "
                                 f"(median) from the plain engine's, the limit is 1e-2")
        far = [(step, m) for step, m in flips if not m <= 1e-2]
        if far:
            raise AssertionError(f"anchor {path.label}: the kernel engine's token differs from the plain engine's "
                                 f"away from a near tie (step, plain-logit margin as a share of the scale): {far}")
        if path.gemm == "qmm_w4a8" and not same:
            raise AssertionError("anchor w4a8: kernel-path tokens differ from plain")
        if launched <= 0:
            raise AssertionError(f"anchor {path.label}: {path.gemm} never launched")
    f32_prefills = sum(_anchor_paged(torch, dev, cfg, params, path, kv) for path, kv in PAGED_PATHS)
    _anchor_einsum(torch, dev, cfg, params)
    return {**_anchor_ruler(torch, dev), "paged_attention_prefill_cuda_core": f32_prefills}


def _anchor_einsum(torch, dev, cfg, params) -> None:
    """The einsum engine (kv_attention_kernel=False) on the trained
    checkpoint, INT4 weights, int8 and packed NVFP4 caches: 4 prompts of 256
    tokens, dense prefill and sparse prefill (64-tiles, threshold 1e-2),
    then 8 greedy decode steps in lock step on the kernel engine's tokens,
    the kernel engine against the all-plain one.

    In bf16 the median logits gap is held to 1e-2 of the scale, and the
    dense prefill's argmax flips to a plain-logit margin <= 1e-2, as the
    other anchor paths. The sparse prefill's attention rounds its output to
    bf16 one ulp apart now and then, as flash does, and this checkpoint
    moves near-tied tokens by much of the logits' scale on that (an H100 run
    read a flip at a plain-logit margin of 0.028): there the flips are reported,
    and held on f32 activations, where the GEMMs run their plain versions
    in both engines and the skip-softmax kernel is the only difference:
    median gap <= 1e-3, every flip at a margin <= 1e-2. The keep fractions
    agree within 1e-3 (the projections' outputs may move a tile max across
    its limit); one skip-softmax launch a layer."""
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    cm = _compressed(torch, FULL_PATHS[1], cfg, params, dev, seed=3)
    cm32 = dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, dtype=torch.float32))
    g = torch.Generator(device=dev).manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (4, 256), generator=g, device=dev)
    L = cfg.num_hidden_layers
    gemms_plain = tuple(n for n in PLAIN_ALL if n != "skip_softmax")

    def lockstep(ek, ep):
        ck, cp = ek.init_cache(4), ep.init_cache(4)
        _counts(reset=True)
        lk = ek.prefill(prompts, ck)
        launched = _counts()
        lp = ep.prefill(prompts, cp)
        gaps, flips = _gaps(lk, lp)
        tok = lk.argmax(dim=-1).to(torch.int32)[:, None]
        for _ in range(8):
            lk, lp = ek.decode_step(tok, ck)[1], ep.decode_step(tok, cp)[1]
            gp, fl = _gaps(lk, lp)
            gaps, flips = gaps + gp, flips + fl
            tok = lk.argmax(dim=-1).to(torch.int32)[:, None]
        keep = None if ek.last_prefill_keep_frac is None else [ek.last_prefill_keep_frac.tolist(),
                                                               ep.last_prefill_keep_frac.tolist()]
        return statistics.median(gaps), max(gaps), flips, keep, launched, ck["k"].shape[-1]

    for kv in ("int8", "nvfp4"):
        for th in (None, 1e-2):
            fields = dict(kv=kv, kv_attention_kernel=False, attn_sparsity=th, attn_sparsity_blocks=(64, 64))
            med, worst, flips, keep, launched, row_bytes = lockstep(
                _engine(torch, cm, 272, dev, **fields), _engine(torch, cm, 272, dev, PLAIN_ALL, **fields))
            row = {"phase": "anchor", "path": f"einsum engine, int4, {kv} cache, "
                   + ("dense prefill" if th is None else f"sparse prefill {th}"), "cache_row_bytes": row_bytes,
                   "prompts": [4, 256], "median_logits_gap_kernel_vs_plain": med,
                   "worst_logits_gap_kernel_vs_plain": worst, "argmax_flips_vs_plain": flips,
                   "keep_frac_kernel_plain": keep, "prefill_launches": {k: v for k, v in launched.items() if v}}
            keeps = [keep]
            if th is not None:  # f32 activations: the skip-softmax kernel is the only difference
                med32, worst32, flips32, keep32, launched32, _ = lockstep(
                    _engine(torch, cm32, 272, dev, gemms_plain, **fields),
                    _engine(torch, cm32, 272, dev, PLAIN_ALL, **fields))
                row.update(f32_median_logits_gap_kernel_vs_plain=med32, f32_worst_logits_gap=worst32,
                           f32_argmax_flips_vs_plain=flips32, f32_keep_frac_kernel_plain=keep32)
                keeps.append(keep32)
                if not (med32 <= 1e-3 and all(m <= 1e-2 for m in flips32)
                        and launched32["skip_softmax_flash_cuda_core"] == L and not launched32["skip_softmax_flash_tc"]):
                    raise AssertionError(f"anchor einsum {kv} {th} f32: median gap {med32}, flips {flips32}, "
                                         f"launches {launched32}")
            log(json.dumps(row))
            if not med <= 1e-2 or (th is None and any(not m <= 1e-2 for m in flips)):
                raise AssertionError(f"anchor einsum {kv} {th}: median gap {med}, flips {flips}")
            if not (launched["qmm_int4_wo"] and launched["skip_softmax_flash_tc"] == (0 if th is None else L)
                    and not launched["skip_softmax_flash_cuda_core"]):
                raise AssertionError(f"anchor einsum {kv} {th}: prefill launches {launched}")
            for kp in keeps:
                if kp and max(abs(a - b) for a, b in zip(*kp)) > 1e-3:
                    raise AssertionError(f"anchor einsum {kv} {th}: keep fractions kernel / plain {kp}")


RULER = dict(thresholds=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1), n=64, ctx_tokens=448, blocks=(64, 64),
             max_acc_drop=0.02, min_dense_acc=0.8, max_dppl=0.05)  # tools/ruler_curve.py's settings


def _anchor_ruler(torch, dev) -> dict:
    """The RULER threshold curve on `artifacts/anchor-ruler` (f32, as
    tools/ruler_curve.py loads it) at that tool's settings, through the
    skip-softmax kernel and through its plain version: rows held to agree
    (keep fractions within 1e-3, accuracies within 1/64), and printed beside
    `artifacts/ruler_curve.json`, which the JAX package made (accuracy, not
    speed). The curve runs on f32 activations, so through the CUDA-core
    route alone; returns its launch count of that route."""
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader
    from tensorrt_model_optimizer_tpu_torch.quant.compress import compress_bf16
    from tensorrt_model_optimizer_tpu_torch.serve.engine import EngineConfig
    from tensorrt_model_optimizer_tpu_torch.sparsity import ruler
    from tensorrt_model_optimizer_tpu_torch.utils import synthlang

    lang = synthlang.SynthLang(0)
    cfg, params = hf_loader.load_hf_checkpoint(ANCHOR_RULER, dtype=torch.float32, device=dev)
    cm = compress_bf16(cfg, params)
    ev = list(lang.eval_batches(2, 8, RULER["ctx_tokens"], seed=991))
    out = {}
    for which, plain in (("kernel", ()), ("plain", ("skip_softmax",))):
        _counts(reset=True)
        t0 = time.perf_counter()
        th, rows = ruler.calibrate_threshold_ruler(cm, EngineConfig(max_seq_len=RULER["ctx_tokens"] + 16,
                                                                    plain_ops=plain),
                                                   lang, ppl_batches=ev, device=dev, **RULER)
        n = _counts()
        out[which] = dict(threshold=th, rows=rows, seconds=time.perf_counter() - t0,
                          launches=n["skip_softmax_flash_cuda_core"], tc_launches=n["skip_softmax_flash_tc"])
    with open(RULER_CURVE) as f:
        artifact = json.load(f)
    jax_rows = artifact["curve"]
    keys = ("threshold", "keep_frac", "acc_override", "acc_multikey", "acc_memory", "dppl")
    table = [{"kernel": {k: rk.get(k) for k in keys}, "plain": {k: rp.get(k) for k in keys},
              "jax_artifact": {k: rj.get(k) for k in keys}}
             for rk, rp, rj in zip(out["kernel"]["rows"], out["plain"]["rows"], jax_rows)]
    log(json.dumps({"phase": "anchor", "path": "RULER curve, anchor-ruler", **{k: v for k, v in RULER.items()},
                    "calibrated_threshold": {w: o["threshold"] for w, o in out.items()},
                    "jax_artifact_threshold": artifact["calibrated_threshold"], "seconds": {w: o["seconds"] for w, o in out.items()},
                    "skip_softmax_launches": out["kernel"]["launches"], "rows": table}))
    for row in table[1:]:
        a, b = row["kernel"], row["plain"]
        if abs(a["keep_frac"] - b["keep_frac"]) > 1e-3 or any(
                abs(a[f"acc_{k}"] - b[f"acc_{k}"]) > 1 / 64 + 1e-9 for k in ("override", "multikey", "memory")):
            raise AssertionError(f"anchor RULER: kernel and plain rows disagree at threshold {a['threshold']}: {row}")
    if not out["kernel"]["launches"] or out["kernel"]["tc_launches"]:
        raise AssertionError(f"anchor RULER: the f32 curve must run the CUDA-core route alone: {out['kernel']}")
    return {"skip_softmax_flash_cuda_core": out["kernel"]["launches"]}


PAGED_ANCHOR = dict(n_pages=64, page_size=8, max_slots=2, max_pages_per_seq=16)
PAGED_PATHS = (  # (path, EngineConfig.kv_dtype): int8 pages, and the packed NVFP4 pool NVFP4_KV_CFG selects
    (Path("int4 + int8 pages", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_int4_wo"), "int8"),
    (Path("nvfp4_kv (packed NVFP4 pages)", "NVFP4_KV_CFG", "qmm_fp4_wo", depth=4, calib=True), None),
)


def _gaps(logits, ref) -> tuple[list, list]:
    """Per row: the largest logit difference as a share of the reference's
    largest magnitude; and, where the argmax differs, how far below its best
    logit the reference holds the other's token (as a share of that scale)."""
    scale = ref.abs().max(dim=-1).values
    gaps = ((logits - ref).abs().max(dim=-1).values / scale).tolist()
    tok = logits.argmax(dim=-1)
    margin = (ref.max(dim=-1).values - ref.gather(1, tok[:, None])[:, 0]) / scale
    return gaps, [float(m) for m in margin[tok != ref.argmax(dim=-1)]]


def _dense_margins(torch, eng, prompt, served: list) -> list:
    """The dense-cache engine fed a request's served tokens: at every step,
    how far below its best logit it holds the served token (a share of the
    logits' scale; 0 where it is the engine's own greedy token)."""
    cache = eng.init_cache(1)
    logits = eng.prefill(prompt[None], cache)
    margins = []
    for t in served:
        margins.append(float((logits.max() - logits[0, t]) / logits.abs().max()))
        logits = eng.decode_step(torch.tensor([[t]], dtype=torch.int32, device=prompt.device), cache)[1]
    return margins


def _anchor_paged(torch, dev, cfg, params, path: Path, kv) -> None:
    """`Engine.serve` on the trained checkpoint over pages of 8 rows and 2
    slots, kernel engine against plain versions.

    In lock step: two engines (the paged and the dense decode attention on
    their kernels, or on their plain versions) fill the same slots. Slot 0
    prefills 40 tokens densely; slot 1 shares slot 0's two full prefix pages
    and streams its 72-token tail through `prefill_chunked` (one chunk of 64
    through the prefill kernel, 8 single tokens through the decode kernel);
    then 12 decode steps run both slots on the kernel engine's tokens. The
    logits are held as the weight-only GEMMs are above: kernel and plain
    version round the same f32 sums to bf16 one ulp apart now and then, the
    quantized pages turn some of those into a flipped code, so the median gap
    may be at most 1e-2 of the logits' scale and every argmax flip must lie at
    a plain-logit margin <= 1e-2.

    Then `serve` itself, with the prefix cache, unroll 1 and 4: 4 requests of
    unequal length behind a 16-token prefix. Request 0 outlives the others and
    keeps the prefix pages published, so requests 2 and 3 share them and
    prefill only their tails (72 tokens: through the prefill kernel). Every
    output has its length, the pool is whole again at the end, both prefill
    routes were taken and both paged kernels launched.

    Against `Engine.generate`: the dense-cache engine is fed each request's
    served tokens, and how far below its own best logit it holds each of them
    is the margin. In bf16 the margins are reported, not held: the paged path
    rounds q and the context to bf16 where the dense path keeps f32, and on
    this checkpoint bf16 rounding alone moves near-tied positions by much of
    the logits' scale. They are held on f32 activations, where the two paths
    differ only by f32 rounding and the codes it flips: a third engine runs
    the GEMMs and flash on their plain versions in f32 and the three KV
    attention kernels as kernels, and every token it serves must lie within
    1e-2 of the logits' scale of what it gives over its dense cache."""
    from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Request

    cm = _compressed(torch, path, cfg, params, dev, seed=3)
    ek = _engine(torch, cm, 128, dev, kv=kv, paged_attention_kernel=True)
    ep = _engine(torch, cm, 128, dev, PAGED_PLAIN + ("kv_attention",), kv=kv, paged_attention_kernel=True)
    g = torch.Generator(device=dev).manual_seed(5)
    shared = torch.randint(0, cfg.vocab_size, (16,), generator=g, device=dev)
    prompts = [torch.cat([shared, torch.randint(0, cfg.vocab_size, (n,), generator=g, device=dev)])
               for n in (24, 40, 72, 9)]

    _counts(reset=True)
    table = torch.full((2, 16), -1, dtype=torch.int32, device=dev)
    table[0, :8] = torch.arange(1, 9)
    table[1, :2] = table[0, :2]
    table[1, 2:14] = torch.arange(20, 32)
    caches = [e.init_paged_cache(**PAGED_ANCHOR) for e in (ek, ep)]
    pairs = []
    for c in caches:
        c.block_table = table.clone()
    pairs.append([e.prefill_into_slot(c, 0, prompts[0][None]) for e, c in zip((ek, ep), caches)])
    for c in caches:
        c.seq_lens[1] = 16
    pairs.append([e.prefill_chunked(c, 1, prompts[2][None, 16:])[None] for e, c in zip((ek, ep), caches)])
    tok = torch.stack([pairs[0][0][0].argmax(), pairs[1][0][0].argmax()]).to(torch.int32)[:, None]
    active = torch.ones(2, dtype=torch.bool, device=dev)
    for _ in range(12):
        pairs.append([e.paged_step(tok, c, active) for e, c in zip((ek, ep), caches)])
        tok = pairs[-1][0].argmax(dim=-1).to(torch.int32)[:, None]
    gaps, flips = [], []
    for logits, ref in pairs:
        gp, fl = _gaps(logits, ref)
        gaps += gp
        flips += fl
    lock = _counts()
    packed = caches[0].packed_nvfp4
    if packed != (ek.ecfg.kv_dtype == "nvfp4"):
        raise AssertionError(f"anchor paged {path.label}: kv_dtype {ek.ecfg.kv_dtype!r}, packed pool {packed}")

    def requests():
        return [Request(rid=i, prompt=p.cpu().numpy(), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, (24, 6, 8, 8)))]

    cm32 = dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, dtype=torch.float32))
    e32 = _engine(torch, cm32, 128, dev, ("w4a8", "flash", "int4_wo", "fp4_wo", "byte_wo"), kv=kv,
                  paged_attention_kernel=True)
    served, f32_prefills = {}, 0
    for unroll in (1, 4):
        _counts(reset=True)
        reqs = requests()
        outs, m = ek.serve(reqs, prefix_cache=True, unroll=unroll, collect_metrics=True, **PAGED_ANCHOR)
        n = _counts()
        margins = [_dense_margins(torch, ek, p, outs[i]) for i, p in enumerate(prompts)]
        _counts(reset=True)
        outs32 = e32.serve(requests(), prefix_cache=True, unroll=unroll, **PAGED_ANCHOR)
        f32_prefills += _counts()["paged_attention_prefill_cuda_core"]
        margins32 = [_dense_margins(torch, e32, p, outs32[i]) for i, p in enumerate(prompts)]
        served[unroll] = dict(outs=outs, metrics=m, launches=n, margins=margins, margins32=margins32)
        if [len(outs[r.rid]) for r in reqs] != [r.max_new_tokens for r in reqs]:
            raise AssertionError(f"anchor paged {path.label}: output lengths {[len(v) for v in outs.values()]}")
        if not (m["dense_prefills"] and m["chunked_prefills"] and m["free_pages"] == PAGED_ANCHOR["n_pages"] - 1):
            raise AssertionError(f"anchor paged {path.label} unroll {unroll}: prefill routes or free pages: {m}")
        if not (n["paged_attention_decode"] and n["paged_attention_prefill"]):
            raise AssertionError(f"anchor paged {path.label} unroll {unroll}: paged kernels not launched: {n}")
    worst = max(max(mg) for sv in served.values() for mg in sv["margins32"])
    log(json.dumps({
        "phase": "anchor", "path": f"serve: {path.label}", "packed_nvfp4_pages": bool(packed),
        "lockstep_rows": len(gaps), "median_logits_gap_kernel_vs_plain": statistics.median(gaps),
        "worst_logits_gap_kernel_vs_plain": max(gaps), "argmax_flips_vs_plain": flips, "lockstep_launches": lock,
        "serve": {u: {"metrics": sv["metrics"], "launches": {k: v for k, v in sv["launches"].items() if v},
                      "tokens_off_the_dense_engines_greedy": sum(m > 0 for mg in sv["margins"] for m in mg),
                      "worst_margin": max(max(mg) for mg in sv["margins"]),
                      "f32_tokens_off_the_dense_engines_greedy": sum(m > 0 for mg in sv["margins32"] for m in mg),
                      "f32_worst_margin": max(max(mg) for mg in sv["margins32"])} for u, sv in served.items()},
        "unroll_4_tokens_equal_unroll_1": served[4]["outs"] == served[1]["outs"],
        "tokens_request0": served[1]["outs"][0]}))
    if not statistics.median(gaps) <= 1e-2:
        raise AssertionError(f"anchor paged {path.label}: kernel engine's logits lie {statistics.median(gaps)} of "
                             "their scale (median) from the plain engine's, the limit is 1e-2")
    if any(not m <= 1e-2 for m in flips):
        raise AssertionError(f"anchor paged {path.label}: argmax differs from the plain engine's away from a near "
                             f"tie (plain-logit margins {flips})")
    if not worst <= 1e-2:
        raise AssertionError(f"anchor paged {path.label}: on f32 activations a served token lies {worst} of the "
                             "logits' scale below the dense-cache engine's best")
    return f32_prefills


def _profile(torch, label: str, fn, calls: int, wall_ms_unprofiled: float) -> None:
    """Device time by kernel over `calls` calls of the served path, and the
    device's idle share against the same calls' wall time measured without
    the profiler (its own host cost would inflate the idle share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3 / calls, e.count // calls)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and not e.key.startswith("Command Buffer")),
                       key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in by_kernel)
    # where the host spends its time (with the profiler on, so inflated: a ranking, not a cost)
    by_op = sorted(((e.key, e.self_cpu_time_total / 1e3 / calls, e.count // calls) for e in prof.key_averages()
                    if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    log(json.dumps({"phase": "profile", "what": label, "per_call_device_busy_ms": busy_ms,
                    "per_call_kernel_launches": sum(n for _, _, n in by_kernel),
                    "per_call_wall_ms_unprofiled": wall_ms_unprofiled,
                    "device_idle_share": 1.0 - busy_ms / wall_ms_unprofiled,
                    "top": [{"kernel": k[:70], "ms": ms, "count": n} for k, ms, n in by_kernel[:10]],
                    "host_top": [{"op": k[:40], "self_cpu_ms": ms, "count": n} for k, ms, n in by_op[:8]]}))


def phase_full(torch, dev, sz: Sizes, profile: bool = False) -> dict:
    """Every path of FULL_PATHS at full width; returns each kernel's launch
    count in the run of the first path that has it."""
    from tensorrt_model_optimizer_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    log(json.dumps({"phase": "full", "model": "llama3_8b", "init_params_s": time.perf_counter() - t0}))
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
    launches: dict = {}
    for path in FULL_PATHS:
        for name, n in _full_path(torch, dev, sz, path, cfg, params, prompt, profile).items():
            if n > 0:
                launches.setdefault(name, n)
        torch.cuda.empty_cache()
    _full_nvfp4_kv(torch, dev, sz, cfg, params, profile)
    return launches


def _full_path(torch, dev, sz: Sizes, path: Path, cfg, params, prompt, profile: bool) -> dict:
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    sync = torch.cuda.synchronize
    layouts = dict(path.layouts)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, num_hidden_layers=path.depth)
    sub = {**params, "layers": {k: v[:path.depth] for k, v in params["layers"].items()}}
    eng = _engine(torch, _compressed(torch, path, cfg, sub, dev, seed=4), sz.max_seq, dev, **layouts)
    torch.cuda.empty_cache()
    sync()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    _counts(reset=True)
    cache = eng.init_cache(sz.batch)
    sync()
    t0 = time.perf_counter()
    logits = eng.prefill(prompt, cache)
    sync()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = _counts()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    step_ms = []
    for _ in range(sz.decode_steps):
        t0 = time.perf_counter()
        tok, step_logits = eng.decode_step(tok, cache)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all())
    del cache

    log(json.dumps({"phase": "full", "path": path.label, "model": "llama3_8b", "kinds": sorted(set(eng.cm.kinds.values())),
                    "layers": path.depth, "batch": sz.batch, "prompt": sz.prompt,
                    "decode_steps": sz.decode_steps, "setup_s": setup_s, "ttft_ms": ttft_ms,
                    "decode_ms_per_step_median": statistics.median(step_ms),
                    "decode_ms_per_step_mean": statistics.mean(step_ms),
                    "decode_tok_per_s": sz.batch * 1e3 / statistics.median(step_ms),
                    "peak_mem_gb": peak_gb, "launches": launches, "prefill_launches": prefill_launches,
                    "logits_finite": finite, "packed_weight_gb": eng.cm.packed_bytes / 1e9}))
    if not finite:
        raise AssertionError(f"full {path.label}: non-finite logits")
    want = {path.gemm, "kv_decode_attention", "flash_gqa"}
    if {k for k, n in launches.items() if n > 0} != want:
        raise AssertionError(f"full {path.label}: launched {launches}, the path's kernels are {sorted(want)}")
    if prefill_launches["flash_gqa"] != path.depth:
        raise AssertionError(f"full {path.label}: the prefill launched flash {prefill_launches['flash_gqa']} times "
                             f"over {path.depth} layers")
    if profile and path.depth == params["layers"]["input_layernorm"].shape[0]:
        _profile(torch, f"{path.label} prefill", lambda: eng.prefill(prompt, eng.init_cache(sz.batch)), 1, ttft_ms)
        pc = eng.init_cache(sz.batch)
        eng.prefill(prompt, pc)
        t = torch.zeros((sz.batch, 1), dtype=torch.int32, device=dev)
        _profile(torch, f"{path.label} decode step", lambda: [eng.decode_step(t, pc) for _ in range(4)], 4,
                 statistics.median(step_ms))
        del pc

    # The prefill logits against the same engine with this path's GEMM on
    # its plain version, at depths 1 and 2 (the plain versions are slow; W4A8
    # keeps its depths 1, 2, 4, 8 and 32). The logits are bf16 values, so one
    # ulp is 2^-8 (0.4%) of the largest. Held to 5e-2 of the logits' scale at
    # depth 2, for every path:
    # - The weight-only GEMMs write bf16; kernel and plain version round the
    #   same f32 sum, taken in another order, so a few outputs in a thousand
    #   land one bf16 ulp apart. Each layer re-quantizes k and v to int8
    #   codes, where such an ulp can move a code across a rounding boundary
    #   (a step of 1/127 of the range), and random (untrained) layers
    #   amplify each flipped code with depth.
    # - W4A8 is bit-exact with its plain version, so its engine is held
    #   against the all-plain one, and an engine that runs only flash on its
    #   plain version must equal the all-plain one exactly: that shows the
    #   whole gap comes from flash, whose outputs may round one bf16 ulp
    #   apart and flip codes of the per-token int8 activations the same way.
    # - A path whose preset fake-quantizes the activations (FP8_DEFAULT_CFG:
    #   e4m3, a step of up to 2^-3 of the value; NVFP4_DEFAULT_CFG: e2m1, a
    #   step of up to a third of the value) is held with those input
    #   quantizers switched off, which is the check of its GEMM; the reading
    #   with them on is reported beside it, not held: there one flipped
    #   activation code moves a value by 12.5% or more.
    w4a8 = path.gemm == "qmm_w4a8"
    for depth in ((1, 2, 4, 8, path.depth) if w4a8 else (1, 2)):
        subcm = _truncate(eng.cm, depth)
        plain_gemm = PLAIN_ALL if w4a8 else (PLAIN_NAME[path.gemm],)

        def run(plain, cm=subcm):
            return _engine(torch, cm, sz.max_seq, dev, plain, **layouts).prefill(prompt, _cache(eng, depth, sz))

        row = {"phase": "full_vs_plain", "path": path.label, "depth": depth}
        if path.calib:
            row["with_input_quantizers_rel_err"] = _rel(run(()), run(plain_gemm))
            subcm = _without_input_quantizers(subcm)
        out, ref = run((), subcm), run(plain_gemm, subcm)
        rel = _rel(out, ref)
        row.update(prefill_logits_rel_err=rel,
                   argmax_agree=float((out.argmax(-1) == ref.argmax(-1)).float().mean()))
        if w4a8:
            flash_plain = run(("flash",))
            row.update(flash_plain_equals_plain=bool(torch.equal(flash_plain, ref)),
                       flash_plain_rel_err=_rel(flash_plain, ref))
            del flash_plain
        log(json.dumps(row))
        if w4a8 and not row["flash_plain_equals_plain"]:
            raise AssertionError(f"full w4a8: depth {depth}: with only flash plain, the logits differ from plain")
        if depth == 2 and not rel <= 5e-2:
            raise AssertionError(f"full {path.label}: depth-2 prefill logits rel err {rel} vs plain > 5e-2")
        del out, ref, subcm
    if path.label == "int4":
        # the INT4 model again, served through `Engine.serve` over int8 pages,
        # and by the einsum engine with dense and sparse prefill; all layers
        for name, n in _full_paged(torch, dev, sz, eng.cm, PAGED_PATHS[0][0].label, "int8", PagedRun(), profile).items():
            launches[name] = launches[name] or n
        for name, n in _full_einsum(torch, dev, sz, eng.cm, prompt, profile).items():
            launches[name] = launches[name] or n
    return launches


def _recording(op, keeps: list):
    """The kernel engine's skip-softmax op, also appending each call's (one a
    layer) keep map [bh, nq, nk]."""
    def call(q, k, v, th, block_q, block_k, causal):
        out, keep = op(q, k, v, th, block_q, block_k, causal)
        keeps.append(keep)
        return out, keep

    return call


def _pinned_plain(torch, keeps: list, decided: list):
    """The plain engine's skip-softmax op at depth 2: the plain version's
    arithmetic (f32 scores, softmax over the kept entries, the result in the
    input dtype) on the keep map the kernel engine took in the same layer,
    `keeps[i]` at the i-th call. It appends the decisions the plain version
    takes on its own inputs, with each tile's scaled max and margin from its
    limit."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import sparse_attention as ssa

    def call(q, k, v, th, block_q, block_k, causal):
        keep = keeps[len(decided)]
        BH, S, d = q.shape
        bq, bk = ssa.tile_sizes(S, block_q, block_k)
        bm = ssa.block_max(q, k, bq, bk, causal)
        own, margin = ssa.tile_decisions(bm, ssa.log_threshold(th), bq, bk, causal)
        decided.append((own, bm, margin))
        scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32, device=q.device)
        above = torch.arange(S, device=q.device)[None, :] > torch.arange(S, device=q.device)[:, None]
        out = torch.empty_like(q)
        for b in range(0, BH, 16):
            s = torch.einsum("bqd,bkd->bqk", q[b:b + 16].float(), k[b:b + 16].float()) * scale
            kf = keep[b:b + 16, :, None, :, None].bool().expand(-1, S // bq, bq, S // bk, bk).reshape(s.shape)
            s = torch.where(kf & ~above if causal else kf, s, torch.full_like(s, -1e30))
            pr = torch.softmax(s, dim=-1)
            pr = torch.where(s > -1e29, pr, torch.zeros_like(pr))
            out[b:b + 16] = torch.einsum("bqk,bkd->bqd", pr, v[b:b + 16].float()).to(q.dtype)
        return out, keep

    return call


APART_MARGIN_MAX = 2.0 ** -5  # of the tile max: how near its limit a tile decided apart must lie


def _decided_apart(keeps: list, decided: list, exact: bool) -> dict:
    """Tiles the kernel engine decided otherwise than the plain version does
    on the plain engine's own inputs, per layer. From layer 2 on (and in
    layer 1 through the GEMM) the two engines' inputs differ by bf16 ulps, so
    a tile whose max lies that close to its limit (log 0.98 = -0.02 below
    the running max at the calibrated threshold: many on random weights)
    may be decided apart; each must lie within APART_MARGIN_MAX of its tile
    max from the limit. `exact` (threshold 1e-30, every causal tile kept):
    none may."""
    counts, apart_margins = [], []
    for layer, (keep, (own, bm, margin)) in enumerate(zip(keeps, decided)):
        apart = keep.bool() != own
        counts.append(int(apart.sum()))
        apart_margins += [(layer, m, t) for m, t in zip(margin[apart].tolist(), bm[apart].tolist())]
    facts = {"tiles_apart_per_layer": counts, "apart_margin_over_tile_max_max":
             max((abs(m) / max(abs(t), 1e-30) for _, m, t in apart_margins), default=0.0),
             "apart_margins": apart_margins[:8]}
    if exact and sum(counts):
        raise AssertionError(f"full einsum: depth-2 keep maps at threshold 1e-30 differ: {facts}")
    far = [m for m in apart_margins if not abs(m[1]) <= APART_MARGIN_MAX * abs(m[2])]
    if far:
        raise AssertionError(f"full einsum: depth-2 tiles decided apart away from their limit (layer, margin, tile "
                             f"max): {far[:8]} ({facts})")
    return facts


def _full_einsum(torch, dev, sz: Sizes, cm, prompt, profile: bool) -> dict:
    """The einsum engine (kv_attention_kernel=False) on the INT4 model at full
    width and depth, int8 cache of prompt + decode rows: batch 8 x 2048
    prefill dense, sparse at the threshold `calibrate_threshold` gives for a
    0.4 block sparsity on the prompt's embeddings (as
    tools/bench_sparse_prefill.py does) and at 0.999999; each layer's keep
    fraction, the logits against dense, 32 greedy decode steps on the einsum
    cache, peak memory and launches. At depth 2 the kernel engine is held
    against the plain one (the GEMM and the skip-softmax kernel on their plain
    versions): logits within 5e-2 of their scale, as the other paths, dense
    and sparse at 1e-30 and at the calibrated threshold. Sparse, the plain
    engine's skip-softmax takes the kernel engine's keep map of each layer
    (`_pinned_plain`), so both compute one function, and the kernel's
    decisions are held against the plain version's on the plain engine's
    inputs (`_decided_apart`)."""
    from tensorrt_model_optimizer_tpu_torch.sparsity.attention_sparsity import calibrate_threshold

    sync = torch.cuda.synchronize
    L = cm.model_cfg.num_hidden_layers
    max_seq = sz.prompt + sz.decode_steps
    x = cm.params["embed_tokens"][prompt[:1, :512]].float()[:, :, None, :]
    calibrated = calibrate_threshold(x, x, x, 0.4)
    del x
    runs, launches, dense_logits = [], {}, None
    for th in (None, calibrated, 0.999999):
        eng = _engine(torch, cm, max_seq, dev, kv_attention_kernel=False, attn_sparsity=th)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cache = eng.init_cache(sz.batch)
        _counts(reset=True)
        sync()
        t0 = time.perf_counter()
        logits = eng.prefill(prompt, cache)
        sync()
        ttft_ms = (time.perf_counter() - t0) * 1e3
        n = _counts()
        for name, c in n.items():
            if c:
                launches.setdefault(name, c)
        row = {"phase": "full", "path": "einsum engine, int4, int8 cache",
               "prefill": "dense" if th is None else "sparse", "threshold": th, "layers": L, "batch": sz.batch,
               "prompt": sz.prompt, "ttft_ms": ttft_ms, "prefill_launches": {k: v for k, v in n.items() if v},
               "logits_finite": bool(torch.isfinite(logits).all())}
        if th is None:
            dense_logits = logits
            tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
            step_ms = []
            for _ in range(sz.decode_steps):
                t0 = time.perf_counter()
                tok, step_logits = eng.decode_step(tok, cache)
                sync()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            row.update(decode_steps=sz.decode_steps, decode_ms_per_step_median=statistics.median(step_ms),
                       decode_steps_finite=bool(torch.isfinite(step_logits).all()))
        else:
            a, b = logits.double().flatten(), dense_logits.double().flatten()
            row.update(keep_frac_per_layer=eng.last_prefill_keep_frac.tolist(),
                       logits_corr_vs_dense=float(torch.corrcoef(torch.stack([a, b]))[0, 1]),
                       logits_largest_gap_vs_dense=_rel(logits, dense_logits),
                       argmax_agree_vs_dense=float((logits.argmax(-1) == dense_logits.argmax(-1)).float().mean()))
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(json.dumps(row))
        runs.append(row)
        if not (row["logits_finite"] and row.get("decode_steps_finite", True)):
            raise AssertionError(f"full einsum {th}: non-finite logits")
        if (n["skip_softmax_flash_tc"] != (0 if th is None else L) or n["skip_softmax_flash_cuda_core"]
                or not n["qmm_int4_wo"]):
            raise AssertionError(f"full einsum {th}: prefill launches {n}")
        if profile:
            _profile(torch, f"einsum {'dense' if th is None else 'sparse'} prefill {th}",
                     lambda e=eng: e.prefill(prompt, e.init_cache(sz.batch)), 1, ttft_ms)
            if th is None:
                pc = eng.init_cache(sz.batch)
                eng.prefill(prompt, pc)
                _profile(torch, "einsum decode step", lambda e=eng: [e.decode_step(tok, pc) for _ in range(2)],
                         2, statistics.median(step_ms))
                del pc
        del eng, cache, logits

    # depth 2: kernel engine against its plain versions, dense and sparse
    # prefill; sparse, the kernel engine's keep maps pin the plain engine's
    sub = _truncate(cm, 2)
    for th in (None, 1e-30, calibrated):
        fields = dict(kv_attention_kernel=False, attn_sparsity=th)
        out = _engine(torch, sub, max_seq, dev, **fields)
        ref = _engine(torch, sub, max_seq, dev, ("int4_wo", "skip_softmax"), **fields)
        keeps, decided = [], []
        if th is not None:
            out._ops["skip_softmax"] = _recording(out._ops["skip_softmax"], keeps)
            ref._ops["skip_softmax"] = _pinned_plain(torch, keeps, decided)
        lo = out.prefill(prompt, out.init_cache(sz.batch))
        lr = ref.prefill(prompt, ref.init_cache(sz.batch))
        rel = _rel(lo, lr)
        row = {"phase": "full_vs_plain", "path": "einsum engine, int4, int8 cache", "depth": 2, "threshold": th,
               "prefill_logits_rel_err": rel, "argmax_agree": float((lo.argmax(-1) == lr.argmax(-1)).float().mean())}
        if th is not None:
            row.update(_decided_apart(keeps, decided, exact=th == 1e-30))
        log(json.dumps(row))
        if not rel <= 5e-2:
            raise AssertionError(f"full einsum: depth-2 prefill logits rel err {rel} vs plain > 5e-2 (threshold {th})")
        del out, ref, lo, lr, keeps, decided
    return launches


@dataclasses.dataclass(frozen=True)
class PagedRun:
    """A request list for `Engine.serve` and its pool: `requests` prompts of
    `prompt` tokens that share their first `shared`; `new_tokens` each, but
    `short_new` for requests 1 .. `short`: those retire early, and the
    requests admitted into their slots find request 0's prefix pages still
    published, share them and prefill only their tails (`prefill_chunked`).
    With equal lengths all slots retire in one step, the prefix pages are
    freed before the next admissions, and no request ever shares a page."""

    requests: int = 12
    prompt: int = 1024
    shared: int = 256
    new_tokens: int = 32
    short: int = 4
    short_new: int = 16
    slots: int = 8
    unroll: int = 4

    def geometry(self, page: int) -> dict:
        need = (self.prompt + self.new_tokens) // page + 2
        return dict(n_pages=self.slots * need + 8, page_size=page, max_slots=self.slots, max_pages_per_seq=need + 1)

    def make(self, torch, dev, vocab: int, seed: int):
        from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Request

        g = torch.Generator(device=dev).manual_seed(seed)
        shared = torch.randint(0, vocab, (self.shared,), generator=g, device=dev)
        prompts = [torch.cat([shared, torch.randint(0, vocab, (self.prompt - self.shared,), generator=g, device=dev)])
                   for _ in range(self.requests)]
        new = [self.short_new if 1 <= i <= self.short else self.new_tokens for i in range(self.requests)]
        return prompts, lambda: [Request(rid=i, prompt=p.cpu().numpy(), max_new_tokens=n)
                                 for i, (p, n) in enumerate(zip(prompts, new))]


def _scheduler_replay(reqs, geom: dict, unroll: int) -> dict:
    """What the scheduler's bookkeeping alone gives for a request list: the
    loop of `Engine.serve` with made-up tokens and no model (no request has an
    EOS token, so the tokens' values decide nothing)."""
    import numpy as np

    from tensorrt_model_optimizer_tpu_torch.serve.paged_cache import init_paged
    from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Scheduler

    sched = Scheduler(geom["max_slots"], geom["n_pages"], geom["page_size"], geom["max_pages_per_seq"],
                      prefix_cache=True)
    cache = init_paged(0, geom["n_pages"], geom["page_size"], 1, 16, geom["max_slots"], geom["max_pages_per_seq"])
    for r in reqs:
        sched.submit(r)
    out = dict(dense_prefills=0, chunked_prefills=0, decode_dispatches=0)
    while sched.has_work:
        cache, admissions = sched.admit(cache)
        for slot, req in admissions:
            out["chunked_prefills" if int(cache.seq_lens[slot]) > 0 else "dense_prefills"] += 1
            sched.register_prefix(slot)
            req.output.append(0)
            req.done = len(req.output) >= req.max_new_tokens
        if sched.active_mask().any():
            sched.record_token_block(np.zeros((geom["max_slots"], unroll), np.int64))
            out["decode_dispatches"] += 1
        sched.retire(cache)
    return dict(out, free_pages=len(sched.free_pages))


def _paged_probe(torch, eng, geom: dict, prompts: list, shared: int, tok=None):
    """Fill one slot per prompt by hand: all but the last prefill densely
    (`prefill_into_slot`); the last shares slot 0's `shared` prefix rows and
    streams its tail through `prefill_chunked`; then one decode step over all
    slots. Returns the pool, [slot 0's prefill logits, the chunked prefill's
    logits, the decode step's logits], and the step's tokens and mask."""
    dev, n, per = prompts[0].device, len(prompts), geom["max_pages_per_seq"] - 1
    cache = eng.init_paged_cache(**geom)
    table = torch.full((geom["max_slots"], per + 1), -1, dtype=torch.int32, device=dev)
    table[:n, :per] = (1 + torch.arange(n * per, device=dev)).reshape(n, per)
    table[n - 1, :shared // geom["page_size"]] = table[0, :shared // geom["page_size"]]
    cache.block_table = table
    logits = [eng.prefill_into_slot(cache, b, p[None]) for b, p in enumerate(prompts[:-1])][:1]
    cache.seq_lens[n - 1] = shared
    logits.append(eng.prefill_chunked(cache, n - 1, prompts[-1][None, shared:])[None])
    active = torch.zeros(geom["max_slots"], dtype=torch.bool, device=dev)
    active[:n] = True
    if tok is None:
        tok = torch.zeros((geom["max_slots"], 1), dtype=torch.int32, device=dev)
        tok[0], tok[n - 1] = logits[0][0].argmax(), logits[1][0].argmax()
    logits.append(eng.paged_step(tok, cache, active))
    return cache, logits, tok, active


def _full_paged(torch, dev, sz: Sizes, cm, label: str, kv, run: PagedRun, profile: bool,
                act_quantizers: bool = False) -> dict:
    """`Engine.serve` at full width over the paged pool: the request list of
    `run` through the kernel engine, its metrics held against the scheduler's
    own bookkeeping; then the paths of the run by hand (`_paged_probe`), at
    full depth for finite logits and step times, and on the first 2 layers
    against the engine that runs the paged kernels' plain versions."""
    sync = torch.cuda.synchronize
    cfg = cm.model_cfg
    geom = run.geometry(sz.page)
    max_seq = run.prompt + run.new_tokens + 16
    fields = dict(kv=kv, paged_attention_kernel=True)
    eng = _engine(torch, cm, max_seq, dev, **fields)
    prompts, requests = run.make(torch, dev, cfg.vocab_size, seed=6)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _counts(reset=True)
    reqs = requests()
    outs, m = eng.serve(reqs, prefix_cache=True, unroll=run.unroll, collect_metrics=True, **geom)
    sync()
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = _scheduler_replay(requests(), geom, run.unroll)
    lengths_ok = all(len(outs[r.rid]) == r.max_new_tokens for r in reqs)
    tokens_ok = all(0 <= t < cfg.vocab_size for v in outs.values() for t in v)

    # the run's paths by hand, every slot filled as in the run's first wave
    cache, logits, tok, active = _paged_probe(torch, eng, geom, prompts[:run.slots], run.shared)
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    chunk_toks = torch.zeros((run.slots, sz.chunk), dtype=torch.int64, device=dev)
    idle = ~active  # a chunk step as `prefill_chunked` runs it: all slots computed, none of the live ones writes
    dense = eng.init_cache(run.slots, max_seq)
    eng.prefill(torch.stack(prompts[:run.slots]), dense)

    def dense_step():  # the dense-cache step over the same rows, for what the paged step adds
        dense["pos"] = run.prompt
        eng.decode_step(tok, dense)

    # the host's cost of a step depends on what the process ran before it, so
    # the decode step is read before and after the chunk steps
    steps = {"decode step": lambda: eng.paged_step(tok, cache, idle), "dense decode step": dense_step,
             "chunk step": lambda: eng.paged_step(chunk_toks, cache, idle),
             "decode step after chunk steps": lambda: eng.paged_step(tok, cache, idle)}
    wall = {}
    for what, fn in steps.items():
        fn()
        sync()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        wall[what] = statistics.median(times)
    del dense
    log(json.dumps({"phase": "full", "path": f"serve: {label}", "model": "llama3_8b", "layers": cfg.num_hidden_layers,
                    "kv_dtype": str(eng.ecfg.kv_dtype), "packed_nvfp4_pages": cache.packed_nvfp4,
                    "requests": run.requests, "prompt": run.prompt, "shared_prefix": run.shared,
                    "new_tokens": [r.max_new_tokens for r in reqs], **geom, "prefix_cache": True,
                    "metrics": m, "scheduler_replay": want, "launches": {k: v for k, v in launches.items() if v},
                    "peak_mem_gb": peak_gb, "output_lengths_ok": lengths_ok, "tokens_in_vocab": tokens_ok,
                    "probe_logits_finite": finite, "step_wall_ms": wall,
                    "page_pool_gb": sum(t.numel() * t.element_size() for t in (
                        cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales) if t is not None) / 1e9}))
    if not (lengths_ok and tokens_ok and finite):
        raise AssertionError(f"full serve {label}: output lengths, token range or finite logits failed")
    if not (m["dense_prefills"] and m["chunked_prefills"]):
        raise AssertionError(f"full serve {label}: a prefill route was never taken: {m}")
    if {k: m[k] for k in want} != want:
        raise AssertionError(f"full serve {label}: the run's metrics {m} differ from the scheduler's bookkeeping {want}")
    if not (launches["paged_attention_decode"] and launches["paged_attention_prefill"] and launches["flash_gqa"]):
        raise AssertionError(f"full serve {label}: kernels of the path never launched: {launches}")
    if launches["paged_attention_prefill_tc"] != launches["paged_attention_prefill"]:
        raise AssertionError(f"full serve {label}: {launches['paged_attention_prefill_cuda_core']} of its "
                             f"{launches['paged_attention_prefill']} chunk prefills left the tensor-core route")
    if cache.packed_nvfp4 != (eng.ecfg.kv_dtype == "nvfp4"):
        raise AssertionError(f"full serve {label}: kv_dtype {eng.ecfg.kv_dtype!r}, packed pool {cache.packed_nvfp4}")
    if profile:
        for what in ("chunk step", "decode step"):
            _profile(torch, f"serve: {label} paged {what}", lambda fn=steps[what]: [fn() for _ in range(2)], 2,
                     wall[what])
    del cache, logits

    # First 2 layers, kernel engine against the engine with the two paged
    # kernels on their plain versions: slot 0's dense prefill (the same
    # kernels in both, so equal), the chunked prefill over shared prefix
    # pages (the prefill kernel, and the decode kernel for the tail's
    # remainder) and a decode step (the decode kernel), each held to the 5e-2
    # of the logits' scale that the dense paths above are held to: kernel and
    # plain version round the same f32 result to bf16, an ulp apart now and
    # then, and quantized pages and random layers amplify that. A preset that
    # fake-quantizes the activations (`act_quantizers`: NVFP4_KV_CFG's e2m1
    # input quantizers, a step of up to a third of a value, the first of them
    # on the attention's own output) is held with those quantizers off, as the
    # dense paths above are; the reading with them on is reported beside it.
    def depth2(sub):
        _, got, tok2, _ = _paged_probe(torch, _engine(torch, sub, max_seq, dev, **fields), geom, prompts[:2],
                                       run.shared)
        _, ref, _, _ = _paged_probe(torch, _engine(torch, sub, max_seq, dev, PAGED_PLAIN, **fields), geom,
                                    prompts[:2], run.shared, tok2)
        return {what: _rel(a, b) for what, a, b in zip(("dense_prefill", "chunked_prefill", "decode_step"), got, ref)}

    sub = _truncate(cm, 2)
    row = {"phase": "full_vs_plain", "path": f"serve: {label}", "depth": 2}
    if act_quantizers:
        row["with_input_quantizers"] = depth2(sub)
        sub = _without_input_quantizers(sub)
    rels = depth2(sub)
    log(json.dumps({**row, **rels}))
    if not all(r <= 5e-2 for r in rels.values()):
        raise AssertionError(f"full serve {label}: depth-2 logits rel err vs the plain paged versions {rels} > 5e-2")
    return launches


def _full_nvfp4_kv(torch, dev, sz: Sizes, cfg, params, profile: bool) -> None:
    """NVFP4_KV_CFG on the first 4 layers at full width: a shorter paged run
    over the packed NVFP4 pool, and generation over the dense NVFP4 KV cache
    at batch 8 x 2048 (the `nvfp4` format of all three attention kernels)."""
    path = PAGED_PATHS[1][0]
    cfg = dataclasses.replace(cfg, num_hidden_layers=path.depth)
    sub = {**params, "layers": {k: v[:path.depth] for k, v in params["layers"].items()}}
    cm = _compressed(torch, path, cfg, sub, dev, seed=4)
    _full_paged(torch, dev, sz, cm, path.label, None,
                PagedRun(requests=6, prompt=512, shared=256, new_tokens=16, short=2, short_new=8, slots=4), profile,
                act_quantizers=True)
    eng = _engine(torch, cm, sz.max_seq, dev, kv=None)
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
    _counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    cache = eng.init_cache(sz.batch)
    t0 = time.perf_counter()
    logits = eng.prefill(prompt, cache)
    torch.cuda.synchronize()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
    step_ms = []
    for _ in range(8):
        t0 = time.perf_counter()
        tok, step_logits = eng.decode_step(tok, cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    dense = _counts()
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all())
    log(json.dumps({"phase": "full", "path": "dense NVFP4 KV cache (NVFP4_KV_CFG)", "layers": path.depth,
                    "batch": sz.batch, "prompt": sz.prompt, "decode_steps": 8, "kv_dtype": str(eng.ecfg.kv_dtype),
                    "cache_bytes_per_row": cache["k"].shape[-1] + cache["ks"].shape[-1], "ttft_ms": ttft_ms,
                    "decode_ms_per_step_median": statistics.median(step_ms),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": {k: v for k, v in dense.items() if v}, "logits_finite": finite}))
    if not (finite and eng.ecfg.kv_dtype == "nvfp4" and dense["kv_decode_attention"] == 8 * path.depth):
        raise AssertionError(f"full dense NVFP4 KV: finite {finite}, kv_dtype {eng.ecfg.kv_dtype}, launches {dense}")


def _truncate(cm, depth: int):
    """The first `depth` layers of a compressed model (views, no copies)."""
    layers = {k: ({n: (a[:depth] if hasattr(a, "shape") else a) for n, a in v.items()}
                  if isinstance(v, dict) else v[:depth]) for k, v in cm.params["layers"].items()}
    return dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, num_hidden_layers=depth),
                               params={**cm.params, "layers": layers})


def _without_input_quantizers(cm):
    """The same compressed model with every `.input` site disabled."""
    from tensorrt_model_optimizer_tpu_torch.models.llama import QuantLayout
    from tensorrt_model_optimizer_tpu_torch.quant.quantizer import DISABLED

    sites = tuple((k, DISABLED if k.endswith(".input") else v) for k, v in cm.layout.sites)
    return dataclasses.replace(cm, layout=QuantLayout(sites=sites))


def _cache(eng, depth: int, sz: Sizes) -> dict:
    c = eng.init_cache(sz.batch)
    return {"k": c["k"][:depth], "v": c["v"][:depth], "pos": 0}


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


KERNELS = {
    "qmm_w4a8": ("tensorrt_model_optimizer_tpu_torch/csrc/qmm_w4a8.cu",
                 "tensorrt_model_optimizer_tpu/ops/pallas/qmm.py:1410"),
    "kv_decode_attention": ("tensorrt_model_optimizer_tpu_torch/csrc/kv_decode_attention.cu",
                            "tensorrt_model_optimizer_tpu/ops/pallas/kv_attention.py:220"),
    "flash_gqa": ("tensorrt_model_optimizer_tpu_torch/csrc/flash_gqa.cu",
                  "tensorrt_model_optimizer_tpu/ops/pallas/flash_gqa.py:80"),
    # one kernel for one function that the TPU package wrote in several layouts
    "qmm_int4_wo": ("tensorrt_model_optimizer_tpu_torch/csrc/qmm_int4_wo.cu",
                    "tensorrt_model_optimizer_tpu/ops/pallas/qmm.py:1184 (qmm_int4_bd2), :189 (qmm_int4), "
                    ":751 (qmm_int4_word), :871 (qmm_int4_word2)"),
    "qmm_fp4_wo": ("tensorrt_model_optimizer_tpu_torch/csrc/qmm_fp4_wo.cu",
                   "tensorrt_model_optimizer_tpu/ops/pallas/qmm.py:997 (qmm_nvfp4_word2), :289 (qmm_nvfp4), "
                   ":434 (qmm_nvfp4_perm), :651 (qmm_nvfp4_word), :1625 (qmm_nvfp4_bd4)"),
    "qmm_byte_wo": ("tensorrt_model_optimizer_tpu_torch/csrc/qmm_byte_wo.cu",
                    "tensorrt_model_optimizer_tpu/ops/pallas/qmm.py:80 (qmm_int8), :122 (qmm_fp8)"),
    "paged_attention_decode": ("tensorrt_model_optimizer_tpu_torch/csrc/paged_attention_decode.cu",
                               "tensorrt_model_optimizer_tpu/ops/pallas/paged_attention.py:108"),
    # one TPU kernel, two routes of one source (`paged_attention.prefill_route`)
    "paged_attention_prefill_tc": ("tensorrt_model_optimizer_tpu_torch/csrc/paged_attention_prefill.cu",
                                   "tensorrt_model_optimizer_tpu/ops/pallas/paged_attention.py:246"),
    "paged_attention_prefill_cuda_core": ("tensorrt_model_optimizer_tpu_torch/csrc/paged_attention_prefill.cu",
                                          "tensorrt_model_optimizer_tpu/ops/pallas/paged_attention.py:246"),
    # one TPU kernel, two routes of one source (`sparse_attention.route`)
    "skip_softmax_flash_tc": ("tensorrt_model_optimizer_tpu_torch/csrc/skip_softmax_flash.cu",
                              "tensorrt_model_optimizer_tpu/ops/pallas/sparse_attention.py:138"),
    "skip_softmax_flash_cuda_core": ("tensorrt_model_optimizer_tpu_torch/csrc/skip_softmax_flash.cu",
                                     "tensorrt_model_optimizer_tpu/ops/pallas/sparse_attention.py:138"),
}
# f32 only: the RULER curve on the anchor launches the first, the anchor's
# f32 paged engine the second
ANCHOR_ONLY = ("skip_softmax_flash_cuda_core", "paged_attention_prefill_cuda_core")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,anchor,full",
                    help="comma-separated; add 'profile' for device time by kernel in the full run")
    args = ap.parse_args(argv)
    import torch

    from tensorrt_model_optimizer_tpu_torch.ops.cuda import _build  # noqa: F401  (fails outside the repo)

    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    dev, sz = torch.device("cuda"), Sizes()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")
    timer = Timer(torch, dev)
    rows: dict = {}
    launches = None
    seconds = {}
    t_start = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        result = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return result

    if "build" in phases:
        timed("build", phase_build)
    if "kernels" in phases:
        timed("kernels", phase_kernels, torch, dev, sz, timer, rows)
    anchor_launches = {}
    if "anchor" in phases:
        anchor_launches = timed("anchor", phase_anchor, torch, dev, sz)
    if "full" in phases:
        launches = {**timed("full", phase_full, torch, dev, sz, "profile" in phases), **anchor_launches}
        never = [name for name in KERNELS if not launches.get(name) and (name not in ANCHOR_ONLY or anchor_launches)]
        if never:
            raise AssertionError(f"full: kernels that no path launched: {never}")
    log(json.dumps({"phase_seconds": seconds, "total_seconds": round(time.perf_counter() - t_start, 1)}))
    out = []
    for name, (src, replaces) in KERNELS.items():
        r = rows.get(name, {})
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": (launches or {}).get(name), "max_abs_err": r.get("max_abs_err"),
                    "ms": r.get("ms"), "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
                    "bound_by": r.get("bound_by"), "library_ms": r.get("library_ms"),
                    "shape": r.get("shape")})
    log(json.dumps({"kernels": out}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
