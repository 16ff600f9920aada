#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py                 # all phases, needs one CUDA card
    python3 chip_smoke.py --phases build,kernels

Phases (any failure raises, and the script exits non-zero):
  build    nvcc-builds every kernel of `tensorrt_model_optimizer_tpu_torch/csrc`
           (one process per source, in parallel) and prints the build time.
  kernels  each kernel against its plain PyTorch version on the card, at the
           Llama-3.1-8B shapes of the served path, with CUDA-event timings,
           the bound (bytes or operations) and, for flash, the library call.
  anchor   the in-repo trained checkpoint `artifacts/anchor-llama` through
           load -> INT4 weight-only PTQ -> compress -> W4A8 / int8-KV engine;
           greedy tokens on the kernels must equal those on the plain versions.
  full     Llama-3.1-8B at full width and depth (seeded random bf16 weights on
           the card): PTQ -> compress -> engine, batch 8 x 2048-token prompts
           then 32 decode steps; launch counts are read around this run, and
           the prefill logits are held against the plain versions, and against
           an engine that runs only flash attention on its plain version.
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
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}  # dense tensor-core peaks
ANCHOR = os.path.join(HERE, "artifacts", "anchor-llama")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of each phase; `full` is the served configuration."""

    qmm_shapes: tuple = ((14336, 4096, "gate_proj"), (4096, 14336, "down_proj"))
    qmm_rows: tuple = (8, 16384)
    kv: tuple = (8, 8, 4, 128, 2560, 2048)  # B, n_kv, rep, hd, S, pos
    flash: tuple = (8, 32, 8, 2048, 128)  # B, H, Hkv, T, d
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
    every layer's weights and cache cold)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
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
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa, kv_attention, qmm

    g = torch.Generator(device=dev).manual_seed(0)
    # --- W4A8 GEMM: the kernel is bit-exact with its plain version by design
    # (exact int32 block sums, the same f32 scale order); the contract held
    # here is the tests' 1e-3 relative to the output's scale.
    shapes = []
    for O, K, label in sz.qmm_shapes:
        nblk = K // 128
        packed = torch.randint(0, 256, (O, K // 2), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
        scales = (torch.rand((nblk, O), generator=g, device=dev) * 1.5 + 0.5).to(torch.bfloat16)
        for N in sz.qmm_rows:
            x8 = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
            out = qmm.w4a8_matmul(x8, packed, scales)
            ref = qmm.w4a8_matmul_plain(x8, packed, scales)
            err = float((out - ref).abs().max())
            rel = _rel(out, ref)
            if not rel <= 1e-3:
                raise AssertionError(f"w4a8 {label} N={N}: rel err {rel} > 1e-3")
            ms = timer(lambda: qmm.w4a8_matmul(x8, packed, scales), sz.reps)
            plain_ms = timer(lambda: qmm.w4a8_matmul_plain(x8, packed, scales), max(2, sz.reps // 8))
            b_ms, b_by = bound(N * K + O * K / 2 + nblk * O * 2 + N * O * 4, 2.0 * N * O * K, "int8")
            shapes.append({"shape": f"{label} N={N} O={O} K={K}", "max_abs_err": err, "rel_err": rel,
                           "bit_exact": bool(torch.equal(out, ref)), "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
            log(json.dumps({"kernel": "qmm_w4a8", **shapes[-1]}))
            del x8, out, ref
        del packed, scales
    rows["qmm_w4a8"] = dict(shapes[0], shapes=shapes)

    # --- KV decode attention: f32 online softmax vs torch.softmax; 1e-5 of
    # the output's scale (f32 rounding of sums taken in another order).
    B, n_kv, rep, hd, S, pos = sz.kv
    shapes = []
    for fmt, dtype in (("int8", torch.int8), ("bf16", torch.bfloat16), ("fp8", torch.float8_e4m3fn)):
        q = torch.randn((B, n_kv * rep, hd), generator=g, device=dev) / math.sqrt(hd)
        if fmt == "int8":
            kc, vc = (torch.randint(-128, 128, (B, n_kv, S, hd), generator=g, device=dev,
                                    dtype=torch.int32).to(dtype) for _ in range(2))
            q = q / 40.0
        else:
            kc, vc = ((torch.randn((B, n_kv, S, hd), generator=g, device=dev) * 2).to(dtype) for _ in range(2))
        kn, vn = (torch.randn((B, n_kv, 1, hd), generator=g, device=dev) for _ in range(2))
        out = kv_attention.kv_decode_attention(q, kc, vc, kn, vn, pos, fmt)
        ref = kv_attention.kv_decode_attention_plain(q, kc, vc, kn, vn, pos, fmt)
        rel = _rel(out, ref)
        if not rel <= 1e-5:
            raise AssertionError(f"kv_decode_attention {fmt}: rel err {rel} > 1e-5")
        ms = timer(lambda: kv_attention.kv_decode_attention(q, kc, vc, kn, vn, pos, fmt), sz.reps)
        plain_ms = timer(lambda: kv_attention.kv_decode_attention_plain(q, kc, vc, kn, vn, pos, fmt),
                         max(2, sz.reps // 4))
        item = kc.element_size()
        nbytes = 2 * B * n_kv * pos * hd * item + 2 * B * n_kv * hd * 4 + 2 * q.numel() * 4
        b_ms, b_by = bound(nbytes, 4.0 * B * n_kv * rep * (pos + 1) * hd, "bf16")
        shapes.append({"shape": f"{fmt} B={B} n_kv={n_kv} rep={rep} S={S} pos={pos}",
                       "max_abs_err": float((out - ref).abs().max()), "rel_err": rel, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        log(json.dumps({"kernel": "kv_decode_attention", **shapes[-1]}))
    rows["kv_decode_attention"] = dict(shapes[0], shapes=shapes)

    # --- flash GQA: bf16 out. Each element is held against the plain
    # version's f32 result (bf16 inputs, f32 softmax, before the bf16 cast):
    # rounding to bf16 moves a value by at most half an ulp, 2^-8 of itself,
    # and the two f32 results differ by ~1e-6 of the row's sum of |p.v|,
    # covered by 1e-3 of the output's rms. The limit is per element, so a
    # late row (|out| ~ 0.03) is held to ~1e-4, not to the largest output's
    # scale. A value just above a power of two rounds by up to 2^-8 of
    # itself, so the worst err/limit of a right kernel comes near 1; the
    # rms term is its headroom for the f32 gap.
    B, H, Hkv, T, d = sz.flash
    q = torch.randn((B, H, T, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, Hkv, T, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    out = flash_gqa.flash_attention_gqa(q, k, v)
    ref32 = flash_gqa.flash_attention_gqa_plain(q.float(), k.float(), v.float())
    diff = (out.float() - ref32).abs()
    tol = 2.0 ** -8 * ref32.abs() + 1e-3 * float(ref32.square().mean().sqrt())
    worst = float((diff / tol).max())
    err = float(diff.max())
    if not worst <= 1.0:
        bad = int((diff > tol).sum())
        raise AssertionError(f"flash_gqa: {bad} elements beyond 2^-8|ref| + 1e-3 rms(ref); "
                             f"worst err/limit {worst}, max abs err {err}, "
                             f"max |ref| {float(ref32.abs().max())}")
    del ref32, diff, tol
    ms = timer(lambda: flash_gqa.flash_attention_gqa(q, k, v), sz.reps)
    plain_ms = timer(lambda: flash_gqa.flash_attention_gqa_plain(q, k, v), max(2, sz.reps // 8))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), sz.reps)
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * k.numel()), 4.0 * B * H * d * T * (T + 1) / 2, "bf16")
    shape = {"shape": f"B={B} H={H} Hkv={Hkv} T={T} d={d}", "max_abs_err": err,
             "worst_err_over_limit": worst, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    log(json.dumps({"kernel": "flash_gqa", **shape}))
    rows["flash_gqa"] = dict(shape, shapes=[shape])


def _engine(torch, cm, max_seq: int, dev, plain: tuple = ()):
    from tensorrt_model_optimizer_tpu_torch.serve.engine import Engine, EngineConfig

    return Engine(cm, EngineConfig(max_seq_len=max_seq, kv_dtype=torch.int8, int4_layout="a8",
                                   kv_attention_kernel=True, plain_ops=plain), device=dev)


def phase_anchor(torch, dev, sz: Sizes):
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    cfg, params = hf_loader.load_hf_checkpoint(ANCHOR, device=dev)
    cm = compress.compress(ptq.quantize(cfg, params, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", device=dev))
    g = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=g, device=dev)
    toks = _engine(torch, cm, 64, dev).generate(prompts, 16)
    ref = _engine(torch, cm, 64, dev, PLAIN_ALL).generate(prompts, 16)
    same = bool(torch.equal(toks, ref))
    log(json.dumps({"phase": "anchor", "prompts": list(prompts.shape), "new_tokens": 16,
                    "tokens_equal_plain": same, "tokens_row0": toks[0].tolist()}))
    if not same:
        raise AssertionError(f"anchor: kernel-path tokens differ from plain\n{toks}\n{ref}")


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
    log(json.dumps({"phase": "profile", "what": label, "per_call_device_busy_ms": busy_ms,
                    "per_call_kernel_launches": sum(n for _, _, n in by_kernel),
                    "per_call_wall_ms_unprofiled": wall_ms_unprofiled,
                    "device_idle_share": 1.0 - busy_ms / wall_ms_unprofiled,
                    "top": [{"kernel": k[:70], "ms": ms, "count": n} for k, ms, n in by_kernel[:10]]}))


def phase_full(torch, dev, sz: Sizes, profile: bool = False):
    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa, kv_attention, qmm
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    sync = torch.cuda.synchronize
    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    qm = ptq.quantize(cfg, params, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", device=dev)
    cm = compress.compress(qm)
    del params, qm
    eng = _engine(torch, cm, sz.max_seq, dev)
    del cm
    torch.cuda.empty_cache()
    sync()
    setup_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats()

    counters = (qmm, kv_attention, flash_gqa)
    for m in counters:
        m.launches = 0
    cache = eng.init_cache(sz.batch)
    sync()
    t0 = time.perf_counter()
    logits = eng.prefill(prompt, cache)
    sync()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    step_ms = []
    for _ in range(sz.decode_steps):
        t0 = time.perf_counter()
        tok, step_logits = eng.decode_step(tok, cache)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"qmm_w4a8": qmm.launches, "kv_decode_attention": kv_attention.launches,
                "flash_gqa": flash_gqa.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all())

    log(json.dumps({"phase": "full", "model": "llama3_8b",
                    "layers": cfg.num_hidden_layers, "batch": sz.batch, "prompt": sz.prompt,
                    "decode_steps": sz.decode_steps, "setup_s": setup_s, "ttft_ms": ttft_ms,
                    "decode_ms_per_step_median": statistics.median(step_ms),
                    "decode_ms_per_step_mean": statistics.mean(step_ms),
                    "decode_tok_per_s": sz.batch * 1e3 / statistics.median(step_ms),
                    "peak_mem_gb": peak_gb, "launches": launches, "logits_finite": finite,
                    "packed_weight_gb": eng.cm.packed_bytes / 1e9}))
    if not finite:
        raise AssertionError("full: non-finite logits")
    if profile:
        _profile(torch, "prefill", lambda: eng.prefill(prompt, eng.init_cache(sz.batch)), 1, ttft_ms)
        pc = eng.init_cache(sz.batch)
        eng.prefill(prompt, pc)
        t = torch.zeros((sz.batch, 1), dtype=torch.int32, device=dev)
        _profile(torch, "decode step", lambda: [eng.decode_step(t, pc) for _ in range(4)], 4,
                 statistics.median(step_ms))
        del pc

    # The prefill logits against the same engine on the plain versions, by
    # depth, and against an engine that runs only flash on its plain version
    # ("flash plain"; prefill runs no KV decode attention). The W4A8 kernel
    # is bit-exact with its plain version, so the flash-plain engine must
    # equal the all-plain one exactly at every depth: that shows the whole
    # kernel-vs-plain gap comes from flash. Flash may round an output one
    # bf16 ulp apart; with per-token int8 activations such an ulp can move a
    # code across a rounding boundary, and random (untrained) layers amplify
    # each flipped code with depth. That gap is held at depth 2 (full
    # width); deeper rows are reported.
    for depth in sorted({d for d in (1, 2, 4, 8) if d < cfg.num_hidden_layers} | {cfg.num_hidden_layers}):
        sub = _truncate(eng.cm, depth)
        out, flash_plain, ref = (_engine(torch, sub, sz.max_seq, dev, plain).prefill(prompt, _cache(eng, depth, sz))
                                 for plain in ((), ("flash",), PLAIN_ALL))
        rel = _rel(out, ref)
        agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
        exact = bool(torch.equal(flash_plain, ref))
        log(json.dumps({"phase": "full_vs_plain", "depth": depth, "prefill_logits_rel_err": rel,
                        "argmax_agree": agree, "flash_plain_equals_plain": exact,
                        "flash_plain_rel_err": _rel(flash_plain, ref)}))
        if not exact:
            raise AssertionError(f"full: depth {depth}: with only flash plain, the logits differ from plain")
        if depth == 2 and not rel <= 5e-2:
            raise AssertionError(f"full: depth-2 prefill logits rel err {rel} vs plain > 5e-2")
        del out, flash_plain, ref, sub
    if min(launches.values()) <= 0:
        raise AssertionError(f"full: a kernel of the path never launched: {launches}")
    return launches


def _truncate(cm, depth: int):
    """The first `depth` layers of a compressed model (views, no copies)."""
    layers = {k: ({n: (a[:depth] if hasattr(a, "shape") else a) for n, a in v.items()}
                  if isinstance(v, dict) else v[:depth]) for k, v in cm.params["layers"].items()}
    return dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, num_hidden_layers=depth),
                               params={**cm.params, "layers": layers})


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
}


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
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(torch, dev, sz, timer, rows)
    if "anchor" in phases:
        phase_anchor(torch, dev, sz)
    if "full" in phases:
        launches = phase_full(torch, dev, sz, "profile" in phases)
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
