#!/usr/bin/env python3
"""Time the port's attention and GEMM kernels in two trees of the repo on
one CUDA card, the same way and on the same inputs.

    python3 tools/torch_kernels_ab.py --base OLD_TREE --change NEW_TREE [--groups kv,paged_prefill,paged_decode,wo,w4a8]

Both trees hold the package `tensorrt_model_optimizer_tpu_torch`, so each
timing run is a process of its own that imports one tree's package (and
builds its kernels from that tree's `csrc/`). The runs go base, change,
change, base, so that a drift of the card's clock over the call shows. The
Timer (cold L2, the card held by a spin while the host enqueues), the seeded
inputs and the shapes come from THIS checkout's `chip_smoke.py`, whatever
the trees' own scripts do. Groups (all by default):
  kv             `kv_decode_attention` at B 8, n_kv 8, rep 4, hd 128, pos 2048
                 (of chip_smoke's S rows), every stored form;
  paged_prefill  `paged_attention_prefill` with bf16 q (the engine's chunk
                 step) at T = 64 and T = 5 over ragged contexts, pages of 16;
  paged_decode   `paged_attention_decode` with bf16 q, 8 sequences of 2048
                 rows and ragged lengths, a 130-page table of 16 rows;
  wo             the weight-only GEMMs (INT4, NVFP4, MXFP4, INT8, FP8) at
                 chip_smoke's projection shapes, N = 8 and N = 16384;
  w4a8           the W4A8 GEMM at the same shapes and N.
Each output is held against its own tree's plain version (rel err and, for
W4A8, bit equality printed; not a gate: this script measures and does not
judge).

Prints one JSON line per run and, last, {"median_ms": {case: {tree: ms}}}
with the median over each tree's two runs. Exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = ("kv", "paged_prefill", "paged_decode", "wo", "w4a8")
SOURCES = {"kv": ["kv_decode_attention"], "paged_prefill": ["paged_attention_prefill"],
           "paged_decode": ["paged_attention_decode"], "wo": ["qmm_int4_wo", "qmm_fp4_wo", "qmm_byte_wo"], "w4a8": ["qmm_w4a8"]}


def _smoke():
    """This checkout's chip_smoke.py as a module (its Timer and helpers)."""
    spec = importlib.util.spec_from_file_location("_ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def _import_tree(tree: str):
    sys.path.insert(0, os.path.abspath(tree))
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import _build, kv_attention, paged_attention, qmm

    if not os.path.abspath(_build.PKG_DIR).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {_build.PKG_DIR}, not the package of {tree}")
    return _build, kv_attention, paged_attention, qmm


def build(tree: str, groups: list) -> None:
    _build = _import_tree(tree)[0]
    _build.build_all([src for grp in groups for src in SOURCES[grp]])


def run(tree: str, groups: list) -> dict:
    _, kv_attention, paged_attention, qmm = _import_tree(tree)  # before chip_smoke puts HERE on sys.path
    import torch

    smoke = _smoke()
    dev = torch.device("cuda")
    sz = smoke.Sizes()
    timer = smoke.Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    B, n_kv, rep, hd, S, pos = sz.kv
    nH, page = n_kv * rep, sz.page
    out = {}
    for fmt in smoke.KV_FORMATS if "kv" in groups else ():
        kc, ks, qf = smoke._stored_rows(torch, dev, g, (B, n_kv, S, hd), fmt)
        vc, vs, _ = smoke._stored_rows(torch, dev, g, (B, n_kv, S, hd), fmt)
        q = torch.randn((B, nH, hd), generator=g, device=dev) / hd ** 0.5 * qf
        kn, vn = (torch.randn((B, n_kv, 1, hd), generator=g, device=dev) for _ in range(2))
        # a tree whose kernel reads pos on the device takes it as a tensor
        # there (an int would add a host copy to every timed launch)
        p = torch.tensor(pos, dtype=torch.int32, device=dev) if hasattr(kv_attention, "_pos_tensor") else pos
        args = (q, kc, vc, kn, vn, p, fmt, ks, vs)
        rel = smoke._rel(kv_attention.kv_decode_attention(*args), kv_attention.kv_decode_attention_plain(*args))
        out[f"kv_decode_attention {fmt} pos={pos}"] = {
            "ms": timer(lambda: kv_attention.kv_decode_attention(*args), sz.reps), "rel_err": rel}
        del kc, vc, ks, vs
    prefill = ((sz.chunk, [1024, 960, 256, 70, 64, 1, 0, 0][:B]), (5, [1024, 37, 256, 70, 64, 1, 0, 0][:B]))
    for T, ctx in prefill if "paged_prefill" in groups else ():
        for fmt in smoke.KV_FORMATS:
            kp, vp, ksp, vsp, qf, table, tl = smoke._paged_pool(torch, dev, g, sz, fmt, ctx, 1024 // page + 2)
            ck, cks, _ = smoke._stored_rows(torch, dev, g, (B, T, n_kv, hd), fmt)
            cv, cvs, _ = smoke._stored_rows(torch, dev, g, (B, T, n_kv, hd), fmt)
            q = (torch.randn((B, T, nH, hd), generator=g, device=dev) * qf).to(torch.bfloat16)
            args = (q, kp, vp, table, tl, ck, cv, "nvfp4" if fmt == "nvfp4" else "raw", ksp, vsp, cks, cvs)
            rel = smoke._rel(paged_attention.paged_attention_prefill(*args).float(),
                             paged_attention.paged_attention_prefill_plain(*args).float())
            out[f"paged_attention_prefill {fmt} T={T} bf16 q"] = {
                "ms": timer(lambda: paged_attention.paged_attention_prefill(*args), sz.reps), "rel_err": rel}
            del kp, vp, ksp, vsp
    for what, lens in (("uniform", [2048] * B), ("ragged", [2048, 1153, 1024, 513, 17, 16, 1, 0][:B])) \
            if "paged_decode" in groups else ():
        for fmt in smoke.KV_FORMATS:
            kp, vp, ksp, vsp, qf, table, tl = smoke._paged_pool(torch, dev, g, sz, fmt, lens, 2048 // page + 2)
            q = (torch.randn((B, nH, hd), generator=g, device=dev) * qf).to(torch.bfloat16)
            args = (q, kp, vp, table, tl, "nvfp4" if fmt == "nvfp4" else "raw", ksp, vsp)
            rel = smoke._rel(paged_attention.paged_attention_decode(*args).float(),
                             paged_attention.paged_attention_decode_plain(*args, out_dtype=torch.float32))
            out[f"paged_attention_decode {fmt} {what} bf16 q"] = {
                "ms": timer(lambda: paged_attention.paged_attention_decode(*args), sz.reps), "rel_err": rel}
            del kp, vp, ksp, vsp
    for O, K, label in sz.qmm_shapes if "wo" in groups else ():
        for N in sz.qmm_rows:
            x = torch.randn((N, K), generator=g, device=dev).to(torch.bfloat16)
            for name, fmt, fn, plain, w, _, _ in smoke._wo_cases(torch, dev, g, O, K):
                rel = smoke._rel(fn(x, *w).float(), plain(x, *w, out_dtype=torch.float32))
                out[f"{name} {fmt} {label} N={N}"] = {"ms": timer(lambda: fn(x, *w), sz.reps), "rel_err": rel}
                del w
            del x
    for O, K, label in sz.qmm_shapes if "w4a8" in groups else ():
        packed = torch.randint(0, 256, (O, K // 2), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
        scales = (torch.rand((K // 128, O), generator=g, device=dev) * 1.5 + 0.5).to(torch.bfloat16)
        for N in sz.qmm_rows:
            x8 = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
            y, ref = qmm.w4a8_matmul(x8, packed, scales), qmm.w4a8_matmul_plain(x8, packed, scales)
            out[f"qmm_w4a8 {label} N={N}"] = {"ms": timer(lambda: qmm.w4a8_matmul(x8, packed, scales), sz.reps),
                                              "rel_err": smoke._rel(y, ref), "bit_exact": bool(torch.equal(y, ref))}
            del x8, y, ref
        del packed, scales
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the tree measured first and last")
    ap.add_argument("--change", help="the tree measured second and third")
    ap.add_argument("--groups", default=",".join(GROUPS), help=f"comma-separated, of {', '.join(GROUPS)}")
    ap.add_argument("--worker", nargs=2, metavar=("MODE", "TREE"), help=argparse.SUPPRESS)
    a = ap.parse_args()
    groups = a.groups.split(",")
    if set(groups) - set(GROUPS):
        ap.error(f"--groups: unknown {sorted(set(groups) - set(GROUPS))}")
    if a.worker:
        mode, tree = a.worker
        if mode == "build":
            build(tree, groups)
        else:
            print(json.dumps(run(tree, groups)), flush=True)
        return 0
    if not (a.base and a.change):
        ap.error("--base and --change are required")
    trees = {"base": a.base, "change": a.change}
    me = os.path.abspath(__file__)
    worker = [sys.executable, me, "--groups", a.groups, "--worker"]
    builds = [subprocess.Popen(worker + ["build", t]) for t in trees.values()]
    if any(p.wait() != 0 for p in builds):
        return 1
    runs: dict[str, list[dict]] = {"base": [], "change": []}
    for name in ("base", "change", "change", "base"):
        r = subprocess.run(worker + ["run", trees[name]], capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return 1
        res = json.loads(r.stdout.strip().splitlines()[-1])
        runs[name].append(res)
        print(json.dumps({"tree": name, "path": trees[name], "cases": res}), flush=True)
    median = {case: {name: statistics.median(r[case]["ms"] for r in runs[name]) for name in runs}
              for case in runs["base"][0]}
    print(json.dumps({"median_ms": median}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
