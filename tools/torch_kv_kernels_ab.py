#!/usr/bin/env python3
"""Time the port's KV decode and paged prefill kernels in two trees of the
repo on one CUDA card, the same way and on the same inputs.

    python3 tools/torch_kv_kernels_ab.py --base OLD_TREE --change NEW_TREE

Both trees hold the package `tensorrt_model_optimizer_tpu_torch`, so each
timing run is a process of its own that imports one tree's package (and
builds its kernels from that tree's `csrc/`). The runs go base, change,
change, base, so that a drift of the card's clock over the call shows. The
Timer (cold L2, the card held by a spin while the host enqueues), the seeded
inputs and the shapes come from THIS checkout's `chip_smoke.py`, whatever
the trees' own scripts do: `kv_decode_attention` at B 8, n_kv 8, rep 4, hd
128, pos 2048 in every stored form, and `paged_attention_prefill` with bf16
q (the engine's chunk step) at T = 64 and T = 5 over ragged contexts, pages
of 16. Each output is held against its own tree's plain version (rel err
printed, not a gate: this script measures and does not judge).

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
SOURCES = ["kv_decode_attention", "paged_attention_prefill"]


def _smoke():
    """This checkout's chip_smoke.py as a module (its Timer and helpers)."""
    spec = importlib.util.spec_from_file_location("_ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def _import_tree(tree: str):
    sys.path.insert(0, os.path.abspath(tree))
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import _build, kv_attention, paged_attention

    if not os.path.abspath(_build.PKG_DIR).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {_build.PKG_DIR}, not the package of {tree}")
    return _build, kv_attention, paged_attention


def build(tree: str) -> None:
    _build, _, _ = _import_tree(tree)
    _build.build_all(SOURCES)


def run(tree: str) -> dict:
    _, kv_attention, paged_attention = _import_tree(tree)  # before chip_smoke puts HERE on sys.path
    import torch

    smoke = _smoke()
    dev = torch.device("cuda")
    sz = smoke.Sizes()
    timer = smoke.Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    B, n_kv, rep, hd, S, pos = sz.kv
    nH, page = n_kv * rep, sz.page
    out = {}
    for fmt in smoke.KV_FORMATS:
        kc, ks, qf = smoke._stored_rows(torch, dev, g, (B, n_kv, S, hd), fmt)
        vc, vs, _ = smoke._stored_rows(torch, dev, g, (B, n_kv, S, hd), fmt)
        q = torch.randn((B, nH, hd), generator=g, device=dev) / hd ** 0.5 * qf
        kn, vn = (torch.randn((B, n_kv, 1, hd), generator=g, device=dev) for _ in range(2))
        args = (q, kc, vc, kn, vn, pos, fmt, ks, vs)
        rel = smoke._rel(kv_attention.kv_decode_attention(*args), kv_attention.kv_decode_attention_plain(*args))
        out[f"kv_decode_attention {fmt} pos={pos}"] = {
            "ms": timer(lambda: kv_attention.kv_decode_attention(*args), sz.reps), "rel_err": rel}
        del kc, vc, ks, vs
    for T, ctx in ((sz.chunk, [1024, 960, 256, 70, 64, 1, 0, 0][:B]), (5, [1024, 37, 256, 70, 64, 1, 0, 0][:B])):
        for fmt in smoke.KV_FORMATS:
            max_pages = 1024 // page + 2
            n_pages = 1 + B * max_pages
            kp, ksp, qf = smoke._stored_rows(torch, dev, g, (n_pages, n_kv, page, hd), fmt)
            vp, vsp, _ = smoke._stored_rows(torch, dev, g, (n_pages, n_kv, page, hd), fmt)
            perm = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1).to(torch.int32).reshape(B, max_pages)
            live = torch.arange(max_pages, device=dev)[None] * page < torch.tensor(ctx, device=dev)[:, None]
            table = torch.where(live, perm, torch.full_like(perm, -1))
            tl = torch.tensor(ctx, dtype=torch.int32, device=dev)
            ck, cks, _ = smoke._stored_rows(torch, dev, g, (B, T, n_kv, hd), fmt)
            cv, cvs, _ = smoke._stored_rows(torch, dev, g, (B, T, n_kv, hd), fmt)
            q = (torch.randn((B, T, nH, hd), generator=g, device=dev) * qf).to(torch.bfloat16)
            args = (q, kp, vp, table, tl, ck, cv, "nvfp4" if fmt == "nvfp4" else "raw", ksp, vsp, cks, cvs)
            rel = smoke._rel(paged_attention.paged_attention_prefill(*args).float(),
                             paged_attention.paged_attention_prefill_plain(*args).float())
            out[f"paged_attention_prefill {fmt} T={T} bf16 q"] = {
                "ms": timer(lambda: paged_attention.paged_attention_prefill(*args), sz.reps), "rel_err": rel}
            del kp, vp, ksp, vsp
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the tree measured first and last")
    ap.add_argument("--change", help="the tree measured second and third")
    ap.add_argument("--worker", nargs=2, metavar=("MODE", "TREE"), help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        mode, tree = a.worker
        if mode == "build":
            build(tree)
        else:
            print(json.dumps(run(tree)), flush=True)
        return 0
    if not (a.base and a.change):
        ap.error("--base and --change are required")
    trees = {"base": a.base, "change": a.change}
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--worker", "build", t]) for t in trees.values()]
    if any(p.wait() != 0 for p in builds):
        return 1
    runs: dict[str, list[dict]] = {"base": [], "change": []}
    for name in ("base", "change", "change", "base"):
        r = subprocess.run([sys.executable, me, "--worker", "run", trees[name]], capture_output=True, text=True)
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
