#!/usr/bin/env python
"""EAGLE-1 / EAGLE-3 drafter training, the PyTorch port against the JAX
package, step by step on the CPU in f32 (a comparison tool: it imports both
packages, as the parity tests do).

Both packages start from JAX's initial drafts (`init_eagle(key 2)`,
`init_eagle3(key 4)`, carried across by `convert.drafts_from_jax`) and the
same base, and train on the same batches with `tools/bench_specdec.py`'s
settings: the anchor (`artifacts/anchor-llama`), `--steps` TTT steps
(default 300) of 8 x 65 tokens from the stream of seed 11, windows drawn by
numpy's default_rng(3), lr 1e-3, 3 TTT steps; then `propose_and_verify` on
the stream's first 32 tokens for 64 tokens. `--base bf16` (default) is the
base as bench_specdec loads it (the f32 checkpoint read as bf16, then cast
to f32: JAX's loader defaults to bf16); `--base f32` keeps the checkpoint's
f32 values, as chip_smoke's `speculative` phase loads them.

Prints one JSON object (and with `--out PATH` writes it there): per method the
two loss trajectories, their largest relative gap and the first step past
`--part` (default 1e-3), the last step's TTT accuracies and the acceptance
of both, and JAX's record (artifacts/specdec_r02.jsonl) beside them.

    JAX_PLATFORMS=cpu python tools/torch_specdec_parity.py --steps 300
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

ANCHOR = os.path.join(ROOT, "artifacts", "anchor-llama")
RECORD = os.path.join(ROOT, "artifacts", "specdec_r02.jsonl")
KEYS = {"eagle": 2, "eagle3": 4}  # bench_specdec's draft init keys


def log(m):
    print(f"[specdec_parity] {m}", file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--methods", default="eagle,eagle3")
    ap.add_argument("--base", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--part", type=float, default=1e-3, help="relative loss gap that counts as parting")
    ap.add_argument("--out", default=None, help="where to write the JSON object, trajectories included")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from tensorrt_model_optimizer_tpu.models import hf_loader as jhf
    from tensorrt_model_optimizer_tpu.speculative import eagle as jeagle
    from tensorrt_model_optimizer_tpu.utils import synthlang
    from tensorrt_model_optimizer_tpu_torch import convert
    from tensorrt_model_optimizer_tpu_torch.speculative import eagle as teagle

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    jcfg, jp = jhf.load_hf_checkpoint(ANCHOR, dtype=jnp.bfloat16 if args.base == "bf16" else jnp.float32)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "dtype": jnp.float32})
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tcfg, tp = convert.llama_cfg_from_jax(jcfg), convert.params_from_jax(jp)
    stream = synthlang.SynthLang(0).token_stream(max(args.steps, 64) * 8 * 65, seed=11)
    prompt = stream[:32][None].astype(np.int32)
    with open(RECORD) as f:
        record = {r["method"]: r for r in map(json.loads, f)}

    out = {"steps": args.steps, "base": args.base, "part": args.part, "methods": {}}
    for m in args.methods.split(","):
        init = jeagle.init_eagle if m == "eagle" else jeagle.init_eagle3
        jd = init(jcfg, jeagle.EagleConfig(num_layers=1), jax.random.key(KEYS[m]))
        td = convert.drafts_from_jax(jd)
        make_j = jeagle.make_eagle_ttt_train_step if m == "eagle" else jeagle.make_eagle3_ttt_train_step
        make_t = teagle.make_eagle_ttt_train_step if m == "eagle" else teagle.make_eagle3_ttt_train_step
        jstep, tstep = jax.jit(make_j(jcfg, ttt_steps=3, lr=1e-3)), make_t(tcfg, ttt_steps=3, lr=1e-3)
        rng = np.random.default_rng(3)
        jl, tl, t0 = [], [], time.time()
        for i in range(args.steps):
            starts = rng.integers(0, stream.size - 64 - 1, size=8)
            b = np.stack([stream[s: s + 65] for s in starts])
            jd, jloss, jaccs = jstep(jd, jp, jnp.asarray(b))
            td, tloss, taccs = tstep(td, tp, torch.from_numpy(b).long())
            jl.append(float(jloss))
            tl.append(float(tloss))
            if i % 50 == 0:
                log(f"{m} step {i}: loss jax {jl[-1]:.6f} port {tl[-1]:.6f} ({time.time() - t0:.0f}s)")
        gaps = [abs(a - b) / abs(b) for a, b in zip(tl, jl)]
        parted = next((i for i, g in enumerate(gaps) if g > args.part), None)
        _, jrate = jeagle.propose_and_verify(jcfg, jp, jd, jnp.asarray(prompt), 64)
        with torch.no_grad():
            _, trate = teagle.propose_and_verify(tcfg, tp, td, torch.from_numpy(prompt).long(), 64)
        row = {"jax_losses": jl, "port_losses": tl, "max_gap": max(gaps), "first_step_past_part": parted,
               "gap_at": {str(k): gaps[k] for k in (0, 9, 49, 99, 199, args.steps - 1) if k < args.steps},
               "jax_last_accs": [float(a) for a in jaccs], "port_last_accs": [float(a) for a in taccs],
               "jax_accept": float(jrate), "port_accept": float(trate),
               "record_accept": record[m]["accept_rate"], "record_last_accs": record[m]["ttt_train_acc"],
               "seconds": round(time.time() - t0, 1)}
        out["methods"][m] = row
        log(f"{m}: max gap {row['max_gap']:.2e} (first past {args.part}: {parted}); accept jax {jrate:.3f} "
            f"port {trate:.3f} record {row['record_accept']:.3f}; accs jax {row['jax_last_accs']} "
            f"port {row['port_last_accs']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    print(json.dumps({m: {k: v for k, v in r.items() if not k.endswith("_losses")} for m, r in out["methods"].items()}))
    return out


if __name__ == "__main__":
    main()
