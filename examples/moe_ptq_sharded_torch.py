#!/usr/bin/env python
"""Multi-GPU MoE PTQ of the PyTorch port, beside `examples/moe_ptq_sharded.py`
(the reference's `examples/llm_ptq` multi-GPU flow): calibrate a routed-MoE
model with its experts sharded over an ("expert", "tensor") mesh, check the
sharded amaxes against one process's, then serve the quantized model with
its experts over the ranks.

Each rank is a process (`parallel.mesh.launch`): one per card under nccl
where there are enough cards, else gloo with every rank on the one card, or
gloo on the CPU with --cpu. The ranks hold the seeded model and calibrate
their slice of the experts (`quant.sharded.quantize_sharded`: each expert's
gate / up rows and down columns over "tensor", the experts over "expert";
the sites that span shards reduce their amaxes, as GSPMD does in JAX's
example), then every rank calibrates the whole model alone as the ground
truth: the amaxes must agree within 1e-6. The model is then compressed and
served by the engine with its experts and heads over all the ranks
(`EngineConfig(mesh=...)`), its greedy tokens against the single-process
engine's.

  python examples/moe_ptq_sharded_torch.py --cpu --devices 4
  python examples/moe_ptq_sharded_torch.py --devices 4 --qformat INT4_BLOCKWISE_WEIGHT_ONLY_CFG
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

AMAX_RTOL = 1e-6
CHECKED = ("moe.gate_proj", "moe.up_proj", "moe.down_proj", "self_attn.q_proj")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--qformat", default="FP8_DEFAULT_CFG")
    ap.add_argument("--devices", type=int, default=4, help="ranks")
    ap.add_argument("--expert_axis", type=int, default=2, help="the expert axis' size (the rest is 'tensor')")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--new_tokens", type=int, default=8)
    return ap.parse_args(argv)


def amax_gap(a, b) -> float:
    """The largest |a - b| / |b| over the sites' weight and input amaxes."""
    worst = 0.0
    for site in CHECKED:
        for which in ("weight", "input"):
            x, y = (s.get(site, {}).get(which) for s in (a, b))
            if x is None or x.amax is None:
                continue
            xa, ya = (t[0] if isinstance(t, tuple) else t for t in (x.amax, y.amax))
            worst = max(worst, float((xa - ya).abs().max() / ya.abs().max().clamp_min(1e-30)))
    return worst


def rank_main(rank: int, args, cfg, params, tokens) -> dict:
    import dataclasses

    import torch

    from tensorrt_model_optimizer_tpu_torch.parallel import mesh as M
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq, sharded
    from tensorrt_model_optimizer_tpu_torch.serve import engine as E

    n, ep = args.devices, args.expert_axis
    mesh = M.Mesh({"expert": ep, "tensor": n // ep})
    dev = mesh.device
    params = {k: (v.to(dev) if isinstance(v, torch.Tensor) else {n_: t.to(dev) for n_, t in v.items()})
              for k, v in params.items()}
    tokens = tokens.to(dev)
    qm = sharded.quantize_sharded("mixtral", cfg, params, args.qformat, [tokens], mesh, device=dev)
    ref = ptq.quantize_family("mixtral", cfg, params, args.qformat, [tokens], device=dev)
    gap = amax_gap(qm.qstate, ref.qstate)
    if not gap <= AMAX_RTOL:
        raise AssertionError(f"sharded amax off the single-process amax by {gap} > {AMAX_RTOL}")
    cm = compress.compress(dataclasses.replace(ref, qstate=qm.qstate))
    prompt = tokens[:, :8]
    ecfg = dict(max_seq_len=prompt.shape[1] + args.new_tokens)
    served = E.Engine(cm, E.EngineConfig(mesh=M.Mesh({"tp": n}), **ecfg))
    served._eager = True  # gloo's collectives run on the host: no CUDA graph
    toks = served.generate(prompt, args.new_tokens)
    single = E.Engine(cm, E.EngineConfig(**ecfg), device=dev).generate(prompt, args.new_tokens)
    if not torch.equal(toks, single):
        raise AssertionError("tokens served over the ranks differ from the single-process engine's")
    return {"amax_gap": gap, "tokens": toks.cpu().numpy(), "mesh": mesh.shape, "backend": mesh.backend}


def main(argv=None) -> list:
    """Runs the example; returns each rank's {"amax_gap", "tokens", "mesh",
    "backend"}."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from tensorrt_model_optimizer_tpu_torch.models import mixtral
    from tensorrt_model_optimizer_tpu_torch.parallel import mesh as M

    cfg = mixtral.MixtralConfig.tiny(num_experts=8, num_key_value_heads=4, capacity_factor=4.0)
    params = mixtral.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)))
    backend, devices = M.rank_devices(args.devices, args.cpu)
    print(f"[moe_ptq] {args.devices} ranks, {backend}, mesh expert={args.expert_axis} "
          f"tensor={args.devices // args.expert_axis}", flush=True)
    out = M.launch(rank_main, args.devices, backend=backend, devices=devices, args=(args, cfg, params, tokens),
                   threads=1 if args.cpu else None)
    print(f"[moe_ptq] {args.qformat}: sharded amax == single-process amax (max rel gap "
          f"{max(r['amax_gap'] for r in out):.1e}); served tokens equal the single-process engine's", flush=True)
    return out


if __name__ == "__main__":
    main()
