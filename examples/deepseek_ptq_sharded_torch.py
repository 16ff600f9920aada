#!/usr/bin/env python
"""Multi-GPU DeepSeek PTQ of the PyTorch port, beside
`examples/deepseek_ptq_sharded.py` (BASELINE config[4]; the reference's
`examples/deepseek/deepseek_v3/ptq.py`): calibrate DeepSeek with its routed
experts sharded over an ("expert", "tensor") mesh, check the sharded
amaxes against one process's, then serve the model with its heads and
experts over the ranks.

Each rank is a process (`parallel.mesh.launch`: nccl with a card a rank,
gloo on one card, or gloo on the CPU with --cpu). The ranks hold the
seeded model and calibrate their slice of the routed experts
(`quant.sharded.quantize_sharded("deepseek", ...)`: each expert's gate / up
rows and down columns over "tensor", the experts over "expert", the
spanning sites' amaxes reduced); MLA, the shared experts and the dense
layer calibrate replicated. Every rank then calibrates the whole model
alone: the quantizer states must agree within 1e-4 (JAX's example's
bound, max |diff|). The compressed model is served by `DeepseekEngine`
with MLA's heads, the shared experts' FFN and the routed experts over 2
ranks (replicated over the rest), its greedy tokens against the single-process engine's, and its
fake-quant logits' correlation with the unquantized forward is printed.

  python examples/deepseek_ptq_sharded_torch.py --cpu --devices 4
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

AMAX_ATOL = 1e-4


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--qformat", default="NVFP4_DEFAULT_CFG")
    ap.add_argument("--devices", type=int, default=4, help="ranks")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--new_tokens", type=int, default=6)
    return ap.parse_args(argv)


def state_gap(a: dict, b: dict) -> float:
    """max |a - b| over every amax of two DeepSeek quantizer states."""
    import torch

    from tensorrt_model_optimizer_tpu_torch.utils import tree

    fa, fb = tree.flatten_with_names(a), tree.flatten_with_names(b)
    if set(fa) != set(fb):
        raise AssertionError(f"state trees differ: {sorted(set(fa) ^ set(fb))}")
    return max((float((fa[k].float() - fb[k].float()).abs().max()) for k in fa
                if isinstance(fa[k], torch.Tensor) and fa[k].numel()), default=0.0)


def rank_main(rank: int, args, cfg, params, batches) -> dict:
    import dataclasses

    import torch

    from tensorrt_model_optimizer_tpu_torch.models import deepseek
    from tensorrt_model_optimizer_tpu_torch.parallel import mesh as M
    from tensorrt_model_optimizer_tpu_torch.quant import sharded
    from tensorrt_model_optimizer_tpu_torch.serve import deepseek_engine as dse
    from tensorrt_model_optimizer_tpu_torch.utils import tree

    n = args.devices
    mesh = M.Mesh({"expert": 2, "tensor": n // 2})
    dev = mesh.device
    params = tree.map_tensors(lambda t: t.to(dev), params)
    batches = [b.to(dev) for b in batches]
    qm = sharded.quantize_sharded("deepseek", cfg, params, args.qformat, batches, mesh, device=dev)
    ref = deepseek.quantize(cfg, params, args.qformat, batches, device=dev)
    gap = state_gap(qm.qstate, ref.qstate)
    if not gap < AMAX_ATOL:
        raise AssertionError(f"sharded amax off the single-process amax by {gap} >= {AMAX_ATOL}")
    qm = dataclasses.replace(ref, qstate=qm.qstate)
    plain = deepseek.forward(cfg, params, batches[0])[0]
    got = qm.forward(batches[0])[0]
    corr = float(torch.corrcoef(torch.stack([plain.flatten().float(), got.flatten().float()]))[0, 1])
    cm = dse.compress(qm)
    prompt = batches[0][:, :8]
    # tp 2 (replicated over the rest): the tiny shared expert's 32-wide K
    # holds two NVFP4 blocks, which do not split four ways (JAX raises too)
    served = dse.DeepseekEngine(cm, max_seq_len=prompt.shape[1] + args.new_tokens,
                                mesh=M.Mesh({"rep": n // 2, "tp": 2}))
    served._eager = True  # gloo's collectives run on the host: no CUDA graph
    toks = served.generate(prompt, args.new_tokens)
    single = dse.DeepseekEngine(cm, max_seq_len=prompt.shape[1] + args.new_tokens, device=dev)
    if not torch.equal(toks, single.generate(prompt, args.new_tokens)):
        raise AssertionError("tokens served over the ranks differ from the single-process engine's")
    return {"amax_gap": gap, "corr": corr, "tokens": toks.cpu().numpy(), "backend": mesh.backend}


def main(argv=None) -> list:
    """Runs the example; returns each rank's {"amax_gap", "corr", "tokens",
    "backend"}."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from tensorrt_model_optimizer_tpu_torch.models import deepseek
    from tensorrt_model_optimizer_tpu_torch.parallel import mesh as M

    cfg = deepseek.DeepseekConfig.tiny()
    params = deepseek.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 32))) for _ in range(4)]
    backend, devices = M.rank_devices(args.devices, args.cpu)
    out = M.launch(rank_main, args.devices, backend=backend, devices=devices, args=(args, cfg, params, batches),
                   threads=1 if args.cpu else None)
    print(f"[deepseek_ptq] {args.devices} ranks ({backend}): sharded-vs-single amax max|diff| = "
          f"{max(r['amax_gap'] for r in out):.2e}", flush=True)
    print(f"[deepseek_ptq] {args.qformat}: quantized logit corr vs bf16 = {out[0]['corr']:.4f}; served tokens "
          "equal the single-process engine's", flush=True)
    return out


if __name__ == "__main__":
    main()
