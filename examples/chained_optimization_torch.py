#!/usr/bin/env python
"""Chained optimizations of the PyTorch port, beside
`examples/chained_optimization.py` and taking its arguments: 2:4 sparsify
-> distillation healing from the dense teacher with the masks re-applied
after every step -> PTQ of the healed sparse model -> the unified HF
checkpoint.

  python examples/chained_optimization_torch.py --device cpu --export_path /tmp/chained

Runs on the card unless `--device cpu`; `main(argv)` returns {"ppl_dense",
"ppl_sparse", "ppl_healed", "ppl_quant", "loss", "export_path",
"quant_config", "model", "masks"}.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--sparsity", default="magnitude", choices=["magnitude", "sparsegpt"])
    ap.add_argument("--qformat", default="FP8_DEFAULT_CFG")
    ap.add_argument("--heal_steps", type=int, default=10)
    ap.add_argument("--export_path", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device
    from tensorrt_model_optimizer_tpu_torch.distill import distillation
    from tensorrt_model_optimizer_tpu_torch.export import hf_export
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, llama
    from tensorrt_model_optimizer_tpu_torch.quant import ptq
    from tensorrt_model_optimizer_tpu_torch.sparsity import sparsify as sp
    from tensorrt_model_optimizer_tpu_torch.utils import evaluate

    dev = resolve_device(args.device)
    if args.model == "tiny":
        cfg = llama.LlamaConfig.tiny(num_hidden_layers=2)
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        cfg, params = hf_loader.load_hf_checkpoint(args.model, device=dev)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))).to(dev) for _ in range(4)]
    ppl0 = evaluate.perplexity(cfg, params, batches[:2])
    print(f"[chained] dense ppl {ppl0:.2f}", flush=True)

    # 1. sparsify (2:4)
    t0 = time.time()
    sparse_params, masks = sp.sparsify(cfg, params, args.sparsity, (2, 4), batches)
    ppl1 = evaluate.perplexity(cfg, sparse_params, batches[:2])
    print(f"[chained] 2:4 {args.sparsity} ppl {ppl1:.2f} ({time.time() - t0:.1f}s)", flush=True)

    # 2. distillation healing (teacher: the dense model), masks re-applied
    step = distillation.make_distill_step(cfg, lr=1e-3)
    healed, loss = sparse_params, None
    for _ in range(args.heal_steps):
        healed, loss = step(healed, params, batches[0])
        healed = sp.reapply(healed, masks)
    for name, m in masks.items():
        if (healed["layers"][name][~m] != 0).any():
            raise AssertionError(f"healing broke the sparsity mask of {name}")
    ppl2 = evaluate.perplexity(cfg, healed, batches[:2])
    print(f"[chained] healed ppl {ppl2:.2f} (loss {float(loss):.3f}, masks intact)", flush=True)

    # 3. quantize the healed sparse model
    model = ptq.quantize(cfg, healed, args.qformat, batches[:2], device=dev)
    ppl3 = evaluate.perplexity(cfg, model.params, batches[:2], layout=model.layout, qstate=model.qstate,
                               adapters=model.adapters)
    print(f"[chained] sparse+quantized ({args.qformat}) ppl {ppl3:.2f}", flush=True)

    # 4. export the final checkpoint
    out = args.export_path or tempfile.mkdtemp(prefix="chained_")
    qc = hf_export.export_hf_checkpoint(model, out)
    print(f"[chained] exported {qc['quantization']['quant_algo']} -> {out}", flush=True)
    print("[chained] done", flush=True)
    return {"ppl_dense": ppl0, "ppl_sparse": ppl1, "ppl_healed": ppl2, "ppl_quant": ppl3, "loss": float(loss),
            "export_path": out, "quant_config": qc, "model": model, "masks": masks}


if __name__ == "__main__":
    main()
    sys.exit(0)
