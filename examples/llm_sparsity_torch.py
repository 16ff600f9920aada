#!/usr/bin/env python
"""Weight sparsity example of the PyTorch port, beside
`examples/llm_sparsity.py` and taking its arguments: N:M-sparsify every
projection (magnitude or SparseGPT), report the perplexity before and
after, and optionally quantize the sparse model (PTQ) after it.

  python examples/llm_sparsity_torch.py --device cpu --method sparsegpt --qformat INT4_BLOCKWISE_WEIGHT_ONLY_CFG

Runs on the card unless `--device cpu`; `main(argv)` returns {"ppl",
"ppl_sparse", "ppl_quant"?, "sparsity", "params", "masks"}.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--method", default="sparsegpt", choices=["magnitude", "sparsegpt"])
    ap.add_argument("--pattern", default="2:4")
    ap.add_argument("--qformat", default=None, help="optional PTQ after sparsify")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, llama
    from tensorrt_model_optimizer_tpu_torch.sparsity import magnitude, sparsify
    from tensorrt_model_optimizer_tpu_torch.utils import dataset, evaluate

    dev = resolve_device(args.device)
    if args.model == "tiny":
        cfg = llama.LlamaConfig.tiny(num_hidden_layers=2)
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        cfg, params = hf_loader.load_hf_checkpoint(args.model, device=dev)
    n, m = (int(x) for x in args.pattern.split(":"))
    batches = [torch.from_numpy(b).to(dev) for b in dataset.get_calib_batches(cfg.vocab_size, num_batches=4,
                                                                               seq_len=64)]

    ppl0 = evaluate.perplexity(cfg, params, batches[:2])
    sp_params, masks = sparsify.sparsify(cfg, params, args.method, (n, m), batches)
    ppl1 = evaluate.perplexity(cfg, sp_params, batches[:2])
    ratio = sum(magnitude.sparsity_ratio(k) for k in masks.values()) / len(masks)
    print(f"[llm_sparsity] {args.method} {n}:{m} ppl {ppl0:.3f} -> {ppl1:.3f} (sparsity {ratio:.3f})", flush=True)
    out = {"ppl": ppl0, "ppl_sparse": ppl1, "sparsity": ratio, "params": sp_params, "masks": masks}

    if args.qformat:
        from tensorrt_model_optimizer_tpu_torch.quant import ptq

        model = ptq.quantize(cfg, sp_params, args.qformat, batches, device=dev)
        out["ppl_quant"] = evaluate.perplexity(cfg, model.params, batches[:2], layout=model.layout,
                                               qstate=model.qstate)
        print(f"[llm_sparsity] + {args.qformat}: ppl {out['ppl_quant']:.3f}", flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
