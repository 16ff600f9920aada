#!/usr/bin/env python
"""Serving demo of the PyTorch port, beside `examples/serve_demo.py`:
quantize -> export -> load -> continuous-batching serve, the whole deploy
loop on a tiny model (or an HF checkpoint with --model).

  python examples/serve_demo_torch.py --device cpu
  python examples/serve_demo_torch.py --qformat INT4_BLOCKWISE_WEIGHT_ONLY_CFG --paged_kernel --prefix_cache

JAX's example asks its engine for `backend="xla"` (XLA's GEMMs); the port's
engine serves the ported kernels on the card and their plain versions on
the CPU. On the card the weight-only kernels take bf16 activations, so the
tiny model is made in bf16 there (f32 on the CPU). `main(argv)` returns
{rid: tokens}.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--qformat", default="INT8_SMOOTHQUANT_CFG")
    ap.add_argument("--num_requests", type=int, default=4)
    ap.add_argument("--max_new_tokens", type=int, default=8)
    ap.add_argument("--paged_kernel", action="store_true")
    ap.add_argument("--prefix_cache", action="store_true", help="share identical prompt-prefix pages across requests")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device
    from tensorrt_model_optimizer_tpu_torch.export import hf_export
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, llama
    from tensorrt_model_optimizer_tpu_torch.quant import ptq
    from tensorrt_model_optimizer_tpu_torch.serve import engine as serve_engine
    from tensorrt_model_optimizer_tpu_torch.serve import loader
    from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Request
    from tensorrt_model_optimizer_tpu_torch.utils import dataset

    dev = resolve_device(args.device)
    if args.model == "tiny":
        cfg = llama.LlamaConfig.tiny(num_hidden_layers=2,
                                     dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        cfg, params = hf_loader.load_hf_checkpoint(args.model, device=dev)
    batches = [torch.from_numpy(b).to(dev) for b in dataset.get_calib_batches(cfg.vocab_size, num_batches=4,
                                                                               seq_len=64)]
    model = ptq.quantize(cfg, params, args.qformat, batches, device=dev)
    print(f"[serve_demo] quantized with {args.qformat}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        qc = hf_export.export_hf_checkpoint(model, tmp)
        print(f"[serve_demo] exported {qc['quantization']['quant_algo']}", flush=True)
        cm = loader.load_quantized_checkpoint(tmp, device=dev)
    eng = serve_engine.Engine(cm, serve_engine.EngineConfig(max_seq_len=256,
                                                            paged_attention_kernel=args.paged_kernel), device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=(6 + i,)).astype(np.int32),
                    max_new_tokens=args.max_new_tokens) for i in range(args.num_requests)]
    outs = eng.serve(reqs, n_pages=64, page_size=16, max_slots=2, max_pages_per_seq=8,
                     prefix_cache=args.prefix_cache)
    for rid in sorted(outs):
        print(f"[serve_demo] request {rid}: {outs[rid]}", flush=True)
    print("[serve_demo] done", flush=True)
    return outs


if __name__ == "__main__":
    main()
    sys.exit(0)
