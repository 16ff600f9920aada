#!/usr/bin/env python
"""VLM PTQ example of the PyTorch port, beside `examples/vlm_ptq.py` and
taking its arguments: quantize a LLaVA-style VLM (ViT, projector, Llama LM)
with a preset over synthetic (image, text) pairs, report the logits'
correlation with the unquantized model's, check that the image still
conditions the text logits, and, with `--export_path`, write the unified
checkpoint (`export_vlm_checkpoint`).

  python examples/vlm_ptq_torch.py --device cpu --qformat NVFP4_DEFAULT_CFG

Runs on the card unless `--device cpu`; `main(argv)` returns {"corr",
"delta", "quant_algo" (with --export_path)}. The pairs' text ids run past
the tiny LM's 256 rows: they are clamped to the last row, which is what
JAX's gather does with them in `examples/vlm_ptq.py`.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--qformat", default="NVFP4_DEFAULT_CFG")
    ap.add_argument("--calib_batches", type=int, default=4)
    ap.add_argument("--export_path", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device
    from tensorrt_model_optimizer_tpu_torch.models import vlm
    from tensorrt_model_optimizer_tpu_torch.utils.dataset import vlm_calib_batches

    dev = resolve_device(args.device)
    cfg = vlm.VLMConfig.tiny()
    params = vlm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    calib = [(torch.from_numpy(px).to(dev), torch.from_numpy(np.minimum(tk, cfg.lm.vocab_size - 1)).to(dev))
             for px, tk in vlm_calib_batches(args.calib_batches)]
    print(f"[vlm_ptq] model: ViT {cfg.vision.depth}L/{cfg.vision.hidden_size}h"
          f" + LM {cfg.lm.num_hidden_layers}L/{cfg.lm.hidden_size}h", flush=True)
    px, tk = calib[0]
    out: dict = {}
    with torch.no_grad():
        ref, _ = vlm.forward(cfg, params, px, tk)
        t0 = time.time()
        layout, qstate = vlm.quantize_vlm(cfg, params, args.qformat, calib)
        q, _ = vlm.forward(cfg, params, px, tk, layout=layout, qstate=qstate)
        out["corr"] = float(np.corrcoef(ref.cpu().numpy().ravel(), q.cpu().numpy().ravel())[0, 1])
        print(f"[vlm_ptq] quantized ({args.qformat}) in {time.time() - t0:.1f}s; logits corr vs unquantized "
              f"{out['corr']:.4f}", flush=True)
        q2, _ = vlm.forward(cfg, params, torch.roll(px, 7, dims=1), tk, layout=layout, qstate=qstate)
        out["delta"] = float((q - q2).abs().max())
        print(f"[vlm_ptq] image-conditioning delta (quantized): {out['delta']:.4f}", flush=True)
    if args.export_path:
        from tensorrt_model_optimizer_tpu_torch.export.hf_export import export_vlm_checkpoint

        hqc = export_vlm_checkpoint(cfg, params, layout, qstate, args.export_path, quant_cfg=args.qformat)
        out["quant_algo"] = hqc["quantization"]["quant_algo"]
        print(f"[vlm_ptq] exported {out['quant_algo']} to {args.export_path}", flush=True)
    return out


if __name__ == "__main__":
    main()
