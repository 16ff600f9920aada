#!/usr/bin/env python
"""Accuracy evaluation CLI of the PyTorch port, beside `examples/llm_eval.py`
and taking its arguments: perplexity (and k-shot MMLU from a local data
dir) of a model, before and after quantization with a preset.

  python examples/llm_eval_torch.py --device cpu --qformat NVFP4_DEFAULT_CFG
  python examples/llm_eval_torch.py --model /ckpts/llama3-8b --mmlu_dir /data/mmlu

MMLU needs the model's own tokenizer (transformers' AutoTokenizer from
--model, as JAX's example loads it). Runs on the card unless `--device
cpu`; `main(argv)` returns {"ppl", "ppl_q"?, "mmlu"?}.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--qformat", default=None)
    ap.add_argument("--calib_batches", type=int, default=4)
    ap.add_argument("--eval_batches", type=int, default=4)
    ap.add_argument("--seq_len", type=int, default=64)
    ap.add_argument("--mmlu_dir", default=None, help="local MMLU csv dir")
    ap.add_argument("--mmlu_subjects", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, llama
    from tensorrt_model_optimizer_tpu_torch.utils import dataset, evaluate

    dev = resolve_device(args.device)
    if args.model == "tiny":
        cfg = llama.LlamaConfig.tiny(num_hidden_layers=2)
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        cfg, params = hf_loader.load_hf_checkpoint(args.model, device=dev)
    batches = [torch.from_numpy(b).to(dev) for b in dataset.get_calib_batches(
        cfg.vocab_size, num_batches=args.calib_batches + args.eval_batches,
        seq_len=min(args.seq_len, cfg.max_position_embeddings))]
    calib, ev = batches[: args.calib_batches], batches[args.calib_batches:]

    out = {}
    t0 = time.time()
    out["ppl"] = evaluate.perplexity(cfg, params, ev)
    print(f"[llm_eval] bf16 ppl {out['ppl']:.3f} ({time.time() - t0:.1f}s)", flush=True)

    layout = qstate = adapters = None
    if args.qformat:
        from tensorrt_model_optimizer_tpu_torch.quant import ptq

        model = ptq.quantize(cfg, params, args.qformat, calib, device=dev)
        params, layout, qstate, adapters = model.params, model.layout, model.qstate, model.adapters
        out["ppl_q"] = evaluate.perplexity(cfg, params, ev, layout=layout, qstate=qstate, adapters=adapters)
        print(f"[llm_eval] {args.qformat} ppl {out['ppl_q']:.3f} (delta {out['ppl_q'] - out['ppl']:+.3f})",
              flush=True)

    if args.mmlu_dir:
        from tensorrt_model_optimizer_tpu_torch.utils import mmlu

        from transformers import AutoTokenizer  # a real tokenizer; tiny random models cannot take MMLU

        tok = AutoTokenizer.from_pretrained(args.model)
        ans_ids = tuple(tok.encode(f" {c}", add_special_tokens=False)[-1] for c in "ABCD")

        def logits_fn(t):
            with torch.no_grad():
                return llama.forward(cfg, params, torch.from_numpy(t).to(dev), layout=layout, qstate=qstate,
                                     adapters=adapters)[0]

        res = mmlu.mmlu_eval(logits_fn, tok.encode, ans_ids, args.mmlu_dir,
                             subjects=mmlu.list_subjects(args.mmlu_dir)[: args.mmlu_subjects])
        out["mmlu"] = res["accuracy"]
        print(f"[llm_eval] MMLU 5-shot: {res['accuracy']:.2%} (n={res['n']})", flush=True)
    print("[llm_eval] done", flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
