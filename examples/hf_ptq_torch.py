#!/usr/bin/env python
"""End-to-end PTQ CLI of the PyTorch port, beside `examples/hf_ptq.py` (the
reference's `examples/hf_ptq/hf_ptq.py`) and taking its arguments.

Load an HF checkpoint of a registered family (`models/registry.py`: Llama,
Qwen2 / Qwen3, Mistral through `quant.ptq.quantize`; Mixtral, Qwen3-MoE,
DBRX, GPT-OSS and Llama4 through `quant.ptq.quantize_family`), or a seeded
random tiny model, quantize it with a preset or a recipe on calibration
data, report perplexity before and after, and export a unified quantized HF
checkpoint (GPT-OSS: its native MXFP4 format, under an MXFP4 preset; a
Llama4 model's shared expert has no name in the unified checkpoint, so its
export raises, as JAX's does). Runs on the card unless `--device cpu`.

Examples:
  python examples/hf_ptq_torch.py --device cpu --model tiny \\
      --qformat NVFP4_DEFAULT_CFG --export_path /tmp/tiny_nvfp4
  python examples/hf_ptq_torch.py --model artifacts/anchor-llama \\
      --recipe w4a8_awq.yaml --export_path /tmp/anchor_w4a8
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny", help="'tiny' or an HF checkpoint dir")
    ap.add_argument("--qformat", default="FP8_DEFAULT_CFG")
    ap.add_argument("--recipe", default=None, help="YAML recipe (builtin name or path); overrides --qformat")
    ap.add_argument("--override", action="append", default=[],
                    help="dotlist recipe overrides, e.g. calib.num_batches=2")
    ap.add_argument("--calib_data", default=None, help="tokens .npy/.bin or text file")
    ap.add_argument("--tokenizer", default=None, help="tokenizer dir for text data")
    ap.add_argument("--calib_batches", type=int, default=8)
    ap.add_argument("--calib_seq_len", type=int, default=512)
    ap.add_argument("--batch_size", default="2",
                    help="calibration batch size, or 'auto': the largest power of two whose forward fits")
    ap.add_argument("--export_path", default=None)
    ap.add_argument("--save_state", default=None, help="dir for the mto-style state (`opt/state.save`)")
    ap.add_argument("--eval_ppl", action="store_true", default=True)
    ap.add_argument("--auto_quantize_bits", type=float, default=None,
                    help="AutoQuantize with this effective-bits budget: --qformat against FP8_DEFAULT_CFG")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the CLI; returns {"preset", "ppl_before", "ppl_after",
    "quant_algo" (with --export_path), "model" (the QuantizedModel)}, or
    with --auto_quantize_bits {"preset", "ppl_before", "auto_quantize_bits",
    "mixed_logits_finite"}."""
    args = parse_args(argv)
    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, llama
    from tensorrt_model_optimizer_tpu_torch.quant import ptq
    from tensorrt_model_optimizer_tpu_torch.utils import dataset, evaluate

    dev = resolve_device(args.device)
    qformat, label = args.qformat, args.qformat
    if args.recipe:
        from tensorrt_model_optimizer_tpu_torch.recipes import loader as recipe_loader

        recipe = recipe_loader.load_recipe(args.recipe, args.override)
        qformat = recipe.resolve_quant_config()
        label = recipe.quant.preset
        args.calib_batches = recipe.calib.num_batches
        args.batch_size = recipe.calib.batch_size
        args.calib_seq_len = recipe.calib.seq_len
        args.export_path = args.export_path or recipe.export_path
        args.save_state = args.save_state or recipe.save_state
        print(f"[hf_ptq] recipe {args.recipe} -> preset {recipe.quant.preset}", flush=True)

    t0 = time.time()
    family = None  # None: the llama family (every calibration algorithm)
    if args.model == "tiny":
        cfg = llama.LlamaConfig.tiny(num_hidden_layers=4)
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        from tensorrt_model_optimizer_tpu_torch.models import registry

        with open(os.path.join(args.model, "config.json")) as f:
            mt = json.load(f).get("model_type", "llama")
        fam = registry.for_hf_model_type(mt)
        if fam.name == "llama":
            cfg, params = hf_loader.load_hf_checkpoint(args.model, device=dev)
        else:
            cfg, params = hf_loader.load_hf_moe_checkpoint(args.model, device=dev)
            family = fam
    print(f"[hf_ptq] model loaded in {time.time() - t0:.1f}s: {cfg.num_hidden_layers}L x "
          f"{cfg.hidden_size}h on {dev}" + (f" ({family.name})" if family else ""), flush=True)
    fwd = family.forward if family else llama.forward

    seq = min(args.calib_seq_len, cfg.max_position_embeddings)
    if str(args.batch_size) == "auto":
        args.batch_size = dataset.get_max_batch_size(lambda t: fwd(cfg, params, t)[0], seq_len=seq,
                                                     vocab_size=cfg.vocab_size, start=2, cap=64, device=dev)
        print(f"[hf_ptq] auto batch_size -> {args.batch_size} (OOM-probed at seq {seq})", flush=True)
    else:
        args.batch_size = int(args.batch_size)
    batches = [torch.from_numpy(b).to(dev) for b in dataset.get_calib_batches(
        cfg.vocab_size, args.calib_data, args.tokenizer, args.calib_batches, args.batch_size, seq)]

    out = {"preset": label}
    if args.eval_ppl:
        out["ppl_before"] = evaluate.perplexity(cfg, params, batches[:4], forward_fn=family and family.forward)
        print(f"[hf_ptq] bf16 ppl {out['ppl_before']:.6f}", flush=True)

    if args.auto_quantize_bits:
        return _auto_quantize(args, cfg, params, qformat, batches, family, out)

    t0 = time.time()
    if family is None:
        model = ptq.quantize(cfg, params, qformat, batches, device=dev)
    else:
        model = ptq.quantize_family(family, cfg, params, qformat, batches, device=dev)
    print(f"[hf_ptq] quantized ({args.recipe or args.qformat}) in {time.time() - t0:.1f}s", flush=True)
    if args.eval_ppl:
        out["ppl_after"] = evaluate.perplexity(cfg, model.params, batches[:4], layout=model.layout,
                                               qstate=model.qstate, adapters=model.adapters,
                                               forward_fn=model.forward_fn)
        print(f"[hf_ptq] quantized ppl {out['ppl_after']:.6f} "
              f"(delta {out['ppl_after'] - out['ppl_before']:+.6f})", flush=True)

    if args.save_state:
        from tensorrt_model_optimizer_tpu_torch.opt import state as opt_state

        opt_state.save(model, args.save_state)
        print(f"[hf_ptq] modelopt state saved to {args.save_state}", flush=True)

    if args.export_path:
        from tensorrt_model_optimizer_tpu_torch.export import hf_export

        qc = hf_export.export_hf_checkpoint(model, args.export_path)
        out["quant_algo"] = qc["quantization"]["quant_algo"]
        print(f"[hf_ptq] exported {out['quant_algo']} checkpoint to {args.export_path}", flush=True)
    out["model"] = model
    return out


def _auto_quantize(args, cfg, params, qformat, batches, family, out: dict) -> dict:
    """--auto_quantize_bits: `qformat` against FP8_DEFAULT_CFG per (layer,
    group) under the budget (`auto_quantize_moe` for an MoE family), then
    the mixed-precision forward; adds "auto_quantize_bits" (achieved) and,
    for Llama, "mixed_logits_finite"."""
    import torch

    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.quant import auto

    t0 = time.time()
    if family is not None:
        res = auto.auto_quantize_moe(cfg, params, [qformat, "FP8_DEFAULT_CFG"], batches,
                                     effective_bits=args.auto_quantize_bits, forward_fn=family.forward)
        print(f"[hf_ptq] auto_quantize_moe achieved {res.effective_bits:.2f} effective bits in "
              f"{time.time() - t0:.1f}s", flush=True)
        out["auto_quantize_bits"] = res.effective_bits
        return out
    res = auto.auto_quantize(cfg, params, [qformat, "FP8_DEFAULT_CFG"], batches,
                             effective_bits=args.auto_quantize_bits)
    print(f"[hf_ptq] auto_quantize achieved {res.effective_bits:.2f} effective bits in {time.time() - t0:.1f}s",
          flush=True)
    with torch.no_grad():
        logits, _ = llama.forward_unrolled(cfg, params, batches[0], res.layer_layouts, res.qstate_list)
    out["auto_quantize_bits"] = res.effective_bits
    out["mixed_logits_finite"] = bool(torch.isfinite(logits).all())
    print("[hf_ptq] mixed-precision forward OK", flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
