#!/usr/bin/env python
"""Prune-then-distill example of the PyTorch port (the Minitron flow),
beside `examples/prune_distill.py` and taking its arguments: importance
scores, a width / depth prune, then knowledge-distillation healing from the
unpruned teacher (`distillation.make_distill_step(teacher_cfg=...)`).

  python examples/prune_distill_torch.py --device cpu --ffn_ratio 0.5 --hidden_ratio 0.75

Runs on the card unless `--device cpu`; `main(argv)` returns {"ppl_teacher",
"ppl_pruned", "ppl_healed", "losses", "cfg", "params", "plan"}.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--ffn_ratio", type=float, default=0.5)
    ap.add_argument("--hidden_ratio", type=float, default=0.75)
    ap.add_argument("--distill_steps", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device
    from tensorrt_model_optimizer_tpu_torch.distill import distillation
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, llama
    from tensorrt_model_optimizer_tpu_torch.prune import minitron
    from tensorrt_model_optimizer_tpu_torch.utils import dataset, evaluate

    dev = resolve_device(args.device)
    if args.model == "tiny":
        cfg = llama.LlamaConfig.tiny(num_hidden_layers=2)
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        cfg, params = hf_loader.load_hf_checkpoint(args.model, device=dev)
    batches = [torch.from_numpy(b).to(dev) for b in dataset.get_calib_batches(cfg.vocab_size, num_batches=4,
                                                                               seq_len=64)]

    scores = minitron.importance(cfg, params, batches)
    new_I = int(cfg.intermediate_size * args.ffn_ratio)
    new_H = int(cfg.hidden_size * args.hidden_ratio) // cfg.hd * cfg.hd or cfg.hd
    new_cfg, new_params, plan = minitron.prune(cfg, params, scores, intermediate_size=new_I, hidden_size=new_H)
    print(f"[prune_distill] pruned to I={new_I} H={new_H}", flush=True)
    ppl_t = evaluate.perplexity(cfg, params, batches[:2])
    ppl_p = evaluate.perplexity(new_cfg, new_params, batches[:2])
    print(f"[prune_distill] teacher ppl {ppl_t:.3f}, pruned ppl {ppl_p:.3f}", flush=True)

    step = distillation.make_distill_step(new_cfg, lr=5e-3, teacher_cfg=cfg)
    student, losses = new_params, []
    for i in range(args.distill_steps):
        student, loss = step(student, params, batches[i % len(batches)])
        losses.append(float(loss))
        if i % 5 == 0:
            print(f"[prune_distill] distill step {i} loss {losses[-1]:.4f}", flush=True)
    ppl_d = evaluate.perplexity(new_cfg, student, batches[:2])
    print(f"[prune_distill] healed ppl {ppl_d:.3f}", flush=True)
    return {"ppl_teacher": ppl_t, "ppl_pruned": ppl_p, "ppl_healed": ppl_d, "losses": losses, "cfg": new_cfg,
            "params": student, "plan": plan}


if __name__ == "__main__":
    main()
    sys.exit(0)
