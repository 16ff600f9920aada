#!/usr/bin/env python
"""Speculative decoding with the PyTorch port, beside
`examples/speculative_decoding.py` and taking its arguments.

Trains a draft (Medusa heads, EAGLE TTT or a DFlash block) on a seeded tiny
model and measures acceptance with the matching verifier: the chain
verifier, the tree verifier (`--tree`: one forward verifies the whole
candidate tree), or tree verification inside the serving engine
(`--engine`: FP8_DEFAULT_CFG, the einsum engine). Runs on the card, in bf16,
unless `--device cpu` (f32, as JAX's example).

  python examples/speculative_decoding_torch.py --mode medusa --tree
  python examples/speculative_decoding_torch.py --mode medusa --engine
  python examples/speculative_decoding_torch.py --mode eagle --device cpu
  python examples/speculative_decoding_torch.py --mode dflash
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["medusa", "eagle", "dflash"], default="medusa")
    ap.add_argument("--tree", action="store_true", help="tree verification (medusa)")
    ap.add_argument("--engine", action="store_true", help="run tree verification inside the serving engine")
    ap.add_argument("--train_steps", type=int, default=30)
    ap.add_argument("--decode_steps", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the demo; returns {"mode", "loss", and "acceptance" where the
    mode verifies, "accs" for EAGLE's per-step accuracies, "tokens"}."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device
    from tensorrt_model_optimizer_tpu_torch.models import llama

    dev = resolve_device(args.device)
    # the card's GEMM kernels take bf16 activations; the CPU runs JAX's f32
    cfg = llama.LlamaConfig.tiny(num_hidden_layers=2, dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))).to(dev)
    prompt = data[:1, :8]
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    result = {"mode": args.mode}

    if args.mode == "medusa":
        from tensorrt_model_optimizer_tpu_torch.speculative import medusa as M

        draft = M.init_medusa(cfg, M.MedusaConfig(num_heads=3), gen, device=dev)
        step = M.make_medusa_train_step(cfg)
        loss = None
        for _ in range(args.train_steps):
            draft, loss = step(draft, params, data)
        result["loss"] = None if loss is None else float(loss)
        print(f"[specdec] medusa trained {args.train_steps} steps (loss {result['loss']}) "
              f"in {time.time() - t0:.1f}s", flush=True)
        if args.engine:
            from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq
            from tensorrt_model_optimizer_tpu_torch.serve import engine as se

            cm = compress.compress(ptq.quantize(cfg, params, "FP8_DEFAULT_CFG", [data], device=dev))
            eng = se.Engine(cm, se.EngineConfig(max_seq_len=64), device=dev)
            out, rate = eng.generate_speculative(prompt, draft, max_new_tokens=args.decode_steps)
            print(f"[specdec] ENGINE tree-spec: {len(out)} tokens, acceptance {rate:.2%}", flush=True)
        elif args.tree:
            from tensorrt_model_optimizer_tpu_torch.speculative import tree as T

            out, rate = T.tree_propose_and_verify(cfg, params, draft, prompt, steps=args.decode_steps)
            print(f"[specdec] TREE verify: {out.shape[1] - prompt.shape[1]} tokens, acceptance {rate:.2%}",
                  flush=True)
        else:
            out, rate = M.propose_and_verify(cfg, params, draft, prompt, steps=args.decode_steps)
            print(f"[specdec] chain verify: acceptance {rate:.2%}", flush=True)
        result.update(acceptance=rate, tokens=out if isinstance(out, list) else out[0].tolist())
    elif args.mode == "eagle":
        from tensorrt_model_optimizer_tpu_torch.speculative import eagle as E

        draft = E.init_eagle(cfg, E.EagleConfig(), gen, device=dev)
        step = E.make_eagle_ttt_train_step(cfg, ttt_steps=2)
        loss = accs = None
        for _ in range(args.train_steps):
            draft, loss, accs = step(draft, params, data)
        result.update(loss=None if loss is None else float(loss), accs=None if accs is None else accs.tolist())
        print(f"[specdec] eagle TTT trained: loss {result['loss']}, per-step acc {result['accs']}", flush=True)
    else:
        from tensorrt_model_optimizer_tpu_torch.speculative import dflash as DF

        dcfg = DF.DFlashConfig(block_size=3)
        draft = DF.init_dflash(cfg, dcfg, gen, device=dev)
        step = DF.make_dflash_train_step(cfg, dcfg)
        loss = None
        for _ in range(args.train_steps):
            draft, loss = step(draft, params, data)
        out, rate = DF.propose_and_verify(cfg, params, draft, prompt, steps=args.decode_steps)
        result.update(loss=None if loss is None else float(loss), acceptance=rate, tokens=out[0].tolist())
        print(f"[specdec] dflash: loss {result['loss']}, acceptance {rate:.2%}", flush=True)
    print("[specdec] done", flush=True)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
