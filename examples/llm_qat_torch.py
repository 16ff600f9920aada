#!/usr/bin/env python
"""QAT example of the PyTorch port, beside `examples/llm_qat.py` and taking
its arguments: calibrate, then train with fake quant active (straight-
through gradients). `--qad` distills from the unquantized teacher while
training (the QADTrainer analog, SGD as JAX's distill step); `--lsq` makes
the int weight and input sites' amax learnable (Adam over params and
quantizer state); `--save_state DIR` writes the mto state (`opt/state.py`),
which either package restores.

  python examples/llm_qat_torch.py --device cpu --qformat NVFP4_DEFAULT_CFG --steps 20
  python examples/llm_qat_torch.py --device cpu --qformat INT8_DEFAULT_CFG --lsq --save_state /tmp/qat

Runs on the card unless `--device cpu`; `main(argv)` returns {"losses",
"model"} (the QuantizedModel after training).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--qformat", default="NVFP4_DEFAULT_CFG")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--qad", action="store_true", help="distill from the unquantized teacher")
    ap.add_argument("--lsq", action="store_true", help="learn amax (LSQ)")
    ap.add_argument("--save_state", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, llama
    from tensorrt_model_optimizer_tpu_torch.quant import qat
    from tensorrt_model_optimizer_tpu_torch.quant.config import QuantizeConfig, get_preset
    from tensorrt_model_optimizer_tpu_torch.utils import dataset

    dev = resolve_device(args.device)
    if args.model == "tiny":
        cfg = llama.LlamaConfig.tiny(num_hidden_layers=2)
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        cfg, params = hf_loader.load_hf_checkpoint(args.model, device=dev)
    batches = [torch.from_numpy(b).to(dev) for b in dataset.get_calib_batches(cfg.vocab_size, num_batches=4,
                                                                               seq_len=64)]
    qcfg = get_preset(args.qformat)
    if args.lsq:
        qcfg = QuantizeConfig(rules=tuple((p, c.replace(learn_amax=True) if (c.enable and not c.is_fp
                                                                             and not c.dynamic) else c)
                                          for p, c in qcfg.rules), algorithm=qcfg.algorithm)
    layout = llama.build_layout(cfg, qcfg)
    qs = llama.init_quant_state(cfg, layout, dev)
    with torch.no_grad():
        for b in batches:
            _, qs, _ = llama.forward(cfg, params, b, layout=layout, qstate=qs, calib=True)
    print("[llm_qat] calibrated", flush=True)

    losses = []
    if args.qad:
        from tensorrt_model_optimizer_tpu_torch.distill import distillation

        step = distillation.make_distill_step(cfg, lr=args.lr, layout=layout)
        teacher = params
        for i in range(args.steps):
            params, loss = step(params, teacher, batches[i % len(batches)], qs)
            losses.append(float(loss))
            if i % 5 == 0:
                print(f"[llm_qat] QAD step {i} loss {losses[-1]:.4f}", flush=True)
    else:
        step_fn, init_fn = qat.make_optax_train_step(cfg, layout, qat.Adam(args.lr), train_amax=args.lsq)
        opt_state = init_fn(params, qs)
        for i in range(args.steps):
            params, qs, opt_state, loss = step_fn(params, qs, opt_state, batches[i % len(batches)])
            losses.append(float(loss))
            if i % 5 == 0:
                print(f"[llm_qat] step {i} loss {losses[-1]:.4f}", flush=True)

    from tensorrt_model_optimizer_tpu_torch.quant.ptq import QuantizedModel

    model = QuantizedModel(cfg, params, layout, qs, qcfg)
    if args.save_state:
        from tensorrt_model_optimizer_tpu_torch.opt import state as opt_state_mod

        opt_state_mod.save(model, args.save_state)
        print(f"[llm_qat] saved to {args.save_state}", flush=True)
    print("[llm_qat] done", flush=True)
    return {"losses": losses, "model": model}


if __name__ == "__main__":
    main()
    sys.exit(0)
