#!/usr/bin/env python
"""Diffusion PTQ example of the PyTorch port, beside
`examples/diffusion_ptq.py` and taking its arguments: quantize a DiT or a
UNet with a preset, report the quantized model's output correlation with
the unquantized one, and sample a few DDIM steps through it. For the DiT it
also packs the block weights (`compress_dit`) and runs the real-quant
denoise step on the weight-only GEMM kernels (`forward_packed`; bf16 on the
card, which the kernels take, f32 on the CPU); `--dmd` runs one DMD2
student loss and its gradient.

  python examples/diffusion_ptq_torch.py --device cpu --backbone dit --qformat NVFP4_DEFAULT_CFG --dmd

Runs on the card unless `--device cpu`; `main(argv)` returns {"corr",
"finite", "packed_rel" (DiT), "dmd" (with --dmd)}. The zero-initialised
output layer (`final_proj`, `conv_out`) is drawn at random, as the JAX
example does, so the comparison has something to compare.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _corr(a, b) -> float:
    import numpy as np

    return float(np.corrcoef(a.float().cpu().numpy().ravel(), b.float().cpu().numpy().ravel())[0, 1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", choices=["dit", "unet"], default="unet")
    ap.add_argument("--qformat", default="FP8_DEFAULT_CFG")
    ap.add_argument("--steps", type=int, default=4, help="DDIM sample steps")
    ap.add_argument("--dmd", action="store_true", help="run one DMD2 student loss (DiT)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    t0 = time.time()
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    out: dict = {}
    t = torch.tensor([100, 700], dtype=torch.int32, device=dev)
    if args.backbone == "dit":
        from tensorrt_model_optimizer_tpu_torch.models import dit as M

        cfg = M.DiTConfig.tiny(dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
        params = M.init_params(cfg, g, device=dev)
        params["final_proj"] = (torch.randn(params["final_proj"].shape, generator=g, device=dev) * 0.1).to(cfg.dtype)
        x = torch.from_numpy(rng.normal(size=(2, cfg.img_size, cfg.img_size, cfg.in_channels))
                             .astype(np.float32)).to(dev)
        layout, qstate = M.quantize_dit(cfg, params, args.qformat, [(x, t)])
        ref, _ = M.forward(cfg, params, x, t)
        fq, _ = M.forward(cfg, params, x, t, layout=layout, qstate=qstate)
        kinds, packed = M.serving_layouts(*M.compress_dit(cfg, params, layout, qstate))
        served = M.forward_packed(cfg, params, kinds, packed, x, t, layout=layout, qstate=qstate)
        out["packed_rel"] = float((served.float() - fq.float()).abs().max() / fq.float().abs().max())
        print(f"[diffusion_ptq] real-quant step on {sorted(set(kinds.values()))}: max gap to the fake-quant "
              f"model {out['packed_rel']:.4f} of its scale", flush=True)
    else:
        from tensorrt_model_optimizer_tpu_torch.models import unet as M

        cfg = M.UNetConfig.tiny()
        params = M.init_params(cfg, g, device=dev)
        params["conv_out"] = torch.randn(params["conv_out"].shape, generator=g, device=dev) * 0.1
        x = torch.from_numpy(rng.normal(size=(2, 8, 8, cfg.in_channels)).astype(np.float32)).to(dev)
        layout, qstate = M.quantize_unet(cfg, params, args.qformat, [(x, t)])
        ref, _ = M.forward(cfg, params, x, t)
        fq, _ = M.forward(cfg, params, x, t, layout=layout, qstate=qstate)
    out["corr"] = _corr(fq, ref)
    print(f"[diffusion_ptq] {args.backbone} quantized ({args.qformat}) in {time.time() - t0:.1f}s, "
          f"corr={out['corr']:.4f}", flush=True)

    h = x
    with torch.no_grad():
        for ti in np.linspace(900, 0, args.steps).astype(int):
            eps, _ = M.forward(cfg, params, h, torch.full((h.shape[0],), int(ti), dtype=torch.int32, device=dev),
                               layout=layout, qstate=qstate)
            h = h - 0.1 * eps
    out["finite"] = bool(torch.isfinite(h).all())
    print(f"[diffusion_ptq] {args.steps}-step DDIM sample finite: {out['finite']}", flush=True)

    if args.dmd and args.backbone == "dit":
        from tensorrt_model_optimizer_tpu_torch.fastgen import dmd as D
        from tensorrt_model_optimizer_tpu_torch.quant import qat

        f32 = M.DiTConfig.tiny()  # trained in f32: SGD in bf16 underflows
        student, fake = M.init_params(f32, g, device=dev), M.init_params(f32, g, device=dev)
        teacher = {k: (v.float() if isinstance(v, torch.Tensor) else {n: w.float() for n, w in v.items()})
                   for k, v in params.items()}
        disc = D.init_discriminator(f32, D.DiscriminatorConfig(), g, device=dev)
        noise = torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(dev)
        sl, _, _ = D.make_dmd_losses(f32, D.DMDConfig(gan_loss_weight_gen=1e-2))
        draws = D.draw(noise, g)
        parts = {}

        def loss(s):
            total, p = sl(s, teacher, fake, disc, noise, draws)
            parts.update(p)
            return total

        total, _ = qat.value_and_grad(loss, student)
        out["dmd"] = {k: float(v) for k, v in parts.items()}
        print(f"[diffusion_ptq] DMD student loss {float(total):.4f} (vsd {out['dmd']['vsd']:.4f}, "
              f"gan {out['dmd']['gan_gen']:.4f})", flush=True)
    print("[diffusion_ptq] done", flush=True)
    return out


if __name__ == "__main__":
    main()
