#!/usr/bin/env python3
"""How random-weight hybrid Mamba2 models respond to PTQ and to bf16 with
depth, in both packages, on the CPU (the reference for chip_smoke's hybrid
bars).

    JAX_PLATFORMS=cpu python tools/torch_hybrid_ptq_depth.py          # the correlation table
    JAX_PLATFORMS=cpu python tools/torch_hybrid_ptq_depth.py --tail   # the bf16 cache gap too

For each block pattern (JAX's test pattern "MM*M-", Nemotron-H-8B's first
5 blocks, blocks 12-16, 12-19, its first 13 and 26, all 52) at a narrow
width (hidden 512, 16 heads of 64, state 64, 8 groups, FFN 1024, vocab
2048; bf16, as chip_smoke's), the port's `mamba.init_params` from a
generator seeded 19 (chip_smoke's init), the same weights given to both
packages: FP8_DEFAULT_CFG and NVFP4_DEFAULT_CFG, max calibration on 2 x
[2, 128], the correlation of the fake-quant logits with the unquantized
ones on another [2, 128] batch (both drawn from that generator). `--tail` adds, at bf16 and
widths 512 and 1024 over all 52 blocks (the port only): prefill 256 tokens
and 4 recurrent steps against the full forward, the last logits' relative
Frobenius and max gaps. Prints one JSON line a row. Imports both packages.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def corr(a, b) -> float:
    return float(np.corrcoef(np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel())[0, 1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tail", action="store_true")
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    import torch

    from _torch_parity import tree_map
    from tensorrt_model_optimizer_tpu.models import mamba as jm
    from tensorrt_model_optimizer_tpu_torch.models import mamba as tm

    jax.config.update("jax_platforms", "cpu")
    full = jm.MambaConfig.nemotron_h_8b().hybrid_pattern
    width = dict(vocab_size=2048, hidden_size=512, mamba_num_heads=16, mamba_head_dim=64, ssm_state_size=64,
                 num_attention_heads=8, num_key_value_heads=2, head_dim=64, intermediate_size=1024)
    for label, pat in (("jax test MM*M-", "MM*M-"), ("first 5", full[:5]), ("blocks 12-16", full[12:17]),
                       ("blocks 12-19", full[12:20]), ("first 13", full[:13]), ("first 26", full[:26]),
                       ("all 52", full)):
        tcfg = tm.MambaConfig.nemotron_h_8b(hybrid_pattern=pat, **width)
        g = torch.Generator().manual_seed(19)
        tp = tm.init_params(tcfg, g, "cpu")
        calib = [torch.randint(0, 2048, (2, 128), generator=g) for _ in range(2)]
        ev = torch.randint(0, 2048, (2, 128), generator=g)
        jcfg = jm.MambaConfig.nemotron_h_8b(hybrid_pattern=pat, dtype=jnp.bfloat16, **width)
        jp = tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tp)
        row = {"pattern": label, "blocks": len(pat)}
        with torch.no_grad():
            tref = tm.forward(tcfg, tp, ev)[0].numpy()
        jref = np.asarray(jm.forward(jcfg, jp, jnp.asarray(ev.numpy()))[0])
        for preset in ("FP8_DEFAULT_CFG", "NVFP4_DEFAULT_CFG"):
            tq = tm.quantize(tcfg, tp, preset, calib, device="cpu")
            jq = jm.quantize(jcfg, jp, preset, [jnp.asarray(b.numpy()) for b in calib])
            with torch.no_grad():
                row[f"port_{preset}"] = corr(tq.forward(ev)[0].numpy(), tref)
            row[f"jax_{preset}"] = corr(np.asarray(jq.forward(jnp.asarray(ev.numpy()))[0]), jref)
        print(json.dumps(row), flush=True)
    if args.tail:
        for h, H in ((512, 16), (1024, 32)):
            cfg = tm.MambaConfig.nemotron_h_8b(vocab_size=2048, hidden_size=h, mamba_num_heads=H, mamba_head_dim=64,
                                               ssm_state_size=64, num_attention_heads=8, num_key_value_heads=2,
                                               head_dim=64, intermediate_size=2 * h)
            g = torch.Generator().manual_seed(19)
            p = tm.init_params(cfg, g, "cpu")
            T = 256
            prompt = torch.randint(0, 2048, (2, T + 4), generator=g)
            with torch.no_grad():
                ref = tm.forward(cfg, p, prompt)[0][:, -1].float()
                c = tm.init_cache(cfg, 2, T + 4, device="cpu")
                _, _, c = tm.forward(cfg, p, prompt[:, :T], cache=c)
                for t in range(T, T + 4):
                    s, _, c = tm.forward(cfg, p, prompt[:, t:t + 1], cache=c)
                s = s[:, -1].float()
            print(json.dumps({"tail_width": h, "blocks": 52, "dtype": "bf16",
                              "frob": float((s - ref).norm() / ref.norm()),
                              "max": float((s - ref).abs().max() / ref.abs().max())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
