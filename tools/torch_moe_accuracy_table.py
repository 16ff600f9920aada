#!/usr/bin/env python
"""Per-preset accuracy table of the PyTorch port on the trained MoE anchor,
beside `tools/moe_accuracy_table.py` (the JAX package's), which it mirrors.

For each preset, quantize `artifacts/anchor-moe` (qwen3_moe, f32) through
`quant.ptq.quantize_family` (max / smoothquant / awq_lite / gptq as the
preset's algorithm says) and report the held-out ppl on eval_batches(4, 8,
128, seed=999), calibrated on eval_batches(4, 8, 128, seed=555): one JSON
line per preset on stdout (presets whose method the family refuses get an
"error" row, as JAX's tool writes them), then the table, which it writes to
`artifacts/moe_accuracy_table_torch.json` only. Runs on the card;
`--device cpu` runs the plain path.

Env: MOE_ANCHOR (artifacts/anchor-moe), MOE_PRESETS (comma list; JAX's 13
by default).
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

ANCHOR = os.environ.get("MOE_ANCHOR", os.path.join(ROOT, "artifacts", "anchor-moe"))
OUT = os.path.join(ROOT, "artifacts", "moe_accuracy_table_torch.json")
PRESETS = os.environ.get(
    "MOE_PRESETS",
    "FP8_DEFAULT_CFG,NVFP4_DEFAULT_CFG,NVFP4_KV_CFG,INT8_DEFAULT_CFG,"
    "INT8_SMOOTHQUANT_CFG,INT4_AWQ_CFG,INT4_GPTQ_CFG,"
    "INT4_BLOCKWISE_WEIGHT_ONLY_CFG,MXFP4_DEFAULT_CFG,MXFP8_DEFAULT_CFG,"
    "W4A8_AWQ_BETA_CFG,NF4_WEIGHT_ONLY_CFG,NVFP4_AWQ_LITE_CFG",
).split(",")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, mixtral
    from tensorrt_model_optimizer_tpu_torch.quant import ptq
    from tensorrt_model_optimizer_tpu_torch.utils import synthlang
    from tensorrt_model_optimizer_tpu_torch.utils.evaluate import perplexity

    dev = resolve_device(args.device)
    cfg, params = hf_loader.load_hf_moe_checkpoint(ANCHOR, dtype=torch.float32, device=dev)
    lang = synthlang.SynthLang(0)
    ev = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(4, 8, 128, seed=999)]
    calib = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(4, 8, 128, seed=555)]
    base = perplexity(cfg, params, ev, forward_fn=mixtral.forward)
    print(f"[moe-table] unquantized ppl {base:.4f}", file=sys.stderr, flush=True)
    rows = []
    for preset in (p.strip() for p in PRESETS):
        try:
            model = ptq.quantize_family("mixtral", cfg, params, preset, calib, device=dev)
            ppl = perplexity(cfg, model.params, ev, layout=model.layout, qstate=model.qstate,
                             forward_fn=mixtral.forward)
            row = {"preset": preset, "ppl": float(ppl), "dppl": float(ppl - base),
                   "rel_pct": 100 * float(ppl - base) / base}
        except NotImplementedError as e:
            row = {"preset": preset, "error": str(e)[:120]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"baseline_ppl": float(base), "rows": rows, "anchor": os.path.relpath(ANCHOR, ROOT), "dtype": "float32",
           "device": str(dev), "card": card}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
