#!/usr/bin/env python
"""Per-preset accuracy table of the PyTorch port on the trained anchor,
beside `tools/accuracy_table.py` (the JAX package's), which it mirrors.

For every preset in the port's `PRESETS` (all 25 of JAX's), PTQ the trained
synthetic-language anchor (`artifacts/anchor-llama`, f32) and measure

  ppl         held-out perplexity, eval_batches(4, 8, 256, seed=999)
  d_ppl       ppl - the unquantized model's ppl
  kl          mean logit KL(unquantized || quantized) over the same tokens
  mmlu        synthlang MMLU (5 subjects x ACC_MMLU_N questions, k = 3)
  mmlu_ci95   its 95% binomial half-width
  d_mmlu_pct  accuracy drop against the unquantized model, in points

on the calibration batches eval_batches(8, 4, 256, seed=555), as JAX's tool
does. JAX's QAT-recovery row needs `quant/qat.py` (ROADMAP queue 1 item 8):
it is recorded as null with that reason.

Prints the table's JSON and writes it to `artifacts/accuracy_table_torch.json`
(never `artifacts/accuracy_table.json` or `ACCURACY.md`, JAX's records).
Runs on the card; `--device cpu` runs the plain path.

Env: ACC_PRESETS=comma,list (default all), ACC_MMLU_N (questions a subject,
default 120), ANCHOR_OUT (default artifacts/anchor-llama).
"""

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

ANCHOR = os.environ.get("ANCHOR_OUT", os.path.join(ROOT, "artifacts", "anchor-llama"))
MMLU_N = int(os.environ.get("ACC_MMLU_N", "120"))
OUT = os.path.join(ROOT, "artifacts", "accuracy_table_torch.json")
MMLU_BATCH = 8  # prompts a forward (right-padded; the causal mask keeps each prompt's logits)


def log(m):
    print(f"[acc] {m}", file=sys.stderr, flush=True)


def score(fwd, eval_batches, data_dir, ref_logits=None, mmlu_n=MMLU_N, eval_logits=None):
    """{"ppl", "kl"?, "mmlu", "mmlu_n", "mmlu_ci95", "mmlu_subjects",
    "choices"} of a tokens -> logits function (JAX's tool's `evaluate`);
    `eval_logits`, where given, are fwd's logits of the eval batches."""
    import torch

    from tensorrt_model_optimizer_tpu_torch.utils import evaluate, mmlu, synthlang

    tot_nll, n_tok, kls = 0.0, 0, []
    for i, b in enumerate(eval_batches):
        logits = fwd(b[:, :-1]) if eval_logits is None else eval_logits[i]
        tot_nll += float(evaluate._nll_sum(logits, b[:, 1:]))
        n_tok += b[:, 1:].numel()
        if ref_logits is not None:
            kls.append(float(evaluate._kl_sum(ref_logits[i], logits)) / (b.shape[0] * (b.shape[1] - 1)))
    dev = eval_batches[0].device
    res = mmlu.mmlu_eval(lambda t: fwd(torch.from_numpy(t).to(dev)), synthlang.encode, synthlang.ANSWER_TOKEN_IDS,
                         data_dir, k_shot=3, max_questions_per_subject=mmlu_n, batch=MMLU_BATCH)
    p, n = res["accuracy"], res["n"]
    out = {"ppl": float(np.exp(tot_nll / n_tok)), "mmlu": p, "mmlu_n": n,
           "mmlu_ci95": round(1.96 * math.sqrt(max(p * (1.0 - p), 1e-9) / max(n, 1)), 4),
           "mmlu_subjects": res["per_subject"], "choices": res["choices"]}
    if kls:
        out["kl"] = float(np.mean(kls))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    import torch

    from tensorrt_model_optimizer_tpu_torch import resolve_device
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, llama
    from tensorrt_model_optimizer_tpu_torch.quant import ptq
    from tensorrt_model_optimizer_tpu_torch.quant.config import PRESETS
    from tensorrt_model_optimizer_tpu_torch.utils import synthlang

    dev = resolve_device(args.device)
    cfg, params = hf_loader.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device=dev)
    lang = synthlang.SynthLang(0)
    eval_batches = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(4, 8, 256, seed=999)]
    calib = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(8, 4, 256, seed=555)]
    data_dir = lang.write_mmlu_data(tempfile.mkdtemp(prefix="accmmlu"), n_test=MMLU_N)
    names = os.environ["ACC_PRESETS"].split(",") if os.environ.get("ACC_PRESETS") else list(PRESETS)

    def bf16_fwd(tokens):
        return llama.forward(cfg, params, tokens)[0]

    with torch.no_grad():
        ref_logits = [bf16_fwd(b[:, :-1]) for b in eval_batches]
        base = score(bf16_fwd, eval_batches, data_dir, eval_logits=ref_logits)
    log(f"bf16: ppl {base['ppl']:.4f} mmlu {base['mmlu']:.3f} +/-{base['mmlu_ci95']:.3f}")
    rows = {}
    for name in names:
        t0 = time.time()
        model = ptq.quantize(cfg, params, name, calib, device=dev)
        with torch.no_grad():
            r = score(lambda t, m=model: m.forward(t)[0], eval_batches, data_dir, ref_logits)
        r["d_ppl"] = r["ppl"] - base["ppl"]
        r["d_mmlu_pct"] = (base["mmlu"] - r["mmlu"]) * 100.0
        r["calib_s"] = round(time.time() - t0, 1)
        r.pop("choices")
        rows[name] = r
        log(f"{name}: ppl {r['ppl']:.4f} (d {r['d_ppl']:+.4f}) kl {r['kl']:.5f} mmlu {r['mmlu']:.3f}")
        del model
    base.pop("choices")
    card = None
    if dev.type == "cuda":
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"bf16": base, "presets": rows,
           "qat_recovery": None,
           "qat_recovery_reason": "needs quant/qat.py, the training-side slice (ROADMAP queue 1 item 8)",
           "anchor": os.path.relpath(ANCHOR, ROOT), "mmlu_n_per_subject": MMLU_N, "dtype": "float32",
           "device": str(dev), "card": card}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
