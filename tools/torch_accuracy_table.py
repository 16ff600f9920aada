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
does. Then JAX's QAT-recovery row: where the worst preset's d_ppl exceeds
0.005, that preset is trained by JAX's recipe (`QAT_RECIPE`, `qat_recover`:
600 Adam(2e-4) steps of 8 x 129 tokens from the stream of seed 123, the
windows drawn by numpy's default_rng(5)) and scored again; else the row is
null with the reason.

Prints the table's JSON and writes it to `artifacts/accuracy_table_torch.json`
(never `artifacts/accuracy_table.json` or `ACCURACY.md`, JAX's records).
Runs on the card; `--device cpu` runs the plain path.

Env: ACC_PRESETS=comma,list (default all), ACC_MMLU_N (questions a subject,
default 120), ACC_QAT=0 (skip the QAT row; default on, as JAX's),
ANCHOR_OUT (default artifacts/anchor-llama).
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
QAT = os.environ.get("ACC_QAT", "1") == "1"
# JAX's tools/accuracy_table.py QAT recovery: steps, batch, tokens a row,
# Adam's lr, the token stream's seed and its length, the window draws' seed
QAT_RECIPE = dict(steps=600, batch=8, seq=129, lr=2e-4, stream_seed=123, stream_tokens=600 * 8 * 129, rng_seed=5)
QAT_MIN_D_PPL = 0.005  # JAX's: the worst preset is trained only past this


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


def qat_recover(model, device, steps=QAT_RECIPE["steps"]):
    """JAX's QAT-recovery recipe on the port: `steps` Adam steps
    (make_optax_train_step, the quantizer state frozen) of a calibrated
    QuantizedModel on windows of the synthetic language's stream. Returns
    (the trained QuantizedModel, the step losses as floats); `model` is left
    as it was."""
    import dataclasses

    import torch

    from tensorrt_model_optimizer_tpu_torch.quant import qat

    step_fn, init_fn = qat.make_optax_train_step(model.model_cfg, model.layout, qat.Adam(QAT_RECIPE["lr"]))
    p, qs = model.params, model.qstate
    opt = init_fn(p, qs)
    losses = []
    for window in qat_windows(steps):
        p, qs, opt, loss = step_fn(p, qs, opt, torch.from_numpy(window).to(device=device, dtype=torch.int64))
        losses.append(loss)
    return dataclasses.replace(model, params=p, qstate=qs), [float(v) for v in losses]


def qat_windows(steps: int):
    """The recipe's token batches, [batch, seq] int32 each, as JAX's tool
    draws them."""
    from tensorrt_model_optimizer_tpu_torch.utils import synthlang

    r = QAT_RECIPE
    stream = synthlang.SynthLang(0).token_stream(r["stream_tokens"], seed=r["stream_seed"])
    rng = np.random.default_rng(r["rng_seed"])
    for _ in range(steps):
        starts = rng.integers(0, stream.size - (r["seq"] + 1), size=r["batch"])
        yield np.stack([stream[s:s + r["seq"]] for s in starts])


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
    qat_row, qat_reason = None, "ACC_QAT=0"
    worst = max((n for n, r in rows.items() if "d_ppl" in r), key=lambda n: rows[n]["d_ppl"], default=None)
    if QAT and worst is not None and rows[worst]["d_ppl"] > QAT_MIN_D_PPL:
        log(f"QAT recovery on worst preset: {worst} (d_ppl {rows[worst]['d_ppl']:.4f})")
        t0 = time.time()
        model, losses = qat_recover(ptq.quantize(cfg, params, worst, calib, device=dev), dev)
        with torch.no_grad():
            qat_row = score(lambda t: model.forward(t)[0], eval_batches, data_dir, ref_logits)
        qat_row.pop("choices")
        qat_row.update(preset=worst, d_ppl=qat_row["ppl"] - base["ppl"],
                       d_mmlu_pct=(base["mmlu"] - qat_row["mmlu"]) * 100.0, qat_s=round(time.time() - t0, 1),
                       first_loss=losses[0], last_loss=losses[-1])
        qat_reason = None
        log(f"{worst}+QAT: ppl {qat_row['ppl']:.4f} mmlu {qat_row['mmlu']:.3f}")
    elif QAT:
        qat_reason = f"the worst preset's d_ppl is at most {QAT_MIN_D_PPL} (JAX's rule)"
    base.pop("choices")
    card = None
    if dev.type == "cuda":
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"bf16": base, "presets": rows,
           "qat_recovery": qat_row, "qat_recovery_reason": qat_reason,
           "anchor": os.path.relpath(ANCHOR, ROOT), "mmlu_n_per_subject": MMLU_N, "dtype": "float32",
           "device": str(dev), "card": card}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
