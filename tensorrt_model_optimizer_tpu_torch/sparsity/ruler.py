"""RULER-style long-context retrieval calibration for attention sparsity
(port of `sparsity/ruler.py`).

Synthetic needle-in-a-haystack retrieval tasks in the synthlang token space
(`utils/synthlang.py`) drive the skip-softmax threshold search, so
`EngineConfig.attn_sparsity` gets an operating point grounded in a task;
the trained anchor `artifacts/anchor-ruler` is the calibration model:

 - **override** (niah_single): one needle sentence assigns a person a
   RANDOM residence that contradicts the trained fact table; the query asks
   it back. Memorized weights answer wrong: only attending to the needle
   answers right, so accuracy isolates retrieval.
 - **multikey** (niah_multikey): several override needles for different
   persons; one is queried, the others distract.
 - **memory** control: no needle; the trained fact is queried. Sparsity
   should never hurt this; a drop flags a threshold that corrupts local
   attention.

Calibration = the largest threshold whose accuracy on every task the dense
model is competent at stays within `max_acc_drop` of dense (and, with
`ppl_batches`, whose long-context ppl stays within `max_dppl`), searched
over a log-spaced ladder; the whole curve (threshold -> accuracy,
keep-frac) comes back with it. The engine runs on `device` (cuda unless the
caller passes "cpu"), where the compressed model must live.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from ..utils import synthlang

KINDS = ("override", "multikey", "memory")


def _encode(text: str) -> list[int]:
    return list(synthlang.encode(text))


def make_retrieval_batch(
    lang: synthlang.SynthLang,
    kind: str,
    n: int,
    ctx_tokens: int,
    depth: Optional[float] = None,
    seed: int = 0,
):
    """Build one retrieval batch.

    Returns (tokens [n, ctx_tokens] int32, answer_token [n] int32). The
    query tail is `personXX lives in what country \\n personXX lives in`
    and the answer is the `countryYY` token — argmax at the last position
    scores it. `depth` in [0, 1] pins the needle's relative position
    (None = uniform per sample)."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, ctx_tokens), np.int32)
    answers = np.zeros((n,), np.int32)
    for i in range(n):
        p = int(rng.integers(0, synthlang.N_PERSONS))
        if kind == "memory":
            c = int(lang.residence[p])
        else:
            c = int(rng.integers(0, synthlang.N_COUNTRIES))
        needle = f"person{p:02d} lives in country{c:02d} \n"
        guard = f"person{p:02d} lives"
        query = f"person{p:02d} lives in what country \n person{p:02d} lives in"
        q_ids = _encode(query)
        needle_ids = _encode(needle) if kind != "memory" else []

        distract_ids: list[list[int]] = []
        if kind == "multikey":
            used = {p}
            for _ in range(3):
                dp = int(rng.integers(0, synthlang.N_PERSONS))
                if dp in used:
                    continue
                used.add(dp)
                dc = int(rng.integers(0, synthlang.N_COUNTRIES))
                distract_ids.append(
                    _encode(f"person{dp:02d} lives in country{dc:02d} \n")
                )

        budget = ctx_tokens - len(q_ids) - len(needle_ids) - sum(
            len(d) for d in distract_ids
        )
        filler: list[int] = []
        while len(filler) < budget:
            s = lang.fact_sentence(rng)
            if guard in s:
                continue
            filler.extend(_encode(s))
        filler = filler[:budget]

        d = float(rng.uniform(0.1, 0.9)) if depth is None else depth
        pos = int(d * len(filler))
        body = filler[:pos] + needle_ids + filler[pos:]
        for dn in distract_ids:  # distractors at random positions
            at = int(rng.integers(0, len(body)))
            body = body[:at] + dn + body[at:]
        seq = body + q_ids
        toks[i] = np.asarray(seq[-ctx_tokens:], np.int32)
        answers[i] = _encode(f"country{c:02d}")[0]
    return toks, answers


def eval_retrieval(engine, tokens: np.ndarray, answers: np.ndarray):
    """Run `engine.prefill` on the batch; score the last position's argmax.

    Returns (accuracy, keep_frac): keep_frac is the mean kept-tile share the
    sparse prefill recorded (None when dense)."""
    cache = engine.init_cache(tokens.shape[0], tokens.shape[1] + 8)
    logits = engine.prefill(torch.from_numpy(np.asarray(tokens)).to(engine.device), cache)
    pred = torch.argmax(logits, dim=-1).cpu().numpy()
    acc = float((pred == answers).mean())
    kf = engine.last_prefill_keep_frac
    keep = float(kf.float().mean()) if kf is not None else None
    return acc, keep


def engine_prefill_ppl(eng, batches) -> float:
    """Next-token ppl through the engine's PREFILL path (the sparse route
    when `attn_sparsity` is set): every position teacher-forced in one
    full-logits model step per batch."""
    sparse = eng.ecfg.attn_sparsity is not None
    tot, cnt = 0.0, 0
    for batch in batches:
        toks = torch.from_numpy(np.asarray(batch)).to(eng.device)
        B, T = toks.shape
        logits = eng._model_step(toks, eng.init_cache(B, T + 8), full_logits=True,
                                 keep_fracs=[] if sparse else None)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = toks[:, 1:].long()
        nll = -torch.gather(logp, -1, tgt[..., None])
        tot += float(nll.sum())
        cnt += tgt.numel()
    return float(np.exp(tot / max(cnt, 1)))


def threshold_curve(
    cm,
    base_ecfg,
    lang: synthlang.SynthLang,
    thresholds=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1),
    kinds=("override", "multikey", "memory"),
    n: int = 32,
    ctx_tokens: int = 448,
    blocks=(64, 64),
    seed: int = 11,
    ppl_batches=None,
    device=None,
):
    """Sweep skip-softmax thresholds over the RULER tasks.

    Returns a list of rows: {threshold, keep_frac, acc per kind}, with the
    dense row first (threshold None). With `ppl_batches` (token arrays),
    each row also gets long-context ppl/dppl through the sparse prefill —
    the second gate the calibration needs (an aggressive threshold can keep
    retrieval intact while corrupting the general token distribution)."""
    from ..serve.engine import Engine

    batches = {
        k: make_retrieval_batch(lang, k, n, ctx_tokens, seed=seed + j)
        for j, k in enumerate(kinds)
    }
    rows = []
    for th in (None, *thresholds):
        ecfg = dataclasses.replace(
            base_ecfg, attn_sparsity=th, attn_sparsity_blocks=blocks
        )
        eng = Engine(cm, ecfg, device=device)
        row = {"threshold": th, "keep_frac": None}
        for k in kinds:
            toks, ans = batches[k]
            acc, keep = eval_retrieval(eng, toks, ans)
            row[f"acc_{k}"] = acc
            if keep is not None:
                row["keep_frac"] = keep
        if ppl_batches is not None:
            row["ppl"] = engine_prefill_ppl(eng, ppl_batches)
            row["dppl"] = round(row["ppl"] - rows[0]["ppl"], 4) if rows else 0.0
        rows.append(row)
        print(f"[ruler] {row}", file=sys.stderr, flush=True)
    return rows


def calibrate_threshold_ruler(
    cm,
    base_ecfg,
    lang: synthlang.SynthLang,
    max_acc_drop: float = 0.02,
    min_dense_acc: float = 0.8,
    max_dppl: float = 0.05,
    **kw,
):
    """Largest threshold that keeps retrieval accuracy within
    `max_acc_drop` of dense on every COMPETENT task AND long-context ppl
    within `max_dppl` of dense (when `ppl_batches` is passed through).

    The accuracy gate is only meaningful on tasks the DENSE model can do: at
    chance-level dense accuracy the whole ladder trivially "passes" and the
    calibration would bless the most aggressive threshold. Competence is
    judged PER TASK (dense acc >= `min_dense_acc`): incompetent tasks are
    left out of the drop gate, so an anchor that aces memory but not
    multikey retrieval still grounds a threshold on what it does. With NO
    competent task the calibration refuses.

    Returns (threshold or None, curve rows). The dense row records
    `gating_tasks` (the competent subset) and `ungated_tasks`; None =
    serve dense (smallest rung failed, or no competent task)."""
    rows = threshold_curve(cm, base_ecfg, lang, **kw)
    dense = rows[0]
    ret_kinds = [k for k in ("override", "multikey", "memory")
                 if f"acc_{k}" in dense]
    gating = [k for k in ret_kinds if dense[f"acc_{k}"] >= min_dense_acc]
    dense["gating_tasks"] = gating
    dense["ungated_tasks"] = [k for k in ret_kinds if k not in gating]
    if not gating:
        best_acc = max(dense[f"acc_{k}"] for k in ret_kinds)
        dense["calibration_invalid"] = (
            f"no task with dense acc >= {min_dense_acc} (best "
            f"{best_acc:.3f}): anchor cannot ground the threshold search")
        return None, rows
    best = None
    for row in rows[1:]:  # ladder is ascending; stop at the FIRST failure
        # (a larger threshold passing after a failure is noise, not signal)
        if any(row[f"acc_{k}"] < dense[f"acc_{k}"] - max_acc_drop
               for k in gating):
            break
        if row.get("dppl") is not None and row["dppl"] > max_dppl:
            break
        best = row["threshold"]
    return best, rows
