"""MMLU accuracy harness (port of `utils/mmlu.py`).

Reads the MMLU CSV layout from a local directory
(`data_dir/{dev,test}/<subject>_{dev,test}.csv`, rows = question, A, B, C,
D, answer): a k-shot prompt per question, the model's logits at the answer
position, argmax over the four answer-letter token ids. Tokenizer-agnostic:
pass `encode(text) -> list[int]` and the ids of " A" " B" " C" " D".

`mmlu_eval` takes the prompts `batch` at a time: right-padded to the
longest prompt of the batch (token 0), one forward, each prompt's logits
read at its own last position. Under the causal mask the padding after a
prompt changes none of its logits; the k-shot back-off under `max_seq_len`
is JAX's.
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Iterable, Optional

import numpy as np

CHOICES = ("A", "B", "C", "D")


def format_example(row: list[str], include_answer: bool = True) -> str:
    q, a, b, c, d = row[0], row[1], row[2], row[3], row[4]
    s = f"{q}\nA. {a}\nB. {b}\nC. {c}\nD. {d}\nAnswer:"
    if include_answer:
        s += f" {row[5]}\n\n"
    return s


def build_prompt(dev_rows: list[list[str]], test_row: list[str], k_shot: int = 5) -> str:
    header = "The following are multiple choice questions (with answers).\n\n"
    shots = "".join(format_example(r) for r in dev_rows[:k_shot])
    return header + shots + format_example(test_row, include_answer=False)


def read_subject(data_dir: str, subject: str):
    def rd(split):
        with open(os.path.join(data_dir, split, f"{subject}_{split}.csv")) as f:
            return [row for row in csv.reader(f) if row]

    return rd("dev"), rd("test")


def list_subjects(data_dir: str) -> list[str]:
    test_dir = os.path.join(data_dir, "test")
    return sorted(f[: -len("_test.csv")] for f in os.listdir(test_dir) if f.endswith("_test.csv"))


def prompt_tokens(encode: Callable[[str], list[int]], dev_rows, row, k_shot: int, max_seq_len: int) -> list[int]:
    """A question's k-shot prompt, shots dropped one at a time while it is
    longer than max_seq_len (JAX's back-off)."""
    k = k_shot
    toks = encode(build_prompt(dev_rows, row, k))
    while len(toks) > max_seq_len and k > 0:
        k -= 1
        toks = encode(build_prompt(dev_rows, row, k))
    return toks


def answer_logits(logits_fn: Callable, prompts: list[list[int]], ans_ids, batch: int = 1) -> np.ndarray:
    """[n, 4] f32: each prompt's last-position logits at the answer ids,
    `batch` right-padded prompts a forward."""
    out = []
    for s in range(0, len(prompts), batch):
        group = prompts[s: s + batch]
        T = max(len(p) for p in group)
        tokens = np.zeros((len(group), T), np.int32)
        for i, p in enumerate(group):
            tokens[i, : len(p)] = p
        logits = np.asarray(logits_fn(tokens), np.float32)
        for i, p in enumerate(group):
            out.append(logits[i, len(p) - 1, ans_ids])
    return np.stack(out)


def mmlu_eval(logits_fn: Callable[[np.ndarray], np.ndarray], encode: Callable[[str], list[int]],
              answer_token_ids: tuple[int, int, int, int], data_dir: str,
              subjects: Optional[Iterable[str]] = None, k_shot: int = 5,
              max_questions_per_subject: Optional[int] = None, max_seq_len: int = 2048,
              batch: int = 1) -> dict:
    """{"accuracy", "per_subject", "n"} as JAX's, plus "choices" (the
    predicted letter index of every question, in order) and "logits" ([n, 4]
    answer logits). `logits_fn(tokens [B, T] int32) -> logits [B, T, V]`
    (a numpy array or a tensor)."""
    subjects = list(subjects) if subjects else list_subjects(data_dir)
    ans_ids = np.asarray(answer_token_ids)
    per_subject, choices, all_logits = {}, [], []
    total, correct = 0, 0
    for subject in subjects:
        dev_rows, test_rows = read_subject(data_dir, subject)
        if max_questions_per_subject:
            test_rows = test_rows[:max_questions_per_subject]
        prompts = [prompt_tokens(encode, dev_rows, row, k_shot, max_seq_len) for row in test_rows]
        al = answer_logits(lambda t: _numpy(logits_fn(t)), prompts, ans_ids, batch) if prompts else np.zeros((0, 4))
        pred = np.argmax(al, axis=-1)
        gold = np.asarray([CHOICES.index(row[5].strip()) for row in test_rows], np.int64)
        sc = int(np.sum(pred == gold))
        per_subject[subject] = sc / max(len(test_rows), 1)
        total += len(test_rows)
        correct += sc
        choices.extend(int(p) for p in pred)
        all_logits.append(al)
    return {"accuracy": correct / max(total, 1), "per_subject": per_subject, "n": total,
            "choices": choices, "logits": np.concatenate(all_logits) if all_logits else np.zeros((0, 4))}


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)
