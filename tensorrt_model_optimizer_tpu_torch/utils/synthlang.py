"""Deterministic synthetic language for trained-model accuracy anchoring
(the port's own copy of `utils/synthlang.py`, which is numpy only; the port
imports nothing of the JAX package). Token ids, fact tables, corpora and
evaluation batches are the same for the same seed, so a checkpoint trained
on the JAX package's corpus (`artifacts/anchor-llama`, `anchor-ruler`)
reads the same tokens here.

A seeded synthetic language with
 - **facts** (country -> capital, person -> job and residence, fixed by the
   seed) that a model must memorize,
 - **rules** (two-digit addition / subtraction) that it must compute,
 - **multiple-choice exercises** in the MMLU harness's prompt format
   (`build_prompt`): capitals, jobs, arithmetic with near-miss distractors,
   2-hop composition over held-out persons, and reverse capital lookup,
 - **retrieval documents** (a residence restated in context, usually against
   the fact table, then queried), the task `sparsity/ruler.py` measures.

Word-level tokenizer: every word and newline is one token; the vocabulary is
closed over everything `build_prompt` can emit.
"""

from __future__ import annotations

import csv
import os

import numpy as np

N_COUNTRIES = 80
N_PERSONS = 48
N_JOBS = 16
MAX_NUM = 60  # operands in [0, 60); sums < 120
# persons whose hop EXERCISES may appear in training docs; the rest are
# eval-only (their residence/job facts still train — composition is what's
# held out, not the facts)
N_TRAIN_PERSONS = 40
SUBJECTS = ("capitals", "jobs", "arithmetic", "hops", "reverse")

_HEADER_WORDS = (
    "The following are multiple choice questions (with answers).".split()
)


def _build_vocab() -> list[str]:
    vocab = ["<pad>", "\n"]
    vocab += [f"country{i:02d}" for i in range(N_COUNTRIES)]
    vocab += [f"city{i:02d}" for i in range(N_COUNTRIES)]
    vocab += [f"person{i:02d}" for i in range(N_PERSONS)]
    vocab += [f"job{i:02d}" for i in range(N_JOBS)]
    vocab += [str(i) for i in range(2 * MAX_NUM)]
    vocab += [
        "the", "capital", "of", "is", "plus", "minus", "equals",
        "works", "as", "a", "what", "who", "does", "do",
        "lives", "in", "country", "where",
        "A.", "B.", "C.", "D.", "Answer:", "A", "B", "C", "D",
    ]
    vocab += list(_HEADER_WORDS)
    # dedupe preserving order ("The" vs "the" both survive; exact words only)
    seen, out = set(), []
    for w in vocab:
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


VOCAB = _build_vocab()
TOKEN_ID = {w: i for i, w in enumerate(VOCAB)}
VOCAB_SIZE = 512  # padded (actual words < 512)
assert len(VOCAB) <= VOCAB_SIZE, len(VOCAB)
ANSWER_TOKEN_IDS = tuple(TOKEN_ID[c] for c in ("A", "B", "C", "D"))


def _format_example(row: list[str], include_answer: bool = True) -> str:
    q, a, b, c, d = row[0], row[1], row[2], row[3], row[4]
    s = f"{q}\nA. {a}\nB. {b}\nC. {c}\nD. {d}\nAnswer:"
    if include_answer:
        s += f" {row[5]}\n\n"
    return s


def build_prompt(dev_rows: list[list[str]], test_row: list[str], k_shot: int = 5) -> str:
    """The MMLU harness's k-shot prompt (`utils/mmlu.py` `build_prompt`)."""
    header = "The following are multiple choice questions (with answers).\n\n"
    shots = "".join(_format_example(r) for r in dev_rows[:k_shot])
    return header + shots + _format_example(test_row, include_answer=False)


def encode(text: str) -> list[int]:
    toks = text.replace("\n", " \n ").split(" ")
    return [TOKEN_ID[t] for t in toks if t]


def decode(ids) -> str:
    return " ".join(VOCAB[int(i)] for i in ids)


class SynthLang:
    """Seeded fact tables + corpus/eval samplers."""

    def __init__(self, seed: int = 0, retrieval_mix: bool = False):
        self.rng = np.random.default_rng(seed)
        self.capital = self.rng.permutation(N_COUNTRIES)  # country i -> city
        self.job = self.rng.integers(0, N_JOBS, size=N_PERSONS)
        self.residence = self.rng.integers(0, N_COUNTRIES, size=N_PERSONS)
        # retrieval_mix=True: the RULER-anchor training curriculum - 1/3 of
        # documents are retrieval (incl. MULTIKEY: several persons' needles,
        # one queried) instead of 1/6 single-needle. Used to train
        # `artifacts/anchor-ruler` (dense retrieval competence for the
        # attention-sparsity gate); the accuracy anchor keeps the original mix.
        self.retrieval_mix = retrieval_mix

    # ---- declarative sentences --------------------------------------
    def fact_sentence(self, rng) -> str:
        kind = rng.integers(0, 6)
        if kind == 0:
            c = rng.integers(0, N_COUNTRIES)
            return f"the capital of country{c:02d} is city{self.capital[c]:02d} \n"
        if kind == 1:
            c = rng.integers(0, N_COUNTRIES)
            return f"city{self.capital[c]:02d} is the capital of country{c:02d} \n"
        if kind == 2:
            p = rng.integers(0, N_PERSONS)
            return f"person{p:02d} works as a job{self.job[p]:02d} \n"
        if kind == 3:
            # residence facts train for ALL persons (incl. eval-held-out
            # ones); only the COMPOSED hop exercises are held out
            p = rng.integers(0, N_PERSONS)
            return f"person{p:02d} lives in country{self.residence[p]:02d} \n"
        a, b = int(rng.integers(0, MAX_NUM)), int(rng.integers(0, MAX_NUM))
        if kind == 4:
            return f"{a} plus {b} equals {a + b} \n"
        lo, hi = min(a, b), max(a, b)
        return f"{hi} minus {lo} equals {hi - lo} \n"

    # ---- in-context override documents (retrieval training) ---------
    def context_doc(self, rng) -> str:
        """A document whose answer is IN-CONTEXT, not memorized: a person's
        residence is (re)stated mid-document — usually to a RANDOM country
        that contradicts the trained fact table — then queried, and the
        answer repeats the in-context statement.

        This trains the retrieval behavior the RULER-style attention-
        sparsity calibration measures (`sparsity/ruler.py`): the model must
        ATTEND to the needle statement to answer; a model that answers from
        weights alone scores ~chance on override needles. Filler sentences
        mentioning the queried person's residence are re-drawn so exactly
        one in-context statement exists. Reference counterpart:
        `sparsity/attention_sparsity/calibration/ruler_dataset.py` (niah
        single-needle tasks)."""
        p = int(rng.integers(0, N_PERSONS))
        guard = f"person{p:02d} lives"
        # 1/4 of context docs have NO needle: the query falls back to the
        # trained fact table (the RULER "memory" control behavior)
        has_needle = rng.integers(0, 4) > 0
        c = (int(rng.integers(0, N_COUNTRIES)) if has_needle
             else int(self.residence[p]))
        answer = f"person{p:02d} lives in country{c:02d} \n"

        def filler(n):
            out = []
            while len(out) < n:
                s = self.fact_sentence(rng)
                if guard not in s:
                    out.append(s)
            return out

        # LONG-RANGE retrieval training: needle-to-query distances up to
        # ~350 tokens (post fillers 0..44 sentences), so RULER calibration
        # contexts (~448 tokens) are in-distribution (with 1..5 post fillers
        # a trained model retrieves only within ~60 tokens).
        parts = filler(int(rng.integers(1, 8)))
        if has_needle:
            parts.append(answer)
        parts += filler(int(rng.integers(0, 45)))
        parts.append(f"person{p:02d} lives in what country \n")
        parts.append(answer)
        return "".join(parts)

    def context_doc_multikey(self, rng) -> str:
        """Multikey retrieval training doc (`sparsity/ruler.py` multikey
        task): needles for SEVERAL distinct persons appear in one document,
        separated by filler, then one of them is queried - the model must
        select the right needle among in-context distractors."""
        n_keys = int(rng.integers(2, 5))
        ps = rng.choice(N_PERSONS, size=n_keys, replace=False)
        cs = rng.integers(0, N_COUNTRIES, size=n_keys)
        guards = [f"person{p:02d} lives" for p in ps]

        def filler(n):
            out = []
            while len(out) < n:
                sent = self.fact_sentence(rng)
                if not any(g in sent for g in guards):
                    out.append(sent)
            return out

        parts = filler(int(rng.integers(1, 5)))
        for p, c in zip(ps, cs):
            parts.append(f"person{p:02d} lives in country{c:02d} \n")
            parts += filler(int(rng.integers(1, 10)))
        parts += filler(int(rng.integers(0, 20)))
        qi = int(rng.integers(0, n_keys))
        parts.append(f"person{ps[qi]:02d} lives in what country \n")
        parts.append(f"person{ps[qi]:02d} lives in country{cs[qi]:02d} \n")
        return "".join(parts)

    # ---- multiple-choice rows (MMLU CSV schema) ---------------------
    def mc_row(self, rng, subject: str, heldout: bool = False) -> list[str]:
        """[question, A, B, C, D, answer_letter] — consumed by utils/mmlu.py.

        `heldout=True` (hops only) draws persons the training corpus never
        composed, so the model must chain residence -> capital at
        inference; dev/few-shot rows always use train persons."""
        if subject == "capitals":
            c = rng.integers(0, N_COUNTRIES)
            correct = f"city{self.capital[c]:02d}"
            pool = [f"city{i:02d}" for i in self.rng_distract(rng, self.capital[c], N_COUNTRIES)]
            q = f"what is the capital of country{c:02d}"
        elif subject == "jobs":
            p = rng.integers(0, N_PERSONS)
            correct = f"job{self.job[p]:02d}"
            pool = [f"job{i:02d}" for i in self.rng_distract(rng, self.job[p], N_JOBS)]
            q = f"what does person{p:02d} do"
        elif subject == "hops":
            # 2-hop composition: person -> country -> capital
            if heldout:
                p = int(rng.integers(N_TRAIN_PERSONS, N_PERSONS))
            else:
                p = int(rng.integers(0, N_TRAIN_PERSONS))
            ans = self.capital[self.residence[p]]
            correct = f"city{ans:02d}"
            # near distractors: the capital of a NEIGHBORING person's
            # country plus randoms — confusable under fact-recall noise
            pool_idx = []
            q2 = self.capital[self.residence[(p + 1) % N_PERSONS]]
            if q2 != ans:
                pool_idx.append(int(q2))
            for i in self.rng_distract(rng, ans, N_COUNTRIES):
                if len(pool_idx) >= 3:
                    break
                if i not in pool_idx:
                    pool_idx.append(i)
            pool = [f"city{i:02d}" for i in pool_idx[:3]]
            q = f"what is the capital of the country where person{p:02d} lives"
        elif subject == "reverse":
            c = rng.integers(0, N_COUNTRIES)
            city = self.capital[c]
            correct = f"country{c:02d}"
            pool = [f"country{i:02d}" for i in self.rng_distract(rng, c, N_COUNTRIES)]
            q = f"city{city:02d} is the capital of what country"
        elif subject == "arithmetic":
            a, b = int(rng.integers(0, MAX_NUM)), int(rng.integers(0, MAX_NUM))
            s = a + b
            correct = str(s)
            # near-misses: +-1/+-2/+-10 and the digit swap — small logit
            # perturbations flip these, random offsets don't
            near = [s + 1, s - 1, s + 10, s - 10, s + 2, s - 2]
            if 10 <= s < 100:
                near.insert(0, (s % 10) * 10 + s // 10)  # digit swap
            wrongs = []
            for w in near:
                if 0 <= w < 2 * MAX_NUM and w != s and str(w) not in wrongs:
                    wrongs.append(str(w))
                if len(wrongs) == 3:
                    break
            while len(wrongs) < 3:  # degenerate edges (s tiny)
                d = int(rng.integers(1, 10))
                w = s + d
                if 0 <= w < 2 * MAX_NUM and str(w) not in wrongs and w != s:
                    wrongs.append(str(w))
            pool = wrongs
            q = f"what is {a} plus {b}"
        else:
            raise ValueError(subject)
        opts = pool[:3] + [correct]
        order = rng.permutation(4)
        opts = [opts[i] for i in order]
        letter = "ABCD"[list(order).index(3)]
        return [q, *opts, letter]

    @staticmethod
    def rng_distract(rng, correct_idx, n) -> list[int]:
        out = []
        while len(out) < 3:
            i = int(rng.integers(0, n))
            if i != correct_idx and i not in out:
                out.append(i)
        return out

    # ---- corpus -----------------------------------------------------
    def document(self, rng) -> str:
        """One training document: facts, or an MMLU-formatted exercise.

        Hop exercises only ever use TRAIN_PERSONS (`mc_row(heldout=False)`)
        — the eval's held-out persons appear in training only as isolated
        residence/job facts."""
        r = rng.integers(0, 6)
        if r < 2:  # 1/3 of docs are k-shot MC exercises
            subject = SUBJECTS[rng.integers(0, len(SUBJECTS))]
            dev = [self.mc_row(rng, subject) for _ in range(int(rng.integers(0, 3)))]
            row = self.mc_row(rng, subject)
            return build_prompt(dev, row, k_shot=len(dev)) + f" {row[5]} \n \n"
        if self.retrieval_mix:
            if r == 2:
                return self.context_doc(rng)
            if r == 3:
                return self.context_doc_multikey(rng)
        elif r == 2:  # 1/6 in-context override docs (retrieval training)
            return self.context_doc(rng)
        return "".join(self.fact_sentence(rng) for _ in range(int(rng.integers(4, 9))))

    def token_stream(self, n_tokens: int, seed: int = 1) -> np.ndarray:
        rng = np.random.default_rng(seed)
        out: list[int] = []
        while len(out) < n_tokens:
            out.extend(encode(self.document(rng)))
        return np.asarray(out[:n_tokens], np.int32)

    def eval_batches(self, n_batches: int, batch: int, seq: int, seed: int = 999):
        stream = self.token_stream(n_batches * batch * seq, seed=seed)
        return stream.reshape(n_batches, batch, seq)

    # ---- MMLU-format data dir ---------------------------------------
    def write_mmlu_data(
        self, outdir: str, n_test: int = 64, n_dev: int = 5, seed: int = 7
    ) -> str:
        rng = np.random.default_rng(seed)
        for split, n in (("dev", n_dev), ("test", n_test)):
            os.makedirs(os.path.join(outdir, split), exist_ok=True)
            for subject in SUBJECTS:
                p = os.path.join(outdir, split, f"{subject}_{split}.csv")
                with open(p, "w", newline="") as f:
                    w = csv.writer(f)
                    for _ in range(n):
                        # hop TEST rows use held-out persons (the model
                        # never trained on their composed question); dev
                        # few-shot rows demonstrate the task on train ones
                        ho = subject == "hops" and split == "test"
                        w.writerow(self.mc_row(rng, subject, heldout=ho))
        return outdir


def anchor_config(dtype=None):
    """The anchor model: ~7M-param llama (the port's `LlamaConfig`)."""
    import torch

    from ..models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=VOCAB_SIZE,
        hidden_size=256,
        intermediate_size=704,
        num_hidden_layers=6,
        num_attention_heads=8,
        num_key_value_heads=4,
        max_position_embeddings=512,
        rope_theta=10000.0,
        tie_word_embeddings=False,
        dtype=dtype or torch.float32,
    )
