"""Calibration datasets (port of `utils/dataset.py`).

Loaders read local files only (tokenized .npy / .bin, plain text with a
local HF tokenizer directory, a local HF `datasets` directory), with a
deterministic synthetic fallback, so every pipeline runs without downloads.
Batches are int32 numpy arrays [B, T], the same values JAX's loaders give
for the same inputs and seed; the caller moves them to its device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def synthetic_batches(vocab_size: int, num_batches: int = 8, batch_size: int = 2, seq_len: int = 512,
                      seed: int = 0) -> list[np.ndarray]:
    """Deterministic pseudo-text: zipf-ish tokens with local repeats (a
    closer match to text than uniform noise). numpy's `default_rng`, so the
    tokens equal JAX's for the same seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_batches):
        toks = np.clip(rng.zipf(1.3, size=(batch_size, seq_len)).astype(np.int64), 1, vocab_size - 1)
        for b in range(batch_size):  # text has heavy short-range reuse
            for _ in range(seq_len // 16):
                i = rng.integers(0, seq_len - 8)
                j = rng.integers(0, seq_len - 8)
                toks[b, j: j + 4] = toks[b, i: i + 4]
        out.append(toks.astype(np.int32))
    return out


def _chunk(ids: np.ndarray, batch_size: int, seq_len: int, max_batches: Optional[int]) -> list[np.ndarray]:
    per = batch_size * seq_len
    n = len(ids) // per
    if max_batches:
        n = min(n, max_batches)
    return [ids[i * per: (i + 1) * per].reshape(batch_size, seq_len).astype(np.int32) for i in range(n)]


def batches_from_tokens_file(path: str, batch_size: int = 2, seq_len: int = 512,
                             max_batches: Optional[int] = None) -> list[np.ndarray]:
    """A flat .npy (any int dtype) or .bin (int32) token array in [B, T]
    batches."""
    arr = np.load(path) if path.endswith(".npy") else np.fromfile(path, np.int32)
    return _chunk(arr.reshape(-1), batch_size, seq_len, max_batches)


def batches_from_text(text_path: str, tokenizer_dir: str, batch_size: int = 2, seq_len: int = 512,
                      max_batches: Optional[int] = None) -> list[np.ndarray]:
    """A local text file tokenized by a local HF tokenizer directory
    (`transformers`, imported here and nowhere else)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer_dir)
    with open(text_path) as f:
        ids = tok(f.read(), return_tensors="np")["input_ids"].reshape(-1)
    return _chunk(ids, batch_size, seq_len, max_batches)


def get_calib_batches(vocab_size: int, data: Optional[str] = None, tokenizer_dir: Optional[str] = None,
                      num_batches: int = 8, batch_size: int = 2, seq_len: int = 512) -> list[np.ndarray]:
    """Dispatch: tokens file > text + tokenizer > synthetic."""
    if data and (data.endswith(".npy") or data.endswith(".bin")):
        return batches_from_tokens_file(data, batch_size, seq_len, num_batches)
    if data and tokenizer_dir:
        return batches_from_text(data, tokenizer_dir, batch_size, seq_len, num_batches)
    return synthetic_batches(vocab_size, num_batches, batch_size, seq_len)


def batches_from_hf_dataset(path: str, tokenizer_dir: str, text_field: str = "text", batch_size: int = 2,
                            seq_len: int = 512, num_batches: int = 8, pack: bool = True) -> list[np.ndarray]:
    """A local HF `datasets` directory (save_to_disk form; nothing is
    fetched). `pack=True` concatenates the samples and chunks them to
    seq_len; otherwise each sample is truncated or zero-padded."""
    from datasets import load_from_disk
    from transformers import AutoTokenizer

    ds = load_from_disk(path)
    tok = AutoTokenizer.from_pretrained(tokenizer_dir)
    texts = (ex[text_field] for ex in ds)
    if pack:
        ids: list[int] = []
        need = num_batches * batch_size * seq_len
        for t in texts:
            ids.extend(tok(t, add_special_tokens=False)["input_ids"])
            if len(ids) >= need:
                break
        chunks = np.asarray(ids[: need // seq_len * seq_len], np.int32).reshape(-1, seq_len)
    else:
        rows = []
        for t in texts:
            e = tok(t, add_special_tokens=False)["input_ids"][:seq_len]
            rows.append(np.pad(e, (0, seq_len - len(e))))
            if len(rows) >= num_batches * batch_size:
                break
        chunks = np.asarray(rows, np.int32)
    n = min(num_batches, len(chunks) // batch_size)
    return [chunks[i * batch_size: (i + 1) * batch_size] for i in range(n)]


def get_max_batch_size(forward_fn: Callable, seq_len: int = 512, vocab_size: int = 32000, start: int = 1,
                       cap: int = 512, device=None) -> int:
    """The largest power-of-two batch whose forward runs: doubles the batch
    from `start` until `forward_fn(tokens)` raises `torch.cuda.
    OutOfMemoryError` (or the batch passes `cap`), and returns the last one
    that ran. Tokens are made on `device` (the card unless the caller says
    otherwise); any other error propagates."""
    from .. import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    good = 0
    b = max(start, 1)
    while b <= cap:
        toks = torch.from_numpy(rng.integers(0, vocab_size, size=(b, seq_len), dtype=np.int32)).to(dev)
        try:
            forward_fn(toks)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except torch.cuda.OutOfMemoryError:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            break
        good = b
        b *= 2
    if good == 0:
        raise RuntimeError(f"even batch={start} does not fit at seq_len={seq_len}")
    return good


def vlm_calib_batches(n_batches: int, batch: int = 2, img: int = 64, seq: int = 32, seed: int = 0):
    """Synthetic VLM calibration pairs: [(pixels [batch, img, img, 3] f32 in
    [-1, 1], synthlang text tokens [batch, seq] int32)], numpy, the JAX
    package's numbers draw for draw (the pixels from
    `np.random.default_rng(seed)`, the text from `SynthLang(0)`'s stream
    seeded `seed + 1`)."""
    from . import synthlang

    lang = synthlang.SynthLang(0)
    rng = np.random.default_rng(seed)
    stream = lang.token_stream(n_batches * batch * seq + seq, seed=seed + 1)
    out = []
    for i in range(n_batches):
        px = rng.uniform(-1, 1, size=(batch, img, img, 3)).astype(np.float32)
        s = i * batch * seq
        out.append((px, stream[s: s + batch * seq].reshape(batch, seq).astype(np.int32)))
    return out
