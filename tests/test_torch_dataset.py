"""The port's calibration datasets (`utils/dataset.py`) against the JAX
package's: the synthetic batches bit for bit (the same numpy generator and
seed), the token-file loaders and `get_calib_batches`'s dispatch equal on
files the test writes, the text loaders' lazy imports failing as JAX's do
where the packages are missing, and the OOM probe."""

import sys

import numpy as np
import pytest
import torch

from tensorrt_model_optimizer_tpu.utils import dataset as jds
from tensorrt_model_optimizer_tpu_torch.utils import dataset as tds


@pytest.mark.parametrize("vocab,n,b,t,seed", [(512, 3, 2, 64, 0), (128256, 2, 4, 512, 7), (32, 1, 1, 32, 3)])
def test_synthetic_batches_bit_equal(vocab, n, b, t, seed):
    jb, tb = jds.synthetic_batches(vocab, n, b, t, seed), tds.synthetic_batches(vocab, n, b, t, seed)
    assert len(jb) == len(tb) == n
    for a, c in zip(jb, tb):
        assert c.dtype == np.int32 and c.shape == (b, t)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("suffix", [".npy", ".bin"])
@pytest.mark.parametrize("max_batches", [None, 2])
def test_tokens_file_equal(tmp_path, suffix, max_batches):
    toks = np.random.default_rng(1).integers(0, 1000, size=5 * 2 * 48 + 17).astype(np.int32)
    path = str(tmp_path / f"toks{suffix}")
    np.save(path, toks) if suffix == ".npy" else toks.tofile(path)
    jb = jds.batches_from_tokens_file(path, 2, 48, max_batches)
    tb = tds.batches_from_tokens_file(path, 2, 48, max_batches)
    assert len(tb) == (max_batches or 5)
    for a, c in zip(jb, tb):
        np.testing.assert_array_equal(a, c)
    # the dispatch takes a tokens file first, else the synthetic batches
    for a, c in zip(jds.get_calib_batches(1000, path, None, 3, 2, 48), tds.get_calib_batches(1000, path, None, 3, 2, 48)):
        np.testing.assert_array_equal(a, c)
    for a, c in zip(jds.get_calib_batches(1000, None, None, 3, 2, 48), tds.get_calib_batches(1000, None, None, 3, 2, 48)):
        np.testing.assert_array_equal(a, c)


def test_text_loaders_fail_as_jax_does_without_transformers(tmp_path, monkeypatch):
    """The card's machine has neither `transformers` nor `datasets`: the text
    loaders import them only when called, and then fail as JAX's do."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "datasets", None)
    p = tmp_path / "t.txt"
    p.write_text("hello world")
    for mod in (jds, tds):
        with pytest.raises(ImportError):
            mod.batches_from_text(str(p), str(tmp_path))
        with pytest.raises(ImportError):
            mod.get_calib_batches(100, str(p), str(tmp_path))
        with pytest.raises(ImportError):
            mod.batches_from_hf_dataset(str(tmp_path), str(tmp_path))


def test_max_batch_size_stops_at_out_of_memory():
    """The probe doubles the batch until the forward raises CUDA's OOM and
    returns the last batch that ran; other errors propagate."""
    seen = []

    def fwd(t):
        seen.append(t.shape[0])
        if t.shape[0] > 8:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return t

    assert tds.get_max_batch_size(fwd, seq_len=16, vocab_size=50, start=2, device="cpu") == 8
    assert seen == [2, 4, 8, 16]
    assert tds.get_max_batch_size(lambda t: t, seq_len=4, vocab_size=5, start=1, cap=32, device="cpu") == 32

    def broken(t):
        raise ValueError("not an OOM")

    with pytest.raises(ValueError):
        tds.get_max_batch_size(broken, seq_len=4, vocab_size=5, device="cpu")


def test_vlm_calib_batches_names_its_slice():
    # ported with the VLM (models/vlm.py): JAX's pairs, draw for draw
    for kw in ({}, dict(batch=3, img=32, seq=16, seed=4)):
        ours, theirs = tds.vlm_calib_batches(2, **kw), jds.vlm_calib_batches(2, **kw)
        assert len(ours) == len(theirs) == 2
        for (px, tk), (jpx, jtk) in zip(ours, theirs):
            assert px.dtype == np.float32 and tk.dtype == np.int32
            np.testing.assert_array_equal(px, jpx)
            np.testing.assert_array_equal(tk, jtk)
