"""RULER-style attention-sparsity calibration of the port (`sparsity/ruler.py`,
`utils/synthlang.py`) against the JAX package's, and the port of
`tests/test_ruler.py`. The synthetic language and the retrieval batches are
numpy in both packages and held equal; the threshold curve runs the port's
einsum engine on a tiny random model (retrieval accuracy is chance there:
the mechanics are under test) against JAX's on the same weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, tree_map
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu.sparsity import ruler as jruler
from tensorrt_model_optimizer_tpu.utils import synthlang as jsynth
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.sparsity import ruler
from tensorrt_model_optimizer_tpu_torch.utils import synthlang

TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2)
CURVE = dict(kinds=("override",), n=4, ctx_tokens=128, blocks=(16, 16), seed=1)


@pytest.fixture(scope="module")
def lang():
    return synthlang.SynthLang(0)


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, JAX bf16-kind model, the port's) on the same seeded weights."""
    jcfg = jsynth.anchor_config()
    jcfg = type(jcfg)(**{**jcfg.__dict__, **TINY})
    pnp = llama_params_np(jcfg, seed=0)
    tcfg = synthlang.anchor_config()
    tcfg = type(tcfg)(**{**tcfg.__dict__, **TINY})
    return (jcfg, jcompress.compress_bf16(jcfg, tree_map(jnp.asarray, pnp)),
            tcompress.compress_bf16(tcfg, tree_map(torch.from_numpy, pnp)))


def _ecfg():
    return tengine.EngineConfig(max_seq_len=160)


# ---- the synthetic language, equal to JAX's ----


def test_synthlang_matches_jax(lang):
    assert synthlang.VOCAB == jsynth.VOCAB and synthlang.TOKEN_ID == jsynth.TOKEN_ID
    assert synthlang.VOCAB_SIZE == jsynth.VOCAB_SIZE and synthlang.ANSWER_TOKEN_IDS == jsynth.ANSWER_TOKEN_IDS
    text = "person03 lives in what country \n person03 lives in country17 \n 12 plus 30 equals 42"
    assert synthlang.encode(text) == jsynth.encode(text)
    assert synthlang.decode(synthlang.encode(text)) == jsynth.decode(jsynth.encode(text))
    ref = jsynth.SynthLang(0)
    for table in ("capital", "job", "residence"):
        np.testing.assert_array_equal(getattr(lang, table), getattr(ref, table))
    np.testing.assert_array_equal(synthlang.SynthLang(0).eval_batches(2, 3, 96, seed=5),
                                  jsynth.SynthLang(0).eval_batches(2, 3, 96, seed=5))
    np.testing.assert_array_equal(synthlang.SynthLang(1, retrieval_mix=True).token_stream(3000, seed=2),
                                  jsynth.SynthLang(1, retrieval_mix=True).token_stream(3000, seed=2))
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    for subject in synthlang.SUBJECTS:
        assert lang.mc_row(rng_a, subject, heldout=True) == ref.mc_row(rng_b, subject, heldout=True)
    cfg = synthlang.anchor_config()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers, cfg.hd, cfg.dtype) == (512, 256, 6, 32,
                                                                                            torch.float32)


@pytest.mark.parametrize("kind", ruler.KINDS)
@pytest.mark.parametrize("seed,depth", [(0, None), (5, None), (9, 0.3)])
def test_make_retrieval_batch_matches_jax(lang, kind, seed, depth):
    toks, ans = ruler.make_retrieval_batch(lang, kind, 4, 160, depth=depth, seed=seed)
    jtoks, jans = jruler.make_retrieval_batch(jsynth.SynthLang(0), kind, 4, 160, depth=depth, seed=seed)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(ans, jans)


# ---- batch construction (the port of TestBatchConstruction) ----


def test_shapes_and_answer_token(lang):
    toks, ans = ruler.make_retrieval_batch(lang, "override", 4, 160, seed=3)
    assert toks.shape == (4, 160) and ans.shape == (4,)
    for i in range(4):
        text = synthlang.decode(toks[i])
        word = synthlang.VOCAB[int(ans[i])]
        assert word.startswith("country")
        assert f"lives in {word}" in text
        assert text.rstrip().endswith("lives in")


def test_memory_kind_has_no_needle(lang):
    toks, _ = ruler.make_retrieval_batch(lang, "memory", 4, 160, seed=7)
    for i in range(4):
        text = synthlang.decode(toks[i])
        body = text.rsplit("lives in what country", 1)[0]
        p = int(text.rstrip().split("person")[-1].split(" ")[0])
        assert f"person{p:02d} lives" not in body


def test_depth_pins_needle_position(lang):
    early, _ = ruler.make_retrieval_batch(lang, "override", 2, 200, depth=0.1, seed=9)
    late, _ = ruler.make_retrieval_batch(lang, "override", 2, 200, depth=0.9, seed=9)
    t_e, t_l = synthlang.decode(early[0]), synthlang.decode(late[0])
    p = int(t_e.rstrip().split("person")[-1].split(" ")[0])
    needle = f"person{p:02d} lives in country"
    assert t_e.find(needle) < t_l.find(needle)


# ---- the threshold curve and the calibration gates ----


def test_threshold_curve_matches_jax(tiny, lang):
    """JAX's rows: accuracies equal, keep fractions within 1e-6, ppl within
    1e-5 of itself (f32 sums in another order)."""
    _, jcm, cm = tiny
    ev = [np.asarray(b) for b in lang.eval_batches(1, 2, 128, seed=5)]
    kw = dict(CURVE, thresholds=(1e-6, 1e-2, 0.9), ppl_batches=ev)
    rows = ruler.threshold_curve(cm, _ecfg(), lang, device="cpu", **kw)
    jrows = jruler.threshold_curve(jcm, jengine.EngineConfig(max_seq_len=160, backend="xla"), jsynth.SynthLang(0),
                                   **kw)
    assert len(rows) == len(jrows) == 4
    for row, jrow in zip(rows, jrows):
        assert row["threshold"] == jrow["threshold"] and row["acc_override"] == jrow["acc_override"]
        if jrow["keep_frac"] is None:
            assert row["keep_frac"] is None
        else:
            assert abs(row["keep_frac"] - jrow["keep_frac"]) <= 1e-6
        assert abs(row["ppl"] - jrow["ppl"]) <= 1e-5 * jrow["ppl"]
    assert rows[3]["keep_frac"] <= rows[1]["keep_frac"] + 1e-6  # harsher threshold keeps fewer tiles


def test_threshold_curve_runs_and_keepfrac_monotone(tiny, lang):
    _, _, cm = tiny
    rows = ruler.threshold_curve(cm, _ecfg(), lang, thresholds=(1e-6, 0.9), device="cpu", **CURVE)
    assert rows[0]["threshold"] is None and rows[0]["keep_frac"] is None
    assert rows[2]["keep_frac"] <= rows[1]["keep_frac"] + 1e-6
    assert 0.0 < rows[1]["keep_frac"] <= 1.0


def test_calibrate_returns_threshold_or_none(tiny, lang):
    _, _, cm = tiny
    # min_dense_acc=0 turns the competence gate off: this random model scores
    # chance, and only the ladder's mechanics are under test
    th, _ = ruler.calibrate_threshold_ruler(cm, _ecfg(), lang, max_acc_drop=1.0, min_dense_acc=0.0,
                                            thresholds=(1e-6, 1e-3), device="cpu", **CURVE)
    assert th == 1e-3  # the largest rung passes under a 100% allowed drop
    th2, _ = ruler.calibrate_threshold_ruler(cm, _ecfg(), lang, max_acc_drop=-1.0, min_dense_acc=0.0,
                                             thresholds=(1e-6,), device="cpu", **CURVE)
    assert th2 is None


def test_incompetent_dense_baseline_refuses_to_calibrate(tiny, lang):
    """A dense model at chance accuracy yields NO operating point, not the
    most aggressive rung."""
    _, _, cm = tiny
    th, rows = ruler.calibrate_threshold_ruler(cm, _ecfg(), lang, max_acc_drop=1.0, min_dense_acc=0.8,
                                               thresholds=(1e-6, 0.3), device="cpu", **CURVE)
    assert th is None and "calibration_invalid" in rows[0]
    assert rows[0]["gating_tasks"] == [] and rows[0]["ungated_tasks"] == ["override"]


def test_dppl_gate_stops_the_ladder(tiny, lang):
    """A rung whose long-context dppl exceeds max_dppl fails even when its
    retrieval accuracy passes."""
    _, _, cm = tiny
    ev = [np.asarray(b) for b in lang.eval_batches(1, 2, 128, seed=5)]
    th, rows = ruler.calibrate_threshold_ruler(cm, _ecfg(), lang, max_acc_drop=1.0, min_dense_acc=0.0,
                                               max_dppl=-1.0, thresholds=(1e-6, 1e-3), ppl_batches=ev,
                                               device="cpu", **CURVE)
    assert th is None and all("ppl" in r for r in rows[:2])


def test_engine_prefill_ppl_sparse_at_tiny_threshold_equals_dense(tiny, lang):
    """Through the sparse route with nothing but the causal tiles skipped,
    the prefill ppl is the dense one (f32 sums in another order)."""
    _, _, cm = tiny
    ev = [np.asarray(b) for b in lang.eval_batches(1, 2, 64, seed=6)]
    dense = tengine.Engine(cm, _ecfg(), device="cpu")
    sparse = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=160, attn_sparsity=1e-30,
                                                     attn_sparsity_blocks=(16, 16)), device="cpu")
    a, b = ruler.engine_prefill_ppl(dense, ev), ruler.engine_prefill_ppl(sparse, ev)
    assert abs(a - b) <= 1e-5 * a and np.isfinite(a)
