"""The port's weight sparsity (`sparsity/{magnitude,sparsegpt,sparsify}.py`
and the masked QAT step of `quant/qat.py`) against the JAX package, the same
seeded inputs in both.

 - `nm_mask` bit-equal to JAX's, f32 and bf16, with ties inside groups
   (weights drawn from a few values), for 2:4 and 4:8; `apply_mask` and
   `sparsity_ratio` equal.
 - `sparsegpt_prune`: masks equal and weights within 1e-5 relative
   Frobenius on the two block paths (K a multiple of 128: two 128-blocks;
   K = 192: blocks of m), from 512 calibration tokens, as `sparsify` takes
   them (4 batches x 128). Both packages then lie ~2e-7 from the same
   algorithm in f64. With fewer tokens than K, H is near-singular and both
   f32 runs lie up to ~2e-5 from the f64 one (measured at K = 1024, 128
   tokens), whichever way H^-1's factor is taken; the pruned weights are
   exactly +0.0.
 - `sparsify` by magnitude and by SparseGPT (masks equal, weights within
   1e-5) on the tiny Llama, `reapply` and `export` equal. Magnitude's
   weights are equal values, bit for bit but for the sign of masked zeros:
   `apply_mask` multiplies by the mask, as JAX's source does, which leaves
   -0.0 under a negative weight (JAX run eagerly, and jitted in bf16); jitted
   in f32, as JAX's `sparsify` runs it, XLA makes the multiply a select and
   writes +0.0. Eager JAX is held bit for bit (`apply_mask`, `reapply`).
 - The masked Adam step (`make_optax_train_step(masks=...)`): 3 steps in f32
   within 1e-5 of JAX's on every parameter, the loss within 1e-6, and every
   masked-off weight exactly 0 after each step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import qat as jqat
from tensorrt_model_optimizer_tpu.sparsity import magnitude as jmag
from tensorrt_model_optimizer_tpu.sparsity import sparsegpt as jsgpt
from tensorrt_model_optimizer_tpu.sparsity import sparsify as jsp
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import qat as tqat
from tensorrt_model_optimizer_tpu_torch.sparsity import magnitude as tmag
from tensorrt_model_optimizer_tpu_torch.sparsity import sparsegpt as tsgpt
from tensorrt_model_optimizer_tpu_torch.sparsity import sparsify as tsp

SGPT_FROB = 1e-5
STEP_TOL = 1e-5


def _frob(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    pnp = llama_params_np(jcfg, seed=0)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, jcfg.vocab_size, size=(2, 33)).astype(np.int32) for _ in range(4)]
    return jcfg, tree_map(jnp.asarray, pnp), convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp), batches


@pytest.mark.parametrize("pattern", [(2, 4), (4, 8)], ids=["2:4", "4:8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nm_mask_bit_equal_with_ties(dtype, pattern):
    n, m = pattern
    rng = np.random.default_rng(11)
    # few distinct magnitudes, both signs: most groups hold ties
    w = (rng.integers(-3, 4, size=(3, 16, 64)) * 0.25).astype(np.float32)
    w[0, 0, :8] = 0.5  # whole groups of equal weights
    jw = jnp.asarray(w).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tw = torch.from_numpy(w).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    jm, tm = np.asarray(jmag.nm_mask(jw, n, m)), tmag.nm_mask(tw, n, m)
    assert tm.dtype == torch.bool and np.array_equal(jm, tm.numpy())
    assert (tm.reshape(3, 16, 64 // m, m).sum(-1) == n).all()
    assert jm[0, 0, :m].tolist() == [True] * n + [False] * (m - n)  # a tied group keeps its lowest indices
    ja, ta = jmag.apply_mask(jw, jnp.asarray(jm)), tmag.apply_mask(tw, tm)
    assert ta.dtype == tw.dtype
    assert np.array_equal(np.asarray(ja.astype(jnp.float32)).view(np.uint32), ta.float().numpy().view(np.uint32))
    assert tmag.sparsity_ratio(tm) == jmag.sparsity_ratio(jnp.asarray(jm)) == 1 - n / m


def test_nm_mask_refuses_a_ragged_group():
    with pytest.raises(ValueError, match="not divisible"):
        tmag.nm_mask(torch.zeros(4, 10))


@pytest.mark.parametrize("K", [256, 192], ids=["blocks_of_128", "blocks_of_m"])
def test_sparsegpt_prune_matches_jax(K):
    rng = np.random.default_rng(K)
    O = 24
    w = (rng.standard_normal((O, K)) / np.sqrt(K)).astype(np.float32)
    x = rng.standard_normal((512, K)).astype(np.float32)
    jH = jsgpt.hessian_from_acts(jnp.asarray(x))
    tH = tsgpt.hessian_from_acts(torch.from_numpy(x))
    assert rel_err(tH.numpy(), np.asarray(jH)) <= 1e-6
    jw, jm = jax.jit(jsgpt.sparsegpt_prune)(jnp.asarray(w), jH)
    tw, tm = tsgpt.sparsegpt_prune(torch.from_numpy(w), tH)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert _frob(tw.numpy(), np.asarray(jw)) <= SGPT_FROB
    assert (tw[~tm] == 0).all() and not torch.signbit(tw[~tm]).any()
    assert (tm.reshape(O, K // 4, 4).sum(-1) == 2).all()
    # the reconstruction moved the kept weights (not magnitude pruning)
    assert not torch.equal(tw, tmag.apply_mask(torch.from_numpy(w), tm))


def test_sparsegpt_prune_keeps_the_weights_dtype():
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)).to(torch.bfloat16)
    H = tsgpt.hessian_from_acts(torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32)))
    tw, tm = tsgpt.sparsegpt_prune(w, H, 4, 8)
    assert tw.dtype == torch.bfloat16 and (tm.reshape(8, 8, 8).sum(-1) == 4).all()


@pytest.mark.parametrize("method", ["magnitude", "sparsegpt"])
def test_sparsify_matches_jax(tiny, method):
    jcfg, jp, tcfg, tp, batches = tiny
    jnew, jmasks = jsp.sparsify(jcfg, jp, method, (2, 4), [jnp.asarray(b) for b in batches])
    tnew, tmasks = tsp.sparsify(tcfg, tp, method, (2, 4), [torch.from_numpy(b).long() for b in batches])
    assert sorted(tmasks) == sorted(jmasks) == sorted(tllama.PROJ_NAMES)
    for name in tllama.PROJ_NAMES:
        assert np.array_equal(np.asarray(jmasks[name]), tmasks[name].numpy()), name
        a, b = tnew["layers"][name].numpy(), np.asarray(jnew["layers"][name])
        if method == "magnitude":  # equal values; the sign of a masked zero is XLA's choice (docstring)
            assert np.array_equal(a, b) and np.array_equal(a[a != 0].view(np.uint32), b[a != 0].view(np.uint32)), name
        else:
            assert _frob(a, b) <= SGPT_FROB, (name, _frob(a, b))
        assert (tnew["layers"][name][~tmasks[name]] == 0).all()
    for k in ("embed_tokens", "norm", "lm_head"):
        assert tnew[k] is tp[k]
    assert tp["layers"]["mlp.up_proj"].count_nonzero() == tp["layers"]["mlp.up_proj"].numel()  # not written


def test_sparsify_needs_batches_for_sparsegpt_and_a_known_method(tiny):
    _, _, tcfg, tp, _ = tiny
    with pytest.raises(ValueError, match="calib_batches"):
        tsp.sparsify(tcfg, tp, "sparsegpt")
    with pytest.raises(ValueError, match="unknown sparsity method"):
        tsp.sparsify(tcfg, tp, "wanda")


def test_reapply_and_export_match_jax(tiny):
    jcfg, jp, tcfg, tp, _ = tiny
    _, jmasks = jsp.sparsify(jcfg, jp)
    tmasks = convert.params_from_jax(jax.tree.map(np.asarray, jmasks))
    moved = tree_map(lambda t: t + 0.01, tp)  # a training step's dense update
    jmoved = tree_map(lambda a: a + 0.01, jp)
    for jfn, tfn in ((jsp.reapply, tsp.reapply), (jsp.export, tsp.export)):
        jo, to = jfn(jmoved, jmasks), tfn(moved, tmasks)
        for name in tllama.PROJ_NAMES:
            assert np.array_equal(np.asarray(jo["layers"][name]).view(np.uint32),
                                  to["layers"][name].numpy().view(np.uint32)), name
        assert to["layers"]["input_layernorm"] is moved["layers"]["input_layernorm"]


def test_masked_adam_steps_match_jax(tiny):
    jcfg, jp, tcfg, tp, batches = tiny
    jsparse, jmasks = jsp.sparsify(jcfg, jp)
    tsparse, tmasks = tsp.sparsify(tcfg, tp)
    jlay, tlay = jllama.QuantLayout(sites=()), tllama.QuantLayout(sites=())
    jstep, jinit = jqat.make_optax_train_step(jcfg, jlay, optax.adam(1e-4), masks=jmasks)
    tstep, tinit = tqat.make_optax_train_step(tcfg, tlay, tqat.Adam(1e-4), masks=tmasks)
    jstep = jax.jit(jstep)
    jo, to = jinit(jsparse, None), tinit(tsparse, None)
    jq, tq = jsparse, tsparse
    for i in range(3):
        tok = batches[i]
        jq, _, jo, jloss = jstep(jq, None, jo, jnp.asarray(tok))
        tq, _, to, tloss = tstep(tq, None, to, torch.from_numpy(tok).long())
        assert abs(float(tloss) - float(jloss)) <= 1e-6 * abs(float(jloss))
        for name in tllama.PROJ_NAMES:
            assert (tq["layers"][name][~tmasks[name]] == 0).all(), (i, name)
            assert not torch.equal(tq["layers"][name], tsparse["layers"][name])
    flat_t = {f"layers/{k}": v for k, v in tq["layers"].items()} | {k: v for k, v in tq.items() if k != "layers"}
    flat_j = {f"layers/{k}": v for k, v in jq["layers"].items()} | {k: v for k, v in jq.items() if k != "layers"}
    worst = max((rel_err(flat_t[k].numpy(), np.asarray(flat_j[k])), k) for k in flat_t)
    assert worst[0] <= STEP_TOL, worst
