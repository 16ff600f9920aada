"""The port's AutoQuantize (`quant/auto.py`) against the JAX package on
tiny models, the same seeded weights in both.

 - `_solve_ilp`: the same picks as JAX's on seeded problems (MILP and the
   greedy fallback), the one-hot and budget constraints held.
 - `_collect_grads_and_inputs`: every capture and every probe gradient
   within 1e-5 of JAX's compiled pass (f32 sums in another order).
 - `auto_quantize` ("gradient" and "kl_div" scores; budgets 4.5, 6 and 8
   bits): the same choice as JAX's, the achieved bits equal, the scores
   within 1e-4 relative; its calibrated mixed model runs through
   `llama.forward_unrolled` (and its cached form) to finite logits.
 - The .npz score checkpoint: a second call resumes from it (no scoring)
   to the same choice, and a new budget re-solves.
 - `auto_quantize_moe` on the tiny Mixtral and GPT-OSS: JAX's choice,
   bits and active-expert ratio.
 - `quant.api.auto_quantize` is this function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import gpt_oss as jgpt
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.models import mixtral as jmixtral
from tensorrt_model_optimizer_tpu.quant import auto as jauto
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import gpt_oss as tgpt
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import api as tapi
from tensorrt_model_optimizer_tpu_torch.quant import auto as tauto

CANDIDATES = ["INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "FP8_DEFAULT_CFG"]
SCORE_TOL = 1e-4  # "kl_div" KLs of near-equal logits: differences of nearly equal f32 sums


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    pnp = llama_params_np(jcfg, seed=0)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    return jcfg, tree_map(jnp.asarray, pnp), convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp), toks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ilp_and_greedy_pick_as_jax(seed):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 10, (12, 3))
    scores[:, 2] = scores[:, 0] * rng.uniform(0.01, 0.3, 12)  # the costly candidate scores lowest
    costs = np.tile([1.0, 2.0, 4.0], (12, 1)) * rng.uniform(1, 2, (12, 1))
    budget = float(costs[:, 1].sum())
    pick = tauto._solve_ilp(scores, costs, budget)
    assert np.array_equal(pick, jauto._solve_ilp(scores, costs, budget))
    assert costs[np.arange(12), pick].sum() <= budget + 1e-9
    greedy = tauto._solve_greedy(scores, costs, budget)
    assert costs[np.arange(12), greedy].sum() <= budget + 1e-9
    assert scores[np.arange(12), pick].sum() <= scores[np.arange(12), greedy].sum() + 1e-9
    # JAX's own test problem
    pick = tauto._solve_ilp(np.array([[10.0, 1.0]] * 3), np.array([[1.0, 4.0]] * 3), 9.0)
    assert (pick == 1).sum() == 2


def test_captures_and_gradients_equal_jax(tiny):
    jcfg, jp, tcfg, tp, toks = tiny
    jc, jg = jax.jit(lambda t: jauto._collect_grads_and_inputs(jcfg, jp, t, 16))(jnp.asarray(toks))
    tc, tg = tauto._collect_grads_and_inputs(tcfg, tp, torch.from_numpy(toks), 16)
    assert set(tc) == set(jc) and set(tg) == set(jg)
    for k in tc:
        assert tc[k].shape == jc[k].shape and rel_err(tc[k].numpy(), np.asarray(jc[k])) <= 1e-5, k
    for k in tg:
        assert tg[k].dtype == torch.float32 and rel_err(tg[k].numpy(), np.asarray(jg[k])) <= 1e-5, k


@pytest.mark.parametrize("bits", [4.5, 6.0, 8.0])
@pytest.mark.parametrize("method", ["gradient", "kl_div"])
def test_choice_equals_jax(tiny, bits, method):
    jcfg, jp, tcfg, tp, toks = tiny
    jr = jauto.auto_quantize(jcfg, jp, CANDIDATES, [jnp.asarray(toks)], bits, 16, method)
    tr = tauto.auto_quantize(tcfg, tp, CANDIDATES, [torch.from_numpy(toks)], bits, 16, method)
    assert tr.choice == jr.choice
    assert tr.effective_bits == jr.effective_bits and tr.effective_bits <= bits + 1e-9
    assert rel_err(tr.scores, jr.scores) <= SCORE_TOL
    if bits == 6.0:
        picks = [v for c in tr.choice for v in c.values()]
        assert 0 < picks.count(0) < len(picks)  # a real mix
        t = torch.from_numpy(toks).long()
        with torch.no_grad():
            full, _ = tllama.forward_unrolled(tcfg, tp, t, tr.layer_layouts, tr.qstate_list)
            cache = tllama.init_cache(tcfg, 2, 32, device="cpu")
            part, _, cache = tllama.forward_unrolled(tcfg, tp, t[:, :12], tr.layer_layouts, tr.qstate_list,
                                                     cache=cache)
        assert bool(torch.isfinite(full).all())
        assert rel_err(part[:, -1].numpy(), full[:, 11].numpy()) <= 1e-5


def test_score_checkpoint_resumes(tiny, tmp_path, monkeypatch):
    _, _, tcfg, tp, toks = tiny
    ckpt = str(tmp_path / "aq_scores.npz")
    r1 = tauto.auto_quantize(tcfg, tp, ["NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG"], [torch.from_numpy(toks)], 6.0, 16,
                             checkpoint_path=ckpt)
    assert (tmp_path / "aq_scores.npz").exists()

    def no_scoring(*a, **k):
        raise AssertionError("resumed from the checkpoint: no gradient pass")

    monkeypatch.setattr(tauto, "_collect_grads_and_inputs", no_scoring)
    r2 = tauto.auto_quantize(tcfg, tp, ["NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG"], [torch.from_numpy(toks)], 6.0, 16,
                             checkpoint_path=ckpt)
    assert r1.choice == r2.choice and r1.effective_bits == r2.effective_bits
    r3 = tauto.auto_quantize(tcfg, tp, ["NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG"], [torch.from_numpy(toks)], 4.6, 16,
                             checkpoint_path=ckpt)
    assert r3.effective_bits <= 4.6 + 1e-9
    assert tapi.auto_quantize is tauto.auto_quantize


@pytest.mark.parametrize("family", ["mixtral", "gpt_oss"])
def test_moe_choice_equals_jax(family):
    if family == "mixtral":
        jcfg = jmixtral.MixtralConfig.tiny()
        jp = jmixtral.init_params(jcfg, jax.random.PRNGKey(0))
        jfwd, tfwd = None, None
    else:
        jcfg = jgpt.GptOssConfig.tiny(capacity_factor=4.0)
        jp = jgpt.init_params(jcfg, jax.random.PRNGKey(31))
        jfwd, tfwd = jgpt.forward, tgpt.forward
    tcfg, tp = convert.llama_cfg_from_jax(jcfg), convert.params_from_jax(jp)
    toks = np.random.default_rng(3).integers(0, 256, (2, 16)).astype(np.int32)
    for bits in (4.6, 6.0):
        jr = jauto.auto_quantize_moe(jcfg, jp, ["NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG"], [jnp.asarray(toks)], bits, 16,
                                     forward_fn=jfwd)
        tr = tauto.auto_quantize_moe(tcfg, tp, ["NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG"], [torch.from_numpy(toks)],
                                     bits, 16, forward_fn=tfwd)
        assert tr.choice == jr.choice, (bits, tr.choice, jr.choice)
        assert abs(tr.effective_bits - jr.effective_bits) <= 1e-9 and tr.effective_bits <= bits + 1e-9
        assert tr.expert_cost_ratio == jr.expert_cost_ratio == jcfg.top_k / jcfg.num_experts
        assert tr.layer_layouts == [convert.layout_from_jax(lay) for lay in jr.layer_layouts]
