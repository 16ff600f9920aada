"""The port's Minitron pruning (`prune/minitron.py`, `prune/minitron_moe.py`)
against the JAX package, the same seeded weights in both.

 - `importance`: every score (KV groups, FFN channels, hidden channels,
   depth) within 1e-5 relative of JAX's (f32 means in another order).
 - `prune`: from JAX's scores, plans equal and every sliced tensor bit-equal
   to JAX's, for width (FFN), KV groups, depth and hidden (head_dim kept);
   from the port's own scores, the same plans. The pruned model's logits
   within 1e-5 of JAX's pruned model's.
 - `expert_importance` / `prune_experts` on the tiny Mixtral, Qwen3-MoE's
   router (q/k norms, normalized top-k) and the top-k usage count of the
   softmax-after-top-k and sigmoid routers: scores within 1e-5 (the usage
   counts equal), plans and gathered leaves equal, logits within 1e-5.
 - A pruned model (hidden 256 -> 128, FFN 512 -> 256: every K a whole number
   of 128-blocks, JAX's W4A8 tiling) through PTQ -> compress -> the kernel
   engine (W4A8, int8 KV): greedy tokens equal to JAX's engine's (Pallas in
   interpret mode), logits within 1e-3 (the engine tests' rule)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.models import mixtral as jmix
from tensorrt_model_optimizer_tpu.prune import minitron as jmin
from tensorrt_model_optimizer_tpu.prune import minitron_moe as jmoe
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.models import mixtral as tmix
from tensorrt_model_optimizer_tpu_torch.prune import minitron as tmin
from tensorrt_model_optimizer_tpu_torch.prune import minitron_moe as tmoe
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine

SCORE_TOL = 1e-5
LOGITS_TOL = 1e-5
# 4 layers so that depth pruning has a choice; 4 kv groups of one q head each
DIMS = dict(num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4)
TARGETS = {
    "ffn": dict(intermediate_size=64),
    "kv_groups": dict(num_kv_heads=2),
    "depth": dict(num_layers=2),
    "hidden": dict(hidden_size=48),
    "all": dict(intermediate_size=96, num_kv_heads=2, hidden_size=32, num_layers=3),
}


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    pnp = llama_params_np(jcfg, seed=0)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32) for _ in range(3)]
    jp = tree_map(jnp.asarray, pnp)
    jscores = jmin.importance(jcfg, jp, [jnp.asarray(b) for b in batches])
    tcfg, tp = convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp)
    tscores = tmin.importance(tcfg, tp, [torch.from_numpy(b).long() for b in batches])
    return jcfg, jp, jscores, tcfg, tp, tscores, batches


def test_importance_matches_jax(tiny):
    _, _, js, _, _, ts, _ = tiny
    for f in ("kv_group", "ffn", "hidden", "layer"):
        a, b = getattr(ts, f), getattr(js, f)
        assert isinstance(a, np.ndarray) and a.shape == b.shape and a.dtype == b.dtype, f
        assert rel_err(a, b) <= SCORE_TOL, (f, rel_err(a, b))
    assert ts.layer[-1] == ts.layer.max()


def _flat(p) -> dict:
    out = {f"layers/{k}": v for k, v in p["layers"].items()}
    out.update({k: v for k, v in p.items() if k != "layers"})
    return out


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_prune_plans_and_slices_equal_jax(tiny, target):
    jcfg, jp, js, tcfg, tp, ts, batches = tiny
    kw = TARGETS[target]
    jnc, jnp_, jplan = jmin.prune(jcfg, jp, js, **kw)
    tnc, tnp_, tplan = tmin.prune(tcfg, tp, js, **kw)  # JAX's scores: the same numpy selections
    own = tmin.prune(tcfg, tp, ts, **kw)[2]  # the port's own scores: the same plan
    for f in ("keep_kv_groups", "keep_ffn", "keep_hidden", "keep_layers"):
        assert np.array_equal(getattr(tplan, f), getattr(jplan, f)), f
        assert np.array_equal(getattr(own, f), getattr(jplan, f)), f
    for f in ("num_hidden_layers", "num_key_value_heads", "num_attention_heads", "intermediate_size",
              "hidden_size", "head_dim"):
        assert getattr(tnc, f) == getattr(jnc, f), f
    assert tnc.hd == tcfg.hd  # head_dim kept under hidden pruning
    jf, tf = _flat(jnp_), _flat(tnp_)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert np.array_equal(tf[k].numpy().view(np.uint32), np.asarray(jf[k]).view(np.uint32)), k
    tok = batches[0]
    jl = np.asarray(jllama.forward(jnc, jnp_, jnp.asarray(tok))[0])
    with torch.no_grad():
        tl = tllama.forward(tnc, tnp_, torch.from_numpy(tok).long())[0].numpy()
    assert rel_err(tl, jl) <= LOGITS_TOL


MOE_CASES = {
    "mixtral": {},
    "qwen3_moe": dict(qk_norm=True, norm_topk_prob=True),
    "topk_softmax": dict(router_softmax_after_topk=True),
    "sigmoid_input_scaled": dict(router_sigmoid_input_scaled=True),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_expert_pruning_matches_jax(case):
    jcfg = jmix.MixtralConfig.tiny(num_experts=8, top_k=2, capacity_factor=4.0, **MOE_CASES[case])
    tcfg = convert.llama_cfg_from_jax(jcfg)
    jp = jmix.init_params(jcfg, jax.random.PRNGKey(3))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32) for _ in range(2)]
    js = np.asarray(jmoe.expert_importance(jcfg, jp, [jnp.asarray(b) for b in batches]))
    ts = tmoe.expert_importance(tcfg, tp, [torch.from_numpy(b).long() for b in batches])
    assert ts.shape == (2, 8) and ts.dtype == torch.float32
    if jcfg.router_sigmoid_input_scaled or jcfg.router_softmax_after_topk:  # usage counts: exact
        assert np.array_equal(ts.numpy(), js)
        assert np.allclose(ts.numpy().sum(-1), jcfg.top_k)
    else:
        assert rel_err(ts.numpy(), js) <= SCORE_TOL
        assert np.allclose(ts.numpy().sum(-1), 1.0, atol=1e-5)
    jnc, jpp = jmoe.prune_experts(jcfg, jp, 4, js)
    tnc, tpp = tmoe.prune_experts(tcfg, tp, 4, ts)
    assert (tnc.num_experts, tnc.top_k) == (jnc.num_experts, jnc.top_k) == (4, 2)
    for k in jpp["layers"]:
        assert np.array_equal(tpp["layers"][k].numpy().view(np.uint32), np.asarray(jpp["layers"][k]).view(np.uint32)), k
    tok = batches[1]
    jl = np.asarray(jmix.forward(jnc, jpp, jnp.asarray(tok))[0])
    with torch.no_grad():
        tl = tmix.forward(tnc, tpp, torch.from_numpy(tok).long())[0].numpy()
    assert rel_err(tl, jl) <= LOGITS_TOL
    # the one-call form, with the family forward named
    again = tmoe.prune_moe(tcfg, tp, [torch.from_numpy(b).long() for b in batches], 4, forward_fn=tmix.forward)[1]
    assert all(torch.equal(again["layers"][k], tpp["layers"][k]) for k in tpp["layers"])


ENGINE_DIMS = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4, num_key_value_heads=2)
PRESET = "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"


def test_pruned_model_serves_as_jax():
    jcfg = jllama.LlamaConfig.tiny(**ENGINE_DIMS)
    pnp = llama_params_np(jcfg, seed=1)
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32) for _ in range(2)]
    prompt = rng.integers(0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    jp = tree_map(jnp.asarray, pnp)
    kw = dict(hidden_size=128, intermediate_size=256)
    jnc, jpp, _ = jmin.prune(jcfg, jp, jmin.importance(jcfg, jp, [jnp.asarray(b) for b in batches]), **kw)
    jcm = jcompress.compress(jptq.quantize(jnc, jpp, PRESET))
    jeng = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=32, backend="pallas", kv_dtype=jnp.int8,
                                                    int4_layout="a8", kv_attention_kernel=True))
    assert set(jeng.cm.kinds.values()) == {"int4w48"}
    jlogits = np.asarray(jeng.prefill(jnp.asarray(prompt), jeng.init_cache(2))[0])
    jtoks = np.asarray(jeng.generate(jnp.asarray(prompt), 6))

    tcfg, tp = convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp)
    tnc, tpp, _ = tmin.prune(tcfg, tp, tmin.importance(tcfg, tp, [torch.from_numpy(b).long() for b in batches]),
                             **kw)
    assert dataclasses.asdict(tnc)["hidden_size"] == 128 and tnc.hd == 64
    cm = tcompress.compress(tptq.quantize(tnc, tpp, PRESET, device="cpu"))
    eng = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=32, kv_dtype=torch.int8, int4_layout="a8",
                                                  kv_attention_kernel=True), device="cpu")
    logits = eng.prefill(torch.from_numpy(prompt), eng.init_cache(2))
    assert rel_err(logits.numpy(), jlogits) < 1e-3
    np.testing.assert_array_equal(eng.generate(torch.from_numpy(prompt), 6).numpy(), jtoks)
