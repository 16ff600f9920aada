"""The port's DeepSeek model (`models/deepseek.py`) and its HF loader against
the JAX package's, on `DeepseekConfig.tiny()` in f32 with the same seeded
weights (`tests/_torch_deepseek.py`): routing (group-limited, the
correction bias) with equal expert indices and weights within 1e-6; the
naive and the cached (absorbed) forward's logits within 2e-5 of their scale
(f32 sums in another order); the absorbed form against the naive one within
JAX's own 2e-4 / 1e-3; every preset's calibrated amax within 1e-5, the
latent-cache sites included, and its fake-quant logits within 1e-4; the
`q_lora_rank = 0` and `first_k_dense_replace = 0` variants; the index
dispatch keeping JAX's capacity one-hot's pairs; the loader param by param
(equal) on an interleaved-rope checkpoint. And the two deliberate
differences: the yarn softmax scale (transformers' mscale squared) and the
refused `deepseek_v2`."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_deepseek as shared
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import deepseek as jds
from tensorrt_model_optimizer_tpu.models import hf_loader as jload
from tensorrt_model_optimizer_tpu.models.llama import RopeScaling as JRope
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import deepseek as tds
from tensorrt_model_optimizer_tpu_torch.models import hf_loader as tload

LOGITS_REL = 2e-5
AMAX_REL = 1e-5
FAKE_QUANT_REL = 1e-4


@pytest.mark.parametrize("case", ["group_limited", "e_bias_moves_choice_only", "v3_shape"])
def test_route_matches_jax(case):
    """Equal expert indices, weights within 1e-6: JAX's group-limited case
    (both picks from one group), its e_bias case (the bias picks expert 1,
    the weight stays sigmoid(0)) and V3's 256 experts in 8 groups, top-4
    groups, top-8, scaling 2.5, with a random bias."""
    rng = np.random.default_rng(3)
    if case == "group_limited":
        kw, logits, bias = dict(n_group=2, topk_group=1, n_routed_experts=4), rng.normal(size=(16, 4)), np.zeros(4)
    elif case == "e_bias_moves_choice_only":
        kw, logits = dict(n_group=1, topk_group=1, n_routed_experts=4, num_experts_per_tok=1), np.zeros((8, 4))
        bias = np.array([0.0, 5.0, 0.0, 0.0])
    else:
        kw = dict(n_group=8, topk_group=4, n_routed_experts=256, num_experts_per_tok=8, routed_scaling_factor=2.5)
        logits, bias = rng.normal(size=(64, 256)), 0.1 * rng.normal(size=256)
    jcfg = jds.DeepseekConfig.tiny(**kw)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    logits, bias = logits.astype(np.float32), bias.astype(np.float32)
    jw, ji = jds._route(jcfg, jnp.asarray(logits), jnp.asarray(bias))
    tw, ti = tds.route(tcfg, torch.from_numpy(logits), torch.from_numpy(bias))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    if case == "group_limited":
        assert (ti.numpy()[:, 0] // 2 == ti.numpy()[:, 1] // 2).all()
    if case == "e_bias_moves_choice_only":
        assert (ti.numpy() == 1).all()
        np.testing.assert_allclose(tw.numpy(), 0.5, atol=1e-6)


def test_dispatch_keeps_jax_capacity_pairs():
    """The index dispatch keeps the (token, choice) pairs JAX's one-hot
    [S, k, E, C] assignment keeps (`models/deepseek.py` `_moe_mlp`: a
    token-major cumulative count over the S k pairs, kept where < C), at
    a prefill's C and at C = 1, and lands each in the same expert row."""
    jcfg = jds.DeepseekConfig.tiny(n_routed_experts=8, num_experts_per_tok=3, n_group=2, topk_group=2)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    rng = np.random.default_rng(5)
    for S in (40, 2):
        logits = rng.normal(size=(S, 8)).astype(np.float32)
        topw, topi = tds.route(tcfg, torch.from_numpy(logits), torch.zeros(8))
        E, k, C = 8, 3, tds.capacity(tcfg, S)
        assert C == max(int(2.0 * S * k / E), 1)
        onehot = jax.nn.one_hot(jnp.asarray(topi.numpy()), E, dtype=jnp.float32)  # JAX's lines, as written
        pos = jnp.cumsum(onehot.reshape(S * k, E), axis=0).reshape(S, k, E) - 1.0
        in_cap = (pos < C) & (onehot > 0)
        slot = jax.nn.one_hot(pos.astype(jnp.int32), C, dtype=jnp.float32)
        assign = np.asarray(onehot[..., None] * in_cap[..., None] * slot)  # [S, k, E, C]
        d = tds.dispatch(tcfg, topw, topi, S)
        np.testing.assert_array_equal(d.keep.numpy(), assign.reshape(S * k, -1).sum(-1) > 0)
        rows = assign.reshape(S * k, E * C).argmax(-1)
        kept = d.keep.numpy()
        np.testing.assert_array_equal(d.dest.numpy()[kept], rows[kept])
        if S == 2:
            assert C == 1


def test_forward_naive_and_cached_match_jax():
    """The naive forward's logits and the cached forward's (a prefill of 8
    through the cache, then one token at a time) match JAX's; the absorbed
    steps equal the naive logits within JAX's 2e-4 / 1e-3."""
    jcfg, jp, tcfg, tp = shared.shared_pair()
    tok = shared.TOKENS
    jl = np.asarray(jds.forward(jcfg, jp, jnp.asarray(tok))[0])
    tl = tds.forward(tcfg, tp, torch.from_numpy(tok))[0].numpy()
    assert rel_err(tl, jl) <= LOGITS_REL
    jc, tc = jds.init_cache(jcfg, 2, 32), tds.init_cache(tcfg, 2, 32, device="cpu")
    for lo, hi in [(0, 8)] + [(t, t + 1) for t in range(8, 12)]:
        jlog, _, jc = jds.forward(jcfg, jp, jnp.asarray(tok[:, lo:hi]), cache=jc)
        tlog, _, tc = tds.forward(tcfg, tp, torch.from_numpy(tok[:, lo:hi]), cache=tc)
        assert rel_err(tlog.numpy(), np.asarray(jlog)) <= LOGITS_REL, (lo, hi)
        np.testing.assert_allclose(tlog.numpy(), tl[:, lo:hi], atol=2e-4, rtol=1e-3)
    assert int(tc["pos"]) == 12
    for key in ("ckv_dense", "kpe_dense", "ckv_moe", "kpe_moe"):
        assert rel_err(tc[key].numpy(), np.asarray(jc[key])) <= LOGITS_REL, key


@pytest.mark.parametrize("variant", [dict(q_lora_rank=0), dict(first_k_dense_replace=0)],
                         ids=["q_lora_rank_0", "no_dense_layers"])
def test_variants_match_jax(variant):
    """q_proj in place of q_a / q_b; no dense group (no "layers_dense", no
    "dense" state or cache): naive and cached logits, and FP8's calibrated
    state, against JAX's."""
    jcfg, jp, tcfg, tp = shared.pair(1, **variant)
    if "q_lora_rank" in variant:
        assert "self_attn.q_proj" in tp["layers_moe"] and "self_attn.q_a_proj" not in tp["layers_moe"]
    else:
        assert "layers_dense" not in tp and "ckv_dense" not in tds.init_cache(tcfg, 1, 4, device="cpu")
    tok = shared.TOKENS[:, :10]
    assert rel_err(tds.forward(tcfg, tp, torch.from_numpy(tok))[0].numpy(),
                   np.asarray(jds.forward(jcfg, jp, jnp.asarray(tok))[0])) <= LOGITS_REL
    jc = jds.init_cache(jcfg, 2, 16)
    tc = tds.init_cache(tcfg, 2, 16, device="cpu")
    jlog = jds.forward(jcfg, jp, jnp.asarray(tok), cache=jc)[0]
    tlog = tds.forward(tcfg, tp, torch.from_numpy(tok), cache=tc)[0]
    assert rel_err(tlog.numpy(), np.asarray(jlog)) <= LOGITS_REL
    jq = jds.quantize(jcfg, jp, "FP8_DEFAULT_CFG", [jnp.asarray(tok)])
    tq = tds.quantize(tcfg, tp, "FP8_DEFAULT_CFG", [torch.from_numpy(tok)], device="cpu")
    assert set(tq.qstate) == set(jq.qstate)
    for key, sub in tq.qstate.items():
        for name, st in sub.items():
            for which, s in (st.items() if isinstance(st, dict) else [("", st)]):
                j = jq.qstate[key][name][which] if which else jq.qstate[key][name]
                assert rel_err(s.amax.numpy(), np.asarray(j.amax)) <= AMAX_REL, (key, name, which)


@pytest.mark.parametrize("preset", shared.PRESETS)
def test_calibration_matches_jax(preset):
    """Max calibration on the same batch: the same sites in both groups,
    every amax within 1e-5 (the routed experts' per expert, kv_b's input on
    the latent, the latent-cache sites under NVFP4_KV), and the fake-quant
    forward's logits (naive and cached) within 1e-4."""
    jq, tq = shared.quantized(preset)
    assert set(tq.qstate) == set(jq.qstate) == {"dense", "moe"}
    n = 0
    for key, sub in tq.qstate.items():
        assert set(sub) == set(jq.qstate[key]), key
        for name, st in sub.items():
            for which, s in (st.items() if isinstance(st, dict) else [("", st)]):
                j = jq.qstate[key][name][which] if which else jq.qstate[key][name]
                assert tuple(s.amax.shape) == tuple(np.asarray(j.amax).shape), (key, name, which)
                assert rel_err(s.amax.numpy(), np.asarray(j.amax)) <= AMAX_REL, (key, name, which)
                n += 1
    assert tq.qstate["moe"]["moe.gate_proj"]["weight"].amax.shape[:2] == (2, 4)
    if preset == "NVFP4_KV_CFG":
        assert {"self_attn.ckv_bmm", "self_attn.kpe_bmm"} <= set(tq.qstate["moe"])
    if preset != "INT4_BLOCKWISE_WEIGHT_ONLY_CFG":
        assert "input" in tq.qstate["dense"]["self_attn.kv_b_proj"]
    tok = shared.TOKENS
    jl = np.asarray(jq.forward(jnp.asarray(tok))[0])
    assert rel_err(tq.forward(torch.from_numpy(tok))[0].numpy(), jl) <= FAKE_QUANT_REL
    jcfg, tcfg = jq.model_cfg, tq.model_cfg
    jc = jq.forward(jnp.asarray(tok[:, :8]), cache=jds.init_cache(jcfg, 2, 16))[0]
    tc = tq.forward(torch.from_numpy(tok[:, :8]), cache=tds.init_cache(tcfg, 2, 16, device="cpu"))[0]
    assert rel_err(tc.numpy(), np.asarray(jc)) <= FAKE_QUANT_REL


def test_quantize_without_batches_keeps_the_initial_state():
    """JAX's `quantize` runs no forward without batches: the state is
    `init_quant_state`'s."""
    _, _, tcfg, tp = shared.shared_pair()
    qm = tds.quantize(tcfg, tp, "FP8_DEFAULT_CFG", [], device="cpu")
    init = tds.init_quant_state(tcfg, qm.layout, "cpu")
    assert torch.equal(qm.qstate["moe"]["moe.gate_proj"]["weight"].amax, init["moe"]["moe.gate_proj"]["weight"].amax)


# --------------------------------------------------------------------------
# HF loader
# --------------------------------------------------------------------------


def _write_hf_ckpt(path, cfg, params, model_type="deepseek_v3", rope_scaling=None):
    """A transformers-convention checkpoint of the port's params: the rope
    rows interleaved back (rope_interleave), f32 tensors."""
    dr = cfg.qk_rope_head_dim
    inv = torch.empty(dr, dtype=torch.long)  # half-split -> interleaved rows
    inv[0::2], inv[1::2] = torch.arange(dr // 2), torch.arange(dr // 2, dr)

    def interleave_kva(w):
        return torch.cat([w[: w.shape[0] - dr], w[w.shape[0] - dr:][inv]])

    def interleave_q(w):
        hd = cfg.qk_head_dim
        h = w.reshape(w.shape[0] // hd, hd, -1)
        return torch.cat([h[:, : hd - dr], h[:, hd - dr:][:, inv]], dim=1).reshape(w.shape)

    flat = {"model.embed_tokens.weight": params["embed_tokens"], "model.norm.weight": params["norm"],
            "lm_head.weight": params["lm_head"]}
    Ld = cfg.first_k_dense_replace

    def put_attn(i, blk, j):
        p = f"model.layers.{i}.self_attn."
        flat[f"model.layers.{i}.input_layernorm.weight"] = blk["input_layernorm"][j]
        flat[f"model.layers.{i}.post_attention_layernorm.weight"] = blk["post_attention_layernorm"][j]
        flat[p + "kv_a_layernorm.weight"] = blk["self_attn.kv_a_norm"][j]
        flat[p + "kv_a_proj_with_mqa.weight"] = interleave_kva(blk["self_attn.kv_a_proj"][j])
        flat[p + "kv_b_proj.weight"] = blk["self_attn.kv_b_proj"][j]
        flat[p + "o_proj.weight"] = blk["self_attn.o_proj"][j]
        if cfg.q_lora_rank:
            flat[p + "q_a_proj.weight"] = blk["self_attn.q_a_proj"][j]
            flat[p + "q_a_layernorm.weight"] = blk["self_attn.q_a_norm"][j]
            flat[p + "q_b_proj.weight"] = interleave_q(blk["self_attn.q_b_proj"][j])
        else:
            flat[p + "q_proj.weight"] = interleave_q(blk["self_attn.q_proj"][j])

    for i in range(Ld):
        put_attn(i, params["layers_dense"], i)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            flat[f"model.layers.{i}.mlp.{proj}.weight"] = params["layers_dense"][f"mlp.{proj}"][i]
    moe = params["layers_moe"]
    for i in range(Ld, cfg.num_hidden_layers):
        j = i - Ld
        put_attn(i, moe, j)
        flat[f"model.layers.{i}.mlp.gate.weight"] = moe["moe.router"][j]
        if model_type == "deepseek_v3":
            flat[f"model.layers.{i}.mlp.gate.e_score_correction_bias"] = moe["moe.e_bias"][j]
        for proj in ("gate_proj", "up_proj", "down_proj"):
            for e in range(cfg.n_routed_experts):
                flat[f"model.layers.{i}.mlp.experts.{e}.{proj}.weight"] = moe[f"moe.{proj}"][j, e]
            flat[f"model.layers.{i}.mlp.shared_experts.{proj}.weight"] = moe[f"shared.{proj}"][j]
    tload.save_safetensors({k: v.float().contiguous() for k, v in flat.items()},
                           os.path.join(path, "model.safetensors"))
    hf = {"model_type": model_type, "rope_interleave": True, "vocab_size": cfg.vocab_size,
          "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
          "num_hidden_layers": cfg.num_hidden_layers, "num_attention_heads": cfg.num_attention_heads,
          "num_key_value_heads": cfg.num_key_value_heads, "rope_theta": cfg.rope_theta,
          "rms_norm_eps": cfg.rms_norm_eps, "max_position_embeddings": cfg.max_position_embeddings,
          "tie_word_embeddings": False, "q_lora_rank": cfg.q_lora_rank or None, "kv_lora_rank": cfg.kv_lora_rank,
          "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
          "v_head_dim": cfg.v_head_dim, "n_routed_experts": cfg.n_routed_experts,
          "num_experts_per_tok": cfg.num_experts_per_tok, "n_shared_experts": cfg.n_shared_experts,
          "moe_intermediate_size": cfg.moe_intermediate_size, "first_k_dense_replace": cfg.first_k_dense_replace,
          "n_group": cfg.n_group, "topk_group": cfg.topk_group, "routed_scaling_factor": cfg.routed_scaling_factor,
          "norm_topk_prob": cfg.norm_topk_prob}
    if rope_scaling is not None:
        hf["rope_scaling"] = rope_scaling
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)


@pytest.mark.parametrize("q_lora", [48, 0])
def test_interleaved_checkpoint_loads_as_jax(tmp_path, q_lora):
    """Both loaders read the same interleaved-rope checkpoint: every param
    equal, the rope rows back in half-split order (the port's loaded params
    equal the weights written), and `load_hf_moe_checkpoint` routes
    deepseek_v3 to the DeepSeek loader."""
    _, _, tcfg, tp = shared.pair(3, q_lora_rank=q_lora)
    _write_hf_ckpt(str(tmp_path), tcfg, tp)
    jcfg2, jp2 = jload.load_hf_deepseek_checkpoint(str(tmp_path), dtype=jnp.float32)
    tcfg2, tp2 = tload.load_hf_deepseek_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    assert convert.llama_cfg_from_jax(jcfg2) == tcfg2
    assert tcfg2.softmax_scale_factor == 1.0
    for key in ("layers_dense", "layers_moe"):
        assert set(tp2[key]) == set(jp2[key]) == set(tp[key]), key
        for name, t in tp2[key].items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jp2[key][name]), err_msg=f"{key}.{name}")
            np.testing.assert_array_equal(t.numpy(), tp[key][name].numpy(), err_msg=f"{key}.{name}")
    for name in ("embed_tokens", "norm", "lm_head"):
        np.testing.assert_array_equal(tp2[name].numpy(), np.asarray(jp2[name]))
    assert tp2["layers_moe"]["moe.e_bias"].dtype == torch.float32
    cfg3, _ = tload.load_hf_moe_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    assert isinstance(cfg3, tds.DeepseekConfig)


def _yarn(factor=40.0, mscale_all_dim=1.0):
    """DeepSeek-V3's published rope_scaling (config.json)."""
    return {"type": "yarn", "factor": factor, "beta_fast": 32, "beta_slow": 1, "mscale": 1.0,
            "mscale_all_dim": mscale_all_dim, "original_max_position_embeddings": 4096}


@pytest.mark.parametrize("factor,mscale_all_dim", [(40.0, 1.0), (40.0, 0.707), (4.0, 1.0), (40.0, 0.0)])
def test_yarn_softmax_scale_is_transformers(tmp_path, factor, mscale_all_dim):
    """A deliberate difference: the port's loaded DeepSeek scales its
    softmax as transformers' `DeepseekV3Attention` does (1/sqrt(qk_head_dim)
    times yarn_get_mscale(factor, mscale_all_dim)^2: 1.874 for V3's factor 40),
    where JAX's loader keeps only the cos / sin factor and so serves a real
    V3 with scores 1.874x too small."""
    tf = pytest.importorskip("transformers.models.deepseek_v3.modeling_deepseek_v3")
    from transformers import DeepseekV3Config

    _, _, tcfg, tp = shared.pair(4)
    _write_hf_ckpt(str(tmp_path), tcfg, tp, rope_scaling=_yarn(factor, mscale_all_dim))
    cfg2, _ = tload.load_hf_deepseek_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    hf = DeepseekV3Config(hidden_size=tcfg.hidden_size, num_attention_heads=tcfg.num_attention_heads,
                          q_lora_rank=tcfg.q_lora_rank, kv_lora_rank=tcfg.kv_lora_rank,
                          qk_nope_head_dim=tcfg.qk_nope_head_dim, qk_rope_head_dim=tcfg.qk_rope_head_dim,
                          v_head_dim=tcfg.v_head_dim, rope_scaling=_yarn(factor, mscale_all_dim))
    want = tf.DeepseekV3Attention(hf, 0).scaling
    assert math.isclose(tds.softmax_scale(cfg2), want, rel_tol=1e-12)
    if factor == 40.0 and mscale_all_dim == 1.0:
        assert math.isclose(cfg2.softmax_scale_factor, (1 + 0.1 * math.log(40)) ** 2, rel_tol=1e-12)
        jcfg2, _ = jload.load_hf_deepseek_checkpoint(str(tmp_path), dtype=jnp.float32)
        assert cfg2.rope_scaling.attention_factor == jcfg2.rope_scaling.attention_factor == 1.0


def test_yarn_config_with_the_factor_at_one_computes_jax():
    """With the softmax factor at 1 (every config JAX builds) the port's
    logits on a yarn config equal JAX's: the difference is the factor
    alone."""
    rope = dict(rope_type="yarn", factor=40.0, original_max_position_embeddings=16, beta_fast=32.0, beta_slow=1.0,
                attention_factor=1.0)
    jcfg, jp, tcfg, tp = shared.pair(5, rope_scaling=JRope(**rope), max_position_embeddings=640)
    assert tcfg.softmax_scale_factor == 1.0 and tcfg.rope_scaling.rope_type == "yarn"
    tok = shared.TOKENS
    jl = np.asarray(jds.forward(jcfg, jp, jnp.asarray(tok))[0])
    tl = tds.forward(tcfg, tp, torch.from_numpy(tok))[0].numpy()
    assert rel_err(tl, jl) <= LOGITS_REL
    import dataclasses

    scaled = tds.forward(dataclasses.replace(tcfg, softmax_scale_factor=1.874), tp, torch.from_numpy(tok))[0].numpy()
    assert rel_err(scaled, jl) > 1e-3


def test_deepseek_v2_is_refused_naming_its_router(tmp_path):
    """A deliberate difference: `deepseek_v2` routes by a softmax and ships
    no `e_score_correction_bias`. JAX's loader reads it all the same and
    fails on the missing bias (a KeyError); the port refuses the model type
    with a NotImplementedError that names the router, in both loaders."""
    _, _, tcfg, tp = shared.pair(6)
    _write_hf_ckpt(str(tmp_path), tcfg, tp, model_type="deepseek_v2")
    with pytest.raises(KeyError, match="e_score_correction_bias"):
        jload.load_hf_deepseek_checkpoint(str(tmp_path), dtype=jnp.float32)
    for load in (tload.load_hf_deepseek_checkpoint, tload.load_hf_moe_checkpoint):
        with pytest.raises(NotImplementedError, match="softmax"):
            load(str(tmp_path), dtype=torch.float32, device="cpu")
