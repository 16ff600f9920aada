"""The port's DeepSeek serving (`serve/deepseek_engine.py`) against the JAX
package's, on `DeepseekConfig.tiny()` in f32 (`tests/_torch_deepseek.py`):
`compress` packs both layer groups and the routed experts' stacks bit-equal
to JAX's; for each preset the port's engine (its own calibration and packs,
the kernels' plain versions on the CPU) gives prefill logits within 1e-5 of
their scale of JAX's engine (its XLA backend on the CPU) and JAX's greedy
tokens, and its greedy tokens equal the model's own fake-quant cached
forward (JAX's `test_generate_matches_fakequant_decode`); the
`q_lora_rank = 0` and `first_k_dense_replace = 0` variants serve JAX's
tokens from JAX's packs; the entry points (`decode_step(unroll)`,
`decode`, `generate_host`) agree, and computing the scores a head at a
time changes nothing. The tests on the card are in
`tests/test_torch_deepseek_kernels.py`, which imports no JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_deepseek as shared
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import deepseek as jds
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.serve import deepseek_engine as jdse
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import deepseek as tds
from tensorrt_model_optimizer_tpu_torch.serve import deepseek_engine as tdse

PREFILL_REL = 1e-5  # f32: the plain GEMMs sum in another order than JAX's dequantize-and-matmul
NEW = 6
PROMPT = shared.TOKENS[:, :8]


def _bits(a):
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.element_size() == 1 and a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


@pytest.mark.parametrize("preset", shared.PRESETS)
def test_compress_packs_equal_jax(preset):
    """The port's `compress` of JAX's calibrated model: the same kinds and,
    in both groups, every packed array (routed experts [L, E, ...]) equal
    bit for bit; the rest of the params as they were."""
    jq, _ = shared.quantized(preset)
    jcm = shared.jax_compressed(preset)
    tcm = tdse.compress(convert.quantized_from_jax(jq))
    assert tcm.kinds == jcm.kinds
    for key in ("layers_dense", "layers_moe"):
        assert set(tcm.params[key]) == set(jcm.params[key]), key
        for name in tcm.kinds:
            if name not in tcm.params[key]:
                continue
            ja, ta = jcm.params[key][name], tcm.params[key][name]
            assert set(ja) == set(ta), (key, name)
            for k in ja:
                np.testing.assert_array_equal(_bits(ta[k]), _bits(ja[k]), err_msg=f"{key}.{name}.{k}")
    np.testing.assert_array_equal(tcm.params["layers_moe"]["moe.e_bias"].numpy(),
                                  np.asarray(jq.params["layers_moe"]["moe.e_bias"]))
    assert next(iter(tcm.params["layers_moe"]["moe.gate_proj"].values())).shape[:2] == (2, 4)
    assert tcm.packed_bytes > 0


@pytest.mark.parametrize("preset", shared.PRESETS)
def test_engine_matches_jax(preset):
    """The port calibrates, packs and serves on its own: prefill logits
    within PREFILL_REL of JAX's engine's (on JAX's packs) and the same
    greedy tokens; the port's engine on JAX's packs (`compressed_from_jax`)
    gives its own logits."""
    _, tq = shared.quantized(preset)
    jcm = shared.jax_compressed(preset)
    je = jdse.DeepseekEngine(jcm, max_seq_len=48)
    te = tdse.DeepseekEngine(tdse.compress(tq), max_seq_len=48, device="cpu")
    jl = np.asarray(je.prefill(jnp.asarray(PROMPT), je.init_cache(2))[0])
    tl = te.prefill(torch.from_numpy(PROMPT), te.init_cache(2)).numpy()
    assert rel_err(tl, jl) <= PREFILL_REL
    tj = tdse.DeepseekEngine(convert.compressed_from_jax(jcm), max_seq_len=48, device="cpu")
    assert rel_err(tj.prefill(torch.from_numpy(PROMPT), tj.init_cache(2)).numpy(), tl) <= PREFILL_REL
    jt = np.asarray(je.generate(jnp.asarray(PROMPT), NEW))
    np.testing.assert_array_equal(te.generate(torch.from_numpy(PROMPT), NEW).numpy(), jt)


@pytest.mark.parametrize("preset", shared.PRESETS)
def test_generate_matches_fakequant_decode(preset):
    """The engine's greedy tokens equal the model's own fake-quant cached
    forward's (the packs hold the grid values fake quantization rounds to;
    the latent is cached after kv_b's input quantizer in both)."""
    _, tq = shared.quantized(preset)
    te = tdse.DeepseekEngine(tdse.compress(tq), max_seq_len=48, device="cpu")
    got = te.generate(torch.from_numpy(PROMPT), NEW)
    cache = tds.init_cache(tq.model_cfg, 2, 48, device="cpu")
    logits, _, cache = tq.forward(torch.from_numpy(PROMPT), cache=cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    ref = [tok]
    for _ in range(NEW - 1):
        logits, _, cache = tq.forward(tok, cache=cache)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        ref.append(tok)
    np.testing.assert_array_equal(got.numpy(), torch.cat(ref, dim=1).numpy())


@pytest.mark.parametrize("variant", [dict(q_lora_rank=0), dict(first_k_dense_replace=0)],
                         ids=["q_lora_rank_0", "no_dense_layers"])
def test_variant_engines_match_jax(variant):
    """The variants served from JAX's packs (FP8 weights; without the input
    quantizers, whose static fp8 grid carries an f32 ulp of either
    package's sums across a rounding edge now and then: 0.27% of the logits'
    scale on the model without dense layers, in the fake-quant forwards of
    both packages alike): prefill logits and greedy tokens against JAX's
    engine."""
    jcfg, jp, _, _ = shared.pair(2, **variant)
    preset = jconfig.FP8_DEFAULT_CFG.with_rules({"*input_quantizer": {"enable": False}})
    jq = jds.quantize(jcfg, jp, preset, [jnp.asarray(shared.TOKENS)])
    jcm = jdse.compress(jq)
    je = jdse.DeepseekEngine(jcm, max_seq_len=32)
    te = tdse.DeepseekEngine(convert.compressed_from_jax(jcm), max_seq_len=32, device="cpu")
    assert ("ckv_dense" in te.init_cache(1)) == (jcfg.first_k_dense_replace > 0)
    jl = np.asarray(je.prefill(jnp.asarray(PROMPT), je.init_cache(2))[0])
    assert rel_err(te.prefill(torch.from_numpy(PROMPT), te.init_cache(2)).numpy(), jl) <= PREFILL_REL
    np.testing.assert_array_equal(te.generate(torch.from_numpy(PROMPT), 4).numpy(),
                                  np.asarray(je.generate(jnp.asarray(PROMPT), 4)))


def test_entry_points_agree(monkeypatch):
    """`decode_step(unroll=3)` returns the third of three eager steps and
    leaves their cache; `decode` and `generate_host` give `generate`'s
    tokens; a prefill into a used cache and a step past the cache raise;
    kv_b is dequantized once, in the model dtype, per layer; scores computed
    one head at a time (`SCORE_BYTES` small) give the same logits."""
    _, tq = shared.quantized("INT4_BLOCKWISE_WEIGHT_ONLY_CFG")
    cm = tdse.compress(tq)
    te = tdse.DeepseekEngine(cm, max_seq_len=16, device="cpu")
    assert set(te.cm.kinds.values()) == {"int4wo"}
    assert te._kvb["moe"][1].shape == (4, 32, 32) and te._kvb["moe"][1].dtype == torch.float32
    prompt = torch.from_numpy(PROMPT)
    gen = te.generate(prompt, 5)
    np.testing.assert_array_equal(te.generate_host(prompt, 5).numpy(), gen.numpy())
    caches = [te.init_cache(2) for _ in range(2)]
    first = [torch.argmax(te.prefill(prompt, c), dim=-1).to(torch.int32)[:, None] for c in caches]
    eager = first[0]
    for _ in range(3):
        eager = torch.argmax(te._model_step(eager, caches[0]), dim=-1).to(torch.int32)[:, None]
    fused, same = te.decode_step(first[1], caches[1], unroll=3)
    assert same is caches[1] and torch.equal(fused, eager)
    for key in caches[0]:
        assert torch.equal(caches[0][key], caches[1][key]), key
    cache = te.init_cache(2)
    te.prefill(prompt, cache)
    assert torch.equal(te.decode(gen[:, :1], cache, 4), gen[:, 1:])
    with pytest.raises(ValueError, match="empty cache"):
        te.prefill(prompt, caches[0])
    with pytest.raises(ValueError, match="rows"):
        te.decode_step(fused, caches[0], unroll=6)
    full = te.prefill(prompt, te.init_cache(2))
    monkeypatch.setattr(tdse, "SCORE_BYTES", 1)
    assert torch.allclose(te.prefill(prompt, te.init_cache(2)), full, rtol=1e-6, atol=1e-6)
