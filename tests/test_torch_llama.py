"""The port's Llama and loader against JAX's on the in-repo trained
checkpoint `artifacts/anchor-llama` (6 layers, hidden 256, GQA 8/4), loaded
by both loaders: equal weights, forward logits within 1e-4 relative (f32;
matmul sums in another order), equal calibration amax; and llama-3.1 RoPE
scaling at 8B's head width."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import hf_loader as jload
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch.models import hf_loader as tload
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq

ANCHOR = os.path.join(os.path.dirname(__file__), "..", "artifacts", "anchor-llama")


@pytest.fixture(scope="module")
def anchor():
    jcfg, jp = jload.load_hf_checkpoint(ANCHOR, dtype=jnp.float32)
    tcfg, tp = tload.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    return jcfg, jp, tcfg, tp, tokens


def test_loaders_agree(anchor):
    jcfg, jp, tcfg, tp, _ = anchor
    assert (tcfg.num_hidden_layers, tcfg.hidden_size, tcfg.hd, tcfg.num_key_value_heads) == (
        jcfg.num_hidden_layers, jcfg.hidden_size, jcfg.hd, jcfg.num_key_value_heads)
    np.testing.assert_array_equal(tp["embed_tokens"].numpy(), np.asarray(jp["embed_tokens"]))
    for name in tllama.PROJ_NAMES + ("input_layernorm",):
        np.testing.assert_array_equal(tp["layers"][name].numpy(), np.asarray(jp["layers"][name]))


def test_bf16_load_is_bit_exact(anchor):
    _, jp = jload.load_hf_checkpoint(ANCHOR)  # bf16 default on both sides
    _, tp = tload.load_hf_checkpoint(ANCHOR, device="cpu")
    assert tp["lm_head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["lm_head"].view(torch.uint16).numpy(),
                                  np.asarray(jp["lm_head"]).view(np.uint16))


def test_forward_logits_match(anchor):
    jcfg, jp, tcfg, tp, tokens = anchor
    jl = np.asarray(jllama.forward(jcfg, jp, jnp.asarray(tokens))[0])
    tl, _, _ = tllama.forward(tcfg, tp, torch.from_numpy(tokens))
    assert rel_err(tl.numpy(), jl) < 1e-4


@pytest.mark.parametrize("preset", ["INT8_DEFAULT_CFG", "FP8_KV_CFG"])
def test_calibration_amax(anchor, preset):
    jcfg, jp, tcfg, tp, tokens = anchor
    jm = jptq.quantize(jcfg, jp, preset, [jnp.asarray(tokens)])
    tm = tptq.quantize(tcfg, tp, preset, [torch.from_numpy(tokens)], device="cpu")
    assert set(tm.qstate) == set(jm.qstate)
    for name, sub in tm.qstate.items():
        jsub = jm.qstate[name]
        if not isinstance(sub, dict):  # the KV sites hold one state each
            sub, jsub = {"kv": sub}, {"kv": jsub}
        for which, st in sub.items():
            j = jsub[which]
            if which == "weight":  # straight from the weights: bit-equal
                np.testing.assert_array_equal(st.amax.numpy(), np.asarray(j.amax))
            else:  # activations: f32 matmuls in another order
                assert rel_err(st.amax.numpy(), np.asarray(j.amax)) < 1e-5


def test_weight_fake_quant_forward(anchor):
    """INT4 block weights, no activation quant: logits within 1e-4. (With
    per-tensor int8 activations an ulp of difference in an f32 sum moves a
    rounding boundary, and six layers amplify each flipped code.)"""
    jcfg, jp, tcfg, tp, tokens = anchor
    preset = "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"
    jm = jptq.quantize(jcfg, jp, preset)
    tm = tptq.quantize(tcfg, tp, preset, device="cpu")
    jl = np.asarray(jm.forward(jnp.asarray(tokens))[0])
    tl = tm.forward(torch.from_numpy(tokens))[0]
    assert rel_err(tl.numpy(), jl) < 1e-4


def test_llama31_rope_scaling():
    jcfg, tcfg = jllama.LlamaConfig.llama3_8b(), tllama.LlamaConfig.llama3_8b()
    jf, _ = jllama.rope_freqs(jcfg.hd, jcfg.rope_theta, jcfg.rope_scaling)
    tf, _ = tllama.rope_freqs(tcfg.hd, tcfg.rope_theta, tcfg.rope_scaling)
    assert rel_err(tf.numpy(), np.asarray(jf)) < 1e-6
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4, 2, tcfg.hd)).astype(np.float32)
    pos = np.array([[0, 1, 2047, 9000]], np.int32)
    jr = np.asarray(jllama.rope(jnp.asarray(x), jnp.asarray(pos), jcfg.rope_theta, jcfg.rope_scaling))
    tr = tllama.rope(torch.from_numpy(x), torch.from_numpy(pos), tcfg.rope_theta, tcfg.rope_scaling)
    np.testing.assert_allclose(tr.numpy(), jr, atol=5e-4, rtol=0)  # cos/sin of angles ~1e4 rad


def test_init_params_is_seeded():
    cfg = tllama.LlamaConfig.tiny()
    a = tllama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tllama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["layers"]["mlp.down_proj"], b["layers"]["mlp.down_proj"])
    assert a["layers"]["mlp.down_proj"].shape == (cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size)
