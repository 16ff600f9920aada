"""The port's GPT-OSS model (`models/gpt_oss.py`, `llama.sink_softmax`)
against the JAX package's on a tiny model (2 layers, sliding then full,
window 8; sinks N(0, 1), every bias N(0, 0.5^2)) in f32: the sink softmax
(within 1e-6 of its scale), the forward and its captures at 20 tokens, past
the window (within 1e-5 of their scale: f32 sums in another order), the
sliding window's reach, `quantize_family` under max (MXFP4), awq_lite,
smoothquant and gptq (every amax and pre_quant_scale within 1e-5 of its
scale; folded weights within 1e-6; GPTQ's weights at most GPTQ_APART_MAX
apart, each by code steps at rounding ties) and `compress`'s packs, bit-equal
to JAX's. The model is `_torch_families.family_pair`'s (hidden 128,
head_dim 32); JAX's quantized and packed models are built once a process."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import CALIB, bits, family_pair, jax_compressed, quantized, state_errors
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import gpt_oss as jgpt
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import gpt_oss as tgpt
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq

T = 20  # prompt tokens: past the window of 8
GPTQ_APART_MAX = 2e-2
METHODS = {"max": "MXFP4_DEFAULT_CFG", "awq_lite": "INT4_AWQ_CFG", "smoothquant": "INT8_SMOOTHQUANT_CFG",
           "gptq": "INT4_GPTQ_CFG"}


@pytest.fixture(scope="module")
def oss():
    jcfg, jp, tcfg, tp = family_pair("gpt_oss")
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, size=(2, T)).astype(np.int32)
    return jcfg, jp, tcfg, tp, tokens, CALIB


def _both(oss, preset):
    jq, tq = quantized("gpt_oss", preset)
    assert tq.forward_fn is tgpt.forward
    return jq, tq


def test_config_and_params_carry_over(oss):
    jcfg, jp, tcfg, tp, _, _ = oss
    assert type(tcfg) is tgpt.GptOssConfig and tcfg.layer_flags() == (True, False)
    assert tcfg.resolved_layer_types() == jcfg.resolved_layer_types() == ("sliding_attention", "full_attention")
    ref = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    assert set(tp["layers"]) == set(ref["layers"])
    assert {k: tuple(v.shape) for k, v in tp["layers"].items()} == {k: v.shape for k, v in ref["layers"].items()}
    assert tgpt.param_specs(tcfg)["layers"] == {k: tuple(v) for k, v in jgpt.param_specs(jcfg)["layers"].items()}


def test_sink_softmax_matches_jax():
    """Scores with masked entries (-1e9) and per-head sinks: the sink joins
    the max and the denominator and its mass is dropped, as in JAX; a very
    negative sink gives the plain softmax."""
    rng = np.random.default_rng(2)
    scores = (3 * rng.standard_normal((2, 4, 5, 9))).astype(np.float32)
    scores[..., 6:] = -1e9
    sinks = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jllama.sink_softmax(jnp.asarray(scores), jnp.asarray(sinks), jnp.float32))
    got = tllama.sink_softmax(torch.from_numpy(scores.copy()), torch.from_numpy(sinks), torch.float32).numpy()
    assert rel_err(got, want) < 1e-6
    assert float(got.sum(-1).max()) < 1.0
    plain = torch.softmax(torch.from_numpy(scores), dim=-1).numpy()
    none = tllama.sink_softmax(torch.from_numpy(scores.copy()), torch.full((4,), -1e4), torch.float32).numpy()
    assert rel_err(none, plain) < 1e-6


def test_forward_and_captures_match_jax(oss):
    jcfg, jp, tcfg, tp, tokens, _ = oss
    jl, _, jcaps = jgpt.forward(jcfg, jp, jnp.asarray(tokens), capture_tokens=32)
    tl, _, tcaps = tgpt.forward(tcfg, tp, torch.from_numpy(tokens), capture_tokens=32)
    assert rel_err(tl.numpy(), np.asarray(jl)) < 1e-5
    assert set(tcaps) == set(jcaps) == {"attn_in", "moe_in"}
    for key, t in tcaps.items():
        assert tuple(t.shape) == (2, 32, tcfg.hidden_size) and rel_err(t.numpy(), np.asarray(jcaps[key])) < 1e-5


@pytest.mark.parametrize("types", [("sliding_attention",), ("full_attention",)])
def test_the_window_bounds_what_a_sliding_layer_sees(oss, types):
    """One layer: a change of the first token moves every later position's
    logits under full attention, and only the first `window` positions'
    under the sliding window (JAX's logits equal on that model)."""
    jcfg, jp, tcfg, tp, tokens, _ = oss
    one = {k: v[:1] for k, v in tp["layers"].items()}
    tcfg1 = dataclasses.replace(tcfg, num_hidden_layers=1, layer_types=types)
    jcfg1 = dataclasses.replace(jcfg, num_hidden_layers=1, layer_types=types)
    p1 = {**tp, "layers": one}
    other = tokens.copy()
    other[:, 0] = (other[:, 0] + 1) % tcfg.vocab_size
    a = tgpt.forward(tcfg1, p1, torch.from_numpy(tokens))[0]
    b = tgpt.forward(tcfg1, p1, torch.from_numpy(other))[0]
    moved = (a - b).abs().amax(dim=(0, 2)) > 0
    reach = T if types[0] == "full_attention" else tcfg.sliding_window
    assert moved.tolist() == [True] * reach + [False] * (T - reach)
    jl = jgpt.forward(jcfg1, {**jp, "layers": {k: v[:1] for k, v in jp["layers"].items()}}, jnp.asarray(tokens))[0]
    assert rel_err(a.numpy(), np.asarray(jl)) < 1e-5


@pytest.mark.parametrize("method", sorted(METHODS))
def test_quantize_family_matches_jax(oss, method):
    jq, tq = _both(oss, METHODS[method])
    errs = state_errors(tq, jq)
    assert max(errs.values()) < 1e-5, max(errs.items(), key=lambda kv: kv[1])
    if method in ("awq_lite", "smoothquant"):
        assert any(k.endswith(".pqs") for k in errs)
    for name, w in tq.params["layers"].items():
        jw = np.asarray(jq.params["layers"][name])
        if method == "gptq" and name in tq.qstate and "weight" in tq.qstate[name]:
            apart = np.abs(w.numpy() - jw) > 1e-3 * np.abs(jw).max()
            assert apart.mean() <= GPTQ_APART_MAX, (name, apart.mean())
        else:
            assert rel_err(w.numpy(), jw) < 1e-6, name


def test_compress_packs_bit_equal_jax(oss):
    """JAX's MXFP4 model packed by both packages: every packed array
    bit-equal; sinks, the router, norms and every bias pass through
    unpacked, as they are. (NVFP4 packs meet JAX's in
    tests/test_torch_family_engine.py, through served tokens.)"""
    jq = _both(oss, METHODS["max"])[0]
    jcm, tcm = jax_compressed("gpt_oss", METHODS["max"]), tcompress.compress(convert.quantized_from_jax(jq))
    assert tcm.kinds == jcm.kinds and tcm.kinds["moe.gate_proj"] == "mxfp4"
    for name, arrays in tcm.params["layers"].items():
        ja = jcm.params["layers"][name]
        if name in tcm.kinds:
            assert set(arrays) == set(ja), name
            for k in ja:
                np.testing.assert_array_equal(bits(arrays[k]), bits(ja[k]), err_msg=f"{name}.{k}")
        else:
            assert name == "self_attn.sinks" or name.endswith(("__bias", "layernorm")) or name == "moe.router", name
            np.testing.assert_array_equal(arrays.numpy(), np.asarray(ja), err_msg=name)


def test_unsupported_methods_raise_as_jax(oss):
    jcfg, jp, tcfg, tp, _, calib = oss
    with pytest.raises(NotImplementedError, match="llama-family only"):
        jptq.quantize_family("gpt_oss", jcfg, jp, "INT4_SVDQUANT_CFG", [jnp.asarray(b) for b in calib])
    with pytest.raises(NotImplementedError, match="llama-family only"):
        tptq.quantize_family("gpt_oss", tcfg, tp, "INT4_SVDQUANT_CFG", [torch.from_numpy(b) for b in calib],
                             device="cpu")
