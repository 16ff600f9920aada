"""The port's Llama4 model (`models/llama4.py`, `llama.rope_interleaved`)
against the JAX package's on a tiny model (4 layers, the 4th a nope layer;
chunk 8, floor_scale 8) in f32: interleaved rope (within 1e-5 of its
scale: XLA's f32 sin / cos and torch's differ in the last bits),
`rope_or_temperature` on rope and nope layers past floor_scale (1e-5), the forward and its captures at 20 tokens, past the chunk and
floor_scale (1e-5 of their scale: f32 sums in another order), the chunk's
reach, `quantize_family` under max (NVFP4), awq_lite, smoothquant and gptq
with the shared expert in the routed experts' capture group (every amax and
pre_quant_scale within 1e-5; folded weights within 1e-6; GPTQ's weights at
most GPTQ_APART_MAX apart) and `compress`'s packs, the shared expert's
dense [L, O, K] ones included, bit-equal to JAX's. The model is
`_torch_families.family_pair`'s (hidden 128, head_dim 32); JAX's quantized
and packed models are built once a process."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import CALIB, bits, family_pair, jax_compressed, quantized, state_errors
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.models import llama4 as jl4
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.models import llama4 as tl4
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress

T = 20  # prompt tokens: past the chunk and floor_scale of 8
GPTQ_APART_MAX = 2e-2
METHODS = {"max": "NVFP4_DEFAULT_CFG", "awq_lite": "INT4_AWQ_CFG", "smoothquant": "INT8_SMOOTHQUANT_CFG",
           "gptq": "INT4_GPTQ_CFG"}


@pytest.fixture(scope="module")
def l4():
    jcfg, jp, tcfg, tp = family_pair("llama4")
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, size=(2, T)).astype(np.int32)
    return jcfg, jp, tcfg, tp, tokens, CALIB


def _both(l4, preset):
    jq, tq = quantized("llama4", preset)
    assert tq.forward_fn is tl4.forward
    return jq, tq


def test_config_and_params_carry_over(l4):
    jcfg, jp, tcfg, tp, _, _ = l4
    assert type(tcfg) is tl4.Llama4Config
    assert tcfg.use_rope_layers() == jcfg.use_rope_layers() == (True, True, True, False)
    flags = (1, 0, 0, 1)  # HF's explicit no_rope_layers win over the every-4th rule
    assert (dataclasses.replace(tcfg, no_rope_layers=flags).use_rope_layers()
            == dataclasses.replace(jcfg, no_rope_layers=flags).use_rope_layers() == (True, False, False, True))
    ref = jl4.init_params(jcfg, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in tp["layers"].items()} == {k: v.shape for k, v in ref["layers"].items()}
    assert tl4.param_specs(tcfg)["layers"] == {k: tuple(v) for k, v in jl4.param_specs(jcfg)["layers"].items()}
    with pytest.raises(NotImplementedError, match="all-MoE"):
        tl4.init_params(dataclasses.replace(tcfg, interleave_moe_layer_step=2), torch.Generator(), "cpu")


@pytest.mark.parametrize("scaling", [None, "llama3", "yarn"])
def test_rope_interleaved_matches_jax(scaling):
    rs = {"llama3": dict(rope_type="llama3", factor=16.0, original_max_position_embeddings=64),
          "yarn": dict(rope_type="yarn", factor=32.0, original_max_position_embeddings=64, truncate=False)}.get(scaling)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None], (2, 40)).copy()
    want = jllama.rope_interleaved(jnp.asarray(x), jnp.asarray(pos), 5e5, rs and jllama.RopeScaling(**rs))
    got = tllama.rope_interleaved(torch.from_numpy(x), torch.from_numpy(pos), 5e5, rs and tllama.RopeScaling(**rs))
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5
    # the pairs are (2i, 2i + 1): rotating each pair keeps its norm
    n = lambda a: np.hypot(a[..., 0::2], a[..., 1::2])  # noqa: E731
    assert rel_err(n(got.numpy()) / tllama.rope_freqs(32, 5e5, rs and tllama.RopeScaling(**rs))[1], n(x)) < 1e-5


@pytest.mark.parametrize("use_rope", [True, False])
def test_rope_or_temperature_matches_jax(l4, use_rope):
    """Positions 0 .. 39 (floor_scale 8): interleaved rope and the L2 qk-norm
    on a rope layer; the log-floor temperature on a nope layer's q, > 1 from
    position 7 on, k untouched."""
    jcfg, _, tcfg, _, _, _ = l4
    rng = np.random.default_rng(4)
    q, k = (rng.standard_normal((2, 40, n, 16)).astype(np.float32) for n in (4, 2))
    pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None], (2, 40)).copy()
    jq, jk = jl4.rope_or_temperature(jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), jnp.asarray(use_rope))
    tq, tk = tl4.rope_or_temperature(tcfg, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos), use_rope)
    assert rel_err(tq.numpy(), np.asarray(jq)) < 1e-5 and rel_err(tk.numpy(), np.asarray(jk)) < 1e-5
    if not use_rope:
        scale = tl4.temperature(tcfg, torch.from_numpy(pos))[0]
        assert float(scale[6]) == 1.0 and float(scale[7]) > 1.0 and float(scale[39]) > float(scale[7])
        np.testing.assert_array_equal(tk.numpy(), k)


def test_forward_and_captures_match_jax(l4):
    jcfg, jp, tcfg, tp, tokens, _ = l4
    jl, _, jcaps = jl4.forward(jcfg, jp, jnp.asarray(tokens), capture_tokens=32)
    tl, _, tcaps = tl4.forward(tcfg, tp, torch.from_numpy(tokens), capture_tokens=32)
    assert rel_err(tl.numpy(), np.asarray(jl)) < 1e-5
    assert set(tcaps) == set(jcaps) == {"attn_in", "moe_in"}
    for key, t in tcaps.items():
        assert tuple(t.shape) == (4, 32, tcfg.hidden_size) and rel_err(t.numpy(), np.asarray(jcaps[key])) < 1e-5


@pytest.mark.parametrize("rope", [1, 0])
def test_the_chunk_bounds_what_a_rope_layer_sees(l4, rope):
    """One layer: a change of the first token moves only the first chunk's
    logits on a rope layer, every position's on a nope layer (JAX's logits
    equal on that model)."""
    jcfg, jp, tcfg, tp, tokens, _ = l4
    tcfg1 = dataclasses.replace(tcfg, num_hidden_layers=1, no_rope_layers=(rope,))
    jcfg1 = dataclasses.replace(jcfg, num_hidden_layers=1, no_rope_layers=(rope,))
    p1 = {**tp, "layers": {k: v[:1] for k, v in tp["layers"].items()}}
    other = tokens.copy()
    other[:, 0] = (other[:, 0] + 1) % tcfg.vocab_size
    a = tl4.forward(tcfg1, p1, torch.from_numpy(tokens))[0]
    b = tl4.forward(tcfg1, p1, torch.from_numpy(other))[0]
    moved = (a - b).abs().amax(dim=(0, 2)) > 0
    reach = tcfg.attention_chunk_size if rope else T
    assert moved.tolist() == [True] * reach + [False] * (T - reach)
    jl = jl4.forward(jcfg1, {**jp, "layers": {k: v[:1] for k, v in jp["layers"].items()}}, jnp.asarray(tokens))[0]
    assert rel_err(a.numpy(), np.asarray(jl)) < 1e-5


@pytest.mark.parametrize("method", sorted(METHODS))
def test_quantize_family_matches_jax(l4, method):
    jq, tq = _both(l4, METHODS[method])
    assert {"shared.gate_proj", "shared.down_proj"} <= set(tq.qstate)
    errs = state_errors(tq, jq)
    assert max(errs.values()) < 1e-5, max(errs.items(), key=lambda kv: kv[1])
    if method in ("awq_lite", "smoothquant"):  # the shared expert joins the routed experts' group
        assert "shared.gate_proj.input.pqs" in errs and "moe.gate_proj.input.pqs" in errs
    for name, w in tq.params["layers"].items():
        jw = np.asarray(jq.params["layers"][name])
        if method == "gptq" and name in tq.qstate and "weight" in tq.qstate[name]:
            apart = np.abs(w.numpy() - jw) > 1e-3 * np.abs(jw).max()
            assert apart.mean() <= GPTQ_APART_MAX, (name, apart.mean())
        else:
            assert rel_err(w.numpy(), jw) < 1e-6, name


def test_compress_packs_bit_equal_jax(l4):
    """JAX's NVFP4 model packed by both packages: every packed array
    bit-equal, the shared expert's as dense [L, O, K] layers; routers and
    norms pass through unpacked. (INT4 packs of the shared expert meet
    JAX's in tests/test_torch_family_engine.py, through served tokens.)"""
    jq = _both(l4, METHODS["max"])[0]
    jcm, tcm = jax_compressed("llama4", METHODS["max"]), tcompress.compress(convert.quantized_from_jax(jq))
    assert tcm.kinds == jcm.kinds and {"shared.gate_proj", "shared.up_proj", "shared.down_proj"} <= set(tcm.kinds)
    for name, arrays in tcm.params["layers"].items():
        ja = jcm.params["layers"][name]
        if name in tcm.kinds:
            assert set(arrays) == set(ja), name
            for k in ja:
                np.testing.assert_array_equal(bits(arrays[k]), bits(ja[k]), err_msg=f"{name}.{k}")
        else:
            np.testing.assert_array_equal(arrays.numpy(), np.asarray(ja), err_msg=name)
    lead = tcm.params["layers"]["shared.down_proj"]
    assert all(a.shape[0] == 4 and a.ndim == 3 for a in lead.values() if isinstance(a, torch.Tensor) and a.ndim > 1)
