"""The port's hybrid Mamba2 PTQ (`mamba.quantize`, `quantize_family("mamba")`,
`convert.quantized_from_jax` of its models) against the JAX package on one
seeded tiny f32 model (the model itself: tests/test_torch_mamba.py).

Tolerances: amaxes within 1e-6 relative; JAX's calibrated state carried
into the port gives JAX's fake-quant logits within 1e-5 of their scale;
each package's own state within 1e-4 on the two-batch calibration.
Calibrated on the evaluation batch itself, the FP8 state puts one
activation on the other side of a grid step in one package (the f32 ulp at
the calibration max), and the random tiny model carries that through
exp(dt A) to 4.6e-2 of the logits' scale in 8 of 48 positions: the
carried-state check is the one that holds the forward. Where JAX's family
calibration fails (AWQ, SmoothQuant, GPTQ: its capture forward), the port
refuses by name before any work."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mamba import mamba_pair, tokens
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import mamba as jm
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import mamba as tm
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq

TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return mamba_pair(0)


@pytest.fixture(scope="module")
def toks():
    return tokens(1)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _amaxes(qstate):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif t is not None and hasattr(t, "amax") and t.amax is not None:
            out[path] = _np(t.amax) if not isinstance(t.amax, tuple) else _np(t.amax[0])

    walk(qstate, "")
    return out


@pytest.mark.parametrize("preset", ["FP8_DEFAULT_CFG", "NVFP4_DEFAULT_CFG"])
def test_quantize(pair, toks, preset):
    jcfg, jp, tcfg, tp = pair
    calib = [toks[:, :16], toks[:, 8:]]
    jq = jm.quantize(jcfg, jp, preset, [jnp.asarray(b) for b in calib])
    tq = tm.quantize(tcfg, tp, preset, [torch.from_numpy(b) for b in calib], device="cpu")
    ja, ta = _amaxes(jq.qstate), _amaxes(tq.qstate)
    assert set(ja) == set(ta) and ja
    for k in ja:
        assert rel_err(ta[k], ja[k]) <= 1e-6, k
    carried = convert.quantized_from_jax(jq)
    assert isinstance(carried, tm.MambaQuantizedModel) and carried.layout == tq.layout
    jl = jq.forward(jnp.asarray(toks))[0]
    assert rel_err(_np(tq.forward(torch.from_numpy(toks))[0]), jl) <= 1e-4
    assert rel_err(_np(carried.forward(torch.from_numpy(toks))[0]), jl) <= TOL


def test_quantize_family_max(pair, toks):
    jcfg, jp, tcfg, tp = pair
    calib = [toks[:, :16], toks[:, 8:]]
    jq = jptq.quantize_family("mamba", jcfg, jp, "FP8_DEFAULT_CFG", [jnp.asarray(b) for b in calib])
    tq = tptq.quantize_family("mamba", tcfg, tp, "FP8_DEFAULT_CFG", [torch.from_numpy(b) for b in calib],
                              device="cpu")
    ja, ta = _amaxes(jq.qstate), _amaxes(tq.qstate)
    assert set(ja) == set(ta) and all(rel_err(ta[k], ja[k]) <= 1e-6 for k in ja)
    assert rel_err(_np(tq.forward(torch.from_numpy(toks))[0]), jq.forward(jnp.asarray(toks))[0]) <= 1e-4
    assert rel_err(_np(convert.quantized_from_jax(jq).forward(torch.from_numpy(toks))[0]),
                   jq.forward(jnp.asarray(toks))[0]) <= TOL


@pytest.mark.parametrize("preset,method", [("INT4_AWQ_CFG", "awq_lite"), ("W4A8_AWQ_BETA_CFG", "awq_lite"),
                                           ("INT8_SMOOTHQUANT_CFG", "smoothquant"), ("INT4_GPTQ_CFG", "gptq")])
def test_quantize_family_refusals(pair, toks, preset, method, monkeypatch):
    """JAX fails inside its capture forward (mamba.forward takes no
    capture_tokens); the port refuses by name before any work."""
    jcfg, jp, tcfg, tp = pair
    with pytest.raises(TypeError, match="capture_tokens"):
        jptq.quantize_family("mamba", jcfg, jp, preset, [jnp.asarray(toks)])
    monkeypatch.setattr(tm, "forward", None)  # no forward may run before the refusal
    with pytest.raises(NotImplementedError, match=method):
        tptq.quantize_family("mamba", tcfg, tp, preset, [torch.from_numpy(toks)], device="cpu")


def test_embedding_and_head_unquantized_in_both(pair, toks):
    """Shared by both packages: `build_layout` resolves the embedding and
    lm_head weight sites, but neither forward applies them (ROADMAP queue
    3). Under a config that enables both sites the logits equal the plain
    forward's when every per-block site is off."""
    from tensorrt_model_optimizer_tpu.quant import config as jqc
    from tensorrt_model_optimizer_tpu_torch.quant import config as tqc

    jcfg, jp, tcfg, tp = pair
    rules = {"*": {"enable": False}, "*lm_head.weight_quantizer": {"num_bits": 4, "axis": 0},
             "*embed_tokens.weight_quantizer": {"num_bits": 4, "axis": 0}}
    jq_cfg = jqc.get_preset("INT8_DEFAULT_CFG").with_rules(rules)
    tq_cfg = tqc.get_preset("INT8_DEFAULT_CFG").with_rules(rules)
    jl_, tl_ = jm.build_layout(jcfg, jq_cfg), tm.build_layout(tcfg, tq_cfg)
    assert jl_.get("lm_head.weight").enable and tl_.get("lm_head.weight").enable
    assert jl_.get("embed_tokens.weight").enable and tl_.get("embed_tokens.weight").enable
    jq = jm.quantize(jcfg, jp, jq_cfg, [jnp.asarray(toks)])
    tq = tm.quantize(tcfg, tp, tq_cfg, [torch.from_numpy(toks)], device="cpu")
    plain_j, plain_t = jm.forward(jcfg, jp, jnp.asarray(toks))[0], tm.forward(tcfg, tp, torch.from_numpy(toks))[0]
    np.testing.assert_array_equal(np.asarray(jq.forward(jnp.asarray(toks))[0]), np.asarray(plain_j))
    assert torch.equal(tq.forward(torch.from_numpy(toks))[0], plain_t)
