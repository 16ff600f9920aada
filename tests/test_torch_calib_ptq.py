"""`quant.ptq.quantize` of the port against the JAX package's, for every
calibration preset this slice unlocks and every method of JAX's dispatch
(smoothquant fixed / auto / auto_layer, awq_lite, awq_clip, awq_full, gptq,
svdquant, mse, local_hessian, nvfp4_act_headroom), on LlamaConfig.tiny()
with seeded numpy weights and JAX's `tests/test_calibration.py` batches
(three [2, 16] token batches of numpy seed 1).

Parity rules (the tolerances):
 - the calibrated state (every amax, pre_quant_scale and affine bias, the
   sequential amax tuples included) and the folded weights: within 1e-5 of
   JAX's, relative to each tensor's largest magnitude (f32: the forwards
   that collect them sum in another order);
 - SVDQuant's adapters: B @ A within 1e-4 relative, each factor up to the
   sign of its rank-1 pairs; the residual weights and their amax within
   1e-4 of the split weight's magnitude (where the rank covers a
   projection, its residual is rounding noise);
 - the algorithm a search picks (SmoothQuant "auto"): JAX's;
 - the fake-quant logits: the median over positions of the largest gap and
   the largest gap at most the case's limits, as shares of the logits'
   scale (1e-4 both unless named: 5e-2 both for GPTQ, whose weights sit on
   the grid, and where the max pass grew a block's amax by 8/7 (a -8
   code), a quarter of them on exact rounding ties that JAX's amax * f32(1/7)
   and the port's amax / 7 break apart, which moves every position; the
   largest gap 5e-2 for the affine FP8 KV cache, whose fp8 activations pass
   such ties on at a few positions; the largest gap 1e-2 for NVFP4
   SVDQuant, whose residuals lie one ulp apart after the SVD).

One deliberate difference, pinned below: the AWQ-lite search quantizes one
layer at a time, so a per-tensor stage of the weight quantizer (NVFP4's
global amax, W4A8's fp8 stage) takes that layer's amax, as the served model
does; JAX's stacked search takes the whole stack's. NVFP4_AWQ_LITE_CFG and
W4A8_AWQ_BETA_CFG are held to JAX on one layer, where the two agree.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.quant.calib import awq as jawq
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq

STATE_REL = 1e-5
TIGHT = (1e-4, 1e-4)  # (median, largest) logits gap as a share of the scale


def _int4(method):
    return jconfig.INT4_BLOCKWISE_WEIGHT_ONLY_CFG.replace(algorithm=method)


# case -> (preset name or JAX QuantizeConfig, layers, (median, largest) logits gap)
CASES = {
    "INT8_SMOOTHQUANT_CFG": ("INT8_SMOOTHQUANT_CFG", 2, TIGHT),
    "INT4_AWQ_CFG": ("INT4_AWQ_CFG", 2, TIGHT),
    "INT4_GPTQ_CFG": ("INT4_GPTQ_CFG", 2, (5e-2, 5e-2)),
    "INT4_LOCAL_HESSIAN_CFG": ("INT4_LOCAL_HESSIAN_CFG", 2, TIGHT),
    "INT4_SVDQUANT_CFG": ("INT4_SVDQUANT_CFG", 2, TIGHT),
    "NVFP4_SVDQUANT_CFG": ("NVFP4_SVDQUANT_CFG", 2, (1e-4, 1e-2)),
    "W4A8_AWQ_BETA_CFG": ("W4A8_AWQ_BETA_CFG", 1, TIGHT),
    "NVFP4_AWQ_LITE_CFG": ("NVFP4_AWQ_LITE_CFG", 1, TIGHT),
    "NVFP4_ACT_HEADROOM_CFG": ("NVFP4_ACT_HEADROOM_CFG", 2, TIGHT),
    "FP8_KV_AFFINE_CFG": ("FP8_KV_AFFINE_CFG", 2, (1e-4, 5e-2)),
    "INT4_AWQ_KV_FP8_CFG": ("INT4_AWQ_KV_FP8_CFG", 2, TIGHT),
    "smoothquant_alpha_0.5": (jconfig.INT8_SMOOTHQUANT_CFG.replace(
        algorithm={"method": "smoothquant", "alpha": 0.5}), 2, TIGHT),
    "smoothquant_auto_layer": (jconfig.INT8_SMOOTHQUANT_CFG.replace(
        algorithm={"method": "smoothquant", "alpha": "auto_layer"}), 2, TIGHT),
    "awq_clip": (_int4("awq_clip"), 2, TIGHT),
    "awq_full": (_int4({"method": "awq_full", "alpha_step": 0.1}), 2, TIGHT),
    "mse": (_int4("mse"), 2, TIGHT),
}


def _tcfg(q):
    if isinstance(q, str):
        return q
    return tconfig.QuantizeConfig(rules=tuple((p, convert.quantizer_cfg_from_jax(c)) for p, c in q.rules),
                                  algorithm=q.algorithm)


def _batches_np():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, size=(2, 16)).astype(np.int32) for _ in range(3)]


_RUNS: dict = {}


def _run(case):
    """(JAX model, port model, port model of JAX's state) for a case, made once."""
    if case not in _RUNS:
        q, layers, _ = CASES[case]
        jcfg = jllama.LlamaConfig.tiny(num_hidden_layers=layers)
        pnp = llama_params_np(jcfg, seed=0)
        bnp = _batches_np()
        jm = jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), q, [jnp.asarray(b) for b in bnp])
        tm = tptq.quantize(convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp), _tcfg(q),
                           [torch.from_numpy(b) for b in bnp], device="cpu")
        _RUNS[case] = (jm, tm, convert.quantized_from_jax(jm))
    return _RUNS[case]


def _leaves(prefix, x, out):
    if x is None:
        return out
    if isinstance(x, dict):
        for k, v in x.items():
            _leaves(f"{prefix}.{k}", v, out)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            _leaves(f"{prefix}[{i}]", v, out)
    elif hasattr(x, "pre_quant_scale"):
        for f in ("amax", "pre_quant_scale", "bias"):
            _leaves(f"{prefix}.{f}", getattr(x, f), out)
    else:
        out[prefix] = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return out


def _logit_gaps(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    g = np.abs(a - b).max(-1) / np.abs(b).max()
    return float(np.median(g)), float(g.max())


@pytest.mark.parametrize("case", list(CASES))
def test_quantize_matches_jax(case):
    jm, tm, _ = _run(case)
    assert tm.quant_cfg.algorithm == jm.quant_cfg.algorithm  # SmoothQuant "auto": the flavor JAX picked
    J = _leaves("qstate", jm.qstate, {})
    T = _leaves("qstate", tm.qstate, {})
    lay = {k: v for k, v in jm.params["layers"].items()}
    _leaves("layers", lay, J)
    _leaves("layers", tm.params["layers"], T)
    assert set(T) == set(J)
    for k in J:
        assert T[k].shape == J[k].shape, k
        proj = next((n for n in (jm.adapters or {}) if k in (f"layers.{n}", f"qstate.{n}.weight.amax")), None)
        if proj is None:
            assert rel_err(T[k], J[k]) <= STATE_REL, k
        else:  # an SVDQuant residual (and its amax): held to the weight it came from, as the rule says
            w = np.abs(np.asarray(jm.params["layers"][proj])).max() + np.abs(np.einsum(
                "lor,lrk->lok", np.asarray(jm.adapters[proj]["B"]), np.asarray(jm.adapters[proj]["A"]))).max()
            assert np.abs(T[k] - J[k]).max() <= 1e-4 * w, k
    assert (tm.adapters is None) == (jm.adapters is None)
    for name, ad in (jm.adapters or {}).items():
        tad = tm.adapters[name]
        assert rel_err(torch.einsum("lor,lrk->lok", tad["B"], tad["A"]).numpy(),
                       np.einsum("lor,lrk->lok", np.asarray(ad["B"]), np.asarray(ad["A"]))) <= 1e-4
        sign = np.sign(np.sum(tad["A"].numpy() * np.asarray(ad["A"]), axis=-1))
        assert rel_err(tad["A"].numpy() * sign[..., None], np.asarray(ad["A"])) <= 1e-4
        np.testing.assert_array_equal(tad["scale"].numpy(), np.asarray(ad["scale"]))
    tokens = _batches_np()[0]
    med, worst = _logit_gaps(tm.forward(torch.from_numpy(tokens))[0].numpy(), jm.forward(jnp.asarray(tokens))[0])
    print(f"{case}: logits gap median {med:.3g}, worst {worst:.3g} of the scale")
    assert med <= CASES[case][2][0] and worst <= CASES[case][2][1]


@pytest.mark.parametrize("case", ["INT4_AWQ_CFG", "INT4_SVDQUANT_CFG", "NVFP4_SVDQUANT_CFG", "FP8_KV_AFFINE_CFG",
                                  "W4A8_AWQ_BETA_CFG", "INT8_SMOOTHQUANT_CFG"])
def test_convert_carries_the_calibrated_model(case):
    """`convert.quantized_from_jax` brings the adapters, pre_quant_scale,
    sequential amaxes and the affine bias: the port's forward of JAX's model
    is JAX's forward, under the case's limits."""
    jm, _, cm = _run(case)
    assert (cm.adapters is None) == (jm.adapters is None)
    tokens = _batches_np()[1]
    med, worst = _logit_gaps(cm.forward(torch.from_numpy(tokens))[0].numpy(), jm.forward(jnp.asarray(tokens))[0])
    assert med <= CASES[case][2][0] and worst <= CASES[case][2][1]


@pytest.mark.parametrize("preset", ["W4A8_AWQ_BETA_CFG", "NVFP4_AWQ_LITE_CFG"])
def test_awq_search_takes_each_layers_own_per_tensor_amax(preset):
    """The deliberate difference: on two layers the port's AWQ scales are
    JAX's search run on each layer alone (its per-tensor stage sees the
    layer's amax), not JAX's stacked search (the stack's amax)."""
    jcfg = jllama.LlamaConfig.tiny()
    pnp, bnp = llama_params_np(jcfg, seed=0), _batches_np()
    params = tree_map(jnp.asarray, pnp)
    tm = tptq.quantize(convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp), preset,
                       [torch.from_numpy(b) for b in bnp], device="cpu")
    jm = jptq.quantize(jcfg, params, preset, [jnp.asarray(b) for b in bnp])
    layout = jllama.build_layout(jcfg, jconfig.get_preset(preset))
    absmean, _, samples = jptq._capture_stats(jcfg, params, layout, jllama.init_quant_state(jcfg, layout),
                                              [jnp.asarray(b) for b in bnp], 128)
    stacked_apart = 0
    for key, members in jptq.CAPTURE_GROUPS.items():
        qfns = jptq._weight_qfns([layout.get(f"{m}.weight") for m in members])
        port = tm.qstate[members[0]]["input"].pre_quant_scale.numpy()
        for i in range(jcfg.num_hidden_layers):
            _, s = jawq.awq_lite_search(samples[key][i:i + 1], [params["layers"][m][i:i + 1] for m in members], qfns,
                                        absmean[key][i:i + 1], 0.1)
            assert rel_err(port[i], 1.0 / np.asarray(s[0])) <= STATE_REL, (key, i)
        stacked_apart += rel_err(port, np.asarray(jm.qstate[members[0]]["input"].pre_quant_scale)) > 1e-3
    assert stacked_apart > 0  # JAX's stacked search chose otherwise somewhere


def test_awq_clip_raises_where_jax_raises_on_a_ragged_k():
    """An intermediate size of 704 (artifacts/anchor-llama's) is not a whole
    number of 128-blocks for down_proj's input: JAX's clip search fails in
    its reshape, the port's raises, naming the size."""
    jcfg = jllama.LlamaConfig.tiny(intermediate_size=704, num_hidden_layers=1)
    pnp, bnp = llama_params_np(jcfg, seed=0), _batches_np()[:1]
    with pytest.raises(Exception):
        jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), _int4("awq_clip"), [jnp.asarray(b) for b in bnp])
    with pytest.raises(ValueError, match="704"):
        tptq.quantize(convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp), _tcfg(_int4("awq_clip")),
                      [torch.from_numpy(b) for b in bnp], device="cpu")


def test_calibrate_and_summary_match_jax(capsys):
    jm, tm, _ = _run("INT4_AWQ_KV_FP8_CFG")
    more = np.random.default_rng(5).integers(0, 256, size=(2, 16)).astype(np.int32)
    jc = jptq.calibrate(jm, [jnp.asarray(more)])
    tc = tptq.calibrate(tm, [torch.from_numpy(more)])
    J, T = _leaves("q", jc.qstate, {}), _leaves("q", tc.qstate, {})
    assert set(J) == set(T)
    for k in J:
        assert rel_err(T[k], J[k]) <= STATE_REL, k
    assert tptq.print_quant_summary(tm) == jptq.print_quant_summary(jm)
    assert "self_attn.k_bmm" in capsys.readouterr().out


def test_every_method_needs_its_batches_as_jax():
    jcfg = jllama.LlamaConfig.tiny(num_hidden_layers=1)
    pnp = llama_params_np(jcfg, seed=0)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    for method in ("smoothquant", "awq_lite", "awq_clip", "awq_full", "gptq"):
        with pytest.raises(ValueError, match="calib_batches"):
            jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), _int4(method))
        with pytest.raises(ValueError, match="calib_batches"):
            tptq.quantize(tcfg, tree_map(torch.from_numpy, pnp), _tcfg(_int4(method)), device="cpu")
    # weight-only MSE needs none: the weights are their own data
    jm = jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), _int4("mse"))
    tm = tptq.quantize(tcfg, tree_map(torch.from_numpy, pnp), _tcfg(_int4("mse")), device="cpu")
    for name in tllama.PROJ_NAMES:
        assert rel_err(tm.qstate[name]["weight"].amax.numpy(), np.asarray(jm.qstate[name]["weight"].amax)) <= STATE_REL


def test_presets_equal_jax_field_for_field():
    unlocked = ["INT8_SMOOTHQUANT_CFG", "INT4_AWQ_CFG", "INT4_GPTQ_CFG", "INT4_LOCAL_HESSIAN_CFG",
                "INT4_SVDQUANT_CFG", "NVFP4_SVDQUANT_CFG", "W4A8_AWQ_BETA_CFG", "NVFP4_AWQ_LITE_CFG",
                "NVFP4_ACT_HEADROOM_CFG", "FP8_KV_AFFINE_CFG", "INT4_AWQ_KV_FP8_CFG"]
    for name in unlocked:
        j, t = jconfig.get_preset(name), tconfig.get_preset(name)
        assert t.algorithm == j.algorithm, name
        assert len(t.rules) == len(j.rules), name
        for (pt, ct), (pj, cj) in zip(t.rules, j.rules):
            assert pt == pj and ct == convert.quantizer_cfg_from_jax(cj), (name, pt)
    assert tconfig.W4A8_SEQUENTIAL == convert.quantizer_cfg_from_jax(jconfig.W4A8_SEQUENTIAL)
    assert tconfig.FP8_KV_AFFINE == convert.quantizer_cfg_from_jax(jconfig.FP8_KV_AFFINE)
    assert dataclasses.replace(tconfig.FP8_KV_AFFINE, bias_corr=False) == tconfig.FP8_KV
