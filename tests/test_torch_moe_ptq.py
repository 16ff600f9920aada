"""`ptq.quantize_family` in the port against the JAX package's on the
trained `artifacts/anchor-moe` (its first 3 layers): max calibration (weight amax per expert,
equal), INT4 AWQ-lite (scales and folded weights within 1e-6; a layer's
experts share one migration scale, their stack folded into rows),
SmoothQuant with the per-layer "auto" alpha (equal choices, or where the
choice differs, JAX's scale is one of the port's candidates whose loss lies
within TIE_REL of the best: a near tie the f32 sums break apart), and GPTQ
(the pinned amax equal; at most GPTQ_APART_MAX of the weights apart, each by
code steps at rounding ties); the methods JAX's family PTQ refuses raise.
The port's export refuses the AWQ- and SmoothQuant-calibrated models, whose
experts' pre_quant_scale no checkpoint tensor holds."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import hf_loader as jload
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch.export import hf_export as texport
from tensorrt_model_optimizer_tpu_torch.models import hf_loader as tload
from tensorrt_model_optimizer_tpu_torch.models import registry
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.quant.calib import smoothquant as sq
from tensorrt_model_optimizer_tpu_torch.utils import synthlang

ANCHOR = os.path.join(os.path.dirname(__file__), "..", "artifacts", "anchor-moe")
TIE_REL = 1e-4
GPTQ_APART_MAX = 2e-2


DEPTH = 3  # the anchor's first 3 of 6 layers


@pytest.fixture(scope="module")
def anchor():
    jcfg, jp = jload.load_hf_moe_checkpoint(ANCHOR, dtype=jnp.float32)
    tcfg, tp = tload.load_hf_moe_checkpoint(ANCHOR, dtype=torch.float32, device="cpu")
    jcfg, tcfg = (dataclasses.replace(c, num_hidden_layers=DEPTH) for c in (jcfg, tcfg))
    jp = {**jp, "layers": {k: v[:DEPTH] for k, v in jp["layers"].items()}}
    tp = {**tp, "layers": {k: v[:DEPTH] for k, v in tp["layers"].items()}}
    calib = list(synthlang.SynthLang(0).eval_batches(1, 4, 32, seed=555))
    return jcfg, jp, tcfg, tp, calib


_QUANTIZED: dict = {}  # preset -> (JAX's, the port's) quantized model, each calibrated once a module


def _both(anchor, preset):
    if preset not in _QUANTIZED:
        jcfg, jp, tcfg, tp, calib = anchor
        jm = jptq.quantize_family("mixtral", jcfg, jp, preset, [jnp.asarray(b) for b in calib])
        tm = tptq.quantize_family("mixtral", tcfg, tp, preset, [torch.from_numpy(b) for b in calib], device="cpu")
        assert set(tm.qstate) == set(jm.qstate) and tm.forward_fn is registry.get("mixtral").forward
        _QUANTIZED[preset] = jm, tm
    return _QUANTIZED[preset]


def _amax(st):
    return st.amax[0] if isinstance(st.amax, tuple) else st.amax


def test_max_calibration_matches_jax(anchor):
    jm, tm = _both(anchor, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG")
    for name in ("self_attn.q_proj", "moe.gate_proj", "moe.down_proj"):
        np.testing.assert_array_equal(tm.qstate[name]["weight"].amax.numpy(), np.asarray(jm.qstate[name]["weight"].amax))
    assert tm.qstate["moe.down_proj"]["weight"].amax.shape[:2] == (DEPTH, 4)  # per expert


def test_awq_lite_matches_jax(anchor):
    jm, tm = _both(anchor, "INT4_AWQ_CFG")
    for name in ("self_attn.k_proj", "moe.gate_proj", "moe.up_proj"):
        assert rel_err(tm.params["layers"][name].numpy(), np.asarray(jm.params["layers"][name])) < 1e-6
        if name != "moe.up_proj":  # the family forward carries the block input's state on gate_proj only
            pqs = tm.qstate[name]["input"].pre_quant_scale
            assert pqs.shape == (DEPTH, 256)
            assert rel_err(pqs.numpy(), np.asarray(jm.qstate[name]["input"].pre_quant_scale)) < 1e-6


def test_smoothquant_auto_matches_jax(anchor):
    jcfg, jp, tcfg, tp, calib = anchor
    jm, tm = _both(anchor, "INT8_SMOOTHQUANT_CFG")
    fam = registry.get("mixtral")
    layout = fam.build_layout(tcfg, tm.quant_cfg)
    _, amax, samples = tptq._family_samples(fam, tcfg, tp, layout, fam.init_quant_state(tcfg, layout, "cpu"),
                                            [torch.from_numpy(b) for b in calib], 128)
    for cap, members in (("attn_in", ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")),
                         ("moe_in", ("moe.gate_proj", "moe.up_proj"))):
        jp_ = np.asarray(jm.qstate[members[0]]["input"].pre_quant_scale)
        tp_ = tm.qstate[members[0]]["input"].pre_quant_scale.numpy()
        qfns = tptq._weight_qfns([layout.get(f"{m}.weight") for m in members])
        for i in range(tcfg.num_hidden_layers):
            if rel_err(tp_[i], jp_[i]) < 1e-6:
                continue
            ws = [tp["layers"][m][i].reshape(1, -1, 256) for m in members]
            scales, errs = sq.smoothquant_auto_losses(samples[cap][i:i + 1], amax[cap][i:i + 1], ws,
                                                      [lambda w, f=f: f(w[0])[None] for f in qfns])
            best = float(errs[:, 0].min())
            near = [c for c in range(errs.shape[0]) if float(errs[c, 0]) <= best * (1 + TIE_REL)]
            assert any(rel_err(1.0 / scales[c, 0].numpy(), jp_[i]) < 1e-6 for c in near), (cap, i)


def test_gptq_matches_jax(anchor):
    jm, tm = _both(anchor, "INT4_GPTQ_CFG")
    for name in ("self_attn.v_proj", "moe.gate_proj", "moe.up_proj"):
        a, b = tm.params["layers"][name].numpy(), np.asarray(jm.params["layers"][name])
        apart = np.abs(a - b) > 1e-3 * np.abs(b).max()
        assert apart.mean() <= GPTQ_APART_MAX, (name, apart.mean())
    # the amax pinned before the max pass: the original weights' grid, unless the updates outgrew it
    w0 = anchor[3]["layers"]["moe.gate_proj"][0, 0].abs().reshape(256, 2, 128).amax(-1)
    assert bool((_amax(tm.qstate["moe.gate_proj"]["weight"])[0, 0] >= w0).all())


@pytest.mark.parametrize("preset", ["INT4_SVDQUANT_CFG", "INT4_LOCAL_HESSIAN_CFG", "NVFP4_ACT_HEADROOM_CFG"])
def test_unsupported_methods_raise_as_jax(anchor, preset):
    jcfg, jp, tcfg, tp, calib = anchor
    with pytest.raises(NotImplementedError, match="llama-family only"):
        jptq.quantize_family("mixtral", jcfg, jp, preset, [jnp.asarray(b) for b in calib])
    with pytest.raises(NotImplementedError, match="llama-family only"):
        tptq.quantize_family("mixtral", tcfg, tp, preset, [torch.from_numpy(b) for b in calib], device="cpu")
    with pytest.raises(ValueError, match="requires calib_batches"):
        tptq.quantize_family("mixtral", tcfg, tp, "INT4_AWQ_CFG", device="cpu")
    # gpt_oss is registered since the GPT-OSS / Llama4 slice; mamba since the
    # hybrid slice: JAX's AWQ fails in its capture forward, the port refuses by name
    from _torch_mamba import mamba_pair

    mj, mjp, mt, mtp = mamba_pair(0)
    with pytest.raises(TypeError, match="capture_tokens"):
        jptq.quantize_family("mamba", mj, mjp, "INT4_AWQ_CFG", [jnp.asarray(b) for b in calib])
    with pytest.raises(NotImplementedError, match="awq_lite"):
        tptq.quantize_family("mamba", mt, mtp, "INT4_AWQ_CFG", device="cpu")


@pytest.mark.parametrize("preset", ["INT4_AWQ_CFG", "INT8_SMOOTHQUANT_CFG"])
def test_export_refuses_experts_with_a_pre_quant_scale(anchor, tmp_path, preset):
    """The calibration folds s into the expert weights and keeps 1/s on the
    block's input; the expert modules have no tensor for it, so export
    raises before it writes anything, where a loaded model would serve
    without 1/s."""
    _, tm = _both(anchor, preset)
    assert tm.qstate["moe.gate_proj"]["input"].pre_quant_scale is not None
    with pytest.raises(NotImplementedError, match="AWQ / SmoothQuant MoE checkpoints"):
        texport.export_hf_checkpoint(tm, str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
