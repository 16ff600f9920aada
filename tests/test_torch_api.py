"""The port's mtq façade (`quant/api.py`) and layerwise calibration
(`quant/layerwise.py`) against the JAX package:

 - `fold_weight`: the folded weights equal JAX's bit for bit (the same
   fake quant a layer at a time), the weight sites disabled as JAX's; the
   folded model's forward equals the fake-quant forward's (1e-6 of the
   logits' scale: the same values, one matmul order);
 - `compute_quantization_mse`: equal to JAX's within 1e-6 relative (f32
   means in another order); `disable_quantizer` the same sites as JAX's;
 - `auto_quantize` is `quant/auto.py`'s (held to JAX's in
   `test_torch_auto_quantize.py`);
 - `layerwise_calibrate`: every amax bit-equal to the one-shot max
   calibration's (`ptq.quantize`), from stacked layers and through a
   `layer_loader`; a run stopped after layer k and resumed from its
   checkpoint gives the same state; its amax equal to JAX's layerwise
   within 1e-6 relative (f32 activations summed in another order)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import api as japi
from tensorrt_model_optimizer_tpu.quant import layerwise as jlw
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import api as tapi
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
from tensorrt_model_optimizer_tpu_torch.quant import layerwise as tlw
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2,
            num_hidden_layers=3)
PRESETS = ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "NVFP4_DEFAULT_CFG", "NF4_WEIGHT_ONLY_CFG", "W4A8_AWQ_BETA_CFG")


def _setup(preset):
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    pnp = llama_params_np(jcfg, seed=3)
    rng = np.random.default_rng(4)
    calib = [rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32) for _ in range(2)]
    jm = jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), preset, [jnp.asarray(c) for c in calib])
    return jcfg, pnp, calib, jm, convert.quantized_from_jax(jm)


@pytest.mark.parametrize("preset", PRESETS)
def test_fold_weight_and_mse_equal_jax(preset):
    _, _, calib, jm, tm = _setup(preset)
    jf, tf = japi.fold_weight(jm), tapi.fold_weight(tm)
    assert tf.layout == convert.layout_from_jax(jf.layout)
    for name in tllama.PROJ_NAMES:
        np.testing.assert_array_equal(tf.params["layers"][name].numpy(), np.asarray(jf.params["layers"][name]))
    tokens = torch.from_numpy(calib[0])
    fq = tm.forward(tokens)[0]
    folded = tf.forward(tokens)[0]
    assert float((folded - fq).abs().max()) <= 1e-6 * float(fq.abs().max())
    jmse, tmse = japi.compute_quantization_mse(jm), tapi.compute_quantization_mse(tm)
    assert set(tmse) == set(jmse)
    for k, v in jmse.items():
        assert abs(tmse[k] - v) <= 1e-6 * abs(v), (k, tmse[k], v)


def test_disable_quantizer_and_auto_quantize():
    _, _, _, jm, tm = _setup("NVFP4_DEFAULT_CFG")
    for pattern in ("*mlp*", "*.input", "self_attn.q_proj.weight"):
        assert tapi.disable_quantizer(tm, pattern).layout == convert.layout_from_jax(
            japi.disable_quantizer(jm, pattern).layout)
    from tensorrt_model_optimizer_tpu_torch.quant import auto as tauto

    assert tapi.auto_quantize is tauto.auto_quantize  # ported: tests/test_torch_auto_quantize.py holds it to JAX
    assert tapi.get_preset("NF4_WEIGHT_ONLY_CFG") is tconfig.NF4_WEIGHT_ONLY_CFG
    assert tapi.quantize is tptq.quantize and tapi.PRESETS is tconfig.PRESETS


def _amaxes(qstate):
    out = {}
    for name, sub in qstate.items():
        for which, st in (sub.items() if isinstance(sub, dict) else (("", sub),)):
            amax = st.amax if isinstance(st.amax, tuple) else (st.amax,)
            for i, a in enumerate(amax):
                if a is not None:
                    out[f"{name}.{which}.{i}"] = a
    return out


@pytest.mark.parametrize("preset", ["FP8_DEFAULT_CFG", "W4A8_AWQ_BETA_CFG", "NVFP4_KV_CFG"])
def test_layerwise_equals_one_shot_and_resumes(preset, tmp_path):
    jcfg, pnp, calib, _, _ = _setup("INT4_BLOCKWISE_WEIGHT_ONLY_CFG")
    tcfg = convert.llama_cfg_from_jax(jcfg)
    params = tree_map(torch.from_numpy, pnp)
    batches = [torch.from_numpy(c) for c in calib]
    qcfg = tconfig.get_preset(preset).replace(algorithm="max")
    layout = tllama.build_layout(tcfg, qcfg)
    one_shot = _amaxes(tptq.quantize(tcfg, params, qcfg, batches, device="cpu").qstate)
    lw = _amaxes(tlw.layerwise_calibrate(tcfg, params, layout, batches))
    assert set(lw) == set(one_shot)
    for k, a in lw.items():
        assert torch.equal(a, one_shot[k]), k
    # through a layer loader
    host = params["layers"]
    loaded = {k: v for k, v in params.items() if k != "layers"}
    loaded["layer_loader"] = lambda i: {k: v[i].clone() for k, v in host.items()}
    for k, a in _amaxes(tlw.layerwise_calibrate(tcfg, loaded, layout, batches)).items():
        assert torch.equal(a, lw[k]), k
    # a run cut off while loading layer 2, resumed from its checkpoint
    ck = str(tmp_path / "ck")

    def dies_at_2(i):
        if i == 2:
            raise RuntimeError("lost the machine")
        return {k: v[i] for k, v in host.items()}

    with pytest.raises(RuntimeError):
        tlw.layerwise_calibrate(tcfg, {**loaded, "layer_loader": dies_at_2}, layout, batches, ck)
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f) == {"next_layer": 2, "total": 3}
    resumed = _amaxes(tlw.layerwise_calibrate(tcfg, params, layout, batches, ck))
    assert set(resumed) == set(lw)
    for k, a in resumed.items():
        assert torch.equal(a, lw[k]), k
    # JAX's layerwise, on the same weights and tokens
    jl = jlw.layerwise_calibrate(jcfg, tree_map(jnp.asarray, pnp), jllama.build_layout(jcfg, _jax_cfg(preset)),
                                 [jnp.asarray(c) for c in calib])
    for k, a in _amaxes(convert.params_from_jax(jl)).items():
        assert float((lw[k] - a).abs().max()) <= 1e-6 * float(a.abs().max().clamp_min(1e-30)), k


def _jax_cfg(preset):
    from tensorrt_model_optimizer_tpu.quant import config as jconfig

    return jconfig.get_preset(preset).replace(algorithm="max")
