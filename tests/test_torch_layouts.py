"""The last formats and layouts served, exported and loaded, the port
against the JAX package on a tiny configuration:

 - engines: NF4 (INT4 at 64-blocks; JAX serves its word2 kernel, bd2
   taking no 64-block), MXFP6 and MXFP8 (bf16 grid values under MX
   activations), `int4_layout="xla"` (int4x) and `nvfp4_layout="i8"`
   (int8a8): each package calibrates, compresses and serves on its own
   (the port's pipeline from JAX's calibrated model, `convert.
   quantized_from_jax`), greedy tokens equal and prefill logits within 1e-2
   of their scale (f32 model; JAX's word2 rounds (u - 136) s to bf16 a
   weight, qmm.py `_int4_word2_kernel`);
 - the packs `compress` makes equal JAX's bit for bit;
 - export: MXFP8 (fp16 grid values), MXFP6 (quant_algo NONE, as JAX's) and
   NF4 (W4A16_AWQ at group 64) checkpoints byte for byte equal to JAX's;
 - loading: the port's loader of JAX's MXFP8 checkpoint equals JAX's loader
   by value (weights, layout, input amax)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.export import hf_export as jexport
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu.serve import loader as jloader
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.export import hf_export as texport
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.serve import loader as tloader

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)
# case -> (preset, EngineConfig layout fields, the port's served kinds)
CASES = {
    "nf4": ("NF4_WEIGHT_ONLY_CFG", {}, {"int4wo"}),
    "mxfp6": ("MXFP6_DEFAULT_CFG", {}, {"bf16"}),
    "mxfp8": ("MXFP8_DEFAULT_CFG", {}, {"bf16"}),
    "int4x": ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", {"int4_layout": "xla"}, {"int4x"}),
    "int8a8": ("NVFP4_WEIGHT_ONLY_CFG", {"nvfp4_layout": "i8"}, {"int8a8"}),
}
_MODELS: dict = {}


def _jax_model(preset):
    if preset not in _MODELS:
        jcfg = jllama.LlamaConfig.tiny(**DIMS)
        rng = np.random.default_rng(1)
        calib = [jnp.asarray(rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)) for _ in range(2)]
        _MODELS[preset] = jptq.quantize(jcfg, tree_map(jnp.asarray, llama_params_np(jcfg, seed=0)), preset, calib)
    return _MODELS[preset]


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else (
            t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn else t.numpy())
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else (a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a)


@pytest.mark.parametrize("case", list(CASES))
def test_served_tokens_equal_jax_engine(case):
    preset, layouts, kinds = CASES[case]
    jm = _jax_model(preset)
    jcm = jcompress.compress(jm)
    tcm = tcompress.compress(convert.quantized_from_jax(jm))
    for name, kind in jcm.kinds.items():  # the canonical packs, bit for bit
        assert tcm.kinds[name] == kind
        for k, a in jcm.params["layers"][name].items():
            np.testing.assert_array_equal(_bits(tcm.params["layers"][name][k]), _bits(a))
    layout = layouts.get("int4_layout", layouts.get("nvfp4_layout"))
    for name, kind in jcm.kinds.items():  # the served layouts JAX makes with XLA: their values bit for bit
        if layout in ("xla", "i8"):
            jk, ja = jcompress.word_convert_site(kind, jcm.params["layers"][name], layout)
            want = np.asarray(jcompress.decompress_weight(jk, ja, out_dtype=jnp.float32))
            for i in range(want.shape[0]):
                tk, ta = tcompress.word_convert_site(kind, tcompress.layer_arrays(tcm.params["layers"][name], i), layout)
                assert tk == jk
                np.testing.assert_array_equal(tcompress.decompress_weight(tk, ta, torch.float32).numpy(), want[i])
    prompt = np.random.default_rng(2).integers(0, 256, size=(2, 8)).astype(np.int32)
    jeng = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=32, backend="pallas", kv_dtype=jnp.int8,
                                                    kv_attention_kernel=True, **layouts))
    jlogits, _ = jeng.prefill(jnp.asarray(prompt), jeng.init_cache(2))
    jtoks = np.asarray(jeng.generate(jnp.asarray(prompt), 8))
    teng = tengine.Engine(tcm, tengine.EngineConfig(max_seq_len=32, kv_dtype=torch.int8, kv_attention_kernel=True,
                                                    **layouts), device="cpu")
    assert set(teng.cm.kinds.values()) == kinds
    logits = teng.prefill(torch.from_numpy(prompt), teng.init_cache(2))
    assert rel_err(logits.numpy(), np.asarray(jlogits)) < 1e-2
    np.testing.assert_array_equal(teng.generate(torch.from_numpy(prompt), 8).numpy(), jtoks)


@pytest.mark.parametrize("preset,algo", [("MXFP8_DEFAULT_CFG", "MXFP8"), ("MXFP6_DEFAULT_CFG", "NONE"),
                                         ("NF4_WEIGHT_ONLY_CFG", "W4A16_AWQ")])
def test_export_bytes_equal_jax(preset, algo, tmp_path):
    jm = _jax_model(preset)
    jq = jexport.export_hf_checkpoint(jm, str(tmp_path / "jax"))
    tq = texport.export_hf_checkpoint(convert.quantized_from_jax(jm), str(tmp_path / "port"))
    assert tq == jq and tq["quantization"]["quant_algo"] == algo
    if algo == "W4A16_AWQ":
        assert tq["quantization"]["group_size"] == 64
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "port" / n).read_bytes(), n


def test_mxfp8_loader_equals_jax_loader(tmp_path):
    jexport.export_hf_checkpoint(_jax_model("MXFP8_DEFAULT_CFG"), str(tmp_path))
    jcm = jloader.load_quantized_checkpoint(str(tmp_path))
    tcm = tloader.load_quantized_checkpoint(str(tmp_path), device="cpu")
    assert tcm.kinds == dict(jcm.kinds) and set(tcm.kinds.values()) == {"bf16"}
    assert tcm.layout == convert.layout_from_jax(jcm.layout)
    for name, arrays in tcm.params["layers"].items():
        want = jcm.params["layers"][name]
        if isinstance(arrays, dict):
            for k, a in arrays.items():
                np.testing.assert_array_equal(a.float().numpy(), np.asarray(want[k], np.float32))
        else:
            np.testing.assert_array_equal(arrays.float().numpy(), np.asarray(want, np.float32))
    for name, sub in tcm.qstate.items():
        for which, st in sub.items():
            np.testing.assert_array_equal(st.amax.numpy(), np.asarray(jcm.qstate[name][which].amax))
