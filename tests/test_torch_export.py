"""The port's unified HF export (`export/hf_export.py`) and
`models/hf_loader.save_hf_checkpoint` against the JAX package's: every file
they write, compared whole and byte for byte (`model*.safetensors`,
`model.safetensors.index.json`, `config.json`, `hf_quant_config.json`),
single-file and sharded, for every algo the ported presets reach (NVFP4,
FP8, W4A16_AWQ, MXFP4, INT8, NONE) and the KV algos INT8 / FP8 / NVFP4.

Both exporters read the same quantized model: JAX's `ptq.quantize` output on
seeded numpy weights (calibrated on one seeded batch where the preset has
static quantizers), carried to the port by `convert.quantized_from_jax`.
Tolerance: none; the bytes are equal.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, tree_map
from tensorrt_model_optimizer_tpu.export import hf_export as jexport
from tensorrt_model_optimizer_tpu.models import hf_loader as jhf
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.export import hf_export as texport
from tensorrt_model_optimizer_tpu_torch.models import hf_loader as thf

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)

# case -> (JAX preset or QuantizeConfig, calibrate, the algo, the KV algo)
CASES = {
    "nvfp4_w4a4": ("NVFP4_DEFAULT_CFG", True, "NVFP4", None),
    "nvfp4_weight_only": ("NVFP4_WEIGHT_ONLY_CFG", False, "NVFP4", None),
    "fp8": ("FP8_DEFAULT_CFG", True, "FP8", None),
    "int4": ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", False, "W4A16_AWQ", None),
    "int4_awq_pre_quant_scale": ("INT4_AWQ_CFG", True, "W4A16_AWQ", None),
    "mxfp4": ("MXFP4_WEIGHT_ONLY_CFG", False, "MXFP4", None),
    "int8_w8a8_scales": ("INT8_DEFAULT_CFG", True, "INT8", None),
    "int8_kv_int8": (jconfig.INT8_DEFAULT_CFG.with_rules(jconfig.KV_INT8_RULES), True, "INT8", "INT8"),
    "none": (jconfig.INT8_DEFAULT_CFG.with_rules({"*weight_quantizer": {"enable": False},
                                                  "*input_quantizer": {"enable": False}}), False, "NONE", None),
    "fp8_kv_fp8": ("FP8_KV_CFG", True, "FP8", "FP8"),
    "nvfp4_kv_nvfp4": ("NVFP4_KV_CFG", True, "NVFP4", "NVFP4"),
}


@pytest.fixture(scope="module")
def base():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    pnp = llama_params_np(jcfg, seed=0)
    calib = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    return jcfg, tree_map(jnp.asarray, pnp), calib


def _models(base, case):
    jcfg, params, calib = base
    preset, cal, _, _ = CASES[case]
    jm = jptq.quantize(jcfg, params, preset, [jnp.asarray(calib)] if cal else None)
    return jm, convert.quantized_from_jax(jm)


def _files(d):
    return sorted(os.listdir(d))


def _same_dirs(a, b):
    assert _files(a) == _files(b)
    for name in _files(a):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("case", list(CASES))
def test_export_bytes_equal_jax(base, tmp_path, case, sharded):
    jm, tm = _models(base, case)
    shard = 60_000 if sharded else None  # the tiny model's 0.2-1.1 MB in several shards
    jq = jexport.export_hf_checkpoint(jm, str(tmp_path / "jax"), max_shard_bytes=shard)
    with pytest.warns(UserWarning) if case == "fp8_kv_fp8" and _large_kv(jm) else contextlib.nullcontext():
        tq = texport.export_hf_checkpoint(tm, str(tmp_path / "port"), max_shard_bytes=shard)
    assert tq == jq
    assert (tq["quantization"]["quant_algo"], tq["quantization"]["kv_cache_quant_algo"]) == CASES[case][2:]
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "port"))
    if sharded:
        assert len([f for f in _files(str(tmp_path / "port")) if f.startswith("model-")]) > 2


def _large_kv(jm) -> bool:
    return any(float(np.max(np.asarray(jm.qstate[f"self_attn.{w}_bmm"].amax))) / 448.0 > 0.5 for w in "kv")


def test_export_carries_the_kv_and_input_scales(base, tmp_path):
    """What the byte comparison covers, spelled out once: FP8 KV scales are
    clamped to >= 1, NVFP4 input scales are amax / (6 * 448)."""
    jm, tm = _models(base, "fp8_kv_fp8")
    texport.export_hf_checkpoint(tm, str(tmp_path))
    t = texport.load_exported(str(tmp_path))
    for i in range(tm.model_cfg.num_hidden_layers):
        for w in "kv":
            assert float(t[f"model.layers.{i}.self_attn.{w}_proj.{w}_scale"]) >= 1.0
    assert t["model.layers.0.self_attn.q_proj.weight"].dtype == torch.float8_e4m3fn
    assert t["model.embed_tokens.weight"].dtype == torch.float16


def test_save_hf_checkpoint_bytes_equal_jax(base, tmp_path):
    jcfg, params, _ = base
    jhf.save_hf_checkpoint(jcfg, params, str(tmp_path / "jax"))
    tcfg = convert.llama_cfg_from_jax(jcfg)
    thf.save_hf_checkpoint(tcfg, convert.params_from_jax(tree_map(np.asarray, params)), str(tmp_path / "port"))
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "port"))
    cfg, loaded = thf.load_hf_checkpoint(str(tmp_path / "port"), dtype=torch.float32, device="cpu")
    assert cfg.hd == tcfg.hd and cfg.num_hidden_layers == tcfg.num_hidden_layers
    np.testing.assert_array_equal(loaded["layers"]["mlp.up_proj"].numpy(), np.asarray(params["layers"]["mlp.up_proj"]))


def test_save_safetensors_matches_the_library(tmp_path):
    """The port's writer against safetensors.torch.save_file on every dtype
    the exports write, 0-d tensors and unsorted names included."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    t = {"b.weight_scale_2": torch.tensor(0.25), "a.w": torch.randn(3, 5, generator=g).to(torch.float16),
         "z.q": torch.randint(-128, 127, (4, 8), generator=g).to(torch.int8),
         "c.fp8": torch.randn(2, 16, generator=g).to(torch.float8_e4m3fn),
         "d.u8": torch.randint(0, 255, (7,), generator=g).to(torch.uint8),
         "e.bf": torch.randn(3, generator=g).to(torch.bfloat16), "f.f32": torch.randn(2, 3, generator=g)}
    save_file(t, str(tmp_path / "lib.safetensors"))
    thf.save_safetensors(t, str(tmp_path / "port.safetensors"))
    assert (tmp_path / "lib.safetensors").read_bytes() == (tmp_path / "port.safetensors").read_bytes()
    back = thf.SafetensorsDir(str(tmp_path))
    for name, want in t.items():
        assert back[name].dtype == want.dtype and torch.equal(back[name].view(torch.uint8) if want.element_size() == 1
                                                              else back[name], want.view(torch.uint8)
                                                              if want.element_size() == 1 else want)


def test_int4_export_at_a_ragged_k_raises_as_jax_does(tmp_path):
    """K = 704 (artifacts/anchor-llama's down_proj) is not a multiple of the
    128-wide INT4 blocks: the reference's packer fails on it, and the
    port's refuses it with the reason."""
    jcfg = jllama.LlamaConfig.tiny(hidden_size=128, intermediate_size=704, num_attention_heads=4,
                                   num_key_value_heads=2, num_hidden_layers=1)
    jm = jptq.quantize(jcfg, tree_map(jnp.asarray, llama_params_np(jcfg, seed=2)), "INT4_BLOCKWISE_WEIGHT_ONLY_CFG")
    with pytest.raises(Exception):
        jexport.export_hf_checkpoint(jm, str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="not a multiple"):
        texport.export_hf_checkpoint(convert.quantized_from_jax(jm), str(tmp_path / "port"))


def test_unported_families_raise(base, tmp_path):
    _, tm = _models(base, "int4")
    moe = tm.__class__(**{**tm.__dict__, "params": {**tm.params,
                                                    "layers": {**tm.params["layers"], "moe.gate_proj": None}}})
    with pytest.raises(NotImplementedError, match="MoE"):
        texport.export_hf_checkpoint(moe, str(tmp_path / "moe"))
    with pytest.raises(NotImplementedError, match="MoE"):
        texport.export_gpt_oss_checkpoint(tm, str(tmp_path / "oss"))
    with pytest.raises(NotImplementedError, match="VLM"):
        texport.export_vlm_checkpoint(None, None, None, None, str(tmp_path / "vlm"))
