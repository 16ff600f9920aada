"""Serving, export and loading of the calibration presets, the port against
the JAX package: W8A8 (INT8_DEFAULT_CFG, INT8_SMOOTHQUANT_CFG: int8 weights
under an int input quantizer), SVDQuant's adapter branch (INT4 and NVFP4),
and W4A8_AWQ's pre_quant_scale under `int4_layout="a8"`.

 - serving: JAX's calibrated and compressed model, carried across by
   `convert.compressed_from_jax`, through the port's kernel engine (int8
   KV) and JAX's (Pallas kernels in interpret mode): prefill logits within
   1e-3 relative (f32 model; sums in another order), greedy tokens equal;
   the port's W8A8 product is an exact int32 product on the CPU;
 - export: the unified checkpoint of W4A8_AWQ, W8A8_SQ_PER_CHANNEL,
   NVFP4_SVDQUANT and INT4 SVDQuant (W4A16_AWQ with lora tensors), every
   file byte for byte equal to JAX's;
 - loading: the port's loader of JAX's checkpoint equals JAX's loader by
   value (packs, scales, pre_quant_scale, input amax, adapters, layout).
The `cuda`-marked tests run on the card: `int8_mm` through `torch._int_mm`
equal to the int32 product bit for bit at N = 1, 8, 17 and 2048; an adapter
engine's graphed decode step equal to its eager step; calibration on the
card against the CPU under the parity rules of test_torch_calib_ptq.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, llama_params_np, rel_err, tree_map  # noqa: F401
from tensorrt_model_optimizer_tpu.export import hf_export as jexport
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu.serve import loader as jloader
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.export import hf_export as texport
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.serve import loader as tloader

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)

# case -> (preset, int4_layout, the port's served kinds, the export's quant_algo)
CASES = {
    "int8_default_w8a8": ("INT8_DEFAULT_CFG", "bd2", {"int8"}, "INT8"),
    "int8_smoothquant_w8a8": ("INT8_SMOOTHQUANT_CFG", "bd2", {"int8"}, "W8A8_SQ_PER_CHANNEL"),
    "int4_svdquant": ("INT4_SVDQUANT_CFG", "bd2", {"int4wo"}, "W4A16_AWQ"),
    "nvfp4_svdquant": ("NVFP4_SVDQUANT_CFG", "bd2", {"nvfp4wo"}, "NVFP4_SVDQUANT"),
    "w4a8_awq_a8": ("W4A8_AWQ_BETA_CFG", "a8", {"int4a8"}, "W4A8_AWQ"),
}


def _calib_np(jcfg):
    rng = np.random.default_rng(1)
    return [rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32) for _ in range(2)]


_MODELS: dict = {}


def _jax_model(case):
    """(JAX QuantizedModel, JAX CompressedModel, prompt), made once."""
    if case not in _MODELS:
        jcfg = jllama.LlamaConfig.tiny(**DIMS)
        jm = jptq.quantize(jcfg, tree_map(jnp.asarray, llama_params_np(jcfg, seed=0)), CASES[case][0],
                           [jnp.asarray(b) for b in _calib_np(jcfg)])
        prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
        _MODELS[case] = (jm, jcompress.compress(jm), prompt)
    return _MODELS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_served_tokens_equal_jax_engine(case):
    jm, jcm, prompt = _jax_model(case)
    layout = CASES[case][1]
    jeng = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=32, backend="pallas", kv_dtype=jnp.int8,
                                                    int4_layout=layout, kv_attention_kernel=True))
    jlogits, _ = jeng.prefill(jnp.asarray(prompt), jeng.init_cache(2))
    jtoks = np.asarray(jeng.generate(jnp.asarray(prompt), 8))
    teng = tengine.Engine(convert.compressed_from_jax(jcm), tengine.EngineConfig(
        max_seq_len=32, kv_dtype=torch.int8, int4_layout=layout, kv_attention_kernel=True), device="cpu")
    assert set(teng.cm.kinds.values()) == CASES[case][2]
    assert (teng.cm.adapters is None) == (jm.adapters is None)
    logits = teng.prefill(torch.from_numpy(prompt), teng.init_cache(2))
    assert rel_err(logits.numpy(), np.asarray(jlogits)) < 1e-3
    np.testing.assert_array_equal(teng.generate(torch.from_numpy(prompt), 8).numpy(), jtoks)


def test_w8a8_is_int8_products():
    """The W8A8 projection is the exact int32 product of int8 codes, scaled
    (acc * a_scale) * w_scale: held against numpy on one projection."""
    jm, jcm, _ = _jax_model("int8_default_w8a8")
    cm = convert.compressed_from_jax(jcm)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(5, 128)).astype(np.float32))
    name = "self_attn.q_proj"
    arrays = tcompress.layer_arrays(cm.params["layers"][name], 0)
    ist = tllama.slice_state(cm.qstate[name]["input"], 0)
    y = tengine._qlinear(x, name, "int8", arrays, cm, ist, tengine._ops(tengine.PLAIN_ALL)).numpy()
    a_scale = np.float32(ist.amax.reshape(-1)[0].item()) / np.float32(127.0)
    x8 = np.clip(np.round(x.numpy() / a_scale), -128, 127).astype(np.int64)
    acc = x8 @ arrays["q"].numpy().astype(np.int64).T
    want = (acc.astype(np.float32) * a_scale) * arrays["scale"].numpy().reshape(1, -1)
    np.testing.assert_array_equal(y, want.astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_export_bytes_equal_jax(case, tmp_path):
    jm, _, _ = _jax_model(case)
    jq = jexport.export_hf_checkpoint(jm, str(tmp_path / "jax"))
    tq = texport.export_hf_checkpoint(convert.quantized_from_jax(jm), str(tmp_path / "port"))
    assert tq == jq and tq["quantization"]["quant_algo"] == CASES[case][3]
    assert ("lora_rank" in tq["quantization"]) == (jm.adapters is not None)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "port" / n).read_bytes(), n


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.dtype == torch.float8_e4m3fn else x.float().numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a.astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_loader_equals_jax_loader(case, tmp_path):
    jm, _, prompt = _jax_model(case)
    jexport.export_hf_checkpoint(jm, str(tmp_path))
    jcm = jloader.load_quantized_checkpoint(str(tmp_path))
    tcm = tloader.load_quantized_checkpoint(str(tmp_path), device="cpu")
    assert tcm.kinds == dict(jcm.kinds)
    jlayers = dict(jcm.params["layers"])
    jad = jlayers.pop("__adapters__", None)
    for name, arrays in tcm.params["layers"].items():
        if isinstance(arrays, dict):
            for k, v in arrays.items():
                np.testing.assert_array_equal(_np(v), _np(jlayers[name][k]), err_msg=f"{name}.{k}")
        else:
            np.testing.assert_array_equal(_np(arrays), _np(jlayers[name]), err_msg=name)
    assert set(tcm.params["layers"]) == set(jlayers)
    assert (tcm.adapters is None) == (jad is None)
    for name, ad in (jad or {}).items():
        for k in ("A", "B", "scale"):
            np.testing.assert_array_equal(_np(tcm.adapters[name][k]), _np(ad[k]), err_msg=f"{name}.{k}")
    jsites = dict(convert.layout_from_jax(jcm.layout).sites)
    for site, cfg in tcm.layout.sites:
        assert cfg == jsites[site] or (site.endswith(".input") and not cfg.enable), site
    for name, sub in jcm.qstate.items():
        for field in ("amax", "pre_quant_scale"):
            j = getattr(sub["input"], field)
            t = getattr(tcm.qstate[name]["input"], field)
            assert (t is None) == (j is None), (name, field)
            if j is not None:
                np.testing.assert_array_equal(_np(t), _np(j), err_msg=f"{name}.{field}")
    # and it serves (the loaded values are JAX loader's, whose engine the
    # serving test above holds the port to)
    ecfg = tengine.EngineConfig(max_seq_len=32, kv_dtype=torch.int8, int4_layout=CASES[case][1],
                                kv_attention_kernel=True)
    eng = tengine.Engine(tcm, ecfg, device="cpu")
    logits = eng.prefill(torch.from_numpy(prompt), eng.init_cache(2))
    assert logits.shape == (2, jm.model_cfg.vocab_size) and bool(torch.isfinite(logits).all())


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 17, 2048])
def test_int8_mm_exact_on_card(cuda_device, n):
    g = torch.Generator().manual_seed(n)
    x8 = torch.randint(-128, 128, (n, 4096), generator=g, dtype=torch.int8)
    w8 = torch.randint(-128, 128, (1024, 4096), generator=g, dtype=torch.int8)
    want = tengine.int8_mm(x8, w8)
    got = tengine.int8_mm(x8.to(cuda_device), w8.to(cuda_device)).cpu()
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
def test_adapter_engine_graphed_step_equals_eager(cuda_device):
    """NVFP4 SVDQuant (adapters on every projection) calibrated on the card
    in bf16: decode_step(unroll=4) replays equal the eager steps."""
    tcfg = tllama.LlamaConfig.tiny(**DIMS, dtype=torch.bfloat16)
    params = tllama.init_params(tcfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    batches = [torch.randint(0, tcfg.vocab_size, (2, 16), generator=g, device=cuda_device) for _ in range(2)]
    cm = tcompress.compress(tptq.quantize(tcfg, params, "NVFP4_SVDQUANT_CFG", batches, device=cuda_device))
    assert cm.adapters is not None
    eng = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=32, kv_dtype=torch.int8, kv_attention_kernel=True),
                         device=cuda_device)
    p = torch.randint(0, tcfg.vocab_size, (2, 8), generator=g, device=cuda_device)
    runs = []
    for eager in (True, False):
        eng._eager = eager
        cache = eng.init_cache(2)
        tok = torch.argmax(eng.prefill(p, cache), dim=-1).to(torch.int32)[:, None]
        toks = []
        for _ in range(2):
            tok, cache = eng.decode_step(tok, cache, unroll=4)
            toks.append(tok.clone())
        runs.append((torch.cat(toks, dim=1).cpu(), {k: v.cpu() for k, v in cache.items()}))

    def bits(t):
        return t.view(torch.uint8) if t.element_size() == 1 else t

    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(bits(runs[0][1][k]), bits(runs[1][1][k])) for k in runs[0][1])


@pytest.mark.cuda
def test_calibration_on_card_equals_cpu(cuda_device):
    """Every calibration module on the card and on the CPU over the same f32
    captures of the tiny model, under the parity rules (chip_smoke's
    `card_cpu_calib_modules`, which the calib phase runs on the anchor)."""
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    params = tree_map(torch.from_numpy, llama_params_np(jcfg, seed=0))
    batches = [torch.from_numpy(b) for b in _calib_np(jcfg)]
    st = chip_smoke.card_cpu_calib_modules(torch, cuda_device, convert.llama_cfg_from_jax(jcfg), params, batches)
    assert st["choices"] > 0
