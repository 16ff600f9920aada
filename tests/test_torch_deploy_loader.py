"""The deploy loop of the port: `export_hf_checkpoint` -> directory ->
`serve.loader.load_quantized_checkpoint` -> `Engine`, against the JAX
package's loader (`serve/loader.py`) on the same directories.

- The port's loaded model equals JAX's by value: planes, scales, kinds,
  layout and input amax (exactly: both read the same bytes). One deliberate
  difference, pinned here: an input quantizer that needs a calibrated amax
  stays off where the checkpoint has no `input_scale` (JAX enables it with
  no amax, which serves a weight-only NVFP4 checkpoint as W4A4).
- Each package reads the other's checkpoint (the files are byte-equal, see
  test_torch_export.py): JAX's loader over a port-written directory equals
  JAX's loader over a JAX-written one.
- The loaded packed weights and scales equal the port's in-memory
  `compress` output bit for bit (INT4, NVFP4, FP8, INT8).
- export -> load -> engine prefill logits correlate > 0.95 with the
  fake-quant forward, the bar of the JAX package's tests/test_deploy_loader.py
  (fp16-stored embeddings, norms and lm_head add their rounding).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, tree_map
from tensorrt_model_optimizer_tpu.export import hf_export as jexport
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import loader as jloader
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.export import hf_export as texport
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.quant import quantizer as tQ
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.serve import loader as tloader

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)

# case -> (JAX preset, calibrate, the loaded kind)
CASES = {
    "nvfp4_w4a4": ("NVFP4_DEFAULT_CFG", True, "nvfp4"),
    "nvfp4_weight_only": ("NVFP4_WEIGHT_ONLY_CFG", False, "nvfp4"),
    "int4": ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", False, "int4"),
    "int4_awq": ("INT4_AWQ_CFG", True, "int4"),
    "fp8": ("FP8_DEFAULT_CFG", True, "fp8"),
    "int8": ("INT8_DEFAULT_CFG", True, "int8"),
    "mxfp4": ("MXFP4_WEIGHT_ONLY_CFG", False, "bf16"),
}


@pytest.fixture(scope="module")
def base():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    calib = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    return jcfg, tree_map(jnp.asarray, llama_params_np(jcfg, seed=0)), calib


@pytest.fixture(scope="module")
def exported(base, tmp_path_factory):
    """case -> (JAX model, port model, the JAX-written directory, the
    port-written directory)"""
    jcfg, params, calib = base
    out = {}
    for case, (preset, cal, _) in CASES.items():
        jm = jptq.quantize(jcfg, params, preset, [jnp.asarray(calib)] if cal else None)
        tm = convert.quantized_from_jax(jm)
        d = tmp_path_factory.mktemp(case)
        jexport.export_hf_checkpoint(jm, str(d / "jax"))
        texport.export_hf_checkpoint(tm, str(d / "port"))
        out[case] = (jm, tm, str(d / "jax"), str(d / "port"))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.dtype == torch.float8_e4m3fn else x.float().numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a.astype(np.float32)


def _same_arrays(t, j, what):
    a, b = _np(t), _np(j)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _held_to_jax(tcm, jcm, case):
    assert tcm.kinds == dict(jcm.kinds)
    assert set(tcm.kinds.values()) == {CASES[case][2]}
    for name in ("embed_tokens", "norm", "lm_head"):
        _same_arrays(tcm.params[name], jcm.params[name], name)
    for name, arrays in tcm.params["layers"].items():
        if isinstance(arrays, dict):
            assert set(arrays) == set(jcm.params["layers"][name]), name
            for k, v in arrays.items():
                _same_arrays(v, jcm.params["layers"][name][k], f"{name}.{k}")
        else:
            _same_arrays(arrays, jcm.params["layers"][name], name)
    jsites = dict(convert.layout_from_jax(jcm.layout).sites)
    tsites = dict(tcm.layout.sites)
    assert set(tsites) == set(jsites)
    for site, cfg in tsites.items():
        if site.endswith(".input") and jsites[site].enable and not cfg.enable:
            # the one difference: JAX enables it with no amax
            assert "input" not in (jcm.qstate.get(site[:-len(".input")]) or {}) or \
                jcm.qstate[site[:-len(".input")]]["input"].amax is None
            continue
        assert cfg == jsites[site], site
    for name, sub in jcm.qstate.items():
        jst, tst = sub["input"], tcm.qstate[name]["input"]
        for field in ("amax", "pre_quant_scale"):
            if getattr(jst, field) is None:
                assert getattr(tst, field) is None
            else:
                _same_arrays(getattr(tst, field), getattr(jst, field), f"{name}.input.{field}")
    assert set(tcm.qstate) == set(jcm.qstate)


@pytest.mark.parametrize("case", list(CASES))
def test_loaded_model_equals_jax_loader(exported, case):
    _, _, jdir, tdir = exported[case]
    jcm = jloader.load_quantized_checkpoint(jdir)
    _held_to_jax(tloader.load_quantized_checkpoint(jdir, device="cpu"), jcm, case)  # the port reads JAX's
    _held_to_jax(tloader.load_quantized_checkpoint(tdir, device="cpu"), jcm, case)


@pytest.mark.parametrize("case", list(CASES))
def test_jax_reads_the_port_checkpoint(exported, case):
    _, _, jdir, tdir = exported[case]
    a, b = jloader.load_quantized_checkpoint(tdir), jloader.load_quantized_checkpoint(jdir)
    assert a.kinds == b.kinds and a.layout == b.layout
    leaves = lambda cm: [np.asarray(x) for x in __import__("jax").tree_util.tree_leaves(cm.params)]  # noqa: E731
    for x, y in zip(leaves(a), leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_weight_only_nvfp4_loads_weight_only(exported):
    """The deliberate difference: JAX's layout quantizes the activations of
    a checkpoint exported without input quantizers; the port's does not."""
    _, _, jdir, _ = exported["nvfp4_weight_only"]
    jcm = jloader.load_quantized_checkpoint(jdir)
    tcm = tloader.load_quantized_checkpoint(jdir, device="cpu")
    assert jcm.layout.get("mlp.gate_proj.input").enable
    assert not tcm.layout.get("mlp.gate_proj.input").enable
    w4a4 = tloader.load_quantized_checkpoint(exported["nvfp4_w4a4"][2], device="cpu")
    assert w4a4.layout.get("mlp.gate_proj.input").enable


@pytest.mark.parametrize("case", ["int4", "nvfp4_w4a4", "fp8", "int8"])
def test_loaded_weights_equal_compress(exported, case):
    """The loaded packs against `compress` of the same quantized model, bit
    for bit, with one named difference: INT4's block scales. The
    reference's export packer runs under XLA, which turns amax / 7 into amax
    * f32(1/7), and the checkpoint holds those bytes; `compress` divides. So
    about half the INT4 scales lie one f32 ulp from compress's on the CPU (the codes
    are equal here). NVFP4's global scale would differ only where an amax
    is 0 (export: max(amax / 2688, 1e-12), compress: 1)."""
    _, tm, _, tdir = exported[case]
    cm = tcompress.compress(tm)
    loaded = tloader.load_quantized_checkpoint(tdir, device="cpu")
    assert loaded.kinds == cm.kinds
    for name, arrays in cm.params["layers"].items():
        if not isinstance(arrays, dict):
            continue
        for k, v in arrays.items():
            got = _t(loaded.params["layers"][name][k]).reshape(v.shape)
            if case == "int4" and k.startswith("scale"):
                amax = tm.qstate[name]["weight"].amax
                half = amax[:, : amax.shape[1] // 2] if k == "scale_lo" else amax[:, amax.shape[1] // 2:]
                assert torch.equal(got, half * torch.tensor(1.0 / 7.0, dtype=torch.float32)), (name, k)
                assert torch.equal(torch.nextafter(v, got), got) or torch.equal(got, v), (name, k)  # one ulp
                continue
            assert torch.equal(got, _t(v)), (name, k)


def _t(x):
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


@pytest.mark.parametrize("case", ["fp8", "nvfp4_weight_only", "int4", "int4_awq"])
def test_export_load_serve_correlates_with_fake_quant(exported, base, case):
    _, tm, _, tdir = exported[case]
    cm = tloader.load_quantized_checkpoint(tdir, device="cpu")
    eng = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=32), device="cpu")
    prompt = torch.from_numpy(base[2][:, :8])
    logits = eng.prefill(prompt, eng.init_cache(2, 32))
    ref, _, _ = tm.forward(prompt)
    corr = np.corrcoef(logits.numpy().ravel(), ref[:, -1].float().numpy().ravel())[0, 1]
    assert corr > 0.95, corr
    # and through the kernel engine, W4A8 over the loaded INT4 weights
    if case == "int4":
        k = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=32, kv_dtype=torch.int8, kv_attention_kernel=True,
                                                    int4_layout="a8"), device="cpu")
        assert set(k.cm.kinds.values()) == {"int4a8"}
        toks = k.generate_host(prompt, 4)
        assert toks.shape == (2, 4)


def test_unported_checkpoints_raise(base, tmp_path):
    """MXFP8 checkpoints load since the remaining-formats slice (its layout
    and weights equal JAX's loader's: test_torch_layouts.py); MoE
    checkpoints load since the MoE-families slice (test_torch_moe_deploy.py);
    a GPT-OSS one raises, naming the loader its native MXFP4 format takes
    (`hf_loader.load_hf_moe_checkpoint`)."""
    jcfg, params, calib = base
    jm = jptq.quantize(jcfg, params, "MXFP8_DEFAULT_CFG", [jnp.asarray(calib)])
    jexport.export_hf_checkpoint(jm, str(tmp_path))
    assert tloader._UNPORTED == {}
    assert set(tloader.load_quantized_checkpoint(str(tmp_path), device="cpu").kinds.values()) == {"bf16"}
    with open(tmp_path / "config.json") as f:
        cfg_d = json.load(f)
    with open(tmp_path / "hf_quant_config.json") as f:
        qc = json.load(f)["quantization"]
    with pytest.raises(NotImplementedError, match="load_hf_moe_checkpoint"):
        tloader.compressed_from_export({**cfg_d, "model_type": "gpt_oss"}, qc, {}, device="cpu")
    assert tQ.DISABLED.enable is False


def test_fp16_storage_moves_both_packages_logits_alike(tmp_path):
    """The unified checkpoint stores embeddings, norms and lm_head in fp16
    (the reference's `to_np16`): bf16 values below 2^-14 land on fp16's
    subnormal grid. Here every embedding lies there (N(0, 1) * 1e-6: the
    storage moves each by up to a few percent; the RMSNorm after it undoes
    the scale, not the move) and lm_head spans 1e-8 .. 1e-1, so the loaded
    model's logits move by ~2% of their scale, the size of the 1.5% an 8B
    run read, and well above the 3e-3 the two packages' engines lie apart
    on one model. Each package's loaded NVFP4 model (activation scales
    calibrated) is held against its own in-memory `compress` model in its
    int8-KV kernel engine (KV amax uncalibrated, 448): the loaded tensors
    are bit-equal across the packages, and the two moves agree within a
    tenth of the larger. So whatever the storage moves, it moves in the
    reference too."""
    jcfg = jllama.LlamaConfig.tiny(**{**DIMS, "num_hidden_layers": 1}, dtype=jnp.bfloat16)
    pnp = llama_params_np(jcfg, seed=4)
    rng = np.random.default_rng(5)
    for name in ("embed_tokens", "lm_head"):
        shape = pnp[name].shape
        pnp[name] = (np.sign(rng.standard_normal(shape)) * 10.0 ** rng.uniform(-8, -1, shape)).astype(np.float32)
    pnp["embed_tokens"] = (rng.standard_normal(pnp["embed_tokens"].shape) * 1e-6).astype(np.float32)
    params = tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), pnp)
    calib = np.random.default_rng(1).integers(0, 256, size=(2, 16)).astype(np.int32)
    prompt = calib[:, :8]
    jm = jptq.quantize(jcfg, params, "NVFP4_DEFAULT_CFG", [jnp.asarray(calib)])
    jexport.export_hf_checkpoint(jm, str(tmp_path))
    from tensorrt_model_optimizer_tpu.quant import compress as jcompress
    from tensorrt_model_optimizer_tpu.serve import engine as jengine

    def jlogits(cm):
        eng = jengine.Engine(cm, jengine.EngineConfig(max_seq_len=16, backend="xla", kv_dtype=jnp.int8,
                                                      kv_attention_kernel=True))
        return np.asarray(eng.prefill(jnp.asarray(prompt), eng.init_cache(2))[0], np.float32)

    def tlogits(cm):
        eng = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=16, kv_dtype=torch.int8, kv_attention_kernel=True),
                             device="cpu")
        return eng.prefill(torch.from_numpy(prompt), eng.init_cache(2)).numpy()

    def share(a, b):
        return float(np.median(np.abs(a - b).max(-1) / np.abs(b).max(-1)))

    jl = jloader.load_quantized_checkpoint(str(tmp_path))
    tl = tloader.load_quantized_checkpoint(str(tmp_path), device="cpu")
    for name in ("embed_tokens", "lm_head"):
        assert tl.params[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(tl.params[name].view(torch.uint16).numpy(),
                                      np.asarray(jl.params[name]).view(np.uint16))
        assert (tl.params[name] != convert.params_from_jax(jm.params)[name]).float().mean() > 0.05
    j_move = share(jlogits(jl), jlogits(jcompress.compress(jm)))
    t_move = share(tlogits(tl), tlogits(tcompress.compress(convert.quantized_from_jax(jm))))
    assert j_move > 1e-2, j_move
    assert abs(t_move - j_move) <= 0.1 * max(j_move, t_move), (j_move, t_move)
