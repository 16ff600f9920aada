"""The MoE deploy loop in the port against the JAX package's, on tiny f32
MoE models from seeded weights: the unified export byte-equal to JAX's
(every file) under qwen3_moe naming (a q/k-norm config) and mixtral naming,
for NVFP4 with activation scales, W4A16_AWQ and FP8; the deploy loader on
JAX's export equal to JAX's loader (kinds, canonical packs bit for bit, the
block's input amax, the layout), INT4 experts loaded where JAX's loader
refuses them (its MoE branch is "not wired" there) with the exported codes
and scales as they are; `save_hf_checkpoint` byte-equal for both namings
and read back by both `load_hf_moe_checkpoint`s, DBRX's fused layout read
as JAX reads it; the registry. Tolerance: none, the bytes are equal."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import tree_map
from tensorrt_model_optimizer_tpu.export import hf_export as jexport
from tensorrt_model_optimizer_tpu.models import hf_loader as jhf
from tensorrt_model_optimizer_tpu.models import mixtral as jmix
from tensorrt_model_optimizer_tpu.models import registry as jreg
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import loader as jloader
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.export import hf_export as texport
from tensorrt_model_optimizer_tpu_torch.models import hf_loader as thf
from tensorrt_model_optimizer_tpu_torch.models import mixtral as tmix
from tensorrt_model_optimizer_tpu_torch.models import registry as treg
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.serve import loader as tloader

NAMING = {"qwen3_moe": dict(qk_norm=True), "mixtral": {}}


def _params(jcfg, seed=0):
    """Seeded numpy weights of a tiny MoE model (JAX's tree)."""
    tcfg = convert.llama_cfg_from_jax(jcfg)
    params = tmix.init_params(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    for name in ("input_layernorm", "post_attention_layernorm", "self_attn.q_norm", "self_attn.k_norm"):
        if name in params["layers"]:
            params["layers"][name] = params["layers"][name] + 0.1 * torch.from_numpy(
                rng.standard_normal(tuple(params["layers"][name].shape)).astype(np.float32))
    return tree_map(lambda t: t.numpy(), params)


@pytest.fixture(scope="module")
def models():
    out = {}
    for naming, kw in NAMING.items():
        jcfg = jmix.MixtralConfig.tiny(hidden_size=128, intermediate_size=128, num_experts=4, **kw)
        pnp = _params(jcfg)
        calib = np.random.default_rng(1).integers(0, 256, size=(2, 16)).astype(np.int32)
        out[naming] = (jcfg, pnp, calib)
    return out


def _same_dirs(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _bits(a):
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.element_size() == 1 else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


@pytest.mark.parametrize("preset,algo", [("NVFP4_DEFAULT_CFG", "NVFP4"), ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "W4A16_AWQ"),
                                         ("FP8_DEFAULT_CFG", "FP8")])
@pytest.mark.parametrize("naming", sorted(NAMING))
def test_export_bytes_equal_jax_and_load(models, tmp_path, naming, preset, algo):
    jcfg, pnp, calib = models[naming]
    jm = jptq.quantize_family("mixtral", jcfg, tree_map(jnp.asarray, pnp), preset, [jnp.asarray(calib)])
    tm = convert.quantized_from_jax(jm)
    jqc = jexport.export_hf_checkpoint(jm, str(tmp_path / "jax"))
    tqc = texport.export_hf_checkpoint(tm, str(tmp_path / "port"), max_shard_bytes=None)
    assert jqc == tqc and tqc["quantization"]["quant_algo"] == algo
    _same_dirs(tmp_path / "jax", tmp_path / "port")
    with open(tmp_path / "port" / "config.json") as f:
        assert json.load(f)["model_type"] == naming
    loaded = tloader.load_quantized_checkpoint(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded.model_cfg, tmix.MixtralConfig) and loaded.model_cfg.qk_norm == jcfg.qk_norm
    if algo == "W4A16_AWQ":  # JAX's MoE branch refuses INT4 experts; the port loads them as exported
        with pytest.raises(NotImplementedError, match="not wired"):
            jloader.load_quantized_checkpoint(str(tmp_path / "jax"))
        t = texport.load_exported(str(tmp_path / "jax"))
        name = ("model.layers.1.mlp.experts.2.down_proj" if naming == "qwen3_moe"
                else "model.layers.1.block_sparse_moe.experts.2.w2")
        arr = tcompress.layer_arrays(tcompress.layer_arrays(loaded.params["layers"]["moe.down_proj"], 1), 2)
        np.testing.assert_array_equal(torch.cat([arr["scale_lo"], arr["scale_hi"]]).numpy(),
                                      t[name + ".weight_scale"].numpy())
        np.testing.assert_array_equal(tloader._outpair_to_plane(t[name + ".weight"]).numpy(), arr["packed"].numpy())
        return
    jl = jloader.load_quantized_checkpoint(str(tmp_path / "jax"))
    assert loaded.kinds == jl.kinds and convert.layout_from_jax(jl.layout) == loaded.layout
    for name, arrays in loaded.params["layers"].items():
        want = jl.params["layers"][name]
        if isinstance(arrays, dict):
            for k in arrays:
                np.testing.assert_array_equal(_bits(arrays[k]), _bits(want[k]), err_msg=f"{name}.{k}")
        else:
            np.testing.assert_array_equal(arrays.float().numpy(), np.asarray(want.astype(jnp.float32)), err_msg=name)
    for name, sub in jl.qstate.items():
        np.testing.assert_array_equal(loaded.qstate[name]["input"].amax.numpy(), np.asarray(sub["input"].amax))


@pytest.mark.parametrize("naming", sorted(NAMING))
def test_hf_checkpoint_round_trip_matches_jax(models, tmp_path, naming):
    jcfg, pnp, _ = models[naming]
    jhf.save_hf_checkpoint(jcfg, tree_map(jnp.asarray, pnp), str(tmp_path / "jax"))
    thf.save_hf_checkpoint(convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp), str(tmp_path / "port"))
    _same_dirs(tmp_path / "jax", tmp_path / "port")
    jc, jp = jhf.load_hf_moe_checkpoint(str(tmp_path / "port"), dtype=jnp.float32)
    tc, tp = thf.load_hf_moe_checkpoint(str(tmp_path / "port"), dtype=torch.float32, device="cpu")
    assert convert.llama_cfg_from_jax(jc) == tc
    assert set(tp["layers"]) == set(jp["layers"])
    for name, t in tp["layers"].items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jp["layers"][name]), err_msg=name)
        np.testing.assert_array_equal(t.numpy(), pnp["layers"][name], err_msg=name)


def test_dbrx_loads_as_jax(tmp_path):
    """DBRX's fused Wqkv, fused expert GLU (w2 untransposed) and LayerNorm
    blocks, written from seeded numpy weights under DBRX's names."""
    L, E, H, I, nH, nkv, hd = 2, 4, 64, 96, 4, 2, 16
    rng = np.random.default_rng(7)
    blk = "transformer.blocks.{i}."
    t = {"transformer.wte.weight": rng.standard_normal((256, H)), "transformer.norm_f.weight": rng.standard_normal(H),
         "lm_head.weight": rng.standard_normal((256, H))}
    for i in range(L):
        t[blk.format(i=i) + "norm_attn_norm.norm_1.weight"] = rng.standard_normal(H)
        t[blk.format(i=i) + "norm_attn_norm.norm_2.weight"] = rng.standard_normal(H)
        t[blk.format(i=i) + "norm_attn_norm.attn.Wqkv.weight"] = rng.standard_normal(((nH + 2 * nkv) * hd, H))
        t[blk.format(i=i) + "norm_attn_norm.attn.out_proj.weight"] = rng.standard_normal((H, nH * hd))
        t[blk.format(i=i) + "ffn.router.layer.weight"] = rng.standard_normal((E, H))
        for w in ("w1", "v1", "w2"):
            t[blk.format(i=i) + f"ffn.experts.mlp.{w}"] = rng.standard_normal((E * I, H))
    os.makedirs(tmp_path / "dbrx")
    thf.save_safetensors({k: torch.from_numpy(v.astype(np.float32)) for k, v in t.items()},
                         str(tmp_path / "dbrx" / "model.safetensors"))
    with open(tmp_path / "dbrx" / "config.json", "w") as f:
        json.dump({"model_type": "dbrx", "d_model": H, "n_heads": nH, "n_layers": L, "vocab_size": 256,
                   "max_seq_len": 128, "attn_config": {"kv_n_heads": nkv, "clip_qkv": 8.0, "rope_theta": 5e5},
                   "ffn_config": {"moe_num_experts": E, "moe_top_k": 2, "ffn_hidden_size": I,
                                  "moe_normalize_expert_weights": 1.0}}, f)
    jc, jp = jhf.load_hf_moe_checkpoint(str(tmp_path / "dbrx"), dtype=jnp.float32)
    tc, tp = thf.load_hf_moe_checkpoint(str(tmp_path / "dbrx"), dtype=torch.float32, device="cpu")
    assert convert.llama_cfg_from_jax(jc) == tc and tc.norm_type == "layernorm" and tc.clip_qkv == 8.0
    for name, w in tp["layers"].items():
        np.testing.assert_array_equal(w.numpy(), np.asarray(jp["layers"][name]), err_msg=name)
    tokens = rng.integers(0, 256, size=(1, 8)).astype(np.int32)
    jl = np.asarray(jmix.forward(jc, jp, jnp.asarray(tokens))[0])
    assert np.abs(tmix.forward(tc, tp, torch.from_numpy(tokens))[0].numpy() - jl).max() <= 1e-4 * np.abs(jl).max()


def test_registry_matches_jax():
    # llama4 and gpt_oss are registered since the GPT-OSS / Llama4 slice
    # (tests/test_torch_family_deploy.py holds their entries to JAX's)
    # dit is registered since the diffusion slice (tests/test_torch_dit.py),
    # mamba since the hybrid slice (tests/test_torch_mamba.py)
    assert treg.families() == jreg.families() == ["dit", "gpt_oss", "llama", "llama4", "mamba", "mixtral"]
    for mt in ("llama", "qwen2", "qwen3", "mistral", "mixtral", "qwen3_moe", "dbrx", "nemotron_h", "mamba2"):
        assert treg.for_hf_model_type(mt).name == jreg.for_hf_model_type(mt).name
    assert treg.get("mixtral").forward is tmix.forward
    assert treg.get("mamba").name == jreg.get("mamba").name == "mamba"
    with pytest.raises(ValueError):
        treg.register(treg.get("llama"))
    # deepseek_v3 loads since the DeepSeek slice (tests/test_torch_deepseek.py
    # holds its loader to JAX's); deepseek_v2 raises, naming its softmax router
    with pytest.raises(NotImplementedError, match="softmax"):
        thf.config_from_hf({"model_type": "deepseek_v2"})
    v3 = thf.config_from_hf({"model_type": "deepseek_v3", "vocab_size": 256, "hidden_size": 64,
                             "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4})
    assert v3.hidden_size == 64
    assert jax.__name__ == "jax"  # both packages side by side; the port imports none of it


def test_moe_accuracy_tool_writes_only_its_own_file(tmp_path, monkeypatch):
    """The port's MoE accuracy table on the anchor (f32, CPU), two presets:
    a row per preset (an error row where the family refuses the method, as
    JAX's tool writes it), the unquantized ppl within 0.05 of JAX's pin
    3.1571 (tests/test_accuracy_anchor.py), and the file it writes is its
    own (`--out`; its default is artifacts/moe_accuracy_table_torch.json)."""
    import importlib.util

    root = os.path.join(os.path.dirname(__file__), "..")
    monkeypatch.setenv("MOE_PRESETS", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG,INT4_SVDQUANT_CFG")
    spec = importlib.util.spec_from_file_location("torch_moe_accuracy_table",
                                                  os.path.join(root, "tools", "torch_moe_accuracy_table.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    before = sorted(os.listdir(os.path.join(root, "artifacts")))
    out = tool.main(["--device", "cpu", "--out", str(tmp_path / "t.json")])
    assert sorted(os.listdir(os.path.join(root, "artifacts"))) == before
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert abs(out["baseline_ppl"] - 3.1571) < 0.05
    ok, refused = out["rows"]
    assert ok["preset"] == "INT4_BLOCKWISE_WEIGHT_ONLY_CFG" and abs(ok["dppl"]) < 0.05
    assert "llama-family only" in refused["error"]
    assert tool.OUT.endswith(os.path.join("artifacts", "moe_accuracy_table_torch.json"))
