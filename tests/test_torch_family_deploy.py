"""GPT-OSS's native MXFP4 export and both families' HF loaders in the port
against the JAX package's, on tiny models (GPT-OSS with yarn rope, sinks and
biases; Llama4 with its shared expert): the export's files byte-equal to
JAX's, single-file and sharded, and its refusal of other formats;
`load_hf_moe_checkpoint` on the native MXFP4 checkpoint JAX writes, on a
bf16 GPT-OSS checkpoint and on a multimodal-nested bf16 Llama4 checkpoint the
test writes, configs and tensors equal to JAX's loaders' (bit for bit: both
dequantize MXFP4 exactly); the deploy loop export -> load -> quantize_family
-> compress, the loaded packs equal to compress's on the in-memory model and
the served logits equal to the engine's over the export's tensors held in
memory; the registry; Llama4's export refusal; and the CLI on a GPT-OSS
checkpoint. JAX's quantized model is built once per module."""

import dataclasses
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import bits, gpt_oss_pair, llama4_pair
from tensorrt_model_optimizer_tpu.export import hf_export as jexport
from tensorrt_model_optimizer_tpu.models import hf_loader as jload
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.models import registry as jreg
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.export import hf_export as texport
from tensorrt_model_optimizer_tpu_torch.models import gpt_oss as tgpt
from tensorrt_model_optimizer_tpu_torch.models import hf_loader as tload
from tensorrt_model_optimizer_tpu_torch.models import llama4 as tl4
from tensorrt_model_optimizer_tpu_torch.models import registry as treg
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.quant import quantizer as tQ
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine

ROOT = os.path.join(os.path.dirname(__file__), "..")
YARN = dict(rope_type="yarn", factor=32.0, original_max_position_embeddings=64, truncate=False)
SHARD = 40_000  # bytes: several shards of the tiny model


@pytest.fixture(scope="module")
def oss():
    jcfg, jp, tcfg, tp = gpt_oss_pair(11, rope_scaling=None)
    jcfg = dataclasses.replace(jcfg, rope_scaling=jllama.RopeScaling(**YARN))
    tcfg = convert.llama_cfg_from_jax(jcfg)
    calib = [np.random.default_rng(12).integers(0, 256, size=(2, 16)).astype(np.int32)]
    jq = jptq.quantize_family("gpt_oss", jcfg, jp, "MXFP4_DEFAULT_CFG", [jnp.asarray(b) for b in calib])
    return jcfg, jp, tcfg, tp, jq, calib


def _files(d) -> dict:
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("shard", [None, SHARD])
def test_gpt_oss_export_bytes_equal_jax(oss, tmp_path, shard):
    *_, jq, _ = oss
    jexport.export_hf_checkpoint(jq, str(tmp_path / "jax"), max_shard_bytes=shard)
    qc = texport.export_hf_checkpoint(convert.quantized_from_jax(jq), str(tmp_path / "port"), max_shard_bytes=shard)
    assert qc["quantization"]["quant_algo"] == "MXFP4"
    jf, tf = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert set(tf) == set(jf) and ("model.safetensors.index.json" in tf) == (shard is not None)
    assert len([f for f in tf if f.endswith(".safetensors")]) > (1 if shard else 0)
    for name, data in jf.items():
        assert tf[name] == data, name


def test_gpt_oss_export_refuses_other_formats_as_jax(oss, tmp_path):
    jcfg, jp, tcfg, tp, _, calib = oss
    tm = tptq.quantize_family("gpt_oss", tcfg, tp, "NVFP4_WEIGHT_ONLY_CFG", device="cpu")
    with pytest.raises(NotImplementedError, match="native MXFP4"):
        texport.export_hf_checkpoint(tm, str(tmp_path / "port"))
    jm = jptq.quantize_family("gpt_oss", jcfg, jp, "NVFP4_WEIGHT_ONLY_CFG")
    with pytest.raises(NotImplementedError, match="native MXFP4"):
        jexport.export_hf_checkpoint(jm, str(tmp_path / "jax"))


def _same_load(path):
    """Both packages' `load_hf_moe_checkpoint` in f32: configs equal, every
    tensor equal bit for bit. Returns the port's (config, params)."""
    jcfg, jp = jload.load_hf_moe_checkpoint(path, dtype=jnp.float32)
    tcfg, tp = tload.load_hf_moe_checkpoint(path, dtype=torch.float32, device="cpu")
    assert convert.llama_cfg_from_jax(jcfg) == tcfg
    assert set(tp["layers"]) == set(jp["layers"]) and set(tp) == set(jp)
    for name, t in tp["layers"].items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jp["layers"][name]), err_msg=name)
    for name in ("embed_tokens", "norm", "lm_head"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]), err_msg=name)
    return tcfg, tp


def test_load_gpt_oss_native_mxfp4_matches_jax(oss, tmp_path):
    """JAX's native export read back by both loaders: the MXFP4 experts
    dequantized (low nibble first, E8M0 - 127, blocks along the contraction
    dim) and de-interleaved to the fake-quantized weights of the quantized
    model; the config's layer types and window. Both loaders read yarn back
    with truncate=True and the default betas: JAX's writer keeps only
    llama3's fields of rope_scaling (ROADMAP queue 3, shared)."""
    jcfg, *_, jq, _ = oss
    jexport.export_hf_checkpoint(jq, str(tmp_path))
    tcfg, tp = _same_load(str(tmp_path))
    assert type(tcfg) is tgpt.GptOssConfig and tcfg.resolved_layer_types() == jcfg.resolved_layer_types()
    assert tcfg.rope_scaling.rope_type == "yarn" and tcfg.rope_scaling.truncate is True
    tm = convert.quantized_from_jax(jq)
    for name in ("moe.gate_proj", "moe.down_proj"):
        wcfg = tm.layout.get(f"{name}.weight")
        want = tQ.quantize(tm.params["layers"][name], wcfg, tm.qstate[name]["weight"])
        np.testing.assert_array_equal(tp["layers"][name].numpy(), want.numpy(), err_msg=name)


def test_load_gpt_oss_bf16_matches_jax(oss, tmp_path):
    """A bf16 GPT-OSS checkpoint (fused gate_up_proj [E, H, 2I], gate the
    even columns) read by both loaders."""
    jcfg, _, tcfg, tp, _, _ = oss
    L, E, I = tcfg.num_hidden_layers, tcfg.num_experts, tcfg.intermediate_size
    lay, flat = tp["layers"], {"model.embed_tokens.weight": tp["embed_tokens"], "model.norm.weight": tp["norm"],
                               "lm_head.weight": tp["lm_head"]}
    for i in range(L):
        p = f"model.layers.{i}."
        flat |= {p + "input_layernorm.weight": lay["input_layernorm"][i],
                 p + "post_attention_layernorm.weight": lay["post_attention_layernorm"][i],
                 p + "self_attn.sinks": lay["self_attn.sinks"][i], p + "mlp.router.weight": lay["moe.router"][i],
                 p + "mlp.router.bias": lay["moe.router__bias"][i],
                 p + "mlp.experts.gate_up_proj": torch.stack([lay["moe.gate_proj"][i], lay["moe.up_proj"][i]],
                                                             dim=-1).transpose(1, 2).reshape(E, -1, 2 * I),
                 p + "mlp.experts.gate_up_proj_bias": torch.stack([lay["moe.gate_proj__bias"][i],
                                                                   lay["moe.up_proj__bias"][i]], -1).reshape(E, 2 * I),
                 p + "mlp.experts.down_proj": lay["moe.down_proj"][i].transpose(1, 2),
                 p + "mlp.experts.down_proj_bias": lay["moe.down_proj__bias"][i]}
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            flat |= {p + f"self_attn.{proj}.weight": lay[f"self_attn.{proj}"][i],
                     p + f"self_attn.{proj}.bias": lay[f"self_attn.{proj}__bias"][i]}
    tload.save_safetensors({k: v.to(torch.bfloat16).contiguous() for k, v in flat.items()},
                           str(tmp_path / "model.safetensors"))
    d = {"model_type": "gpt_oss", "vocab_size": 256, "hidden_size": 64, "intermediate_size": I,
         "num_hidden_layers": L, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "num_local_experts": E, "num_experts_per_tok": 2, "sliding_window": 8,
         "layer_types": ["full_attention", "sliding_attention"], "rope_theta": 150000.0}
    (tmp_path / "config.json").write_text(json.dumps(d))
    cfg, params = _same_load(str(tmp_path))
    assert cfg.resolved_layer_types() == ("full_attention", "sliding_attention")
    np.testing.assert_array_equal(params["layers"]["moe.up_proj"].numpy(),
                                  lay["moe.up_proj"].to(torch.bfloat16).float().numpy())


def _llama4_checkpoint(path, nested: bool, interleave: int = 1):
    jcfg, _, tcfg, tp = llama4_pair(13, no_rope_layers=(1, 1, 0, 1))
    L, I = tcfg.num_hidden_layers, tcfg.intermediate_size
    pre = "language_model." if nested else ""
    lay = tp["layers"]
    flat = {pre + "model.embed_tokens.weight": tp["embed_tokens"], pre + "model.norm.weight": tp["norm"],
            pre + "lm_head.weight": tp["lm_head"]}
    for i in range(L):
        p = pre + f"model.layers.{i}."
        flat |= {p + "input_layernorm.weight": lay["input_layernorm"][i],
                 p + "post_attention_layernorm.weight": lay["post_attention_layernorm"][i],
                 p + "feed_forward.router.weight": lay["moe.router"][i],
                 p + "feed_forward.experts.gate_up_proj": torch.cat([lay["moe.gate_proj"][i], lay["moe.up_proj"][i]],
                                                                    dim=1).transpose(1, 2),
                 p + "feed_forward.experts.down_proj": lay["moe.down_proj"][i].transpose(1, 2)}
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            flat[p + f"self_attn.{proj}.weight"] = lay[f"self_attn.{proj}"][i]
        for proj in ("gate_proj", "up_proj", "down_proj"):
            flat[p + f"feed_forward.shared_expert.{proj}.weight"] = lay[f"shared.{proj}"][i]
    tload.save_safetensors({k: v.to(torch.bfloat16).contiguous() for k, v in flat.items()},
                           os.path.join(path, "model.safetensors"))
    text = {"model_type": "llama4_text", "vocab_size": 256, "hidden_size": 64, "intermediate_size": I,
            "num_hidden_layers": L, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
            "num_local_experts": 4, "num_experts_per_tok": 1, "no_rope_layers": [1, 1, 0, 1],
            "attention_chunk_size": 8, "floor_scale": 8, "attn_scale": 0.1, "interleave_moe_layer_step": interleave,
            "rope_scaling": {"rope_type": "llama3", "factor": 16.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                             "original_max_position_embeddings": 64}}
    d = {"model_type": "llama4", "text_config": text} if nested else text
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(d, f)
    return tp


@pytest.mark.parametrize("nested", [True, False])
def test_load_llama4_matches_jax(tmp_path, nested):
    """A bf16 Llama4 checkpoint, multimodal-nested (`text_config`, the
    `language_model.` prefix) or text-only: chunked gate_up_proj (gate the
    first I columns), the shared expert, the explicit no_rope_layers."""
    tp = _llama4_checkpoint(str(tmp_path), nested)
    cfg, params = _same_load(str(tmp_path))
    assert type(cfg) is tl4.Llama4Config and cfg.use_rope_layers() == (True, True, False, True)
    assert cfg.attention_chunk_size == 8 and cfg.rope_scaling.rope_type == "llama3"
    np.testing.assert_array_equal(params["layers"]["shared.up_proj"].numpy(),
                                  tp["layers"]["shared.up_proj"].to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(params["layers"]["moe.up_proj"].numpy(),
                                  tp["layers"]["moe.up_proj"].to(torch.bfloat16).float().numpy())


def test_llama4_interleaved_moe_layers_raise_as_jax(tmp_path):
    _llama4_checkpoint(str(tmp_path), True, interleave=2)
    with pytest.raises(NotImplementedError, match="interleave_moe_layer_step"):
        jload.load_hf_moe_checkpoint(str(tmp_path))
    with pytest.raises(NotImplementedError, match="interleave_moe_layer_step"):
        tload.load_hf_moe_checkpoint(str(tmp_path), device="cpu")


def test_deploy_loop(oss, tmp_path):
    """The port alone: MXFP4 export -> `load_hf_moe_checkpoint` ->
    `quantize_family` -> compress -> engine. The loaded model's expert and
    attention packs equal compress's packs of the in-memory model (MXFP4 of
    its own grid values is the identity), and its served logits and tokens
    equal the engine's over the export's tensors held in memory
    (`gpt_oss_from_tensors`): the files carry what the export made. In
    bf16, as served: the export's fp16 holds the bf16 weights exactly."""
    _, _, tcfg, tp, _, calib = oss
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    tp = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()} if k == "layers" else v.to(torch.bfloat16))
          for k, v in tp.items()}
    qm = tptq.quantize_family("gpt_oss", tcfg, tp, "MXFP4_WEIGHT_ONLY_CFG", device="cpu")
    texport.export_hf_checkpoint(qm, str(tmp_path))
    with open(tmp_path / "config.json") as f:
        d = json.load(f)
    served = []
    for cfg, params in (tload.load_hf_moe_checkpoint(str(tmp_path), device="cpu"),
                        tload.gpt_oss_from_tensors(d, dict(texport._iter_gpt_oss_tensors(qm)), device="cpu")):
        cm = tcompress.compress(tptq.quantize_family("gpt_oss", cfg, params, "MXFP4_WEIGHT_ONLY_CFG", device="cpu"))
        eng = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=32), device="cpu")
        prompt = torch.from_numpy(calib[0][:, :12].astype(np.int64))
        served.append((cm, eng.prefill(prompt, eng.init_cache(2, 32)), eng.generate(prompt, 4)))
    (loaded, lg, lt), (mem, mg, mt) = served
    assert torch.equal(lg, mg) and torch.equal(lt, mt)
    ref = tcompress.compress(qm)
    for name, kind in ref.kinds.items():
        assert loaded.kinds[name] == kind == "mxfp4"
        for k, a in ref.params["layers"][name].items():
            np.testing.assert_array_equal(bits(loaded.params["layers"][name][k]), bits(a), err_msg=f"{name}.{k}")


def test_registry_matches_jax():
    # dit is registered since the diffusion slice (tests/test_torch_dit.py),
    # mamba since the hybrid slice (tests/test_torch_mamba.py)
    assert treg.families() == ["dit", "gpt_oss", "llama", "llama4", "mamba", "mixtral"]
    for mt in ("llama4", "llama4_text", "gpt_oss"):
        assert treg.for_hf_model_type(mt).name == jreg.for_hf_model_type(mt).name
    assert treg.get("gpt_oss").forward is tgpt.forward and treg.get("llama4").forward is tl4.forward
    assert treg.get("llama4").config_cls is tl4.Llama4Config and treg.get("gpt_oss").init_params is tgpt.init_params
    from tensorrt_model_optimizer_tpu_torch.models import mamba as tmamba

    assert treg.get("mamba").forward is tmamba.forward
    assert treg.for_hf_model_type("nemotron_h").name == jreg.for_hf_model_type("nemotron_h").name == "mamba"


def test_llama4_export_raises_as_jax(tmp_path):
    jcfg, jp, tcfg, tp = llama4_pair(14)
    tm = tptq.quantize_family("llama4", tcfg, tp, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", device="cpu")
    with pytest.raises(NotImplementedError, match="shared expert"):
        texport.export_hf_checkpoint(tm, str(tmp_path / "port"))
    jm = jptq.quantize_family("llama4", jcfg, jp, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG")
    with pytest.raises(NotImplementedError, match="shared"):
        jexport.export_hf_checkpoint(jm, str(tmp_path / "jax"))


def test_cli_runs_gpt_oss(oss, tmp_path):
    """examples/hf_ptq_torch.py on a native GPT-OSS checkpoint: the registry
    sends it to the gpt_oss family and its export writes the native format
    back, which loads."""
    *_, jq, _ = oss
    jexport.export_hf_checkpoint(jq, str(tmp_path / "in"))
    spec = importlib.util.spec_from_file_location("hf_ptq_torch", os.path.join(ROOT, "examples", "hf_ptq_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    out = cli.main(["--device", "cpu", "--model", str(tmp_path / "in"), "--qformat", "MXFP4_WEIGHT_ONLY_CFG",
                    "--calib_batches", "2", "--calib_seq_len", "16", "--export_path", str(tmp_path / "out")])
    assert out["quant_algo"] == "MXFP4" and out["model"].forward_fn is tgpt.forward and np.isfinite(out["ppl_after"])
    assert type(tload.load_hf_moe_checkpoint(str(tmp_path / "out"), device="cpu")[0]) is tgpt.GptOssConfig
