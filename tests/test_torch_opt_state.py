"""The port's replayable state (`opt/{mode,state}.py`) against the JAX
package: a directory saved by either restores in the other.

JAX quantizes a tiny Llama (INT8_SMOOTHQUANT: per-site pre_quant_scale
slots the skeleton lacks; INT4_SVDQUANT: the adapters file); the port's
copy comes through `convert.quantized_from_jax`. After a save in one
package and a restore in the other: every parameter and quantizer tensor
bit-equal to the saved model's, the files' names JAX's, and the restored
model's logits within 1e-5 of the saved model's scale (the two forwards sum
in another order). bf16 weights cross as their raw bits ("::bf16")."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.opt import state as jstate
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.opt import state as tstate
from tensorrt_model_optimizer_tpu_torch.opt.mode import ModeRegistry
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
from tensorrt_model_optimizer_tpu_torch.utils import tree as ttree

LOGITS_TOL = 1e-5


def _jax_model(preset, dtype=jnp.float32):
    import dataclasses

    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=dtype)
    params = jax.tree.map(lambda a: a.astype(dtype), jllama.init_params(cfg, jax.random.PRNGKey(0)))
    batches = [jnp.asarray(np.random.default_rng(1).integers(0, 256, size=(2, 16)))]
    return jptq.quantize(cfg, params, preset, batches), batches[0]


@pytest.fixture(scope="module")
def smoothquant():
    jm, toks = _jax_model("INT8_SMOOTHQUANT_CFG")
    return jm, convert.quantized_from_jax(jm), toks


def _named(tree) -> dict:
    """JAX or port tree -> {name: numpy bits}, through the port's names."""
    flat = ttree.flatten_with_names(convert.params_from_jax(tree) if not _is_torch(tree) else tree)
    return {k: (v.view(torch.uint16) if v.dtype == torch.bfloat16 else v).numpy() for k, v in flat.items()}


def _is_torch(tree) -> bool:
    leaves = []
    ttree.map_tensors(leaves.append, tree)
    return bool(leaves)


def _same_state(a, b):
    na, nb = _named(a), _named(b)
    assert set(na) == set(nb)
    for k in na:
        assert na[k].dtype == nb[k].dtype and np.array_equal(na[k], nb[k]), k


def _logits_close(t_logits, j_logits):
    assert rel_err(t_logits.detach().float().numpy(), np.asarray(j_logits, np.float32)) <= LOGITS_TOL


def test_names_are_jaxs():
    jm, _ = _jax_model("INT8_DEFAULT_CFG")
    tm = convert.quantized_from_jax(jm)
    from tensorrt_model_optimizer_tpu.utils import tree as jtree

    assert set(ttree.flatten_with_names(tm.params)) == set(jtree.flatten_with_names(jm.params))
    assert set(ttree.flatten_with_names(tm.qstate)) == set(jtree.flatten_with_names(jm.qstate))


def test_port_save_restores_in_jax(smoothquant, tmp_path):
    jm, tm, toks = smoothquant
    tstate.save(tm, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["modelopt_state.json", "params.safetensors", "quant_state.safetensors"]
    back = jstate.restore(str(tmp_path))
    _same_state(back.params, tm.params)
    _same_state(back.qstate, tm.qstate)
    assert back.model_cfg == jm.model_cfg and back.quant_cfg == jm.quant_cfg
    with torch.no_grad():
        _logits_close(tm.forward(torch.from_numpy(np.array(toks)).long())[0], back.forward(toks)[0])


def test_jax_save_restores_in_port(smoothquant, tmp_path):
    jm, _, toks = smoothquant
    jstate.save(jm, str(tmp_path))
    back = tstate.restore(str(tmp_path), device="cpu")
    _same_state(back.params, jm.params)
    _same_state(back.qstate, jm.qstate)
    assert back.quant_cfg == convert.quantized_from_jax(jm).quant_cfg
    pqs = back.qstate["self_attn.q_proj"]["input"].pre_quant_scale
    assert pqs is not None and bool((pqs != 1.0).any())
    with torch.no_grad():
        _logits_close(back.forward(torch.from_numpy(np.array(toks)).long())[0], jm.forward(toks)[0])
    with open(tmp_path / "modelopt_state.json") as f:
        assert json.load(f) == tstate.modelopt_state(back).to_json()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_bf16_weights_cross_as_raw_bits(tmp_path, direction):
    jm, toks = _jax_model("FP8_DEFAULT_CFG", jnp.bfloat16)
    tm = convert.quantized_from_jax(jm)
    assert tm.params["lm_head"].dtype == torch.bfloat16
    if direction == "port_to_jax":
        tstate.save(tm, str(tmp_path))
        back = jstate.restore(str(tmp_path))
    else:
        jstate.save(jm, str(tmp_path))
        back = tstate.restore(str(tmp_path), device="cpu")
    _same_state(back.params, tm.params)
    _same_state(back.qstate, tm.qstate)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_svdquant_adapters_cross(tmp_path, direction):
    jm, toks = _jax_model("INT4_SVDQUANT_CFG")
    tm = convert.quantized_from_jax(jm)
    if direction == "port_to_jax":
        tstate.save(tm, str(tmp_path))
        back, ref = jstate.restore(str(tmp_path)), tm
    else:
        jstate.save(jm, str(tmp_path))
        back, ref = tstate.restore(str(tmp_path), device="cpu"), tm
    assert "adapters.safetensors" in os.listdir(tmp_path)
    _same_state(back.adapters, ref.adapters)
    _same_state(back.params, ref.params)


def test_port_roundtrip_with_external_params_and_registry(smoothquant, tmp_path):
    _, tm, toks = smoothquant
    tstate.save(tm, str(tmp_path), save_params=False)
    assert "params.safetensors" not in os.listdir(tmp_path)
    back = tstate.restore(str(tmp_path), params=tm.params, device="cpu")
    t = torch.from_numpy(np.array(toks)).long()
    with torch.no_grad():
        assert torch.equal(back.forward(t)[0], tm.forward(t)[0])
    assert ModeRegistry.get_global("quantize").name == "quantize"
    for name in tconfig.choices():
        cfg = tconfig.get_preset(name)
        assert tconfig.config_from_dict(json.loads(json.dumps(tconfig.config_to_dict(cfg)))) == cfg, name


def test_sharded_save_and_restore_wait_for_multi_gpu(smoothquant, tmp_path):
    """Multi-GPU save / restore came with the multi-GPU slice (its mesh
    round trips are in test_torch_sharded_ptq.py); with no mesh one process
    writes the whole model as one shard and the restore gathers it back,
    weights and quantizer state equal."""
    _, tm, _ = smoothquant
    tstate.save_sharded(tm, str(tmp_path))
    back = tstate.restore_sharded(str(tmp_path), device="cpu")
    from tensorrt_model_optimizer_tpu_torch.utils import tree

    for mine, theirs in ((tm.params, back.params), (tm.qstate, back.qstate)):
        a, b = tree.flatten_with_names(mine), tree.flatten_with_names(theirs)
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
