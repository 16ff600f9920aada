"""Multi-GPU PTQ and sharded checkpoints of the port on gloo ranks (CPU).

The two sharded-calibration examples (`examples/moe_ptq_sharded_torch.py`,
`examples/deepseek_ptq_sharded_torch.py`, 4 ranks each: experts over 2,
each expert's projections over 2) run as `--cpu --devices 4`: in every
rank the sharded amaxes equal one process's calibration of the whole model
(within 1e-6 relative for Mixtral, JAX's example's bound; 1e-4 absolute for
DeepSeek, JAX's), and the model served over the ranks gives the
single-process engine's tokens (each example raises otherwise).

`opt.state.save_sharded` / `restore_sharded`: JAX's FP8 model of a tiny
Llama (its calibration, carried across) saved by 4 ranks on a ("rep",
"tensor") mesh of 2 x 2, each rank's restore equal to its slice of the
model, and the restore with no mesh equal to the model and to JAX's own
`restore_sharded` of its orbax `save_sharded` of the same model, value for
value."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp
from _torch_parity import tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.opt import state as jstate
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.opt import state
from tensorrt_model_optimizer_tpu_torch.quant import sharded
from tensorrt_model_optimizer_tpu_torch.utils import tree

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))


def test_moe_sharded_ptq_example():
    import moe_ptq_sharded_torch as ex

    out = ex.main(["--cpu", "--devices", "4", "--qformat", "FP8_DEFAULT_CFG"])
    assert len(out) == 4 and all(r["amax_gap"] <= ex.AMAX_RTOL for r in out)
    assert all(np.array_equal(r["tokens"], out[0]["tokens"]) for r in out)
    assert out[0]["mesh"] == {"expert": 2, "tensor": 2}


def test_deepseek_sharded_ptq_example():
    import deepseek_ptq_sharded_torch as ex

    out = ex.main(["--cpu", "--devices", "4", "--qformat", "NVFP4_DEFAULT_CFG"])
    assert all(r["amax_gap"] < ex.AMAX_ATOL for r in out)
    assert all(np.array_equal(r["tokens"], out[0]["tokens"]) for r in out)
    assert out[0]["corr"] > 0.5


@pytest.mark.parametrize("family, preset", [("mixtral", "INT4_AWQ_CFG"), ("mixtral", "INT8_SMOOTHQUANT_CFG"),
                                            ("llama", "FP8_DEFAULT_CFG")])
def test_sharded_calibration_refuses_what_it_does_not_shard(family, preset):
    """Max calibration of mixtral / deepseek only (JAX's sharded examples
    calibrate by max): anything else raises before any rank's work."""
    with pytest.raises(NotImplementedError):
        sharded.quantize_sharded(family, None, {}, preset, [], None)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    batches = [jnp.asarray(np.random.default_rng(1).integers(0, 256, size=(2, 16)))]
    jq = jptq.quantize(cfg, params, "FP8_DEFAULT_CFG", batches)
    model = convert.quantized_from_jax(jq)
    path = str(tmp_path_factory.mktemp("sharded") / "ckpt")
    ranks = _torch_tp.launch(_torch_tp.state_cases, 4, tmp_path_factory.mktemp("ranks"), model, path)
    jpath = str(tmp_path_factory.mktemp("jax") / "ckpt")
    jstate.save_sharded(jq, jpath)
    return model, path, ranks, jstate.restore_sharded(jpath)


def test_restore_gathers_the_saved_model(saved):
    model, path, _, jrestored = saved
    back = state.restore_sharded(path, device="cpu")
    want = tree.flatten_with_names(model.params)
    got = tree.flatten_with_names(back.params)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    jflat = tree.flatten_with_names(tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                                             jrestored.params))
    for k in want:
        assert torch.equal(got[k].float(), jflat[k]), k
    for k, v in tree.flatten_with_names(model.qstate).items():
        assert torch.equal(tree.flatten_with_names(back.qstate)[k], v), k


def test_each_rank_restores_its_shards(saved):
    model, _, ranks, _ = saved
    specs = state._param_specs(model)
    want = tree.flatten_with_names(model.params)
    for rank in ranks:
        got = tree.flatten_with_names(rank["params"])
        for k, w in want.items():
            shard = state._shard_of(tuple(specs.get(k, ())), rank["coords"], {"rep": 2, "tensor": 2})
            assert torch.equal(got[k], state._slice(w, shard)), k
