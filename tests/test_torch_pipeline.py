"""The port's GPipe forward on 4 gloo ranks (CPU), a stage a rank, against
the unsharded forward (JAX's tests/test_pipeline.py): a tiny Llama of 8
layers (2 a stage), batch 4 x 16 tokens, f32, seeded by JAX and carried
across. 4 and 2 microbatches within 2e-4 (JAX's bound) of the port's
`llama.forward` and of JAX's; FP8_DEFAULT_CFG, calibrated on the same
batch, within 2e-3 (JAX's bound) of the quantized forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama
from tensorrt_model_optimizer_tpu_torch.quant import config


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = jllama.LlamaConfig.tiny(num_hidden_layers=8)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, 256, size=(4, 16))
    cfg, params = convert.llama_cfg_from_jax(jcfg), convert.params_from_jax(jparams)
    tt = torch.from_numpy(tokens)
    layout = llama.build_layout(cfg, config.get_preset("FP8_DEFAULT_CFG"))
    _, qs, _ = llama.forward(cfg, params, tt, layout=layout, qstate=llama.init_quant_state(cfg, layout, "cpu"),
                             calib=True)
    ranks = _torch_tp.launch(_torch_tp.pipeline_cases, 4, tmp_path_factory.mktemp("pipe"), cfg, params, tt, layout,
                             qs)
    ref = llama.forward(cfg, params, tt)[0].numpy()
    qref = llama.forward(cfg, params, tt, layout=layout, qstate=qs)[0].numpy()
    jref = np.asarray(jllama.forward(jcfg, jparams, jnp.asarray(tokens))[0])
    return ranks, ref, qref, jref


@pytest.mark.parametrize("m", ["m4", "m2"])
def test_pipeline_matches_plain(runs, m):
    ranks, ref, _, jref = runs
    for rank in ranks:
        np.testing.assert_allclose(rank[m], ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(rank[m], jref, rtol=2e-4, atol=2e-4)


def test_quantized_pipeline(runs):
    ranks, _, qref, _ = runs
    for rank in ranks:
        np.testing.assert_allclose(rank["fp8"], qref, rtol=2e-3, atol=2e-3)
