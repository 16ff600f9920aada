"""Tree-speculative decoding on the other families, against the JAX engine.

Windows and chunks: under `mask_override` JAX's `_model_step` applies the
tree mask in every layer in place of GPT-OSS's sliding window and Llama4's
chunk (`serve/engine.py:789-826`), so on a prompt past the window / chunk
its speculative tokens leave its own greedy tokens from the first verify
round. The port refuses those configs (`NotImplementedError`; ROADMAP
queue 3). MoE: the verify step sizes an expert's capacity from the N = 7
tree rows (C = max(int(2 * 7 * 2 / 8), 1) = 3 here), as JAX's does; on the
tiny Mixtral below the port's speculative tokens and rate equal JAX's, and
both equal greedy decoding's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fams
from _torch_parity import tree_map
from tensorrt_model_optimizer_tpu.models import mixtral as jmix
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu.speculative import medusa as jmedusa
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import mixtral as tmix
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine

PROMPT = np.random.default_rng(5).integers(0, 256, size=(1, 16)).astype(np.int32)  # past window / chunk 8


@pytest.mark.parametrize("fam", ["gpt_oss", "llama4"])
def test_span_families_jax_leaves_greedy_and_the_port_refuses(fam):
    jcm = fams.jax_compressed(fam, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG")
    span = getattr(jcm.model_cfg, "sliding_window", None) or jcm.model_cfg.attention_chunk_size
    assert span == 8 < PROMPT.shape[1]
    heads = jmedusa.init_medusa(jcm.model_cfg, jmedusa.MedusaConfig(num_heads=3), jax.random.PRNGKey(3))
    je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=64, backend="xla", kv_dtype=jnp.int8))
    spec, _ = je.generate_speculative(jnp.asarray(PROMPT), heads, max_new_tokens=8)
    greedy = np.asarray(je.generate(jnp.asarray(PROMPT), 8))[0].tolist()
    assert spec[0] == greedy[0] and spec != greedy  # the prefill agrees; the first verify round does not
    te = tengine.Engine(convert.compressed_from_jax(jcm), tengine.EngineConfig(max_seq_len=64, kv_dtype=torch.int8),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="sliding windows or Llama4's chunked attention"):
        te.generate_speculative(torch.from_numpy(PROMPT), convert.drafts_from_jax(heads), 8)


def test_moe_speculative_matches_jax_and_greedy():
    jcfg = jmix.MixtralConfig.tiny(num_experts=8, hidden_size=128, intermediate_size=128, num_hidden_layers=2)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    params = tmix.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jcm = jcompress.compress(jptq.quantize_family("mixtral", jcfg, tree_map(lambda t: jnp.asarray(t.numpy()), params),
                                                  "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"))
    heads = jmedusa.init_medusa(jcfg, jmedusa.MedusaConfig(num_heads=3), jax.random.PRNGKey(3))
    je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=64, backend="xla", kv_dtype=jnp.int8))
    jt, jr = je.generate_speculative(jnp.asarray(PROMPT), heads, max_new_tokens=12)
    te = tengine.Engine(convert.compressed_from_jax(jcm), tengine.EngineConfig(max_seq_len=64, kv_dtype=torch.int8),
                        device="cpu")
    tt, tr = te.generate_speculative(torch.from_numpy(PROMPT), convert.drafts_from_jax(heads), 12)
    assert tt == [int(t) for t in jt] and tr == jr
    assert tt == te.generate(torch.from_numpy(PROMPT), 12)[0].tolist()
