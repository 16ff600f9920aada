"""The port's einsum engine serving GPT-OSS and Llama4 against the JAX
package's: the same seeded tiny models (`_torch_families.family_pair`:
GPT-OSS 2 layers, sliding then full, window 8, sinks N(0, 1), biases
N(0, 0.5^2); Llama4 4 layers, the 4th a nope layer, chunk 8, floor_scale 8;
both hidden 128, head_dim 32), each package calibrating and packing on its
own (JAX's once a process), int8 KV, a 12-token prompt (past the
window and the chunk) and 6 greedy tokens (positions past floor_scale):
prefill logits within 1e-4 of their scale and greedy tokens equal under
GPT-OSS's MXFP4 and NVFP4, Llama4's NVFP4 and W4A8 (JAX on its w48 Pallas
kernel, interpreted; every shape here is one it tiles). Then the port's own
checks: decode steps equal a longer prefill (1e-5), sinks and the window
matter, and every refusal, JAX's shared ones and the two the port adds for
the reference's faults, each shown on JAX's engine: its paged serving runs
a Llama4 model as if it were Llama, and its sparse prefill drops the sinks
and the window."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import SIZE, family_pair, gpt_oss_pair, jax_compressed, llama4_pair, quantized
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import mixtral as jmix
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine

NEW = 6
CASES = {  # name -> (family, preset, layout fields, JAX backend)
    "gpt_oss-mxfp4": ("gpt_oss", "MXFP4_DEFAULT_CFG", {}, "xla"),
    "gpt_oss-nvfp4": ("gpt_oss", "NVFP4_DEFAULT_CFG", {}, "xla"),
    "llama4-nvfp4": ("llama4", "NVFP4_DEFAULT_CFG", {}, "xla"),
    "llama4-w4a8": ("llama4", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", {"int4_layout": "a8"}, "pallas"),
}
PROMPT = np.random.default_rng(5).integers(0, 256, size=(2, 12)).astype(np.int32)


@functools.cache
def _served(case):
    """(JAX engine, port engine) of a case, each package quantizing and
    packing the same weights on its own; built once a module."""
    fam, preset, layout, backend = CASES[case]
    jcm = jax_compressed(fam, preset)
    tcm = tcompress.compress(quantized(fam, preset)[1])
    je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=32, backend=backend, kv_dtype=jnp.int8, **layout))
    te = tengine.Engine(tcm, tengine.EngineConfig(max_seq_len=32, kv_dtype=torch.int8, **layout), device="cpu")
    return je, te


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_greedy_tokens_equal_jax(case):
    prompt = PROMPT
    je, te = _served(case)
    if case == "llama4-w4a8":
        assert "int4w48" in set(je.cm.kinds.values()) and set(te.cm.kinds.values()) == {"int4a8"}
    jl, _ = je.prefill(jnp.asarray(prompt), je.init_cache(2, 32))
    tl = te.prefill(torch.from_numpy(prompt), te.init_cache(2, 32))
    assert rel_err(tl.numpy(), np.asarray(jl)) < 1e-4
    jt = np.asarray(je.generate(jnp.asarray(prompt), NEW))
    np.testing.assert_array_equal(te.generate(torch.from_numpy(prompt), NEW).numpy(), jt)
    # the fused step gives the same tokens as the generate loop
    cache = te.init_cache(2, 32)
    tok = torch.argmax(te.prefill(torch.from_numpy(prompt), cache), dim=-1).to(torch.int32)[:, None]
    tok, cache = te.decode_step(tok, cache, unroll=NEW - 1)
    assert tok[:, 0].tolist() == jt[:, -1].tolist() and int(cache["pos"]) == 12 + NEW - 1


def _bf16(fam):
    """The port's tiny model of `fam` (f32 activations), every weight site
    unquantized (the "bf16" kind)."""
    _, _, tcfg, tp = {"gpt_oss": gpt_oss_pair, "llama4": llama4_pair}[fam](7, **SIZE)
    off = tconfig.make_config({"*": {"enable": False}})
    cm = tcompress.compress(tptq.quantize_family(fam, tcfg, tp, off, device="cpu"))
    assert set(cm.kinds.values()) == {"bf16"}
    return cm


@pytest.mark.parametrize("fam", ["gpt_oss", "llama4"])
def test_decode_steps_equal_a_longer_prefill(fam):
    """Split decode over the cache (the window, the chunk, the sinks, the
    temperature at each step's position) against a prefill of the whole
    sequence: each step's logits within 1e-5 of the prefill's at that
    position (f32 activations and cache)."""
    eng = tengine.Engine(_bf16(fam), tengine.EngineConfig(max_seq_len=32), device="cpu")
    seq = torch.from_numpy(np.random.default_rng(8).integers(0, 256, size=(2, 22)).astype(np.int64))
    full = tengine.Engine._model_step(eng, seq, eng.init_cache(2, 32), full_logits=True)
    cache = eng.init_cache(2, 32)
    eng.prefill(seq[:, :10], cache)
    for t in range(10, 22):
        step = eng._model_step(seq[:, t:t + 1], cache)
        assert rel_err(step.numpy(), full[:, t].numpy()) < 1e-5, t


def test_sinks_and_the_window_matter():
    """Zeroing the sinks, making every GPT-OSS layer full, or every Llama4
    layer a nope layer changes the prefill logits (JAX's
    `test_sliding_and_sinks_matter`: no silent no-ops)."""
    prompt = torch.from_numpy(np.random.default_rng(9).integers(0, 256, size=(2, 12)).astype(np.int64))

    def logits(cm):
        eng = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=32), device="cpu")
        return eng.prefill(prompt, eng.init_cache(2, 32))

    cm = _bf16("gpt_oss")
    base = logits(cm)
    nosink = dataclasses.replace(cm, params={**cm.params, "layers": {
        **cm.params["layers"], "self_attn.sinks": torch.zeros_like(cm.params["layers"]["self_attn.sinks"])}})
    full = dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, layer_types=("full_attention",) * 2))
    assert float((logits(nosink) - base).abs().max()) > 1e-4
    assert float((logits(full) - base).abs().max()) > 1e-4
    cm4 = _bf16("llama4")
    nope = dataclasses.replace(cm4, model_cfg=dataclasses.replace(cm4.model_cfg, no_rope_layers=(0, 0, 0, 0)))
    assert float((logits(nope) - logits(cm4)).abs().max()) > 1e-4


@pytest.mark.parametrize("fam", ["gpt_oss", "llama4"])
def test_refusals(fam):
    """JAX's: the kernel engine refuses sliding windows, Llama4's chunked
    attention and sinks; the port's own: paged serving of either family and
    a sparse prefill of either (ROADMAP queue 3)."""
    cm = _bf16(fam)
    what = "sliding windows" if fam == "gpt_oss" else "chunked attention"
    with pytest.raises(NotImplementedError, match=what):
        tengine.Engine(cm, tengine.EngineConfig(kv_attention_kernel=True), device="cpu")
    with pytest.raises(NotImplementedError, match="attn_sparsity"):
        tengine.Engine(cm, tengine.EngineConfig(attn_sparsity=0.5), device="cpu")
    eng = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=32), device="cpu")
    with pytest.raises(NotImplementedError, match="paged serving"):
        eng.serve([], n_pages=8, page_size=8, max_slots=1, max_pages_per_seq=4)
    with pytest.raises(NotImplementedError, match="paged serving"):
        eng.paged_step(torch.zeros((1, 1), dtype=torch.int64), None, torch.ones((1,), dtype=torch.bool))
    if fam == "gpt_oss":  # sinks alone (no window) still refuse the kernel engine
        nowin = dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, sliding_window=0))
        with pytest.raises(NotImplementedError, match="attention sinks"):
            tengine.Engine(nowin, tengine.EngineConfig(kv_attention_kernel=True), device="cpu")


def test_jax_refuses_the_kernel_engine_alike():
    for fam, match in (("gpt_oss", "sliding-window"), ("llama4", "Llama4")):
        jcm = jcompress.compress_bf16(*family_pair(fam)[:2])
        with pytest.raises(NotImplementedError, match=match):
            jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=32, kv_attention_kernel=True))


def test_jax_paged_serving_runs_llama4_as_llama():
    """The reference fault the port refuses: JAX's paged step applies
    split-half rope with causal masks to every layer of a Llama4 model. Its
    paged chunked prefill's logits lie far from its own dense engine's, and
    equal the dense logits of the same weights under a plain MixtralConfig
    (Llama's rope, no chunk, no temperature; within 1e-5)."""
    prompt = PROMPT[:1]
    jcfg = family_pair("llama4")[0]
    jcm = jax_compressed("llama4", "NVFP4_DEFAULT_CFG")
    as_llama = dataclasses.replace(jcm, model_cfg=jmix.MixtralConfig(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jmix.MixtralConfig)}))

    def dense(eng):
        return np.asarray(eng.prefill(jnp.asarray(prompt), eng.init_cache(1, 32))[0][0])

    eng = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=32, backend="xla"))
    cache = eng.init_paged_cache(n_pages=8, page_size=8, max_slots=1, max_pages_per_seq=4)
    cache = dataclasses.replace(cache, block_table=jnp.arange(1, 5, dtype=jnp.int32)[None])
    paged = np.asarray(eng.prefill_chunked(cache, 0, jnp.asarray(prompt), chunk=4)[0])
    assert rel_err(paged, dense(eng)) > 1e-2
    assert rel_err(paged, dense(jengine.Engine(as_llama, jengine.EngineConfig(max_seq_len=32, backend="xla")))) < 1e-5


def test_jax_sparse_prefill_drops_sinks_and_the_window():
    """The other reference fault the port refuses: at threshold 0 (no tile
    skipped) JAX's sparse prefill gives the same logits (within 1e-6) with
    the sinks zeroed and every layer full: it attends causally without
    them. Its dense prefill, which has them, lies far off."""
    prompt = PROMPT
    jcfg = family_pair("gpt_oss")[0]
    jcm = jax_compressed("gpt_oss", "NVFP4_DEFAULT_CFG")
    bare = dataclasses.replace(
        jcm, model_cfg=dataclasses.replace(jcfg, layer_types=("full_attention",) * 2),
        params={**jcm.params, "layers": {**jcm.params["layers"],
                                         "self_attn.sinks": jnp.zeros_like(jcm.params["layers"]["self_attn.sinks"])}})

    def prefill(cm, sparsity):
        eng = jengine.Engine(cm, jengine.EngineConfig(max_seq_len=32, backend="xla", attn_sparsity=sparsity,
                                                      attn_sparsity_blocks=(8, 8)))
        return np.asarray(eng.prefill(jnp.asarray(prompt), eng.init_cache(2, 32))[0])

    sparse = prefill(jcm, 0.0)
    assert rel_err(sparse, prefill(bare, 0.0)) < 1e-6
    assert rel_err(sparse, prefill(jcm, None)) > 1e-2
