"""The port's tensor- and expert-parallel DeepSeek engine on gloo ranks (CPU)
against JAX's (tests/test_deepseek_tp.py) and the port's single-process
engine.

The tiny DeepSeek (`DeepseekConfig.tiny()`: 4 heads, 4 routed experts, a
dense first layer) is seeded in the port and carried to JAX
(`_torch_deepseek.pair`). Under FP8_DEFAULT_CFG JAX quantizes and packs it
and its engine runs under a mesh of 2 and of 4 virtual CPU devices (4: one
routed expert a device); the port serves JAX's packs, single-process and on
4 gloo ranks launched once for the file (tp 2 on a ("rep", "tp") mesh of 2
x 2, tp 4), and the greedy tokens are equal three ways. INT8 (W8A8: the
per-token amax MAX at o_proj and the down projections) and NVFP4 (W4A4)
run on the port's own calibration of the same weights (JAX's eager DeepSeek
packing takes tens of seconds a preset on the CPU) and are held to the
port's single-process engine, which test_torch_deepseek_engine.py holds to
JAX's. The ranks' prefill logits lie within 2e-5 of the single-process
logits (JAX's test_tp_prefill_logits_close bound; the row sites' SUM adds
in another order)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_tp
from _torch_deepseek import TOKENS, shared_pair
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import deepseek as jds
from tensorrt_model_optimizer_tpu.serve import deepseek_engine as jdse
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import deepseek as tds
from tensorrt_model_optimizer_tpu_torch.serve import deepseek_engine as tdse

LOGITS_REL = 2e-5
CASES = {  # name -> (preset, tp degree, tokens, JAX's engine runs too)
    "fp8_tp2": ("FP8_DEFAULT_CFG", 2, 6, True),
    "fp8_tp4": ("FP8_DEFAULT_CFG", 4, 5, True),
    "int8_tp2": ("INT8_DEFAULT_CFG", 2, 6, False),
    "nvfp4_tp2": ("NVFP4_DEFAULT_CFG", 2, 6, False),
}
PROMPT = TOKENS[:, :8]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, jp, tcfg, tp = shared_pair()
    jfp8 = jdse.compress(jds.quantize(jcfg, jp, "FP8_DEFAULT_CFG", [jnp.asarray(TOKENS)]))
    cms = {"FP8_DEFAULT_CFG": convert.compressed_from_jax(jfp8)}
    for preset in ("INT8_DEFAULT_CFG", "NVFP4_DEFAULT_CFG"):
        cms[preset] = tdse.compress(tds.quantize(tcfg, tp, preset, [torch.from_numpy(TOKENS)], device="cpu"))
    cases = [(name, dict(cm=cms[p], axes={"rep": 2, "tp": 2} if d == 2 else {"tp": 4}, prompt=PROMPT, n=n))
             for name, (p, d, n, _) in CASES.items()]
    ranks = {}

    def go():
        try:
            ranks["out"] = _torch_tp.launch(_torch_tp.deepseek_cases, 4, tmp_path_factory.mktemp("ds"), cases)
        except Exception as e:  # re-raised in the test process below
            ranks["error"] = e

    t = threading.Thread(target=go)
    t.start()
    try:
        jax_out = {}
        for name, (_, d, n, with_jax) in CASES.items():
            if with_jax:
                mesh = Mesh(np.array(jax.devices()[:d]), ("tp",))
                eng = jdse.DeepseekEngine(jfp8, max_seq_len=48, mesh=mesh)
                jax_out[name] = np.asarray(eng.generate(jnp.asarray(PROMPT), max_new_tokens=n))
        single = {}
        for name, (p, _, n, _) in CASES.items():
            eng = tdse.DeepseekEngine(cms[p], max_seq_len=48, device="cpu")
            pr = torch.from_numpy(PROMPT)
            single[name] = (eng.prefill(pr, eng.init_cache(2)).numpy(), eng.generate(pr, n).numpy())
    finally:
        t.join()
    if "error" in ranks:
        raise ranks["error"]
    return single, ranks["out"], jax_out


@pytest.mark.parametrize("name", list(CASES))
def test_tp_tokens_and_logits(runs, name):
    single, ranks, jax_out = runs
    logits1, toks1 = single[name]
    if name in jax_out:
        np.testing.assert_array_equal(toks1, jax_out[name])
    for rank in ranks:
        logits, toks = rank[name]
        np.testing.assert_array_equal(toks, toks1)
        assert rel_err(logits, logits1) < LOGITS_REL


def test_shard_divisibility_refused():
    from tensorrt_model_optimizer_tpu_torch.serve import deepseek_tp

    _, _, tcfg, tp = shared_pair()
    cm = tdse.compress(tds.quantize(tcfg, tp, "FP8_DEFAULT_CFG", [torch.from_numpy(TOKENS)], device="cpu"))
    with pytest.raises(ValueError):
        deepseek_tp.shard_deepseek(cm, 3, 0)
    local = deepseek_tp.shard_deepseek(cm, 2, 1)
    assert local.model_cfg.num_attention_heads == tcfg.num_attention_heads // 2
    assert local.params["layers_moe"]["moe.gate_proj"]["q"].shape[1] == tcfg.n_routed_experts // 2
