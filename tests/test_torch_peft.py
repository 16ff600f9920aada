"""The port's LoRA / QLoRA (`peft/lora.py`) against the JAX package on a
tiny Llama, the same seeded weights in both and JAX's adapters carried
across by `convert.adapters_from_jax`.

A fresh adapter is the identity; `merge` folds B @ A into the base within
1e-6 of JAX's merge; one LoRA step (the plain base) and one QLoRA step
(NF4 weight-only base, each package's own weight calibration: weights only,
so their amax are equal) within 1e-5 of the loss and of every adapter
tensor's scale (`scale` trains too, as JAX's `value_and_grad` over the tree
trains it); the base is untouched; the port's own init draws from an
explicit generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.peft import lora as jlora
from tensorrt_model_optimizer_tpu.quant import get_preset as jget
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.peft import lora as tlora

TOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    pnp = llama_params_np(jcfg, seed=0)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 17)).astype(np.int32)
    ad = jlora.init_adapters(jcfg, jlora.LoRAConfig(rank=4), jax.random.PRNGKey(3))
    ad = jax.tree.map(lambda a: a + 0.02 if a.ndim == 3 else a, ad)  # B != 0: the adapter is live
    return (jcfg, tree_map(jnp.asarray, pnp), convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp),
            tokens, ad, convert.adapters_from_jax(ad))


def _close(t_tree, j_tree, tol):
    for name, sub in t_tree.items():
        for part, t in sub.items():
            assert t.dtype == convert.torch_dtype(j_tree[name][part].dtype), (name, part)
            assert rel_err(t.numpy(), np.asarray(j_tree[name][part])) <= tol, (name, part)


def test_init_is_the_identity_from_a_generator(tiny):
    _, _, tcfg, tp, tokens, _, _ = tiny
    lcfg = tlora.LoRAConfig(rank=4, targets=("mlp.up_proj", "self_attn.q_proj"))
    a = tlora.init_adapters(tcfg, lcfg, torch.Generator().manual_seed(5), device="cpu")
    b = tlora.init_adapters(tcfg, lcfg, torch.Generator().manual_seed(5), device="cpu")
    assert set(a) == set(lcfg.targets) and torch.equal(a["mlp.up_proj"]["A"], b["mlp.up_proj"]["A"])
    assert a["mlp.up_proj"]["A"].shape == (2, 4, 64) and a["mlp.up_proj"]["B"].shape == (2, 128, 4)
    assert float(a["mlp.up_proj"]["scale"][0]) == 16.0 / 4 and not bool(a["mlp.up_proj"]["B"].any())
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        assert torch.equal(tllama.forward(tcfg, tp, t, adapters=a)[0], tllama.forward(tcfg, tp, t)[0])


def test_merge_equals_jax_and_the_adapter_forward(tiny):
    jcfg, jp, tcfg, tp, tokens, jad, tad = tiny
    jm, tm = jlora.merge(jp, jad), tlora.merge(tp, tad)
    for name, w in tm["layers"].items():
        assert rel_err(w.numpy(), np.asarray(jm["layers"][name])) <= 1e-6, name
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        with_ad, merged = tllama.forward(tcfg, tp, t, adapters=tad)[0], tllama.forward(tcfg, tm, t)[0]
    assert rel_err(merged.numpy(), with_ad.numpy()) <= 1e-5


@pytest.mark.parametrize("qlora", [False, True], ids=["lora", "qlora"])
def test_step_equals_jax(tiny, qlora):
    jcfg, jp, tcfg, tp, tokens, jad, tad = tiny
    jlay = tlay = jqs = tqs = None
    if qlora:
        jlay = jllama.build_layout(jcfg, jget("NF4_WEIGHT_ONLY_CFG"))
        _, jqs, _ = jllama.forward(jcfg, jp, jnp.asarray(tokens), layout=jlay,
                                   qstate=jllama.init_quant_state(jcfg, jlay), calib=True)
        tlay = convert.layout_from_jax(jlay)
        with torch.no_grad():
            _, tqs, _ = tllama.forward(tcfg, tp, torch.from_numpy(tokens).long(), layout=tlay,
                                       qstate=tllama.init_quant_state(tcfg, tlay, "cpu"), calib=True)
    jnew, jloss = jax.jit(jlora.make_lora_train_step(jcfg, lr=5e-2, layout=jlay))(jad, jp, jnp.asarray(tokens), jqs)
    base = tp["layers"]["mlp.up_proj"].clone()
    tnew, tloss = tlora.make_lora_train_step(tcfg, lr=5e-2, layout=tlay)(tad, tp, torch.from_numpy(tokens), tqs)
    assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    _close(tnew, jnew, TOL)
    assert float((tnew["mlp.up_proj"]["scale"] - tad["mlp.up_proj"]["scale"]).abs().max()) > 0
    assert torch.equal(tp["layers"]["mlp.up_proj"], base)
