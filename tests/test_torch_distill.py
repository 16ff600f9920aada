"""The port's distillation (`distill/{losses,loss_balancers,distillation}.py`)
against the JAX package on a tiny Llama, the same seeded weights in both.

The losses (KL with temperature, MFT, MGD with and without a projector)
and the balancers within 1e-6 relative of JAX's on seeded f32 logits; one
KD step and one QAD step (FP8 fake quant on the student, each package's own
calibration on the same tokens, the training tokens others) within 1e-5
of their loss and of every updated parameter's scale; the teacher takes no
gradient and is left untouched; `export_student` is the student."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.distill import distillation as jdist
from tensorrt_model_optimizer_tpu.distill import loss_balancers as jlb
from tensorrt_model_optimizer_tpu.distill import losses as jlosses
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import get_preset as jget
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.distill import distillation as tdist
from tensorrt_model_optimizer_tpu_torch.distill import loss_balancers as tlb
from tensorrt_model_optimizer_tpu_torch.distill import losses as tlosses
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama

TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.LlamaConfig.tiny()
    teacher, student = llama_params_np(jcfg, seed=0), llama_params_np(jcfg, seed=7)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 17)).astype(np.int32)
    return (jcfg, convert.llama_cfg_from_jax(jcfg), tree_map(jnp.asarray, teacher), tree_map(torch.from_numpy, teacher),
            tree_map(jnp.asarray, student), tree_map(torch.from_numpy, student), tokens)


def _logits(seed, shape=(2, 5, 32)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 3


@pytest.mark.parametrize("temperature", [1.0, 2.5])
def test_logits_kl_equals_jax(temperature):
    a, b = _logits(3), _logits(4)
    j = jlosses.logits_kl(jnp.asarray(a), jnp.asarray(b), temperature)
    t = tlosses.logits_kl(torch.from_numpy(a), torch.from_numpy(b), temperature)
    assert abs(float(t) - float(j)) <= 1e-6 * abs(float(j)) and float(t) > 0
    jr = jlosses.logits_kl(jnp.asarray(a), jnp.asarray(b), temperature, reduction="none")
    tr = tlosses.logits_kl(torch.from_numpy(a), torch.from_numpy(b), temperature, reduction="none")
    assert rel_err(tr.numpy(), np.asarray(jr)) <= 1e-6
    assert abs(float(tlosses.logits_kl(torch.from_numpy(a), torch.from_numpy(a)))) <= 1e-6


def test_mft_and_mgd_equal_jax():
    a, b = _logits(5), _logits(6)
    tgt = np.random.default_rng(7).integers(0, 32, (2, 5))
    j = jlosses.mft_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(tgt), 0.3)
    t = tlosses.mft_loss(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(tgt), 0.3)
    assert abs(float(t) - float(j)) <= 1e-6 * abs(float(j))
    s, f = _logits(8, (2, 5, 16)), _logits(9, (2, 5, 24))
    proj = np.random.default_rng(10).normal(size=(16, 24)).astype(np.float32) / 4
    for p in (None, proj):
        j = jlosses.mgd_loss(jnp.asarray(s), jnp.asarray(f if p is not None else s * 0.5),
                             None if p is None else jnp.asarray(p))
        t = tlosses.mgd_loss(torch.from_numpy(s), torch.from_numpy(f if p is not None else s * 0.5),
                             None if p is None else torch.from_numpy(p))
        assert abs(float(t) - float(j)) <= 1e-6 * abs(float(j))


def test_balancers_equal_jax():
    assert float(tlb.StaticLossBalancer((0.7, 0.3))([torch.tensor(1.0), torch.tensor(2.0)])) == pytest.approx(1.3)
    js, ts = jlb.init_dynamic_balancer(2), tlb.init_dynamic_balancer(2)
    rng = np.random.default_rng(11)
    for _ in range(50):
        vals = rng.uniform(0.5, 2.0, 2).astype(np.float32) * np.float32([1000.0, 1.0])
        jt, js = jlb.dynamic_balance([jnp.asarray(v) for v in vals], js, decay=0.9)
        tt, ts = tlb.dynamic_balance([torch.tensor(v) for v in vals], ts, decay=0.9)
        assert abs(float(tt) - float(jt)) <= 1e-6 * abs(float(jt))
    assert rel_err(ts.ema.numpy(), np.asarray(js.ema)) <= 1e-6
    x = torch.tensor(3.0, requires_grad=True)
    total, _ = tlb.dynamic_balance([x * 2, x], tlb.init_dynamic_balancer(2))
    (g,) = torch.autograd.grad(total, [x])
    assert float(g) > 0  # the EMA takes no gradient: d/dx of mean(2x / ema0, x / ema1)


def _calibrated(pair, preset):
    jcfg, tcfg, jt, tt, _, _, _ = pair
    cal = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    jlay = jllama.build_layout(jcfg, jget(preset))
    _, jqs, _ = jllama.forward(jcfg, jt, jnp.asarray(cal), layout=jlay, qstate=jllama.init_quant_state(jcfg, jlay),
                               calib=True)
    tlay = convert.layout_from_jax(jlay)
    with torch.no_grad():
        _, tqs, _ = tllama.forward(tcfg, tt, torch.from_numpy(cal).long(), layout=tlay,
                                   qstate=tllama.init_quant_state(tcfg, tlay, "cpu"), calib=True)
    return jlay, jqs, tlay, tqs


@pytest.mark.parametrize("mode", ["kd_mft", "kd_kl", "qad"])
def test_distill_step_equals_jax(pair, mode):
    jcfg, tcfg, jt, tt, js, ts, tokens = pair
    kd = dict(kd_weight=0.7, temperature=2.0, loss="mft" if mode == "kd_mft" else "logits_kl")
    jlay = tlay = jqs = tqs = None
    if mode == "qad":
        jlay, jqs, tlay, tqs = _calibrated(pair, "FP8_DEFAULT_CFG")
        js, ts = jt, tt  # QAD: the quantized student starts from the teacher
    jnew, jloss = jax.jit(jdist.make_distill_step(jcfg, jdist.KDConfig(**kd), lr=5e-2, layout=jlay))(
        js, jt, jnp.asarray(tokens), jqs)
    teacher_before = {k: v.clone() for k, v in tt["layers"].items()}
    tnew, tloss = tdist.make_distill_step(tcfg, tdist.KDConfig(**kd), lr=5e-2, layout=tlay)(
        ts, tt, torch.from_numpy(tokens), tqs)
    assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    for name in ("embed_tokens", "lm_head", "norm"):
        assert rel_err(tnew[name].numpy(), np.asarray(jnew[name])) <= TOL, name
    for name, t in tnew["layers"].items():
        assert rel_err(t.numpy(), np.asarray(jnew["layers"][name])) <= TOL, name
    assert all(torch.equal(tt["layers"][k], v) and not tt["layers"][k].requires_grad
               for k, v in teacher_before.items())
    assert tdist.export_student(tnew) is tnew


def test_distill_loss_takes_no_teacher_gradient(pair):
    _, tcfg, _, tt, _, ts, tokens = pair
    teacher = tree_map(lambda t: t.clone().requires_grad_(True), tt)
    loss = tdist.distill_loss(tcfg, ts, teacher, torch.from_numpy(tokens))
    assert not loss.requires_grad or loss.grad_fn is None
