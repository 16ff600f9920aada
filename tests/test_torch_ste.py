"""The port's straight-through estimators (`ops/ste.py`, routed by
`quant/quantizer.py`'s `_dispatch`) and the flash repair against the JAX
package, on seeded f32 inputs.

 - Every family's forward through `quantizer.quantize` equals JAX's bit for
   bit (eager on both sides), and its x and amax gradients through a
   seeded cotangent equal `jax.vjp`'s: exactly where the backward is a mask
   or the identity.
 - LSQ's gradients against JAX's compiled vjp (`jax.jit`: XLA turns the
   division by the bound into a product by its f32 reciprocal, and JAX's
   QAT step runs compiled): x exactly, amax within 1e-6 relative (f32 sums
   in another order), per-tensor and per-channel.
 - The flash kernel's plain version is differentiable and its gradients
   match `jax.grad` through JAX's `flash_wrapper` (its reference path, as
   JAX runs it on the CPU) within 1e-5 relative; `_build.refuse_grad`'s
   predicate holds on the CPU (the card's refusal is in
   `test_torch_train_kernels.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.ops import ste as jste
from tensorrt_model_optimizer_tpu.ops.formats import BlockSpec as JBlock
from tensorrt_model_optimizer_tpu.ops.pallas import flash_wrapper
from tensorrt_model_optimizer_tpu.quant import quantizer as JQ
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.ops import ste as tste
from tensorrt_model_optimizer_tpu_torch.ops.cuda import _build, flash_gqa
from tensorrt_model_optimizer_tpu_torch.quant import quantizer as TQ

SHAPE = (4, 64)
LSQ_AMAX_TOL = 1e-6

# family -> (JAX QuantizerConfig, the amax of its state: None, "tensor" or
# "channel" (calibrated as the max |x| of the tensor / of each row, times 0.8
# so that some elements clip))
FAMILIES = {
    "int8_static_tensor": (JQ.QuantizerConfig(num_bits=8), "tensor"),
    "int4_static_channel": (JQ.QuantizerConfig(num_bits=4, axis=(0,)), "channel"),
    "int8_static_block": (JQ.QuantizerConfig(num_bits=8, block=JBlock(sizes=((-1, 16),))), "block"),
    "fp8_static": (JQ.QuantizerConfig(num_bits=(4, 3)), "tensor"),
    "nvfp4": (JQ.QuantizerConfig(num_bits=(2, 1), block=JBlock(sizes=((-1, 16),), scale_bits=(4, 3), dynamic=True)),
              None),
    "nvfp4_global_amax": (JQ.QuantizerConfig(num_bits=(2, 1), block=JBlock(sizes=((-1, 16),), scale_bits=(4, 3),
                                                                          dynamic=True)), "tensor"),
    "mxfp4": (JQ.QuantizerConfig(num_bits=(2, 1), block=JBlock(sizes=((-1, 32),), scale_bits=(8, 0), dynamic=True)),
              None),
    "mxint8": (JQ.QuantizerConfig(num_bits=8, block=JBlock(sizes=((-1, 32),), scale_bits=(8, 0), dynamic=True)),
               None),
    "int4_dynamic_block": (JQ.QuantizerConfig(num_bits=4, block=JBlock(sizes=((-1, 16),), dynamic=True)), None),
    "int8_dynamic_per_token": (JQ.QuantizerConfig(num_bits=8, dynamic=True, per_token=True), None),
    "fp8_dynamic_tensor": (JQ.QuantizerConfig(num_bits=(4, 3), dynamic=True), None),
    "int8_pass_through": (JQ.QuantizerConfig(num_bits=8, pass_through_bwd=True), "tensor"),
    "fp8_pass_through": (JQ.QuantizerConfig(num_bits=(4, 3), pass_through_bwd=True), "tensor"),
}
CLIPPED = ("int8_static_tensor", "int4_static_channel", "int8_static_block", "fp8_static")


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(SHAPE) * np.exp(rng.uniform(-2, 2, (SHAPE[0], 1)))).astype(np.float32)
    g = rng.standard_normal(SHAPE).astype(np.float32)
    return x, g


def _amax(x, kind, cfg):
    if kind is None:
        return None
    if kind == "tensor":
        return np.float32(0.8 * np.abs(x).max())
    if kind == "channel":
        return (0.8 * np.abs(x).max(axis=1, keepdims=True)).astype(np.float32)
    return (0.8 * np.abs(x).reshape(SHAPE[0], -1, 16).max(axis=-1)).astype(np.float32)  # compact block amax


def _both(family):
    jcfg, kind = FAMILIES[family]
    x, g = _inputs()
    am = _amax(x, kind, jcfg)
    # JAX's pass-through closes over the amax (differentiating it there
    # leaks a tracer): its amax is a constant on both sides
    diff = am is not None and not jcfg.pass_through_bwd
    ja = None if am is None else jnp.asarray(am)
    if diff:
        y, vjp = jax.vjp(lambda t, a: JQ.quantize(t, jcfg, JQ.QuantizerState(amax=a)), jnp.asarray(x), ja)
        jgx, jga = vjp(jnp.asarray(g))
    else:
        y, vjp = jax.vjp(lambda t: JQ.quantize(t, jcfg, JQ.QuantizerState(amax=ja)), jnp.asarray(x))
        (jgx,), jga = vjp(jnp.asarray(g)), None
    tx = torch.from_numpy(x).requires_grad_(True)
    ta = None if am is None else torch.from_numpy(np.asarray(am)).requires_grad_(diff)
    ty = TQ.quantize(tx, convert.quantizer_cfg_from_jax(jcfg), TQ.QuantizerState(amax=ta))
    grads = torch.autograd.grad(ty, [tx, ta] if diff else [tx], torch.from_numpy(g))
    return (np.asarray(y), np.asarray(jgx), None if jga is None else np.asarray(jga), ty.detach().numpy(),
            grads[0].numpy(), grads[1].numpy() if diff else None)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_bit_equal_and_gradients_equal_jax(family):
    jy, jgx, jga, ty, tgx, tga = _both(family)
    assert np.array_equal(ty.view(np.uint32), jy.view(np.uint32)), family
    assert np.array_equal(tgx, jgx), (family, rel_err(tgx, jgx))
    if jga is not None:
        assert np.array_equal(tga, jga), family  # zero: the amax of a static or global-amax site is state
    if family in CLIPPED:  # the straight-through mask dropped the clipped elements
        assert 0 < int((tgx == 0).sum()) < tgx.size


@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
@pytest.mark.parametrize("num_bits", [4, 8])
def test_lsq_gradients_equal_jax_compiled(per_channel, num_bits):
    x, g = _inputs(3)
    am = (np.abs(x).max(axis=1, keepdims=True) if per_channel else np.abs(x).max()).astype(np.float32) * 0.9
    am = np.asarray(np.maximum(am, 1e-3), dtype=np.float32)
    if per_channel:  # one row's amax its exact max: v sits on the bound
        am[1] = np.abs(x[1]).max()
    jy, vjp = jax.vjp(lambda t, a: jste.fake_quant_int_lsq(t, a, num_bits), jnp.asarray(x), jnp.asarray(am))
    jgx, jga = jax.jit(lambda t, a, c: jax.vjp(lambda u, b: jste.fake_quant_int_lsq(u, b, num_bits), t, a)[1](c))(
        jnp.asarray(x), jnp.asarray(am), jnp.asarray(g))
    tx, ta = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(am).requires_grad_(True)
    ty = tste.fake_quant_int_lsq(tx, ta, num_bits)
    tgx, tga = torch.autograd.grad(ty, [tx, ta], torch.from_numpy(g))
    assert np.array_equal(ty.detach().numpy(), np.asarray(jy))
    assert np.array_equal(tgx.numpy(), np.asarray(jgx))
    assert tga.shape == ta.shape
    assert rel_err(tga.numpy(), np.asarray(jga)) <= LSQ_AMAX_TOL


def test_static_amax_takes_zero_gradient_and_lsq_sums_over_broadcast_axes():
    x, g = _inputs(5)
    tx = torch.from_numpy(x).requires_grad_(True)
    a = torch.full((1, 1), 1.0, requires_grad=True)
    y = TQ.quantize(tx, TQ.QuantizerConfig(num_bits=8), TQ.QuantizerState(amax=a))
    (ga,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), [a])
    assert torch.equal(ga, torch.zeros_like(a))
    y = TQ.quantize(tx, TQ.QuantizerConfig(num_bits=8, learn_amax=True), TQ.QuantizerState(amax=a))
    (ga,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), [a])
    assert ga.shape == (1, 1) and float(ga.abs()) > 0


def test_flash_plain_is_differentiable_and_matches_jax():
    rng = np.random.default_rng(7)
    B, T, H, Hkv, d = 2, 12, 4, 2, 16
    q, k, v = (rng.standard_normal((B, T, h, d)).astype(np.float32) for h in (H, Hkv, Hkv))
    ct = rng.standard_normal((B, T, H, d)).astype(np.float32)
    jgrads = jax.grad(lambda a, b, c: jnp.sum(flash_wrapper.flash_attention(a, b, c, True, force_reference=True)
                                              * ct), argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    out = flash_gqa.flash_attention_gqa(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), True)
    assert out.requires_grad
    tgrads = torch.autograd.grad((out.transpose(1, 2) * torch.from_numpy(ct)).sum(), [tq, tk, tv])
    for tg, jg in zip(tgrads, jgrads):
        assert rel_err(tg.numpy(), np.asarray(jg)) <= 1e-5


def test_refuse_grad_predicate():
    a = torch.zeros(2, requires_grad=True)
    b = torch.zeros(2)
    assert _build.needs_grad(b, a, None)
    assert not _build.needs_grad(b, None, 3)
    with torch.no_grad():
        assert not _build.needs_grad(a)
        _build.refuse_grad("k", a)
    with torch.inference_mode():
        assert not _build.needs_grad(torch.zeros(2))
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("flash_gqa", b, a)
