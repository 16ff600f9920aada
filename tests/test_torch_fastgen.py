"""The port's fastgen (fastgen/dmd.py, fastgen/trainers.py) against the JAX
package's on the CPU, on tiny f32 DiTs whose adaLN-zero tensors are made
random (`_torch_diffusion`), fed JAX's own random draws: JAX draws t, eps
and the R1 noise inside each loss from a PRNG key; the test draws them from
the same key as JAX's loss does and hands them to the port's.

Tolerances:
 - the DMD2 losses (student with the GAN term, fake score, discriminator
   with R1), flow matching and few-step distillation: the loss within 1e-5
   relative, every gradient within GRAD_FROB = 1e-4 relative Frobenius of
   `jax.value_and_grad`'s (the trainers' gradients read off one SGD step at
   lr 10, (p - p') / lr, so the update dwarfs f32 rounding of p);
 - `ddim_sample` and `ema_update`: 1e-5 of the output's largest; the
   sampler's integer timesteps equal JAX's traced f32 arithmetic (at 3
   steps t = 1 - 1/3 gives 665 in f32, 666 in f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_diffusion import dit_pair
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.fastgen import dmd as jdmd
from tensorrt_model_optimizer_tpu.fastgen import trainers as jtr
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.fastgen import dmd as tdmd
from tensorrt_model_optimizer_tpu_torch.fastgen import trainers as ttr
from tensorrt_model_optimizer_tpu_torch.quant import qat
from tensorrt_model_optimizer_tpu_torch.utils.tree import flatten_with_names

TOL = 1e-5
GRAD_FROB = 1e-4
DMD = dict(gan_loss_weight_gen=1e-2, r1_weight=1.0, r1_noise_std=0.01)


def _t(a):
    return torch.from_numpy(np.array(a))


def _frob(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grads_close(tg, jg):
    """Every leaf of the port's gradient tree against JAX's (by JAX's key names)."""
    flat_j = flatten_with_names(jax.tree.map(np.asarray, jg))
    flat_t = flatten_with_names(tg)
    assert set(flat_t) == set(flat_j)
    for k, g in flat_j.items():
        assert _frob(flat_t[k].detach().numpy(), g) <= GRAD_FROB, k
    assert max(np.abs(g).max() for g in flat_j.values()) > 0


@pytest.fixture(scope="module")
def models():
    jcfg, teacher_j, tcfg, teacher_t = dit_pair(0)
    _, student_j, _, student_t = dit_pair(1)
    _, fake_j, _, fake_t = dit_pair(2)
    disc_j = jdmd.init_discriminator(jcfg, jdmd.DiscriminatorConfig(hidden=32), jax.random.PRNGKey(5))
    disc_t = convert.params_from_jax(jax.tree.map(np.asarray, disc_j))
    rng = np.random.default_rng(9)
    shape = (2, jcfg.img_size, jcfg.img_size, jcfg.in_channels)
    noise, latents = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return dict(jcfg=jcfg, tcfg=tcfg, teacher=(teacher_j, teacher_t), student=(student_j, student_t),
                fake=(fake_j, fake_t), disc=(disc_j, disc_t), noise=noise, latents=latents)


def _jax_draws(key, noise, n):
    """JAX's loss's draws from `key`: (t, eps) or, n = 3, (t, eps, r1 noise)."""
    keys = jax.random.split(key, n)
    t = jdmd.sample_timesteps(keys[0], noise.shape[0])
    eps = jax.random.normal(keys[1], noise.shape, jnp.float32)
    out = [_t(t), _t(eps)]
    if n == 3:
        out.append(_t(jax.random.normal(keys[2], noise.shape, jnp.float32)))
    return tuple(out)


def test_student_loss_and_grads_match_jax(models):
    m = models
    sl_j, _, _ = jdmd.make_dmd_losses(m["jcfg"], jdmd.DMDConfig(**DMD))
    sl_t, _, _ = tdmd.make_dmd_losses(m["tcfg"], tdmd.DMDConfig(**DMD))
    key = jax.random.PRNGKey(11)
    (jl, jparts), jg = jax.value_and_grad(sl_j, has_aux=True)(
        m["student"][0], m["teacher"][0], m["fake"][0], m["disc"][0], jnp.asarray(m["noise"]), key)
    draws = _jax_draws(key, m["noise"], 2)
    parts = {}

    def loss(s):
        total, p = sl_t(s, m["teacher"][1], m["fake"][1], m["disc"][1], _t(m["noise"]), draws)
        parts.update(p)
        return total

    tl, tg = qat.value_and_grad(loss, m["student"][1])
    assert rel_err(tl, jl) <= TOL
    for k in ("vsd", "gan_gen"):
        assert rel_err(parts[k].detach(), jparts[k]) <= TOL
    _grads_close(tg, jg)
    # the GAN term reaches the student through the teacher's features: off, the gradient changes
    sl0, _, _ = tdmd.make_dmd_losses(m["tcfg"], tdmd.DMDConfig(**{**DMD, "gan_loss_weight_gen": 0.0}))
    _, tg0 = qat.value_and_grad(lambda s: sl0(s, m["teacher"][1], m["fake"][1], m["disc"][1], _t(m["noise"]),
                                              draws)[0], m["student"][1])
    assert _frob(tg0["patch_embed"].numpy(), tg["patch_embed"].numpy()) > 1e-4


def test_fake_score_and_disc_losses_match_jax(models):
    m = models
    _, fl_j, dl_j = jdmd.make_dmd_losses(m["jcfg"], jdmd.DMDConfig(**DMD))
    _, fl_t, dl_t = tdmd.make_dmd_losses(m["tcfg"], tdmd.DMDConfig(**DMD))
    key = jax.random.PRNGKey(12)
    jl, jg = jax.value_and_grad(fl_j)(m["fake"][0], m["student"][0], jnp.asarray(m["noise"]), key)
    draws = _jax_draws(key, m["noise"], 2)
    tl, tg = qat.value_and_grad(lambda f: fl_t(f, m["student"][1], _t(m["noise"]), draws), m["fake"][1])
    assert rel_err(tl, jl) <= TOL
    _grads_close(tg, jg)
    key = jax.random.PRNGKey(13)
    jl, jg = jax.value_and_grad(dl_j)(m["disc"][0], m["teacher"][0], m["student"][0], jnp.asarray(m["latents"]),
                                      jnp.asarray(m["noise"]), key)
    draws = _jax_draws(key, m["noise"], 3)
    tl, tg = qat.value_and_grad(lambda d: dl_t(d, m["teacher"][1], m["student"][1], _t(m["latents"]),
                                               _t(m["noise"]), draws), m["disc"][1])
    assert rel_err(tl, jl) <= TOL
    _grads_close(tg, jg)


def test_flow_matching_and_distill_steps_match_jax(models):
    m = models
    lr = 10.0
    p_j, p_t = m["teacher"]
    key = jax.random.PRNGKey(21)
    new_j, jl = jtr.make_flow_matching_step(m["jcfg"], lr=lr)(p_j, jnp.asarray(m["latents"]), key)
    k1, k2 = jax.random.split(key)
    draws = (_t(jax.random.normal(k1, m["latents"].shape, jnp.float32)),
             _t(jax.random.uniform(k2, (m["latents"].shape[0],), jnp.float32)))
    new_t, tl = ttr.make_flow_matching_step(m["tcfg"], lr=lr)(p_t, _t(m["latents"]), draws)
    assert rel_err(tl, jl) <= TOL
    _grads_close(jax.tree.map(lambda a, b: (a - b) / lr, convert.params_from_jax(jax.tree.map(np.asarray, p_j)),
                              new_t),
                 jax.tree.map(lambda a, b: (a - b) / lr, p_j, new_j))
    s_j, s_t = m["student"]
    new_j, jl = jtr.make_distill_fewstep_step(m["jcfg"], teacher_steps=3, lr=lr)(s_j, p_j, jnp.asarray(m["noise"]))
    new_t, tl = ttr.make_distill_fewstep_step(m["tcfg"], teacher_steps=3, lr=lr)(s_t, p_t, _t(m["noise"]))
    assert rel_err(tl, jl) <= TOL
    _grads_close(jax.tree.map(lambda a, b: (a - b) / lr, s_t, new_t), jax.tree.map(lambda a, b: (a - b) / lr, s_j,
                                                                                      new_j))


@pytest.mark.parametrize("steps", [3, 4])
def test_ddim_sample_and_ema_match_jax(models, steps):
    m = models
    x = jtr.ddim_sample(m["jcfg"], m["teacher"][0], jnp.asarray(m["noise"]), steps)
    y = ttr.ddim_sample(m["tcfg"], m["teacher"][1], _t(m["noise"]), steps)
    assert rel_err(y.numpy(), x) <= TOL
    assert [ttr._step_t(i, 3) for i in range(3)] == [999, 665, 332]
    ej = jtr.ema_update(m["student"][0], m["teacher"][0], 0.9)
    et = ttr.ema_update(m["student"][1], m["teacher"][1], 0.9)
    for k, v in flatten_with_names(jax.tree.map(np.asarray, ej)).items():
        assert rel_err(flatten_with_names(et)[k].numpy(), v) <= TOL, k
