"""DMD2: distribution matching distillation with an adversarial critic (port
of `fastgen/dmd.py`).

Three losses a training loop alternates between, over DiT models in the
rectified-flow parameterization (v = eps - x0):

 - student: variational score distillation (VSD), plus the GAN generator
   term on the teacher's features when a discriminator is given;
 - fake score: denoising score matching on the student's samples;
 - discriminator: the softplus GAN loss plus the approximate R1 penalty.

Each loss is split in two: its random draws (the timesteps t, the noise eps
and the R1 noise, from a `torch.Generator`) and the loss on given draws, so
the same draws give the same loss in both packages (JAX draws inside the
loss from a PRNG key). `(t * 999)` truncates to int32 timesteps as JAX's
`astype` does.

Gradients stop where JAX's do: the fake score's x0 and the teacher's x0
(`stop_gradient`) are detached, but the teacher's forward keeps the graph
back to the student's sample, because the GAN term reads its features; in
the fake-score and discriminator losses the student's sample and every
feature are detached. The caller owns the optimizers and differentiates
with respect to the model it updates (`torch.autograd.grad`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models import dit


def rf_alpha(t: torch.Tensor) -> torch.Tensor:
    return 1.0 - t


def rf_sigma(t: torch.Tensor) -> torch.Tensor:
    return t


def _bcast(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.reshape(tuple(t.shape) + (1,) * (like.ndim - t.ndim))


def add_noise(x0: torch.Tensor, eps: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x_t = alpha_t x0 + sigma_t eps, in f32, back in x0's dtype."""
    tb = _bcast(t, x0)
    return (rf_alpha(tb) * x0.float() + rf_sigma(tb) * eps.float()).to(x0.dtype)


def timesteps(t: torch.Tensor) -> torch.Tensor:
    """t in [0, 1] -> the DiT's integer timestep, truncated as JAX's astype."""
    return (t * 999).to(torch.int32)


def predict_x0(cfg: dit.DiTConfig, params, x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x0 = x_t - sigma_t v, v the DiT's prediction at t."""
    v, _ = dit.forward(cfg, params, x_t, timesteps(t))
    return (x_t.float() - _bcast(t, x_t) * v.float()).to(x_t.dtype)


def sample_timesteps(generator: torch.Generator, batch: int, device=None) -> torch.Tensor:
    """Uniform perturbation timesteps in [0.02, 0.98)."""
    u = torch.rand((batch,), generator=generator, dtype=torch.float32, device=resolve_device(device))
    return 0.02 + u * (0.98 - 0.02)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def vsd_loss(gen_data, teacher_x0, fake_score_x0):
    """VSD: pseudo-target gen - (fake - teacher) w, w = 1 / mean|gen -
    teacher| per sample; the gradient flows through gen_data only."""
    dims = tuple(range(1, gen_data.ndim))
    g32 = gen_data.detach().float()
    t32 = teacher_x0.float()
    w = 1.0 / (torch.mean(torch.abs(g32 - t32), dim=dims, keepdim=True) + 1e-6)
    pseudo = (g32 - (fake_score_x0.float() - t32) * w).detach()
    return 0.5 * torch.mean((gen_data.float() - pseudo) ** 2)


def dsm_loss_flow(net_pred, x0, eps):
    """Denoising score matching in flow space: target v = eps - x0."""
    return torch.mean((net_pred.float() - (eps.float() - x0.float())) ** 2)


def gan_gen_loss(fake_logits):
    return torch.mean(F.softplus(-fake_logits.float()))


def gan_disc_loss(real_logits, fake_logits):
    return torch.mean(F.softplus(fake_logits.float())) + torch.mean(F.softplus(-real_logits.float()))


def r1_loss(real_logits, perturbed_real_logits):
    """Approximate R1: the logits' sensitivity to small noise on real data."""
    return torch.mean((real_logits.float() - perturbed_real_logits.float()) ** 2)


# ---------------------------------------------------------------------------
# Discriminator over the teacher's features
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    num_heads: int = 4  # independent logit heads
    hidden: int = 128


def init_discriminator(cfg: dit.DiTConfig, dcfg: DiscriminatorConfig, generator: torch.Generator,
                       device=None) -> dict:
    """Seeded f32 weights on `device` (the card unless the caller passes
    the CPU; `generator` lives there)."""
    dev = resolve_device(device)
    h = cfg.hidden_size

    def randn(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)

    return {"fc1": randn((dcfg.hidden, h)) / math.sqrt(h),
            "fc1__bias": torch.zeros((dcfg.hidden,), dtype=torch.float32, device=dev),
            "heads": randn((dcfg.num_heads, dcfg.hidden)) / math.sqrt(dcfg.hidden)}


def discriminator_forward(disc: dict, feats: torch.Tensor) -> torch.Tensor:
    """Teacher token features [B, N, h] -> logits [B, num_heads]."""
    pooled = torch.mean(feats.float(), dim=1)
    return F.silu(pooled @ disc["fc1"].t() + disc["fc1__bias"]) @ disc["heads"].t()


# ---------------------------------------------------------------------------
# The three loss entry points
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DMDConfig:
    gan_loss_weight_gen: float = 5e-3  # 0 turns the GAN branch off
    r1_weight: float = 1.0
    r1_noise_std: float = 0.01


def draw(noise: torch.Tensor, generator: torch.Generator, r1: bool = False) -> tuple:
    """A loss's draws: (t [B], eps like noise) and, with `r1`, the R1
    penalty's standard normal noise like the latents (noise's shape)."""
    t = sample_timesteps(generator, noise.shape[0], noise.device)
    eps = torch.randn(noise.shape, generator=generator, dtype=torch.float32, device=noise.device).to(noise.dtype)
    if not r1:
        return t, eps
    return t, eps, torch.randn(noise.shape, generator=generator, dtype=torch.float32, device=noise.device)


def make_dmd_losses(cfg: dit.DiTConfig, dmd: DMDConfig = DMDConfig()):
    """(student_loss, fake_score_loss, disc_loss):

      student_loss(student, teacher, fake_score, disc or None, noise, draws) -> (total, parts)
      fake_score_loss(fake_score, student, noise, draws) -> loss
      disc_loss(disc, teacher, student, latents, noise, draws) -> loss

    `draws` is `draw(noise, generator)` ((t, eps); the discriminator's with
    `r1=True`: (t, eps, r1 noise)). The one-step student generates x0 =
    predict_x0(student, noise, t = 1)."""

    def generate(student, noise):
        return predict_x0(cfg, student, noise, torch.ones((noise.shape[0],), dtype=torch.float32,
                                                          device=noise.device))

    def student_loss(student, teacher, fake_score, disc, noise, draws):
        t, eps = draws
        gen = generate(student, noise)
        perturbed = add_noise(gen, eps, t)
        fake_x0 = predict_x0(cfg, fake_score, perturbed, t).detach()
        # the teacher's forward keeps the graph: the GAN term's features depend on gen
        v_t, _, feats = dit.forward(cfg, teacher, perturbed, timesteps(t), return_features=True)
        teacher_x0 = (perturbed.float() - _bcast(t, perturbed) * v_t.float()).detach().to(perturbed.dtype)
        vsd = vsd_loss(gen, teacher_x0, fake_x0)
        if disc is not None and dmd.gan_loss_weight_gen > 0:
            gg = gan_gen_loss(discriminator_forward(disc, feats))
            total = vsd + dmd.gan_loss_weight_gen * gg
            return total, {"vsd": vsd, "gan_gen": gg, "total": total}
        return vsd, {"vsd": vsd, "total": vsd}

    def fake_score_loss(fake_score, student, noise, draws):
        t, eps = draws
        gen = generate(student, noise).detach()
        perturbed = add_noise(gen, eps, t).detach()
        v_pred, _ = dit.forward(cfg, fake_score, perturbed, timesteps(t))
        return dsm_loss_flow(v_pred, gen, eps)

    def disc_loss(disc, teacher, student, latents, noise, draws):
        t, eps, r1_noise = draws
        gen = generate(student, noise).detach()
        tt = timesteps(t)

        def logits(x):
            return discriminator_forward(disc, dit.forward(cfg, teacher, x, tt, return_features=True)[2].detach())

        fake_lg, real_lg = logits(add_noise(gen, eps, t)), logits(add_noise(latents, eps, t))
        loss = gan_disc_loss(real_lg, fake_lg)
        if dmd.r1_weight > 0:
            pert = latents + dmd.r1_noise_std * r1_noise.to(latents.dtype)
            loss = loss + dmd.r1_weight * r1_loss(real_lg, logits(add_noise(pert, eps, t)))
        return loss

    return student_loss, fake_score_loss, disc_loss
