"""Diffusion acceleration trainers (port of `fastgen/trainers.py`): flow
matching of the base DiT, the deterministic rectified-flow sampler,
few-step distillation of a student onto the teacher's k-step jump, and EMA
weights.

Each step is plain SGD in the parameters' dtype, p - lr g (JAX's update),
through `quant.qat.value_and_grad`. Its random draws come from a
`torch.Generator` or are given (`draws`), so the same draws give the same
step in both packages; JAX draws from a PRNG key inside the loss. In bf16
the update underflows at small learning rates: train in f32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import dit
from ..quant import qat
from ..utils.tree import map_pairs


def flow_matching_draws(x0: torch.Tensor, generator: torch.Generator) -> tuple:
    """(x1 standard normal like x0, t [B] uniform in [0, 1))."""
    x1 = torch.randn(x0.shape, generator=generator, dtype=torch.float32, device=x0.device).to(x0.dtype)
    return x1, torch.rand((x0.shape[0],), generator=generator, dtype=torch.float32, device=x0.device)


def flow_matching_loss(cfg: dit.DiTConfig, params, x0: torch.Tensor, draws) -> torch.Tensor:
    """Rectified flow: the model at x_t = (1 - t) x0 + t x1 predicts v = x1 - x0."""
    x1, t = draws
    tb = t[:, None, None, None]
    xt = ((1 - tb) * x0 + tb * x1).to(x0.dtype)
    v_pred, _ = dit.forward(cfg, params, xt, (t * 999).to(torch.int32))
    return torch.mean((v_pred.float() - (x1 - x0).float()) ** 2)


def make_flow_matching_step(cfg: dit.DiTConfig, lr: float = 1e-4):
    """step(params, x0, draws) -> (new params, loss); draws from
    `flow_matching_draws`."""

    def step(params, x0, draws):
        loss, grads = qat.value_and_grad(lambda p: flow_matching_loss(cfg, p, x0, draws), params)
        return qat.sgd_update(params, grads, lr), loss

    return step


def _step_t(i: int, steps: int) -> int:
    """Step i's integer timestep as JAX's traced loop computes it: t = 1 - i
    dt in f32, times 999 in f32, truncated."""
    t = np.float32(1.0) - np.float32(i) * np.float32(1.0 / steps)
    return int(np.float32(t) * np.float32(999))


def ddim_sample(cfg: dit.DiTConfig, params, x_T: torch.Tensor, steps: int = 8) -> torch.Tensor:
    """Deterministic rectified-flow sampler: x <- x - dt v(x, t), t from 1 down."""
    dt = 1.0 / steps
    x = x_T
    for i in range(steps):
        tt = torch.full((x.shape[0],), _step_t(i, steps), dtype=torch.int32, device=x.device)
        v, _ = dit.forward(cfg, params, x, tt)
        x = (x.float() - dt * v.float()).to(x.dtype)
    return x


def distill_fewstep_loss(cfg: dit.DiTConfig, student, teacher, x_T: torch.Tensor, teacher_steps: int = 4):
    """The student's one-step jump x_T - v(x_T, 999) against the teacher's
    `teacher_steps`-step sample (no gradient through the teacher)."""
    with torch.no_grad():
        tgt = ddim_sample(cfg, teacher, x_T, teacher_steps)
    t999 = torch.full((x_T.shape[0],), 999, dtype=torch.int32, device=x_T.device)
    v, _ = dit.forward(cfg, student, x_T, t999)
    return torch.mean((x_T.float() - v.float() - tgt.float()) ** 2)


def make_distill_fewstep_step(cfg: dit.DiTConfig, teacher_steps: int = 4, lr: float = 1e-4):
    """step(student, teacher, x_T) -> (new student, loss)."""

    def step(student, teacher, x_T):
        loss, grads = qat.value_and_grad(lambda s: distill_fewstep_loss(cfg, s, teacher, x_T, teacher_steps),
                                         student)
        return qat.sgd_update(student, grads, lr), loss

    return step


def ema_update(ema_params, params, decay: float = 0.999):
    """decay e + (1 - decay) p in f32, in the EMA's dtype."""
    with torch.no_grad():
        return map_pairs(lambda e, p: (decay * e.float() + (1 - decay) * p.float()).to(e.dtype), ema_params, params)
