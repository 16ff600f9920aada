"""Quantization-aware training (port of `quant/qat.py`).

QAT keeps fake quant active during fine-tuning with straight-through
gradients (`ops/ste.py`, routed by `quantizer._dispatch` as JAX routes
them): a next-token loss through the quantized forward, its gradients by
`torch.autograd`, then an SGD or Adam update. Steps are functional, as
JAX's are: they take tensor trees and return new ones (detached), never
writing the caller's tensors.

`Adam` follows `optax.adam` operation for operation (bias-corrected
mu / (sqrt(nu + eps_root) + eps), moments in each parameter's dtype, the
update scaled by -lr and added in the parameter's dtype). The training
entry points read a config's `attn_impl="flash"` as the einsum attention
(`train_cfg`): the flash kernel has no backward (`ops/cuda/_build.py`
`refuse_grad`), where JAX's flash differentiates through its reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..models import llama
from ..utils.tree import map_pairs, map_tensors


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy. logits [B, T, V], targets [B, T]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0].mean()


def train_cfg(cfg):
    """The config a training forward runs: a flash config attends through
    the einsum (the kernel has no backward); any other is returned as is."""
    return dataclasses.replace(cfg, attn_impl="einsum") if cfg.attn_impl == "flash" else cfg


def _trainable(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def value_and_grad(loss_fn: Callable, tree):
    """(loss, grads): `loss_fn(tree)` and its gradient with respect to every
    float tensor of `tree`, as a tree of the same structure (zeros where the
    loss does not reach a tensor, as JAX's; None at non-float leaves). The
    loss comes back detached, and grad mode is on inside whatever context
    the caller is in."""
    leaves = []

    def track(t):
        if not _trainable(t):
            return t
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t

    live = map_tensors(track, tree)
    with torch.enable_grad():
        loss = loss_fn(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(zip(leaves, grads))

    def grad_of(t):
        if not _trainable(t):
            return None
        leaf, g = next(it)
        return torch.zeros_like(leaf) if g is None else g

    return loss.detach(), map_tensors(grad_of, live)


def qat_loss(model_cfg, layout, params, qstate, tokens, forward_fn=None) -> torch.Tensor:
    """Next-token loss with fake quant active (straight-through backward).
    `forward_fn` selects a registry family's forward (returning (logits,
    state)); the default is llama's."""
    cfg = train_cfg(model_cfg)
    if forward_fn is not None:
        logits = forward_fn(cfg, params, tokens[:, :-1], layout=layout, qstate=qstate)[0]
    else:
        logits = llama.forward(cfg, params, tokens[:, :-1], layout=layout, qstate=qstate)[0]
    return cross_entropy(logits, tokens[:, 1:])


def sgd_update(params, grads, lr: float):
    """p - lr * g in the parameter's dtype (JAX's SGD: the gradient cast to
    f32, then to the parameter's dtype)."""
    with torch.no_grad():
        return map_pairs(lambda p, g: p.detach() - lr * g.float().to(p.dtype), params, grads)


def make_train_step(model_cfg, layout, lr: float = 1e-4, forward_fn=None):
    """A pure SGD step: (params, qstate, tokens) -> (params, loss). The
    quantizer state stays frozen (the reference freezes calibrated scales;
    LSQ's learnable amax is `make_optax_train_step(train_amax=True)`)."""

    def train_step(params, qstate, tokens):
        loss, grads = value_and_grad(lambda p: qat_loss(model_cfg, layout, p, qstate, tokens, forward_fn), params)
        return sgd_update(params, grads, lr), loss

    return train_step


@dataclasses.dataclass(frozen=True)
class Adam:
    """`optax.adam(learning_rate, b1, b2, eps, eps_root)`: `init(tree)` ->
    state {"count", "mu", "nu"}; `update(grads, state)` -> (updates, state),
    the updates already scaled by -lr; `apply_updates` adds them."""

    learning_rate: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, tree) -> dict:
        devices = []
        map_tensors(lambda t: devices.append(t.device), tree)
        zeros = map_tensors(lambda t: torch.zeros_like(t) if _trainable(t) else None, tree)
        return {"count": torch.zeros((), dtype=torch.int32, device=devices[0] if devices else None),
                "mu": zeros, "nu": map_tensors(torch.zeros_like, zeros)}

    @torch.no_grad()
    def update(self, grads, state: dict):
        b1, b2 = self.b1, self.b2
        mu = map_pairs(lambda g, m: g * (1 - b1) + m * b1, grads, state["mu"])
        nu = map_pairs(lambda g, v: (g * g) * (1 - b2) + v * b2, grads, state["nu"])
        count = state["count"] + 1
        c = count.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)

        def step(m, v):
            m_hat, v_hat = m / bc1.to(m.dtype), v / bc2.to(v.dtype)
            return (m_hat / (torch.sqrt(v_hat + self.eps_root) + self.eps)) * (-self.learning_rate)

        return map_pairs(step, mu, nu), {"count": count, "mu": mu, "nu": nu}


@torch.no_grad()
def apply_updates(params, updates):
    """p + u in the parameter's dtype (`optax.apply_updates`)."""
    return map_pairs(lambda p, u: (p.detach() + u).to(p.dtype), params, updates)


def make_optax_train_step(model_cfg, layout, optimizer: Optional[Adam] = None, train_amax: bool = False,
                          masks: Optional[dict] = None, forward_fn=None):
    """The QAT trainer step (the QATTrainer analog): an Adam step, and with
    `train_amax` the quantizer state trains too (the `learn_amax` sites'
    amax take LSQ gradients; every other amax a zero gradient; a
    pre_quant_scale its true one), as JAX's step trains the whole
    (params, qstate) pair. `masks` ({projection: bool [L, O, K]},
    `sparsity.sparsify`'s) re-project the weights after every update, so
    masked-off weights stay 0 (masked QAT of a sparse model).

    Returns (step_fn, init_fn): init_fn(params, qstate) -> opt_state;
    step_fn(params, qstate, opt_state, tokens) -> (params, qstate,
    opt_state, loss)."""
    optimizer = optimizer or Adam(1e-4)

    def init_fn(params, qstate):
        return optimizer.init((params, qstate) if train_amax else params)

    def step_fn(params, qstate, opt_state, tokens):
        if train_amax:
            loss, grads = value_and_grad(
                lambda pq: qat_loss(model_cfg, layout, pq[0], pq[1], tokens, forward_fn), (params, qstate))
            updates, opt_state = optimizer.update(grads, opt_state)
            params, qstate = apply_updates((params, qstate), updates)
        else:
            loss, grads = value_and_grad(lambda p: qat_loss(model_cfg, layout, p, qstate, tokens, forward_fn),
                                         params)
            updates, opt_state = optimizer.update(grads, opt_state)
            params = apply_updates(params, updates)
        if masks is not None:
            from ..sparsity import sparsify

            params = sparsify.reapply(params, masks)
        return params, qstate, opt_state, loss

    return step_fn, init_fn
