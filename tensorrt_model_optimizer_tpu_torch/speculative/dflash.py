"""DFlash: block-wise parallel speculative decoding (port of
`speculative/dflash.py`).

One draft module predicts a block of future tokens in parallel from the base
model's hidden state, with a query embedding per offset. Training weights
offset i by gamma^i and takes either soft targets (the base model's own
distribution at t+1+i, self-logit distillation) or hard labels.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..models import llama
from .medusa import _hidden_states, head_weight, randn_init, sgd_step


@dataclasses.dataclass(frozen=True)
class DFlashConfig:
    block_size: int = 4  # tokens drafted in parallel per step
    loss_decay_factor: float = 0.8  # gamma^i weighting per offset
    self_logit_distillation: bool = True
    hidden_mult: int = 2  # draft MLP expansion


def init_dflash(cfg: llama.LlamaConfig, dcfg: DFlashConfig, generator: torch.Generator, device=None) -> dict:
    """offset_emb [block, H] ~ N(0, 0.02^2), fc1 [m, 2H], fc2 [H, m]."""
    dev = resolve_device(device)
    h = cfg.hidden_size
    m = h * dcfg.hidden_mult
    emb = torch.randn((dcfg.block_size, h), generator=generator, dtype=torch.float32, device=dev) * 0.02
    return {"offset_emb": emb.to(cfg.dtype),
            "fc1": randn_init(generator, (m, 2 * h), 2 * h, cfg.dtype, dev),
            "fc2": randn_init(generator, (h, m), m, cfg.dtype, dev)}


def dflash_logits(cfg, params, dflash, tokens):
    """Block predictions at every position: -> (base_logits [B, T, V],
    block_logits [block, B, T, V]), f32; block i predicts token t+1+i from
    hidden_t."""
    hidden = _hidden_states(cfg, params, tokens)
    head_w = head_weight(params)
    base_logits = (hidden @ head_w.t().to(hidden.dtype)).float()
    outs = []
    for i in range(dflash["offset_emb"].shape[0]):
        q = dflash["offset_emb"][i].to(hidden.dtype).expand_as(hidden)
        z = torch.cat([hidden, q], dim=-1)
        z = torch.nn.functional.silu((z @ dflash["fc1"].t().to(z.dtype)).float()).to(hidden.dtype)
        z = hidden + z @ dflash["fc2"].t().to(z.dtype)
        outs.append((z @ head_w.t().to(z.dtype)).float())
    return base_logits, torch.stack(outs)


def make_dflash_train_step(cfg: llama.LlamaConfig, dcfg: DFlashConfig, lr: float = 1e-3):
    """Train the block predictor (the base frozen).
    step(dflash, params, tokens) -> (new dflash, loss)."""

    def loss_fn(dflash, params, tokens):
        base_logits, blk = dflash_logits(cfg, params, dflash, tokens)
        base_logits = base_logits.detach()
        total, wsum = 0.0, 0.0
        T = tokens.shape[1]
        for i in range(dcfg.block_size):
            off = i + 1
            if T <= off:
                continue
            w = dcfg.loss_decay_factor ** i
            lp = torch.log_softmax(blk[i][:, :-off], dim=-1)
            if dcfg.self_logit_distillation:  # soft target: the base model's own prediction at t+off
                tgt = torch.softmax(base_logits[:, off:], dim=-1)
                total = total + w * -(tgt * lp).sum(dim=-1).mean()
            else:
                ll = torch.gather(lp, -1, tokens[:, off:, None].long())[..., 0]
                total = total + w * -ll.mean()
            wsum += w
        return total / max(wsum, 1e-9)

    def step(dflash, params, tokens):
        return sgd_step(dflash, lambda d: loss_fn(d, params, tokens), lr)

    return step


def propose_and_verify(cfg, params, dflash, prompt, steps=16):
    """Greedy block-parallel decoding and its acceptance. -> (tokens [1, P +
    produced], accept_rate)."""
    if prompt.shape[0] != 1:
        raise ValueError(f"the acceptance harness is single-sequence, got batch {prompt.shape[0]}")
    block = dflash["offset_emb"].shape[0]
    dev, dt = prompt.device, prompt.dtype
    tokens = prompt
    accepted_total = proposed_total = produced = 0
    while produced < steps:
        base_logits, blk = dflash_logits(cfg, params, dflash, tokens)
        nxt = int(torch.argmax(base_logits[0, -1]))
        draft = [int(torch.argmax(blk[i][0, -1])) for i in range(block)]
        chain = torch.cat([tokens, torch.tensor([[nxt] + draft], dtype=dt, device=dev)], dim=1)
        ver, _, _ = llama.forward(cfg, params, chain)
        pred = torch.argmax(ver[0, tokens.shape[1]:tokens.shape[1] + block], dim=-1).tolist()
        n_acc = 0
        while n_acc < block and pred[n_acc] == draft[n_acc]:
            n_acc += 1
        tokens = torch.cat([tokens, torch.tensor([[nxt] + draft[:n_acc]], dtype=dt, device=dev)], dim=1)
        produced += 1 + n_acc
        accepted_total += n_acc
        proposed_total += block
    return tokens, accepted_total / max(proposed_total, 1)
