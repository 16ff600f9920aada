"""Medusa speculative decoding: draft heads, their training and the chain
verifier (port of `speculative/medusa.py`).

Each draft head h predicts token t+2+h from the base model's last hidden
state through residual block(s) and its own LM head. The head parameters
are a dict of tensors of their own ({"heads": [{"blocks": [W], "lm": W}]});
the base model stays frozen while they train. A train step is one
`torch.autograd` backward through the heads and plain SGD in each
parameter's dtype (p - lr * g), JAX's `value_and_grad` and update rule.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .. import resolve_device
from ..models import llama
from ..quant import qat as qat_mod
from ..utils.tree import map_tensors


@dataclasses.dataclass(frozen=True)
class MedusaConfig:
    num_heads: int = 4  # draft heads (predict t+2 ... t+1+num_heads)
    num_layers: int = 1  # residual blocks per head


def randn_init(generator: torch.Generator, shape: tuple, fan_in: int, dtype, device) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in f32 on `device` (the generator's), cast to `dtype`."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.div_(math.sqrt(fan_in)).to(dtype)


def init_medusa(cfg: llama.LlamaConfig, mcfg: MedusaConfig, generator: torch.Generator, device=None) -> dict:
    """Head params: per head, `num_layers` residual blocks [H, H] and an LM
    projection [V, H], seeded from `generator` (which lives on `device`)."""
    dev = resolve_device(device)
    h, v = cfg.hidden_size, cfg.vocab_size
    heads = []
    for _ in range(mcfg.num_heads):
        blocks = [randn_init(generator, (h, h), h, cfg.dtype, dev) for _ in range(mcfg.num_layers)]
        heads.append({"blocks": blocks, "lm": randn_init(generator, (v, h), h, cfg.dtype, dev)})
    return {"heads": heads}


def _causal(B: int, T: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [B, T] 0..T-1 and the additive causal mask [1, 1, T, T]."""
    positions = torch.arange(T, device=device, dtype=torch.int32)[None].expand(B, T)
    return positions, llama.causal_mask(T, device)


def _base_layers(cfg, params, tokens, layout=None, qstate=None):
    """The base model's decoder layers over tokens [B, T], causal, without
    the embedding quantizer and the global sites: yields each layer's
    output [B, T, H] (pre-norm)."""
    B, T = tokens.shape
    positions, mask = _causal(B, T, tokens.device)
    x = params["embed_tokens"][tokens].to(cfg.dtype)
    lstate = {k: v for k, v in (qstate or {}).items() if not k.startswith(llama.GLOBAL_SITES)} or None
    lay = layout or llama.QuantLayout(sites=())
    layers = params["layers"]
    for i in range(layers["input_layernorm"].shape[0]):
        lp = {k: v[i] for k, v in layers.items()}
        x = llama._decoder_layer(cfg, lay, False, x, lp, llama.slice_state(lstate, i), positions, mask)[0]
        yield x


def _hidden_states(cfg, params, tokens, layout=None, qstate=None) -> torch.Tensor:
    """The base model's final hidden states [B, T, H] (after the last norm,
    before the LM head)."""
    x = None
    for x in _base_layers(cfg, params, tokens, layout, qstate):
        pass
    return llama.rms_norm(x, params["norm"], cfg.rms_norm_eps)


def head_weight(params: dict) -> torch.Tensor:
    return params.get("lm_head", params["embed_tokens"])


def apply_heads(medusa: dict, hidden: torch.Tensor, head_w: torch.Tensor) -> torch.Tensor:
    """Head logits from a hidden state, no base forward: [num_heads, ..., V]
    f32 (`head_w` is unused: each head has its own LM projection; the
    argument keeps JAX's signature)."""
    outs = []
    for head in medusa["heads"]:
        hh = hidden
        for blk in head["blocks"]:
            hh = hh + torch.nn.functional.silu((hh @ blk.t().to(hh.dtype)).float()).to(hh.dtype)
        outs.append((hh @ head["lm"].t().to(hh.dtype)).float())
    return torch.stack(outs)


def medusa_logits(cfg, params, medusa, tokens, layout=None, qstate=None):
    """-> (base_logits [B, T, V], head_logits [num_heads, B, T, V]), f32."""
    hidden = _hidden_states(cfg, params, tokens, layout, qstate)
    base_logits = (hidden @ head_weight(params).t().to(hidden.dtype)).float()
    return base_logits, apply_heads(medusa, hidden, head_weight(params))


def sgd_step(draft, loss_fn: Callable, lr: float):
    """One SGD step of a draft's tensors: `loss_fn(draft)` -> loss, or (loss,
    aux). The gradients reach the draft's tensors only (the base model's
    stay constants). -> (new draft, loss or (loss, aux), detached). A tensor
    the loss does not reach keeps its value (JAX's zero gradient)."""
    out = {}

    def scalar(d):
        out["res"] = loss_fn(d)
        return out["res"][0] if isinstance(out["res"], tuple) else out["res"]

    _, grads = qat_mod.value_and_grad(scalar, draft)
    return qat_mod.sgd_update(draft, grads, lr), map_tensors(torch.Tensor.detach, out["res"])


def make_medusa_train_step(cfg: llama.LlamaConfig, lr: float = 1e-3):
    """Train the heads only (the base frozen): head h learns P(t+2+h | hidden_t).
    step(medusa, params, tokens) -> (new medusa, loss)."""

    def loss_fn(medusa, params, tokens):
        _, head_logits = medusa_logits(cfg, params, medusa, tokens)
        total = 0.0
        nh = head_logits.shape[0]
        for h in range(nh):
            off = h + 2
            if tokens.shape[1] <= off:
                continue
            total = total + qat_mod.cross_entropy(head_logits[h][:, :-off], tokens[:, off:])
        return total / nh

    def step(medusa, params, tokens):
        return sgd_step(medusa, lambda m: loss_fn(m, params, tokens), lr)

    return step


def propose_and_verify(cfg, params, medusa, prompt, steps=16, layout=None, qstate=None):
    """Greedy Medusa decoding (a chain, no tree) and its acceptance: each
    round one base forward over [tokens, base pick, the heads' chain], the
    longest prefix of the chain the base model's argmax agrees with kept.
    -> (tokens [1, P + produced], accept_rate)."""
    if prompt.shape[0] != 1:
        raise ValueError(f"the acceptance harness is single-sequence, got batch {prompt.shape[0]}")
    nh = len(medusa["heads"])
    tokens = prompt
    accepted_total = proposed_total = produced = 0
    while produced < steps:
        base_logits, head_logits = medusa_logits(cfg, params, medusa, tokens, layout, qstate)
        nxt = int(torch.argmax(base_logits[0, -1]))
        draft = [int(torch.argmax(head_logits[h][0, -1])) for h in range(nh)]
        chain = torch.cat([tokens, torch.tensor([[nxt] + draft], dtype=tokens.dtype, device=tokens.device)], dim=1)
        ver_logits, _, _ = llama.forward(cfg, params, chain, layout=layout, qstate=qstate)
        ver = torch.argmax(ver_logits[0, tokens.shape[1]:tokens.shape[1] + nh], dim=-1).tolist()
        n_acc = 0
        while n_acc < nh and ver[n_acc] == draft[n_acc]:
            n_acc += 1
        keep = [nxt] + draft[:n_acc]
        tokens = torch.cat([tokens, torch.tensor([keep], dtype=tokens.dtype, device=tokens.device)], dim=1)
        produced += len(keep)
        accepted_total += n_acc
        proposed_total += nh
    return tokens, accepted_total / max(proposed_total, 1)
