"""EAGLE speculative decoding: a one-layer draft transformer over hidden
states (port of `speculative/eagle.py`).

The draft consumes [token embedding ; base hidden state] through a fusion
projection and its own decoder layer(s), predicting the base model's next
hidden state and, through the base LM head, the next token (EAGLE-1).
Training-time test (TTT) runs the draft recursively on its own predictions
with the KV of earlier steps under the TTT mask; EAGLE-3 feeds the draft a
projection of several base layers' outputs (`aux_layer_ids`, not a
parameter) and drops the hidden-regression term.

The draft's layers are `llama._decoder_layer` with an empty layout on the
einsum attention: a base config with `attn_impl="flash"` is read as
"einsum" here (`qat.train_cfg`), since the flash kernel has no backward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import resolve_device
from ..models import llama
from ..quant import qat as qat_mod
from .medusa import _base_layers, _causal, _hidden_states, head_weight, randn_init, sgd_step


@dataclasses.dataclass(frozen=True)
class EagleConfig:
    num_layers: int = 1


def init_eagle(cfg: llama.LlamaConfig, ecfg: EagleConfig, generator: torch.Generator, device=None) -> dict:
    """Draft params: the fusion projection fc [H, 2H] and `num_layers`
    decoder layers of the base's shape with their final norm."""
    dev = resolve_device(device)
    h = cfg.hidden_size
    draft_cfg = dataclasses.replace(cfg, num_hidden_layers=ecfg.num_layers, vocab_size=1)  # no own embed / lm
    base = llama.init_params(draft_cfg, generator, device=dev)
    return {"fc": randn_init(generator, (h, 2 * h), 2 * h, cfg.dtype, dev),
            "layers": base["layers"], "norm": base["norm"]}


def _draft_layers(eagle: dict):
    layers = eagle["layers"]
    for i in range(layers["input_layernorm"].shape[0]):
        yield {k: v[i] for k, v in layers.items()}


def _fuse(cfg, params, eagle, tokens, hidden) -> torch.Tensor:
    emb = params["embed_tokens"][tokens].to(cfg.dtype)
    fused = torch.cat([emb, hidden.to(cfg.dtype)], dim=-1)
    return fused @ eagle["fc"].t().to(fused.dtype)


def _head(cfg, params, eagle, x):
    pred_hidden = llama.rms_norm(x, eagle["norm"], cfg.rms_norm_eps)
    return pred_hidden, (pred_hidden @ head_weight(params).t().to(pred_hidden.dtype)).float()


def eagle_forward(cfg, params, eagle, tokens, base_hidden):
    """Draft forward: fuse(embed(tokens), base_hidden) -> the next hidden.
    tokens [B, T]; base_hidden [B, T, H]. -> (pred_hidden [B, T, H],
    draft_logits [B, T, V] f32)."""
    cfg = qat_mod.train_cfg(cfg)
    B, T = tokens.shape
    positions, mask = _causal(B, T, tokens.device)
    x = _fuse(cfg, params, eagle, tokens, base_hidden)
    lay = llama.QuantLayout(sites=())
    for lp in _draft_layers(eagle):
        x = llama._decoder_layer(cfg, lay, False, x, lp, None, positions, mask)[0]
    return _head(cfg, params, eagle, x)


def _smooth_l1(diff: torch.Tensor) -> torch.Tensor:
    return torch.where(diff.abs() < 1, 0.5 * diff ** 2, diff.abs() - 0.5).mean()


def make_eagle_train_step(cfg: llama.LlamaConfig, lr: float = 1e-3, reg_weight: float = 0.1):
    """Train the draft: CE on the next token plus a smooth-L1 regression of
    the next hidden state. step(eagle, params, tokens) -> (new eagle, loss)."""

    def loss_fn(eagle, params, tokens):
        hidden = _hidden_states(cfg, params, tokens).detach()
        pred_hidden, logits = eagle_forward(cfg, params, eagle, tokens, hidden)
        ce = qat_mod.cross_entropy(logits[:, :-1], tokens[:, 1:])
        reg = _smooth_l1(pred_hidden[:, :-1].float() - hidden[:, 1:].float())
        return ce + reg_weight * reg

    def step(eagle, params, tokens):
        return sgd_step(eagle, lambda e: loss_fn(e, params, tokens), lr)

    return step


# ---------------------------------------------------------------------------
# EAGLE-3 training-time test (TTT): multi-step draft training
# ---------------------------------------------------------------------------


def ttt_attention_mask(T: int, s: int, S_total: int, device=None) -> torch.Tensor:
    """Additive mask [1, 1, T, S_total] (0 / -1e9, f32) of TTT step `s`: a
    query at local position q sees the original sequence's KV at kv <= q - s
    and one diagonal entry per earlier step i, kv == q + i T - (s - i),
    within block i; the blocks not yet written stay masked."""
    q_idx = torch.arange(T, device=device)[:, None]
    kv_idx = torch.arange(S_total, device=device)[None, :]
    allow = kv_idx <= (q_idx - s)
    for i in range(1, s + 1):
        allow = allow | ((kv_idx == q_idx + i * T - (s - i)) & (kv_idx >= i * T))
    allow = allow & (kv_idx < (s + 1) * T)
    return torch.where(allow, 0.0, -1e9).float()[None, None]


def eagle_ttt_forward(cfg, params, eagle, tokens, base_hidden, ttt_steps: int):
    """The draft for `ttt_steps` recursive steps over accumulated KV: step 0
    consumes `base_hidden`, step s > 0 the draft's step s-1 predictions rolled
    right by one, attending to every earlier step's KV through the TTT mask.
    -> [(pred_hidden, logits)] a step. Each step's KV lands in a new cache
    tensor (`llama._write_at` clones): nothing autograd saved is written."""
    cfg = qat_mod.train_cfg(cfg)
    B, T = tokens.shape
    nKV, hd = cfg.num_key_value_heads, cfg.hd
    S_total = ttt_steps * T
    dev = tokens.device
    positions = torch.arange(T, device=dev, dtype=torch.int32)[None].expand(B, T)
    lay = llama.QuantLayout(sites=())
    layers = list(_draft_layers(eagle))
    caches = [(torch.zeros((B, S_total, nKV, hd), dtype=cfg.dtype, device=dev),
               torch.zeros((B, S_total, nKV, hd), dtype=cfg.dtype, device=dev)) for _ in layers]
    hidden_in = base_hidden
    outs = []
    for s in range(ttt_steps):
        x = _fuse(cfg, params, eagle, tokens, hidden_in)
        mask = ttt_attention_mask(T, s, S_total, dev)
        for li, lp in enumerate(layers):
            ck, cv = caches[li]
            x, _, _, caches[li] = llama._decoder_layer(cfg, lay, False, x, lp, None, positions, mask, None,
                                                       (ck, cv, s * T))
        pred_hidden, logits = _head(cfg, params, eagle, x)
        outs.append((pred_hidden, logits))
        hidden_in = torch.roll(pred_hidden, 1, dims=1)
    return outs


def _ttt_loss(outs, tokens, hidden=None, reg_weight: float = 0.1):
    """Step s predicts token t+s+1 (CE); with `hidden`, step 0 also regresses
    the base hidden at t+1. -> (loss, per-step accuracy [steps])."""
    total, accs = 0.0, []
    for s, (pred_hidden, logits) in enumerate(outs):
        off = s + 1
        if tokens.shape[1] <= off:
            break
        lg, tg = logits[:, :-off], tokens[:, off:]
        total = total + qat_mod.cross_entropy(lg, tg)
        accs.append((torch.argmax(lg, dim=-1) == tg).float().mean())
        if s == 0 and hidden is not None:
            total = total + reg_weight * _smooth_l1(pred_hidden[:, :-1].float() - hidden[:, 1:].float())
    return total, torch.stack(accs)


def make_eagle_ttt_train_step(cfg: llama.LlamaConfig, ttt_steps: int = 3, lr: float = 1e-3,
                              reg_weight: float = 0.1):
    """The multi-step TTT objective: step s predicts token t+s+1 (CE), step 0
    also the base hidden at t+1 (regression), summed over the steps.
    step(eagle, params, tokens) -> (new eagle, loss, accs [ttt_steps])."""

    def loss_fn(eagle, params, tokens):
        hidden = _hidden_states(cfg, params, tokens).detach()
        outs = eagle_ttt_forward(cfg, params, eagle, tokens, hidden, ttt_steps)
        return _ttt_loss(outs, tokens, hidden, reg_weight)

    def step(eagle, params, tokens):
        new, (loss, accs) = sgd_step(eagle, lambda e: loss_fn(e, params, tokens), lr)
        return new, loss, accs

    return step


# ---------------------------------------------------------------------------
# EAGLE-3: multi-layer auxiliary feature taps
# ---------------------------------------------------------------------------


def default_aux_layer_ids(num_layers: int) -> list[int]:
    """The default EAGLE-3 tap layers: near the start, the middle and the end."""
    return sorted({1, max(0, num_layers // 2 - 1), max(0, num_layers - 4)})


def aux_hidden_states(cfg, params, tokens, layer_ids, layout=None, qstate=None) -> torch.Tensor:
    """The pre-norm hidden state after each tapped layer, concatenated low
    to high: [B, T, len(layer_ids) * H]."""
    all_h = list(_base_layers(cfg, params, tokens, layout, qstate))
    return torch.cat([all_h[i] for i in layer_ids], dim=-1)


def init_eagle3(cfg: llama.LlamaConfig, ecfg: EagleConfig, generator: torch.Generator,
                layer_ids: Optional[list] = None, device=None) -> dict:
    """An EAGLE-1 draft plus fc3 [H, k H], the projection of the k tapped
    features into the draft's hidden input, and the tap layers'
    `aux_layer_ids` (a tuple of ints, not trained)."""
    dev = resolve_device(device)
    h = cfg.hidden_size
    layer_ids = layer_ids or default_aux_layer_ids(cfg.num_hidden_layers)
    base = init_eagle(cfg, ecfg, generator, device=dev)
    k = len(layer_ids)
    base["fc3"] = randn_init(generator, (h, k * h), k * h, cfg.dtype, dev)
    base["aux_layer_ids"] = tuple(int(i) for i in layer_ids)
    return base


def eagle3_fuse(eagle: dict, aux: torch.Tensor) -> torch.Tensor:
    """[B, T, k H] tapped features -> [B, T, H] draft input."""
    return aux @ eagle["fc3"].t().to(aux.dtype)


def make_eagle3_ttt_train_step(cfg: llama.LlamaConfig, ttt_steps: int = 3, lr: float = 1e-3):
    """EAGLE-3 TTT training: step 0 consumes the fused multi-layer features,
    later steps the draft's own hiddens; CE only. step(eagle, params,
    tokens) -> (new eagle, loss, accs [ttt_steps]); `aux_layer_ids` passes
    through."""

    def loss_fn(eagle, params, tokens):
        aux = aux_hidden_states(cfg, params, tokens, list(eagle["aux_layer_ids"])).detach()
        outs = eagle_ttt_forward(cfg, params, eagle, tokens, eagle3_fuse(eagle, aux), ttt_steps)
        return _ttt_loss(outs, tokens)

    def step(eagle, params, tokens):
        new, (loss, accs) = sgd_step(eagle, lambda e: loss_fn(e, params, tokens), lr)
        return new, loss, accs

    return step


def propose_and_verify(cfg, params, eagle, prompt, steps=16, draft_len=3, layout=None, qstate=None):
    """Greedy EAGLE decoding and its acceptance: each round the draft
    proposes `draft_len` tokens autoregressively from the base hidden
    (EAGLE-1) or the fused taps (EAGLE-3: an `fc3` key), its first step on
    the true features of the whole context, the base pick included; one base
    forward verifies the chain; the longest agreeing prefix and the base pick
    are kept. -> (tokens [1, P + produced], accept_rate)."""
    if prompt.shape[0] != 1:
        raise ValueError(f"the acceptance harness is single-sequence, got batch {prompt.shape[0]}")
    is_e3 = "fc3" in eagle
    dev, dt = prompt.device, prompt.dtype
    tokens = prompt
    accepted_total = proposed_total = produced = 0
    while produced < steps:
        full_logits, _, _ = llama.forward(cfg, params, tokens, layout=layout, qstate=qstate)
        nxt = int(torch.argmax(full_logits[0, -1]))
        cur_tokens = torch.cat([tokens, torch.tensor([[nxt]], dtype=dt, device=dev)], dim=1)
        if is_e3:
            aux = aux_hidden_states(cfg, params, cur_tokens, list(eagle["aux_layer_ids"]), layout, qstate)
            cur_hidden = eagle3_fuse(eagle, aux)
        else:
            cur_hidden = _hidden_states(cfg, params, cur_tokens, layout, qstate)
        draft = []
        for _ in range(draft_len):
            ph, dlogits = eagle_forward(cfg, params, eagle, cur_tokens, cur_hidden)
            d = int(torch.argmax(dlogits[0, -1]))
            draft.append(d)
            cur_tokens = torch.cat([cur_tokens, torch.tensor([[d]], dtype=dt, device=dev)], dim=1)
            cur_hidden = torch.cat([cur_hidden, ph[:, -1:]], dim=1)
        chain = torch.cat([tokens, torch.tensor([[nxt] + draft], dtype=dt, device=dev)], dim=1)
        ver_logits, _, _ = llama.forward(cfg, params, chain, layout=layout, qstate=qstate)
        ver = torch.argmax(ver_logits[0, tokens.shape[1]:tokens.shape[1] + draft_len], dim=-1).tolist()
        n_acc = 0
        while n_acc < draft_len and ver[n_acc] == draft[n_acc]:
            n_acc += 1
        tokens = torch.cat([tokens, torch.tensor([[nxt] + draft[:n_acc]], dtype=dt, device=dev)], dim=1)
        produced += 1 + n_acc
        accepted_total += n_acc
        proposed_total += draft_len
    return tokens, accepted_total / max(proposed_total, 1)
