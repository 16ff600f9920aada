"""Ring attention: exact attention with the sequence sharded over a mesh
axis (port of `parallel/ring_attention.py`).

Each rank holds a [B, T/P, n, d] block of q, k and v. P ring steps: the
rank attends its q against the k / v block it holds with a streaming
(online) softmax, a running max m, denominator l and f32 accumulator, then
passes the k / v block one place on along the ring (`mesh.ring_shift`,
JAX's `ppermute`). Causality comes from the blocks' global positions: a
key block after the query block is masked with -inf (JAX's masking, step
for step; the rank's own block comes first, so every row's max is finite
before a fully masked block arrives). The block is plain PyTorch, as JAX's
is jnp: no kernel.
"""

from __future__ import annotations

import math

import torch

from .mesh import Mesh, all_gather, ring_shift


def _block_attend(q, k, v, bias, m_prev, l_prev, acc):
    """One streaming-softmax update: q [B, Tq, n, d], k / v [B, Tk, n, d],
    bias [1, 1, Tq, Tk]; m / l [B, n, Tq], acc [B, n, Tq, d] f32."""
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    s = s / math.sqrt(q.shape[-1]) + bias
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bnqk,bknd->bnqd", p.to(v.dtype), v).float()
    return m_new, l_new, acc


def ring_attention(q, k, v, mesh: Mesh, axis: str = "context", causal: bool = True) -> torch.Tensor:
    """Exact attention with the sequence sharded over `axis`: q, k, v are
    this rank's [B, T_local, n, d] blocks (GQA: repeat the kv heads first);
    returns this rank's [B, T_local, n, d] output in q's dtype."""
    B, Tq, n, d = q.shape
    P, my = mesh.size(axis), mesh.index(axis)
    dev = q.device
    m = torch.full((B, n, Tq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, n, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, n, Tq, d), dtype=torch.float32, device=dev)
    q_pos = my * Tq + torch.arange(Tq, device=dev)
    for i in range(P):
        src = (my - i) % P  # whose block this rank holds at step i
        k_pos = src * Tq + torch.arange(k.shape[1], device=dev)
        if causal:
            bias = torch.where(k_pos[None, :] <= q_pos[:, None], 0.0, -math.inf)[None, None].float()
        else:
            bias = torch.zeros((1, 1, Tq, k.shape[1]), dtype=torch.float32, device=dev)
        m, l, acc = _block_attend(q, k, v, bias, m, l, acc)
        if i < P - 1:  # JAX shifts after the last step too; its result is never read
            k, v = ring_shift(k, mesh, axis), ring_shift(v, mesh, axis)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh: Mesh, axis: str = "context", causal: bool = True) -> torch.Tensor:
    """The whole sequence's q, k, v [B, T, n, d] on every rank: this rank's
    block of T through `ring_attention`, and the blocks gathered back along
    T (JAX's shard_map over the sequence)."""
    P, my = mesh.size(axis), mesh.index(axis)
    T = q.shape[1]
    if T % P:
        raise ValueError(f"sequence {T} does not divide over {P} ranks")
    t = T // P

    def mine(x):
        return x[:, my * t:(my + 1) * t]

    return all_gather(ring_attention(mine(q), mine(k), mine(v), mesh, axis, causal), mesh, axis, dim=1)
