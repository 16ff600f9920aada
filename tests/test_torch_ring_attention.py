"""The port's ring attention on 4 gloo ranks (CPU) against full attention
and JAX's ring attention (tests/test_ring_attention.py): q, k, v [2, 32, 4,
16] f32 from a seeded numpy draw, the sequence 8 tokens a rank. Within
2e-4 (JAX's bound) of full attention, causal and not, and of JAX's ring on
its 8 virtual devices; one rank's block in bf16 through `ring_attention`
against the f32 full attention within 2e-2 (bf16's P.V)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_tp
from tensorrt_model_optimizer_tpu.parallel import ring_attention as jra

TOL = 2e-4


def full_attention(q, k, v, causal=True):
    s = torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(q.shape[-1])
    T = q.shape[1]
    if causal:
        s = s + torch.where(torch.arange(T)[None, :] <= torch.arange(T)[:, None], 0.0, -math.inf)
    return torch.einsum("bnqk,bknd->bqnd", torch.softmax(s, dim=-1), v)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    qkv = [rng.normal(size=(2, 32, 4, 16)).astype(np.float32) for _ in range(3)]
    tq = [torch.from_numpy(a) for a in qkv]
    ranks = _torch_tp.launch(_torch_tp.ring_cases, 4, tmp_path_factory.mktemp("ring"), *tq)
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("context",))
    jout = {c: np.asarray(jra.ring_attention_sharded(*[jnp.asarray(a) for a in qkv], mesh, "context", c))
            for c in (True, False)}
    return tq, ranks, jout


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_full_and_jax(runs, causal):
    tq, ranks, jout = runs
    ref = full_attention(*tq, causal).numpy()
    for rank in ranks:
        np.testing.assert_allclose(rank[causal], ref, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(rank[causal], jout[causal], rtol=TOL, atol=TOL)


def test_ring_block_bf16(runs):
    tq, ranks, _ = runs
    ref = full_attention(*tq, True).numpy()
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank["bf16_block"], ref[:, r * 8:(r + 1) * 8], rtol=2e-2, atol=2e-2)
