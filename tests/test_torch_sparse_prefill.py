"""Skip-softmax sparse prefill in the port's einsum engine
(`EngineConfig.attn_sparsity`), the port of the JAX package's
`TestSparsePrefill` (`tests/test_compress_serve.py`), and the same engine
against JAX's: the per-layer keep fractions, prefill logits and `serve`.

Weights: INT4 weight-only on a tiny f32 Llama whose projections take whole
128-blocks (JAX's test uses INT8_DEFAULT_CFG, which is W8A8 and not served
by the port), carried across by `convert.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, llama_params_np, rel_err, tree_map  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu.serve import scheduler as jsched
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.serve import scheduler as tsched

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    pnp = llama_params_np(jcfg, seed=0)
    jcm = jcompress.compress(jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"))
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    return jcfg, jcm, convert.compressed_from_jax(jcm), prompt


def _engine(cm, threshold, kv=None, device="cpu", **kw):
    return tengine.Engine(cm, tengine.EngineConfig(max_seq_len=64, kv_dtype=kv, attn_sparsity=threshold,
                                                   attn_sparsity_blocks=(8, 8), **kw), device=device)


def test_tiny_threshold_matches_dense(setup):
    """threshold -> 0 keeps every tile: tokens equal to dense; of 16 tokens in
    8-tiles the tile above the diagonal is skipped: 3 of 4 kept."""
    cfg, _, cm, prompt = setup
    p = torch.from_numpy(prompt)
    dense, sparse = _engine(cm, None), _engine(cm, 1e-30)
    assert torch.equal(sparse.generate(p, 4), dense.generate(p, 4))
    keep = sparse.last_prefill_keep_frac
    assert keep.shape == (cfg.num_hidden_layers,)
    np.testing.assert_allclose(keep.numpy(), 0.75, atol=1e-6)


def test_aggressive_threshold_skips_blocks(setup):
    _, _, cm, prompt = setup
    p = torch.from_numpy(prompt)
    hi, lo, dense = _engine(cm, 0.999999), _engine(cm, 1e-30), _engine(cm, None)
    logits = hi.prefill(p, hi.init_cache(2))
    logits_lo = lo.prefill(p, lo.init_cache(2))
    assert float(hi.last_prefill_keep_frac.mean()) < float(lo.last_prefill_keep_frac.mean())
    assert bool(torch.isfinite(logits).all())
    dl = dense.prefill(p, dense.init_cache(2))
    assert np.corrcoef(dl.numpy().ravel(), logits_lo.numpy().ravel())[0, 1] > 0.999


def test_decode_stays_dense_after_sparse_prefill(setup):
    """Decode steps (T = 1) never take the sparse route: the keep fractions
    are the prefill's."""
    _, _, cm, prompt = setup
    eng = _engine(cm, 1e-30)
    out = eng.generate(torch.from_numpy(prompt), 6)
    assert out.shape == (2, 6)
    np.testing.assert_allclose(eng.last_prefill_keep_frac.numpy(), 0.75, atol=1e-6)


@pytest.mark.parametrize("kv", ["model_dtype", "int8"])
@pytest.mark.parametrize("threshold", [1e-30, 1e-2, 0.999999])
def test_sparse_prefill_matches_jax(setup, threshold, kv):
    """Per-layer keep fractions equal to JAX's (1e-6), prefill logits within
    1e-3 of their scale, the cache (written in stored form either way) and
    the greedy tokens that follow equal."""
    _, jcm, cm, prompt = setup
    jkv, tkv = (None, None) if kv == "model_dtype" else (jnp.int8, torch.int8)
    jeng = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=64, backend="xla", kv_dtype=jkv,
                                                    attn_sparsity=threshold, attn_sparsity_blocks=(8, 8)))
    jl, jc = jeng.prefill(jnp.asarray(prompt), jeng.init_cache(2))
    eng = _engine(cm, threshold, tkv)
    cache = eng.init_cache(2)
    logits = eng.prefill(torch.from_numpy(prompt), cache)
    np.testing.assert_allclose(eng.last_prefill_keep_frac.numpy(), np.asarray(jeng.last_prefill_keep_frac),
                               rtol=0, atol=1e-6)
    assert rel_err(logits.numpy(), np.asarray(jl)) < 1e-3
    want = convert.cache_from_jax(jc)
    if tkv is None:
        assert rel_err(cache["k"].numpy(), want["k"].numpy()) < 1e-5
    else:
        assert (cache["k"] != want["k"]).float().mean() <= 1e-3
    np.testing.assert_array_equal(eng.generate(torch.from_numpy(prompt), 6).numpy(),
                                  np.asarray(jeng.generate(jnp.asarray(prompt), 6)))


def test_kernel_engine_refuses_sparsity(setup):
    _, _, cm, _ = setup
    with pytest.raises(NotImplementedError):
        _engine(cm, 1e-3, torch.int8, kv_attention_kernel=True)


def test_serve_with_threshold_matches_jax(setup):
    """`serve` inherits the sparse prefill through `prefill_into_slot`:
    requests of 19, 21 and 23 tokens (tiles of 1 by the halving rule) over
    int8 pages, prefix cache on, give JAX's tokens."""
    _, jcm, cm, _ = setup
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 256, size=(16,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 256, size=(3 + 2 * i,)).astype(np.int32)]) for i in range(3)]
    geom = dict(n_pages=48, page_size=8, max_slots=2, max_pages_per_seq=8)

    def requests(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(zip(prompts, (9, 3, 5)))]

    je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=64, backend="xla", kv_dtype=jnp.int8,
                                                  attn_sparsity=0.5, attn_sparsity_blocks=(8, 8)))
    te = _engine(cm, 0.5, torch.int8)
    jo = je.serve(requests(jsched.Request), prefix_cache=True, **geom)
    to = te.serve(requests(tsched.Request), prefix_cache=True, **geom)
    assert to == {k: [int(t) for t in v] for k, v in jo.items()}
    assert te.last_prefill_keep_frac is not None


@pytest.mark.cuda
def test_sparse_prefill_kernel_matches_plain_on_card(setup, cuda_device):
    """The einsum engine on the card, skip-softmax kernel against its plain
    version: equal keep fractions, logits within 1e-5 of their scale, and
    one launch a layer. The model is f32, so both engines run the INT4 GEMM's
    plain version (its kernel takes bf16 activations)."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import sparse_attention

    cfg, jcm, _, prompt = setup
    cm = convert.compressed_from_jax(jcm, device=cuda_device)
    p = torch.from_numpy(prompt).to(cuda_device)
    for th in (1e-30, 1e-2, 0.999999):
        ek = _engine(cm, th, device=cuda_device, plain_ops=("int4_wo",))
        ep = _engine(cm, th, device=cuda_device, plain_ops=("int4_wo", "skip_softmax"))
        n0 = sparse_attention.launches
        lk = ek.prefill(p, ek.init_cache(2))
        assert sparse_attention.launches - n0 == cfg.num_hidden_layers
        lp = ep.prefill(p, ep.init_cache(2))
        assert torch.equal(ek.last_prefill_keep_frac, ep.last_prefill_keep_frac)
        assert rel_err(lk.cpu().numpy(), lp.cpu().numpy()) < 1e-5
