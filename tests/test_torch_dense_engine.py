"""The port's dense-cache einsum engine (`kv_attention_kernel=False`, the
default `EngineConfig`) against the JAX engine (`backend="xla"`) on a tiny
f32 Llama wide enough for whole 128-blocks of INT4 weights, carried across by
`convert.py`: the KV store and load on the same inputs, the cache a prefill
writes, prefill logits and greedy tokens for every stored form (model dtype,
int8, fp8, packed NVFP4, "nvfp4_fake"), `serve` over pages filled from this
engine, and `compress_bf16`.

The f32 sums of the two packages run in another order, so k/v reach the
store a few f32 ulps apart and now and then land on the other side of a
rounding boundary of a quantized code: the caches are held bit-equal but for
such codes (at most 1 in 1000), the store functions themselves bit-equal on
the same inputs. Logits: 1e-3 of their scale, as `test_torch_engine.py`."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu.serve import paged_cache as jpc
from tensorrt_model_optimizer_tpu.serve import scheduler as jsched
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.serve import paged_cache as tpc
from tensorrt_model_optimizer_tpu_torch.serve import scheduler as tsched

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)
KV = {  # label -> (JAX kv_dtype, port kv_dtype)
    "model_dtype": (None, None),
    "int8": (jnp.int8, torch.int8),
    "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
    "nvfp4": ("nvfp4", "nvfp4"),
    "nvfp4_fake": ("nvfp4_fake", "nvfp4_fake"),
}
SERVE = dict(n_pages=48, page_size=8, max_slots=2, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    pnp = llama_params_np(jcfg, seed=0)
    jcm = jcompress.compress(jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"))
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    return jcfg, pnp, jcm, convert.compressed_from_jax(jcm), prompt


def _bits(t: torch.Tensor) -> torch.Tensor:
    """An integer view of a cache (fp8 and bf16 bytes compare as integers)."""
    if t.dtype in (torch.float8_e4m3fn, torch.uint8, torch.int8):
        return t.view(torch.uint8).to(torch.int32)
    return t.float()


def _held_cache(got: dict, want: dict, label: str):
    assert got["pos"] == want["pos"]
    for name in ("k", "v"):
        a, b = got[name], want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
        if label == "model_dtype":  # plain f32 values
            assert rel_err(a.numpy(), b.numpy()) < 1e-5
        else:
            assert (_bits(a) != _bits(b)).float().mean() <= 1e-3, name


@pytest.mark.parametrize("label", list(KV))
def test_einsum_engine_matches_jax(setup, label):
    _, _, jcm, cm, prompt = setup
    jkv, tkv = KV[label]
    jeng = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=32, backend="xla", kv_dtype=jkv))
    jl, jc = jeng.prefill(jnp.asarray(prompt), jeng.init_cache(2))
    jtoks = np.asarray(jeng.generate(jnp.asarray(prompt), 8))
    eng = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=32, kv_dtype=tkv), device="cpu")
    cache = eng.init_cache(2)
    logits = eng.prefill(torch.from_numpy(prompt), cache)
    want = convert.cache_from_jax(jc)
    assert set(cache) == set(want) == {"k", "v", "pos"}
    if label == "nvfp4":  # one uint8 row of 9 hd / 16 bytes
        assert cache["k"].shape[-1] == 9 * 32 // 16 and cache["k"].dtype == torch.uint8
    _held_cache(cache, want, label)
    assert rel_err(logits.numpy(), np.asarray(jl)) < 1e-3
    np.testing.assert_array_equal(eng.generate(torch.from_numpy(prompt), 8).numpy(), jtoks)
    assert eng.last_prefill_keep_frac is None  # dense prefill


@pytest.mark.parametrize("label", list(KV))
def test_kv_store_and_load_match_jax(label):
    """The stored form and its dequantized values, bit for bit, on the same
    inputs (amax 3.5 per layer, and the uncalibrated 448)."""
    jkv, tkv = KV[label]
    x = (np.random.default_rng(4).standard_normal((2, 5, 2, 32)) * 1.5).astype(np.float32)
    for amax in (3.5, 448.0):
        js = jengine._kv_store(jnp.asarray(x), jkv, jnp.asarray(amax, jnp.float32))
        ts = tengine._kv_store(torch.from_numpy(x), tkv, torch.tensor(amax))
        assert torch.equal(_bits(ts), _bits(convert.tensor_from_array(js)))
        jl = jengine._kv_load(js, jnp.float32, jkv, jnp.asarray(amax, jnp.float32))
        tl = tengine._kv_load(ts, torch.float32, tkv, torch.tensor(amax))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_default_config_serves(setup):
    """`Engine(cm)` with the default `EngineConfig()` (einsum engine, model
    dtype cache of 2048 rows) generates JAX's tokens."""
    _, _, jcm, cm, prompt = setup
    assert not tengine.EngineConfig().kv_attention_kernel
    jtoks = np.asarray(jengine.Engine(jcm, jengine.EngineConfig()).generate(jnp.asarray(prompt), 4))
    eng = tengine.Engine(cm, device="cpu")
    assert eng.init_cache(1)["k"].shape == (2, 1, 2048, 2, 32)
    np.testing.assert_array_equal(eng.generate(torch.from_numpy(prompt), 4).numpy(), jtoks)


def test_compress_bf16_matches_jax(setup):
    """Raw weights wrapped as bf16-kind sites, served by both engines."""
    jcfg, pnp, _, _, prompt = setup
    jcm = jcompress.compress_bf16(jcfg, tree_map(jnp.asarray, pnp))
    cm = tcompress.compress_bf16(tllama.LlamaConfig.tiny(**DIMS), tree_map(torch.from_numpy, pnp))
    assert cm.kinds == jcm.kinds and set(cm.kinds.values()) == {"bf16"} and cm.qstate == {}
    for name in cm.kinds:
        np.testing.assert_array_equal(cm.params["layers"][name]["w"].numpy(),
                                      np.asarray(jcm.params["layers"][name]["w"]))
    jeng = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=32, backend="xla"))
    jl, _ = jeng.prefill(jnp.asarray(prompt), jeng.init_cache(2))
    eng = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=32), device="cpu")
    assert rel_err(eng.prefill(torch.from_numpy(prompt), eng.init_cache(2)).numpy(), np.asarray(jl)) < 1e-3
    np.testing.assert_array_equal(eng.generate(torch.from_numpy(prompt), 8).numpy(),
                                  np.asarray(jeng.generate(jnp.asarray(prompt), 8)))


def _requests(cls):
    """Three requests of unequal length behind a 16-token shared prefix."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 256, size=(16,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 256, size=(3 + 2 * i,)).astype(np.int32)]) for i in range(3)]
    return [cls(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(zip(prompts, (9, 3, 5)))]


@pytest.mark.parametrize("label", ["int8", "nvfp4"])
def test_serve_over_einsum_pages_matches_jax(setup, label):
    """`serve` with this engine's dense prefills copied into int8 pages and
    into packed NVFP4 pages (the one-row form split into nibble planes and
    E4M3 scale bytes), prefix cache on: JAX's tokens."""
    _, _, jcm, cm, _ = setup
    jkv, tkv = KV[label]
    je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=64, backend="xla", kv_dtype=jkv))
    te = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=64, kv_dtype=tkv), device="cpu")
    jo = je.serve(_requests(jsched.Request), prefix_cache=True, **SERVE)
    to, m = te.serve(_requests(tsched.Request), prefix_cache=True, collect_metrics=True, **SERVE)
    assert to == {k: [int(t) for t in v] for k, v in jo.items()}
    assert (m["dense_prefills"], m["chunked_prefills"]) == (2, 1)


@pytest.mark.parametrize("label,packed,kernel", [("int8", False, False), ("fp8", False, False),
                                                 ("nvfp4", True, False), ("nvfp4", False, False),
                                                 ("nvfp4", False, True)],
                         ids=["int8", "fp8", "nvfp4_packed_pool", "nvfp4_grid_value_pool",
                              "nvfp4_grid_value_pool_kernel_engine"])
def test_prefill_into_slot_pages_match_jax(setup, label, packed, kernel):
    """The pages `prefill_into_slot` fills from the einsum cache (with
    `kernel`: from the kernel engine's kv-head-major cache of NVFP4 planes),
    against JAX's: int8 and fp8 rows copied, packed NVFP4 rows split into
    planes and scale bytes, and an unpacked pool under an NVFP4 cache given
    the rows' grid values. There the packages differ on purpose: with no
    calibrated KV amax the rows were stored under the engine's default amax
    448 (global scale 448 / 2688), which the port decodes them with, while
    JAX decodes them with the global scale 1 of an absent amax: its pages
    hold 6x the values its own cache holds, in both engines."""
    jcfg, _, jcm, cm, _ = setup
    jkv, tkv = KV[label]
    if kernel:
        je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=64, backend="pallas", kv_dtype=jkv,
                                                      kv_attention_kernel=True))
        te = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=64, kv_dtype=tkv, kv_attention_kernel=True),
                            device="cpu")
    else:
        je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=64, backend="xla", kv_dtype=jkv))
        te = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=64, kv_dtype=tkv), device="cpu")
    prompt = np.random.default_rng(9).integers(0, 256, size=(1, 21)).astype(np.int32)
    table = np.full((2, 8), -1, np.int32)
    table[0, :3] = [4, 1, 6]
    L, nkv, hd = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.hd
    if packed or label != "nvfp4":
        jc, tc = je.init_paged_cache(**SERVE), te.init_paged_cache(**SERVE)
    else:
        jc = jpc.init_paged(L, SERVE["n_pages"], 8, nkv, hd, 2, 8, jnp.float32)
        tc = tpc.init_paged(L, SERVE["n_pages"], 8, nkv, hd, 2, 8, torch.float32)
    assert tc.packed_nvfp4 == packed
    jc = dataclasses.replace(jc, block_table=jnp.asarray(table))
    tc.block_table = torch.from_numpy(table.copy())
    jl, jc = je.prefill_into_slot(jc, 0, jnp.asarray(prompt))
    tl = te.prefill_into_slot(tc, 0, torch.from_numpy(prompt))
    assert rel_err(tl.numpy(), np.asarray(jl)) < 1e-3
    jc = convert.paged_from_jax(jc)
    assert tc.seq_lens.tolist() == jc.seq_lens.tolist() == [21, 0]
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(tc, name), getattr(jc, name)
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:  # grid values of the same codes
            assert ((a - b * (448.0 / 2688.0)).abs() > 1e-6 * b.abs()).float().mean() <= 1e-3
        else:
            assert (_bits(a) != _bits(b)).float().mean() <= 1e-3
        assert bool((a[:, [4, 1, 6]] != 0).any())


def test_engine_refuses_kernel_path_with_sparsity(setup):
    _, _, _, cm, _ = setup
    with pytest.raises(NotImplementedError):
        tengine.Engine(cm, tengine.EngineConfig(kv_attention_kernel=True, attn_sparsity=1e-3), device="cpu")
