"""The NVFP4 KV cache of the port against the JAX package: the two packed
forms of `ops/numerics.py` bit for bit, the `nvfp4` format of the dense
decode attention (plain version here; the CUDA kernel on a card) against
JAX's Pallas kernel in interpret mode, and the engine with `NVFP4_KV_CFG`:
dense generation and paged serving, tokens equal to the JAX engine's on an
f32 model carried across by `convert.py`."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, llama_params_np, rel_err, tree_map  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.ops import numerics as jnum
from tensorrt_model_optimizer_tpu.ops.pallas import kv_attention as jkva
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu.serve.scheduler import Request as JRequest
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.ops import numerics as tnum
from tensorrt_model_optimizer_tpu_torch.ops.cuda import kv_attention as tkva
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Request as TRequest


def _edge_input(kind):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 4, 64)) * 3).astype(np.float32)
    if kind == "edges":
        x[0, 0, :16] = 0.0                     # an all-zero block: its scale becomes 1
        x[0, 1, 16:32] = 1e-6                  # a block whose scale rounds to zero in e4m3
        x[1, 0, :8] = [0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, -5.0]  # E2M1 midpoints
        x[2, 3, 40] = 1e4                      # beyond 448 * 6 * global scale: the scale saturates
    return x


@pytest.mark.parametrize("amax", [None, 7.5, 0.0])
@pytest.mark.parametrize("kind", ["random", "edges"])
def test_nvfp4_packed_forms_bit_equal(kind, amax):
    x = _edge_input(kind)
    ja = None if amax is None else jnp.asarray(amax, jnp.float32)
    ta = None if amax is None else torch.tensor(amax)
    jp, js, jg = jnum.real_quant_nvfp4_planes(jnp.asarray(x), 16, ja)
    tp, ts, tg = tnum.real_quant_nvfp4_planes(torch.from_numpy(x), 16, ta)
    assert tp.dtype == torch.uint8 and ts.dtype == torch.uint8 and tp.shape == (3, 4, 32) and ts.shape == (3, 4, 4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(tg) == float(jg)
    jq, jsq, jgq = jnum.real_quant_nvfp4(jnp.asarray(x), 16, ja)
    tq, tsq, tgq = tnum.real_quant_nvfp4(torch.from_numpy(x), 16, ta)
    assert tsq.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsq.view(torch.uint8).numpy(), np.asarray(jsq).view(np.uint8))
    assert float(tgq) == float(jgq)
    np.testing.assert_array_equal(tnum.nvfp4_planes_code_load(tp, ts).numpy(),
                                  np.asarray(jnum.nvfp4_planes_code_load(jp, js)))


def test_planes_code_load_every_code_and_scale():
    """All 16 E2M1 codes under every non-negative finite E4M3 scale byte."""
    codes = np.arange(16, dtype=np.uint8)
    planes = np.tile(codes[:8] | (codes[8:] << 4), (127, 1))  # one 16-wide block a row
    sbits = np.arange(127, dtype=np.uint8)[:, None]
    got = tnum.nvfp4_planes_code_load(torch.from_numpy(planes), torch.from_numpy(sbits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnum.nvfp4_planes_code_load(jnp.asarray(planes), jnp.asarray(sbits))))
    e2m1 = np.array([0, .5, 1, 1.5, 2, 3, 4, 6], np.float32)
    assert got[8].tolist() == (np.concatenate([e2m1, -e2m1]) * 2.0 ** -6).tolist()  # byte 0x08 is 2^-6


def test_nvfp4_kv_preset_matches_jax():
    for site in ("self_attn.k_bmm_quantizer", "self_attn.v_bmm_quantizer", "mlp.up_proj.input_quantizer",
                 "self_attn.q_proj.weight_quantizer", "lm_head.weight_quantizer"):
        assert tconfig.NVFP4_KV_CFG.resolve(site) == convert.quantizer_cfg_from_jax(jconfig.NVFP4_KV_CFG.resolve(site))
    assert tconfig.NVFP4_KV_CFG.resolve("self_attn.k_bmm_quantizer") == tconfig.NVFP4_BLOCK16


# ---- the nvfp4 format of the dense decode attention ----

B, N_KV, REP, HD, S = 2, 2, 4, 128, 64


def _decode_inputs(seed, hd=HD, rep=REP):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, N_KV * rep, hd)) / math.sqrt(hd)).astype(np.float32)
    g = jnp.asarray(4.0, jnp.float32)
    kc, ks, _ = (np.asarray(a) for a in jnum.real_quant_nvfp4_planes(
        jnp.asarray(rng.standard_normal((B, N_KV, S, hd)).astype(np.float32)), 16, g))
    vc, vs, _ = (np.asarray(a) for a in jnum.real_quant_nvfp4_planes(
        jnp.asarray(rng.standard_normal((B, N_KV, S, hd)).astype(np.float32)), 16, g))
    kn = rng.standard_normal((B, N_KV, 1, hd)).astype(np.float32) * 300
    vn = rng.standard_normal((B, N_KV, 1, hd)).astype(np.float32) * 300
    return (q / 300, kc, vc, kn, vn), (ks, vs)


@pytest.mark.parametrize("pos", [0, 37, S - 1])
def test_dense_decode_nvfp4_plain_matches_pallas(pos):
    args, scales = _decode_inputs(seed=pos)
    ref = np.asarray(jkva.kv_decode_attention(*[jnp.asarray(a) for a in args], jnp.asarray(pos, jnp.int32), "nvfp4",
                                              k_scales=jnp.asarray(scales[0]), v_scales=jnp.asarray(scales[1]),
                                              interpret=True))
    t = [torch.from_numpy(a) for a in args]
    out = tkva.kv_decode_attention(*t, pos, "nvfp4", *[torch.from_numpy(s) for s in scales])
    assert out.shape == (B, N_KV * REP, HD) and out.dtype == torch.float32
    # f32 throughout; 1e-5 of the output's scale: sums taken in another order
    assert rel_err(out.numpy(), ref) < 1e-5


def test_dense_decode_nvfp4_needs_its_scales():
    args, scales = _decode_inputs(seed=1)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError):
        tkva.kv_decode_attention(*t, 3, "nvfp4")
    with pytest.raises(ValueError):
        tkva.kv_decode_attention(*t, 3, "nvfp4", torch.from_numpy(scales[0])[..., :4], torch.from_numpy(scales[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,rep", [(128, 4), (64, 2), (32, 1)])
def test_dense_decode_nvfp4_kernel_matches_plain(cuda_device, hd, rep):
    args, scales = _decode_inputs(seed=7, hd=hd, rep=rep)
    t = [torch.from_numpy(a).to(cuda_device) for a in args]
    sc = [torch.from_numpy(s).to(cuda_device) for s in scales]
    for pos in (0, 1, 37, S):
        out = tkva.kv_decode_attention(*t, pos, "nvfp4", *sc)
        torch.cuda.synchronize()
        ref = tkva.kv_decode_attention_plain(*t, pos, "nvfp4", *sc)
        assert rel_err(out.cpu().numpy(), ref.cpu().numpy()) < 1e-5


# ---- the engine under NVFP4_KV_CFG ----

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)
SERVE = dict(n_pages=48, page_size=8, max_slots=2, max_pages_per_seq=8)


def _requests(cls):
    """Three requests behind a 16-token shared prefix; request 0 outlives
    request 1, so request 2 is admitted while request 0's prefix pages are
    still published and shares them."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 256, size=(16,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 256, size=(3 + 2 * i,)).astype(np.int32)]) for i in range(3)]
    return [cls(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(zip(prompts, (9, 3, 5)))]


@pytest.fixture(scope="module")
def engines():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    pnp = llama_params_np(jcfg, seed=0)
    calib = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    jm = jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), "NVFP4_KV_CFG", [jnp.asarray(calib)])
    jcm = jcompress.compress(jm)

    def pair(kv_j=None, kv_t=None, **kw):
        je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=64, backend="pallas", kv_dtype=kv_j,
                                                      kv_attention_kernel=True, **kw))
        te = tengine.Engine(convert.compressed_from_jax(jcm), tengine.EngineConfig(
            max_seq_len=64, kv_dtype=kv_t, kv_attention_kernel=True, **kw), device="cpu")
        return je, te

    return jcfg, pnp, calib, jm, pair


def test_nvfp4_kbmm_site_selects_packed_cache(engines):
    *_, pair = engines
    je, te = pair()
    assert je.ecfg.kv_dtype == "nvfp4" and te.ecfg.kv_dtype == "nvfp4"
    cache = te.init_cache(2, 16)
    assert cache["k"].shape == (2, 2, 2, 16, 16) and cache["k"].dtype == torch.uint8
    assert cache["ks"].shape == (2, 2, 2, 16, 2) and cache["vs"].dtype == torch.uint8
    # the calibrated k_bmm / v_bmm amax came across with the model
    np.testing.assert_array_equal(te._ka.numpy(), np.asarray(jengine._kv_amax_from(je.cm.qstate, "k")))
    np.testing.assert_array_equal(te._va.numpy(), np.asarray(jengine._kv_amax_from(je.cm.qstate, "v")))


def test_port_ptq_collects_the_kv_amax(engines):
    jcfg, pnp, calib, jm, _ = engines
    tm = tptq.quantize(tllama.LlamaConfig.tiny(**DIMS), tree_map(torch.from_numpy, pnp), "NVFP4_KV_CFG",
                       [torch.from_numpy(calib)], device="cpu")
    for site in ("self_attn.k_bmm", "self_attn.v_bmm"):
        np.testing.assert_allclose(tm.qstate[site].amax.numpy(), np.asarray(jm.qstate[site].amax), rtol=1e-5)


def test_dense_generate_matches_jax(engines):
    *_, pair = engines
    je, te = pair()
    prompt = np.random.default_rng(4).integers(0, 256, size=(2, 8)).astype(np.int32)
    jc, tc = je.init_cache(2), te.init_cache(2)
    jl, jc = je.prefill(jnp.asarray(prompt), jc)
    tl = te.prefill(torch.from_numpy(prompt), tc)
    assert rel_err(tl.numpy(), np.asarray(jl)) < 1e-3  # f32 model, sums in another order
    # the cache rows the prefill wrote, through convert's helper: E2M1 codes
    # and E4M3 scale bytes are rounded values, so nearly all are bit-equal
    jc = convert.cache_from_jax(jc)
    assert jc["pos"] == tc["pos"] == 8
    for key in ("k", "v", "ks", "vs"):
        assert (jc[key][:, :, :, :8] == tc[key][:, :, :, :8]).float().mean() > 0.995
    np.testing.assert_array_equal(te.generate(torch.from_numpy(prompt), 8).numpy(),
                                  np.asarray(je.generate(jnp.asarray(prompt), 8)))


@pytest.mark.parametrize("unroll", [1, 4])
def test_serve_nvfp4_pages_matches_jax(engines, unroll):
    *_, pair = engines
    je, te = pair(paged_attention_kernel=True)
    jo = je.serve(_requests(JRequest), prefix_cache=True, unroll=unroll, **SERVE)
    to, m = te.serve(_requests(TRequest), prefix_cache=True, unroll=unroll, collect_metrics=True, **SERVE)
    assert to == {k: [int(t) for t in v] for k, v in jo.items()}
    assert [len(to[i]) for i in range(3)] == [9, 3, 5]
    assert m["chunked_prefills"] == 1 and m["dense_prefills"] == 2 and m["free_pages"] == SERVE["n_pages"] - 1


def test_serve_nvfp4_gather_path_matches_jax(engines):
    *_, pair = engines
    je, te = pair(paged_attention_kernel=False)
    jo = je.serve(_requests(JRequest), prefix_cache=True, **SERVE)
    to = te.serve(_requests(TRequest), prefix_cache=True, **SERVE)
    assert to == {k: [int(t) for t in v] for k, v in jo.items()}


def test_serve_nvfp4_fake_pages_matches_jax(engines):
    """`kv_dtype="nvfp4_fake"`: fake-quantized values in pages of the model
    dtype, read as plain values."""
    *_, pair = engines
    je, te = pair("nvfp4_fake", "nvfp4_fake", paged_attention_kernel=True)
    cache = te.init_paged_cache(**SERVE)
    assert cache.k_pages.dtype == torch.float32 and not cache.packed_nvfp4
    jo = je.serve(_requests(JRequest), **SERVE)
    to = te.serve(_requests(TRequest), **SERVE)
    assert to == {k: [int(t) for t in v] for k, v in jo.items()}


def test_packed_pages_after_prefill_match_jax(engines):
    *_, pair = engines
    je, te = pair(paged_attention_kernel=True)
    prompt = np.random.default_rng(6).integers(0, 256, size=(1, 21)).astype(np.int32)
    bt = np.full((2, 8), -1, np.int32)
    bt[0, :5] = [1, 2, 3, 4, 5]
    bt[1, :] = 0
    import dataclasses
    jc = dataclasses.replace(je.init_paged_cache(**SERVE), block_table=jnp.asarray(bt))
    tc = te.init_paged_cache(**SERVE)
    tc.block_table = torch.from_numpy(bt)
    jl, jc = je.prefill_into_slot(jc, 0, jnp.asarray(prompt))
    tl = te.prefill_into_slot(tc, 0, torch.from_numpy(prompt))
    assert rel_err(tl.numpy(), np.asarray(jl)) < 1e-3
    jc = convert.paged_from_jax(jc)
    assert jc.packed_nvfp4 and tc.packed_nvfp4 and jc.seq_lens.tolist() == tc.seq_lens.tolist() == [21, 0]
    for a, b in ((jc.k_pages, tc.k_pages), (jc.v_pages, tc.v_pages), (jc.k_scales, tc.k_scales),
                 (jc.v_scales, tc.v_scales)):
        assert a.dtype == b.dtype == torch.uint8 and a.shape == b.shape
        assert (a[:, 1:6] == b[:, 1:6]).float().mean() > 0.995
        assert not b[:, 6:].any()  # only the slot's pages were written
