"""The port's tensor-, expert- and data-parallel engine on gloo ranks (CPU)
against JAX's tensor-parallel engine and the port's single-process engine:
JAX's tests/test_tp_engine.py case for case.

Every case is served by the port's engine in this process and on 4 gloo
ranks launched once for the whole file (`_torch_tp.engine_cases`; a tp=2
case runs on a ("rep", "tp") mesh of 2 x 2, every pair computing the same):
greedy tokens equal, and the ranks' prefill logits within 1e-5 of the
single-process logits' scale (row-parallel partial sums are added in
another order; measured ~2e-7). Where JAX's engine runs too, under a mesh
of its virtual CPU devices while the ranks work, the model is the JAX
package's (its PTQ and compress, carried across) and the tokens are equal
three ways: W8A8 (the per-token amax MAX), FP8 with and without an fp8
cache, AWQ (pre_quant_scale sharded on K), W4A8, Mixtral's and Llama4's
expert parallelism (Llama4's chunks and shared expert), DP x TP and the
split row sites. JAX's engine compiles each of these for seconds on the
CPU, so the other cases (INT4 and NVFP4 weight-only at tp 2 and 4, paged
serving at tp 2 and at dp 2 x tp 2, the layout matrix, Mixtral under NVFP4, GPT-OSS's sinks and
windows) run on the port's own PTQ of the same weights and are held to the
single-process engine, whose tokens the single-device parity tests hold to
JAX's. Port-only cases: the kernel-attention engine over int8 and packed
NVFP4 caches, W4A8 with the per-token amax MAX left out (its logits must
leave the single-process ones), and the `i8` refusal beside JAX's silent
word2 substitution."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_tp
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import llama
from tensorrt_model_optimizer_tpu.quant import compress, ptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu.serve.scheduler import Request as JRequest
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq

LOGITS_REL = 1e-5
PRESETS = ["INT8_DEFAULT_CFG", "FP8_DEFAULT_CFG", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "NVFP4_DEFAULT_CFG",
           "INT4_AWQ_CFG"]
JAX_PRESETS = ("INT8_DEFAULT_CFG", "FP8_DEFAULT_CFG", "INT4_AWQ_CFG")  # the dense cases JAX's engine runs on
MATRIX = [("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "int4_layout", l) for l in ("blockdot", "word", "word2", "bd2", "xla")] + \
         [("NVFP4_DEFAULT_CFG", "nvfp4_layout", l) for l in ("blockdot", "perm", "word", "word2")]
PAGED = ((5, 3, 6, 5), dict(n_pages=32, page_size=8, max_slots=2, max_pages_per_seq=8))
AXES = {2: {"rep": 2, "tp": 2}, 4: {"tp": 4}}


def _tiny(**kw):
    cfg = llama.LlamaConfig.tiny(**kw)
    return cfg, llama.init_params(cfg, jax.random.PRNGKey(0))


def _batches(seed):
    return [jnp.asarray(np.random.default_rng(seed).integers(0, 256, size=(2, 16)))]


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


def _jax_tp(jcm, ecfg: dict, prompt, n, d, dp=False, serve=None):
    """JAX's engine under a mesh of d devices ("tp"), or of 2 x 2 ("dp", "tp")."""
    devs = np.array(jax.devices()[:d])
    mesh = Mesh(devs.reshape(2, 2), ("dp", "tp")) if dp else Mesh(devs, ("tp",))
    kw = {k: (jnp.float8_e4m3fn if v is torch.float8_e4m3fn else v) for k, v in ecfg.items()}
    eng = jengine.Engine(jcm, jengine.EngineConfig(mesh=mesh, **({"dp_axis": "dp"} if dp else {}), **kw))
    if serve is not None:
        (seed, count, base, new), skw = serve
        rng = np.random.default_rng(seed)
        reqs = [JRequest(rid=i, prompt=rng.integers(0, 256, size=(base + i,)), max_new_tokens=new)
                for i in range(count)]
        return {k: list(v) for k, v in eng.serve(reqs, **skw).items()}
    return np.asarray(eng.generate(jnp.asarray(prompt), max_new_tokens=n))


def _moe_jcm(preset, gpt_oss=False):
    if gpt_oss:
        from tensorrt_model_optimizer_tpu.models import gpt_oss as fam

        cfg = fam.GptOssConfig.tiny(capacity_factor=4.0, sliding_window=4)
    else:
        from tensorrt_model_optimizer_tpu.models import mixtral as fam

        cfg = fam.MixtralConfig.tiny(qk_norm=True, capacity_factor=4.0)
    params = fam.init_params(cfg, jax.random.PRNGKey(9))
    if gpt_oss:
        layers = dict(params["layers"])
        layers["self_attn.sinks"] = jnp.asarray(
            np.random.default_rng(2).normal(size=layers["self_attn.sinks"].shape), cfg.dtype)
        params = {**params, "layers": layers}
    batches = _batches(15)
    jcm = compress.compress(ptq.quantize_family("gpt_oss" if gpt_oss else "mixtral", cfg, params, preset, batches))
    return jcm, np.asarray(batches[0][:, :8]).astype(np.int32)


def _port_cm(family, tcfg, tparams, preset, batches):
    """The port's own PTQ and compress (the cases JAX's engine is not run on)."""
    tb = [torch.from_numpy(np.array(b)) for b in batches]
    if family == "llama":
        return tcompress.compress(tptq.quantize(tcfg, tparams, preset, tb, device="cpu"))
    return tcompress.compress(tptq.quantize_family(family, tcfg, tparams, preset, tb, device="cpu"))


def _cases():
    """name -> (case for the ranks, JAX's reference: a thunk or None). The
    cases JAX's reference runs on are built by the JAX package (its PTQ and
    compress, carried across); the others by the port from the same
    weights."""
    cases = {}

    def add(name, cm, ecfg, prompt, n, d=2, dp=False, serve=None, jcm=None, mode=None):
        axes = {"dp": 2, "tp": 2} if dp else AXES[d]
        case = dict(cm=convert.compressed_from_jax(jcm) if jcm is not None else cm,
                    ecfg=dict(ecfg, **({"dp_axis": "dp"} if dp else {})), axes=axes, prompt=prompt, n=n,
                    serve=serve, mode=mode)
        ref = (lambda: _jax_tp(jcm, ecfg, prompt, n, d, dp, serve)) if jcm is not None else None
        cases[name] = (case, ref)

    cfg, params = _tiny()
    tcfg, tparams = convert.llama_cfg_from_jax(cfg), convert.params_from_jax(params)
    jcms = {p: compress.compress(ptq.quantize(cfg, params, p, _batches(1))) for p in JAX_PRESETS}
    cms = {p: _port_cm("llama", tcfg, tparams, p, _batches(1)) for p in PRESETS if p not in JAX_PRESETS}
    for p in PRESETS:  # test_dense_generate_parity
        add(f"dense_{p}", cms.get(p), dict(max_seq_len=64), _prompt(3, (2, 12)), 8, jcm=jcms.get(p))
    wcfg, wparams = _tiny(num_attention_heads=8, num_key_value_heads=4, hidden_size=128, intermediate_size=256)
    add("dense_tp4", _port_cm("llama", convert.llama_cfg_from_jax(wcfg), convert.params_from_jax(wparams),
                              "NVFP4_DEFAULT_CFG", _batches(1)), dict(max_seq_len=64), _prompt(3, (1, 9)), 8, d=4)
    add("paged", cms["NVFP4_DEFAULT_CFG"], dict(max_seq_len=64), None, 0, serve=PAGED)
    add("paged_dp2_tp2", cms["NVFP4_DEFAULT_CFG"], dict(max_seq_len=64), None, 0, d=4, dp=True, serve=PAGED)
    add("kv_fp8", None, dict(max_seq_len=64, kv_dtype=torch.float8_e4m3fn), _prompt(7, (1, 8)), 8,
        jcm=jcms["FP8_DEFAULT_CFG"])
    for preset, key, layout in MATRIX:  # TestLayoutMeshBackendMatrix
        add(f"matrix_{key}_{layout}", cms[preset], {"max_seq_len": 48, key: layout}, _prompt(11, (2, 10)), 6)
    acfg = llama.LlamaConfig.tiny(hidden_size=128, intermediate_size=256)
    abatches = [jnp.asarray(np.random.default_rng(6).integers(0, 256, size=(2, 16)))]
    a8 = compress.compress(ptq.quantize(acfg, llama.init_params(acfg, jax.random.PRNGKey(5)),
                                        "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", abatches))
    aprompt = np.asarray(abatches[0][:, :8]).astype(np.int32)
    add("a8", None, dict(max_seq_len=48, int4_layout="a8"), aprompt, 6, jcm=a8)
    from tensorrt_model_optimizer_tpu.models import mixtral

    mcfg = mixtral.MixtralConfig.tiny(qk_norm=True, capacity_factor=4.0)
    mparams = mixtral.init_params(mcfg, jax.random.PRNGKey(9))
    mprompt = np.asarray(_batches(15)[0][:, :8]).astype(np.int32)
    add("mixtral_INT8_DEFAULT_CFG", None, dict(max_seq_len=48), mprompt, 8,
        jcm=compress.compress(ptq.quantize_family("mixtral", mcfg, mparams, "INT8_DEFAULT_CFG", _batches(15))))
    add("mixtral_NVFP4_DEFAULT_CFG", _port_cm("mixtral", convert.llama_cfg_from_jax(mcfg),
                                              convert.params_from_jax(mparams), "NVFP4_DEFAULT_CFG", _batches(15)),
        dict(max_seq_len=48), mprompt, 8)
    from tensorrt_model_optimizer_tpu.models import gpt_oss

    gcfg = gpt_oss.GptOssConfig.tiny(capacity_factor=4.0, sliding_window=4)
    gparams = gpt_oss.init_params(gcfg, jax.random.PRNGKey(9))
    gparams["layers"] = dict(gparams["layers"])
    gparams["layers"]["self_attn.sinks"] = jnp.asarray(
        np.random.default_rng(2).normal(size=gparams["layers"]["self_attn.sinks"].shape), gcfg.dtype)
    add("gpt_oss", _port_cm("gpt_oss", convert.llama_cfg_from_jax(gcfg), convert.params_from_jax(gparams),
                            "MXFP4_DEFAULT_CFG", _batches(15)), dict(max_seq_len=48), mprompt, 8)
    from tensorrt_model_optimizer_tpu.models import llama4

    l4cfg = llama4.Llama4Config.tiny(capacity_factor=4.0, attention_chunk_size=4, floor_scale=4.0)
    l4b = [jnp.asarray(np.random.default_rng(27).integers(0, 256, size=(2, 16)))]
    l4 = compress.compress(ptq.quantize_family("llama4", l4cfg, llama4.init_params(l4cfg, jax.random.PRNGKey(27)),
                                               "INT8_DEFAULT_CFG", l4b))
    add("llama4", None, dict(max_seq_len=48), np.asarray(l4b[0][:, :8]).astype(np.int32), 5, jcm=l4)
    add("dp2_tp2", None, dict(max_seq_len=48), _prompt(21, (2, 10)), 8, d=4, dp=True, jcm=jcms["INT8_DEFAULT_CFG"])
    add("overlap", None, dict(max_seq_len=48, overlap_collectives=True), _prompt(22, (2, 10)), 8,
        jcm=jcms["INT8_DEFAULT_CFG"])
    # port only: the kernel-attention engine (int8 and packed NVFP4 caches),
    # the einsum engine over packed NVFP4, W4A8 without the amax MAX, i8
    a8cm = cases["a8"][0]["cm"]
    kv8 = dict(max_seq_len=48, int4_layout="a8", kv_attention_kernel=True, kv_dtype=torch.int8)
    add("kernel_int8_kv", a8cm, kv8, aprompt, 6)
    nv = cms["NVFP4_DEFAULT_CFG"]
    add("kernel_nvfp4_kv", nv, dict(max_seq_len=48, kv_attention_kernel=True, kv_dtype="nvfp4"), _prompt(3, (2, 12)), 6)
    add("einsum_nvfp4_kv", nv, dict(max_seq_len=48, kv_dtype="nvfp4"), _prompt(3, (2, 12)), 6)
    add("a8_no_max", a8cm, dict(max_seq_len=48, int4_layout="a8"), aprompt, 6, mode="no_max")
    add("i8", nv, dict(max_seq_len=64, nvfp4_layout="i8"), None, 0, mode="refuse_i8")
    i8_ref = compress.compress(ptq.quantize(cfg, params, "NVFP4_WEIGHT_ONLY_CFG"))
    return cases, i8_ref


def _single(case):
    if case["mode"] == "refuse_i8":
        return None
    ecfg = {k: v for k, v in case["ecfg"].items() if k != "dp_axis"}
    return _torch_tp.run_engine(case["cm"], ecfg, case["prompt"], case["n"], serve=case["serve"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(cases, single-process results, each rank's results, JAX's), the
    ranks launched while JAX's references compute."""
    from tensorrt_model_optimizer_tpu.ops.pallas import qmm

    qmm._bitcast_order_i8()  # JAX's probe, run once outside a trace (its w48 pack calls it inside lax.map)
    cases, nvfp4 = _cases()
    ranks = {}

    def go():
        try:
            ranks["out"] = _torch_tp.launch(_torch_tp.engine_cases, 4, tmp_path_factory.mktemp("tp"),
                                            [(k, c) for k, (c, _) in cases.items()])
        except Exception as e:  # re-raised in the test process below
            ranks["error"] = e

    t = threading.Thread(target=go)
    t.start()
    try:
        jax_out = {k: ref() for k, (_, ref) in cases.items() if ref is not None}
        i8_pair = tuple(_jax_tp(nvfp4, dict(max_seq_len=64, nvfp4_layout=lay), _prompt(3, (2, 12)), 4, 2)
                        for lay in ("i8", "word2"))
        single = {k: _single(c) for k, (c, _) in cases.items()}
    finally:
        t.join()
    if "error" in ranks:
        raise ranks["error"]
    return cases, single, ranks["out"], jax_out, i8_pair


NAMES = ([f"dense_{p}" for p in PRESETS] + ["dense_tp4", "kv_fp8"] + [f"matrix_{k}_{l}" for _, k, l in MATRIX]
         + ["a8", "mixtral_INT8_DEFAULT_CFG", "mixtral_NVFP4_DEFAULT_CFG", "gpt_oss", "llama4", "dp2_tp2", "overlap"])


@pytest.mark.parametrize("name", NAMES)
def test_tp_tokens_equal_jax_tp_and_single(runs, name):
    cases, single, ranks, jax_out, _ = runs
    logits1, toks1 = single[name]
    if name in jax_out:
        np.testing.assert_array_equal(toks1, jax_out[name])
    for rank in ranks:
        logits, toks = rank[name]
        np.testing.assert_array_equal(toks, toks1)
        assert rel_err(logits, logits1) < LOGITS_REL


@pytest.mark.parametrize("name", ["paged", "paged_dp2_tp2"])
def test_paged_serve_equal_single(runs, name):
    """`serve` at tp 2, and at dp 2 x tp 2 (each replica every other request,
    half the pages and slots, its own scheduler): the single process's tokens."""
    _, single, ranks, _, _ = runs
    for rank in ranks:
        assert rank[name] == single[name]


@pytest.mark.parametrize("name", ["kernel_int8_kv", "kernel_nvfp4_kv", "einsum_nvfp4_kv"])
def test_port_only_paths_equal_single(runs, name):
    """The kernel-attention engine and packed NVFP4 caches: tokens equal.
    The NVFP4 caches' logits are not held at LOGITS_REL: a row-parallel
    SUM's one-ulp difference in the residual reaches the next layer's k / v,
    and where a value lies at an E2M1 rounding edge its code flips (one
    grid step, up to a third of the value): 0.05 of the logits' scale on
    one row of this prompt, as JAX's TP engine would show (its psum adds in
    another order too)."""
    _, single, ranks, _, _ = runs
    logits1, toks1 = single[name]
    for rank in ranks:
        logits, toks = rank[name]
        np.testing.assert_array_equal(toks, toks1)
        if "nvfp4" not in name:
            assert rel_err(logits, logits1) < LOGITS_REL


def test_row_sites_need_the_amax_max(runs):
    """W4A8 row-parallel sites with each shard's own per-token amax: the
    logits leave the single-process ones (with the MAX: within LOGITS_REL)."""
    _, single, ranks, _, _ = runs
    logits1, _ = single["a8"]
    for rank in ranks:
        assert rel_err(rank["a8"][0], logits1) < LOGITS_REL
        assert rel_err(rank["a8_no_max"][0], logits1) > 100 * LOGITS_REL


def test_i8_refused_where_jax_serves_word2(runs):
    """JAX's TP engine serves nvfp4_layout="i8" as word2 (its tokens are
    word2's); the port refuses i8 under a mesh."""
    _, _, ranks, _, (i8, word2) = runs
    np.testing.assert_array_equal(i8, word2)
    assert all(rank["i8"] == "NotImplementedError" for rank in ranks)
