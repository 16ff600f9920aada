"""The port's MoE serving against the JAX package's engine (Pallas kernels in
interpret mode) on the trained `artifacts/anchor-moe`: `compress` packs
expert stacks [L, E, O, K] bit-equal to JAX's per expert, and the int8-KV
kernel-attention engine's greedy tokens equal JAX's for one model whose
sites take every served format: INT4 (q/k/v, the experts' gate), NVFP4
(o_proj, the experts' up) and FP8 (the experts' down), under the default
layouts and under "a8" (W4A8 where JAX takes w48: the INT4 sites). Paged
serving over int8 pages gives the dense engine's tokens. On a tiny
8-expert model decode runs at capacity C = max(int(2 S k / E), 1) = 1 and
drops every repeated pick of an expert: the port keeps and drops the pairs
JAX's dispatch keeps and drops, and its tokens equal JAX's. Three JAX
engines in all, each built once per module."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, tree_map  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu.models import hf_loader as jload
from tensorrt_model_optimizer_tpu.models import mixtral as jmix
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import hf_loader as tload
from tensorrt_model_optimizer_tpu_torch.models import mixtral as tmix
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Request
from tensorrt_model_optimizer_tpu_torch.utils import synthlang

ANCHOR = os.path.join(os.path.dirname(__file__), "..", "artifacts", "anchor-moe")
NEW = 4  # greedy tokens


def _mixed(cfgmod):
    """INT4 weights everywhere, NVFP4 on o_proj and the experts' up, FP8 on
    the experts' down (weight-only)."""
    return cfgmod.INT4_BLOCKWISE_WEIGHT_ONLY_CFG.with_rules({
        "*o_proj.weight_quantizer": cfgmod.NVFP4_BLOCK16, "*moe.up_proj.weight_quantizer": cfgmod.NVFP4_BLOCK16,
        "*moe.down_proj.weight_quantizer": cfgmod.FP8_PER_TENSOR})


def _bits(a):
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.element_size() == 1 else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


@pytest.fixture(scope="module")
def anchor():
    jcfg, jp = jload.load_hf_moe_checkpoint(ANCHOR, dtype=jnp.float32)
    tcfg, tp = tload.load_hf_moe_checkpoint(ANCHOR, dtype=torch.float32, device="cpu")
    calib = list(synthlang.SynthLang(0).eval_batches(1, 4, 64, seed=555))
    jm = jptq.quantize_family("mixtral", jcfg, jp, _mixed(jconfig), [jnp.asarray(b) for b in calib])
    tm = tptq.quantize_family("mixtral", tcfg, tp, _mixed(tconfig), [torch.from_numpy(b) for b in calib],
                              device="cpu")
    prompt = np.asarray(calib[0][:2, :12], np.int32)
    return jm, jcompress.compress(jm), tm, prompt


def test_compress_packs_expert_stacks_as_jax(anchor):
    jm, jcm, tm, _ = anchor
    tcm = tcompress.compress(convert.quantized_from_jax(jm))
    assert tcm.kinds == jcm.kinds and tcm.kinds["moe.up_proj"] == "nvfp4" and tcm.kinds["moe.down_proj"] == "fp8"
    for name, kind in tcm.kinds.items():
        ja, ta = jcm.params["layers"][name], tcm.params["layers"][name]
        assert set(ja) == set(ta), name
        for k in ja:
            np.testing.assert_array_equal(_bits(ta[k]), _bits(ja[k]), err_msg=f"{name}.{k}")
    assert tcm.params["layers"]["moe.gate_proj"]["packed"].shape == (6, 4, 128, 256)
    np.testing.assert_array_equal(tcm.params["layers"]["moe.router"].numpy(), np.asarray(jm.params["layers"]["moe.router"]))


def _engines(layout: str, jcm, tm):
    ecfg = dict(max_seq_len=32, kv_attention_kernel=True, int4_layout=layout)
    je = jengine.Engine(jcm, jengine.EngineConfig(backend="pallas", kv_dtype=jnp.int8, **ecfg))
    te = tengine.Engine(tcompress.compress(tm), tengine.EngineConfig(kv_dtype=torch.int8, **ecfg), device="cpu")
    return je, te


@pytest.mark.parametrize("layout,kinds", [("bd2", {"int4b2", "nvfp4w2", "fp8"}),
                                          ("a8", {"int4w48", "nvfp4w2", "fp8"})])
def test_greedy_tokens_equal_jax(anchor, layout, kinds):
    """The port calibrates, packs and serves on its own; tokens equal JAX's
    (its engine serves the INT4 sites with w48 under "a8")."""
    _, jcm, tm, prompt = anchor
    je, te = _engines(layout, jcm, tm)
    assert set(je.cm.kinds.values()) == kinds
    jt = np.asarray(je.generate(jnp.asarray(prompt), NEW))
    np.testing.assert_array_equal(te.generate(torch.from_numpy(prompt), NEW).numpy(), jt)
    if layout == "bd2":  # paged serving: each request's tokens are the dense engine's
        pe = tengine.Engine(te.cm, tengine.EngineConfig(max_seq_len=32, kv_dtype=torch.int8, kv_attention_kernel=True,
                                                        paged_attention_kernel=True), device="cpu")
        reqs = [Request(i, prompt[i % 2, : 9 + i].tolist(), 3 + i) for i in range(3)]
        out = pe.serve(reqs, n_pages=16, page_size=8, max_slots=2, max_pages_per_seq=4, prefix_cache=True)
        for r in reqs:
            dense = te.generate(torch.tensor([r.prompt]), r.max_new_tokens)[0].tolist()
            assert out[r.rid] == dense, r.rid


def test_decode_at_capacity_one_drops_what_jax_drops(monkeypatch):
    """A tiny 8-expert top-2 model at batch 2: decode runs at C = 1, so an
    expert keeps only the first of the step's pairs routed to it. At every
    step the port's kept pairs equal JAX's dispatch on the same routing,
    some pairs drop, and the tokens equal JAX's engine's (the dense-cache
    einsum engines, int8 KV: the routed FFN is the same in either engine;
    JAX's on its XLA backend)."""
    jcfg = jmix.MixtralConfig.tiny(num_experts=8, hidden_size=128, intermediate_size=128, num_hidden_layers=2)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    params = tmix.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    prompt = np.random.default_rng(4).integers(0, 256, size=(2, 8)).astype(np.int32)
    jcm = jcompress.compress(jptq.quantize_family("mixtral", jcfg, jp, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"))
    je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=16, backend="xla", kv_dtype=jnp.int8))
    jt = np.asarray(je.generate(jnp.asarray(prompt), NEW))
    seen = []
    real = tmix.dispatch_combine

    def recording(cfg, topw, topi, S, C):
        d = real(cfg, topw, topi, S, C)
        seen.append((topw.clone(), topi.clone(), S, C, d.keep.clone()))
        return d

    monkeypatch.setattr(tmix, "dispatch_combine", recording)
    tm = tptq.quantize_family("mixtral", tcfg, params, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", device="cpu")
    te = tengine.Engine(tcompress.compress(tm), tengine.EngineConfig(max_seq_len=16, kv_dtype=torch.int8),
                        device="cpu")
    seen.clear()
    np.testing.assert_array_equal(te.generate(torch.from_numpy(prompt), NEW).numpy(), jt)
    decode = [s for s in seen if s[2] == 2]
    assert len(decode) == 2 * (NEW - 1) and all(C == 1 for *_, C, _ in decode)
    dropped = 0
    for topw, topi, S, C, keep in decode:
        jd, _ = jmix.dispatch_combine(jcfg, jnp.asarray(topw.numpy()), jnp.asarray(topi.numpy()), S, C)
        kept = np.zeros((S, 8), bool)  # [S, E]: the port's kept (token, expert) pairs
        kept[np.arange(S).repeat(2), topi.reshape(-1).numpy()] = keep.numpy()
        np.testing.assert_array_equal(kept, np.asarray(jd.sum(axis=2) > 0))
        dropped += int((~keep).sum())
    assert dropped > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64, 2048])
@pytest.mark.parametrize("o,k", [(768, 2048), (2048, 768)])
def test_expert_gemm_shapes_on_the_card(cuda_device, o, k, n):
    """Qwen3-30B-A3B's expert shapes (gate/up O 768 K 2048, down O 2048 K
    768) at the rows an expert takes at decode (C = 1), a short prefill and
    the 8 x 2048 prefill (C = 2048): W4A8 bit-exact with its plain version;
    INT4 and NVFP4 weight-only per element within 2^-8 |ref| + 1e-3 rms(ref)
    of the plain version's f32 result."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm, qmm_wo

    g = torch.Generator(device=cuda_device).manual_seed(o + k + n)
    packed = torch.randint(0, 256, (o, k // 2), generator=g, device=cuda_device, dtype=torch.int32).to(torch.uint8)
    scales = (torch.rand((k // 128, o), generator=g, device=cuda_device) + 0.5).to(torch.bfloat16)
    x8 = torch.randint(-127, 128, (n, k), generator=g, device=cuda_device, dtype=torch.int32).to(torch.int8)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    want = qmm.w4a8_matmul_plain(x8, packed, scales, n_split=qmm.w4a8_decode_splits(n, k, o, sms))
    assert torch.equal(qmm.w4a8_matmul(x8, packed, scales), want)
    x = torch.randn((n, k), generator=g, device=cuda_device).to(torch.bfloat16)
    s_nv = (torch.randint(0, 48, (o, k // 16), generator=g, device=cuda_device, dtype=torch.int32) + 0x20).to(
        torch.uint8).view(torch.float8_e4m3fn)
    for fn, plain, w in ((qmm_wo.int4_wo_matmul, qmm_wo.int4_wo_matmul_plain, (packed, scales.float() * 0.01)),
                         (qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain,
                          (packed, s_nv, torch.tensor(0.01, device=cuda_device)))):
        out, ref = fn(x, *w).float(), plain(x, *w, out_dtype=torch.float32)
        tol = 2.0 ** -8 * ref.abs() + 1e-3 * float(ref.square().mean().sqrt())
        assert bool(((out - ref).abs() <= tol).all())


@pytest.mark.cuda
def test_rep8_attention_on_the_card(cuda_device):
    """Flash and kv decode at 32 query heads over 4 kv heads (rep 8, which
    no dense model of the port had): flash per element within 2^-8 |ref| +
    1e-3 rms(ref) of the plain version's f32 result, kv decode (int8 cache)
    within 1e-5 of the plain version's scale."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa, kv_attention

    g = torch.Generator(device=cuda_device).manual_seed(8)
    q = torch.randn((2, 32, 300, 128), generator=g, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn((2, 4, 300, 128), generator=g, device=cuda_device).to(torch.bfloat16) for _ in range(2))
    out = flash_gqa.flash_attention_gqa(q, k, v).float()
    ref = flash_gqa.flash_attention_gqa_plain(q.float(), k.float(), v.float())
    assert bool(((out - ref).abs() <= 2.0 ** -8 * ref.abs() + 1e-3 * float(ref.square().mean().sqrt())).all())
    kc, vc = (torch.randint(-128, 128, (2, 4, 320, 128), generator=g, device=cuda_device, dtype=torch.int32)
              .to(torch.int8) for _ in range(2))
    qd = torch.randn((2, 32, 128), generator=g, device=cuda_device) / 400
    kn, vn = (torch.randn((2, 4, 1, 128), generator=g, device=cuda_device) for _ in range(2))
    for pos in (0, 1, 257, 300):
        args = (qd, kc, vc, kn, vn, torch.tensor(pos, dtype=torch.int32, device=cuda_device), "int8", None, None)
        got, want = kv_attention.kv_decode_attention(*args), kv_attention.kv_decode_attention_plain(*args)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5, pos


@pytest.mark.cuda
def test_moe_decode_graph_equals_eager_on_the_card(cuda_device):
    """anchor-moe under W4A8 on the card: `decode_step(unroll=4)` (one
    CUDA-graph replay after its capture) gives the eager steps' tokens and
    cache bit for bit: the dispatch reads nothing back to the host."""
    cfg, params = tload.load_hf_moe_checkpoint(ANCHOR, device=cuda_device)
    cm = tcompress.compress(tptq.quantize_family("mixtral", cfg, params, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG",
                                                 device=cuda_device))
    eng = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=64, kv_dtype=torch.int8, kv_attention_kernel=True,
                                                  int4_layout="a8"), device=cuda_device)
    prompt = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    caches = [eng.init_cache(4) for _ in range(2)]
    toks = [torch.argmax(eng.prefill(prompt, c), dim=-1).to(torch.int32)[:, None] for c in caches]
    eager = toks[0]
    eng._eager = True
    for _ in range(8):
        eager, _ = eng.decode_step(eager, caches[0])
    eng._eager = False
    graphed = toks[1]
    for _ in range(2):
        graphed, _ = eng.decode_step(graphed, caches[1], unroll=4)
    assert torch.equal(graphed, eager)
    assert all(torch.equal(caches[0][key].view(torch.uint8) if caches[0][key].element_size() == 1 else caches[0][key],
                           caches[1][key].view(torch.uint8) if caches[1][key].element_size() == 1 else caches[1][key])
               for key in caches[0])
