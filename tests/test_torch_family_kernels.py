"""The GEMM kernels at the widths GPT-OSS-20B and Llama-4-Scout give them.
GPT-OSS's hidden 2880 is 22.5 blocks of 128: on the CPU, a weight of that K
packed by `compress` into each weight-only layout the engine serves (INT4
padded to 2944 with code 0, NVFP4 / MXFP4 rows ending in a half 128-block)
times x through the plain version equals x times the fake-quantized weight
(1e-5 of the scale, f32). On the card (marked `cuda`, skipped elsewhere; no
JAX here): every format at GPT-OSS's and Scout's projection and expert
shapes, at a decode step's rows, an expert's decode capacity and a prefill
capacity: W4A8 bit-exact with its plain version, the weight-only GEMMs per
element within 2^-8 |ref| + 1e-3 rms(ref) of the plain version's f32
result; and a small GPT-OSS and Llama4 model's graphed decode steps equal
to the eager steps, tokens and cache."""

import pytest
import torch

from _torch_parity import cuda_device, rel_err  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu_torch.quant import compress, config, quantizer

torch.manual_seed(0)


@pytest.mark.parametrize("preset,layout", [("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "bd2"),
                                           ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "blockdot"),
                                           ("NVFP4_WEIGHT_ONLY_CFG", "word2"), ("MXFP4_WEIGHT_ONLY_CFG", "word2")])
def test_gpt_oss_width_packs_serve_the_fake_quantized_weight(preset, layout):
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm_wo

    g = torch.Generator().manual_seed(1)
    w = torch.randn((96, 2880), generator=g) / 50
    wcfg = config.get_preset(preset).resolve("model.layers.0.mlp.gate_proj.weight_quantizer")
    st = quantizer.collect(w, wcfg, quantizer.QuantizerState())
    kind, arrays = compress.compress_weight(w, wcfg, st)
    kind, arrays = compress.word_convert_site(kind, arrays, layout)
    if kind == "int4wo":
        assert arrays["packed"].shape == (96, 1472) and arrays["scales"].shape == (23, 96)
        if layout == "blockdot":  # f32 block scales: the same values as the fake quant
            x = torch.randn((5, 2880), generator=g)
            y = qmm_wo.int4_wo_matmul(x, arrays["packed"], arrays["scales"])
            assert rel_err(y.numpy(), (x @ quantizer.quantize(w, wcfg, st).t()).numpy()) < 1e-5
        return
    assert arrays["packed"].shape == (96, 1440)
    x = torch.randn((5, 2880), generator=g)
    y = qmm_wo.fp4_wo_matmul(x, arrays["packed"], arrays["scales"], arrays.get("global_scale"))
    assert rel_err(y.numpy(), (x @ quantizer.quantize(w, wcfg, st).t()).numpy()) < 1e-5


# (O, K, formats, rows): GPT-OSS-20B q, k and o projections and experts; Scout's q / o, k, experts and shared expert
CARD_SHAPES = [(4096, 2880, ("int4", "nvfp4", "mxfp4"), (8, 4096)), (512, 2880, ("int4", "nvfp4", "mxfp4"), (8,)),
               (2880, 4096, ("int4", "nvfp4", "mxfp4"), (8,)), (2880, 2880, ("int4", "nvfp4", "mxfp4"), (2, 4096)),
               (5120, 5120, ("nvfp4", "w4a8"), (8, 300)), (1024, 5120, ("nvfp4", "w4a8"), (8,)),
               (8192, 5120, ("nvfp4", "w4a8"), (1, 2048)), (5120, 8192, ("nvfp4", "w4a8"), (1, 2048))]


@pytest.mark.cuda
@pytest.mark.parametrize("o,k,fmts,rows", CARD_SHAPES)
def test_family_gemm_shapes_on_the_card(cuda_device, o, k, fmts, rows):
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm, qmm_wo

    g = torch.Generator(device=cuda_device).manual_seed(o + k)
    kp4, kp64 = -(-k // 128) * 128, -(-k // 64) * 64

    def rand_bytes(shape):
        return torch.randint(0, 256, shape, generator=g, device=cuda_device, dtype=torch.int32).to(torch.uint8)

    nib4, nib = rand_bytes((o, kp4 // 2)), rand_bytes((o, kp64 // 2))
    s4 = (torch.rand((kp4 // 128, o), generator=g, device=cuda_device) * 0.02 + 0.005).to(torch.bfloat16).float()
    weights = {"int4": (qmm_wo.int4_wo_matmul, qmm_wo.int4_wo_matmul_plain, (nib4, s4)),
               "nvfp4": (qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain,
                         (nib, (rand_bytes((o, kp64 // 16)) % 48 + 0x20).view(torch.float8_e4m3fn),
                          torch.tensor(0.0137, device=cuda_device))),
               "mxfp4": (qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain,
                         (nib, (rand_bytes((o, kp64 // 32)) % 9).to(torch.int8) - 8))}
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n in rows:
        for fmt in fmts:
            if fmt == "w4a8":
                x8 = torch.randint(-127, 128, (n, k), generator=g, device=cuda_device, dtype=torch.int32).to(torch.int8)
                sc = (torch.rand((k // 128, o), generator=g, device=cuda_device) + 0.5).to(torch.bfloat16)
                want = qmm.w4a8_matmul_plain(x8, nib4, sc, n_split=qmm.w4a8_decode_splits(n, k, o, sms))
                assert torch.equal(qmm.w4a8_matmul(x8, nib4, sc), want), (n, fmt)
                continue
            fn, plain, w = weights[fmt]
            x = torch.randn((n, k), generator=g, device=cuda_device).to(torch.bfloat16)
            out, ref = fn(x, *w).float(), plain(x, *w, out_dtype=torch.float32)
            tol = 2.0 ** -8 * ref.abs() + 1e-3 * float(ref.square().mean().sqrt())
            assert bool(((out - ref).abs() <= tol).all()), (n, fmt)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gpt_oss", "llama4"])
def test_family_decode_graph_equals_eager_on_the_card(cuda_device, family):
    """A small bf16 model (hidden 256, 4 layers) under MXFP4 (GPT-OSS) or
    W4A8 (Llama4), einsum engine, int8 KV: `decode_step(unroll=4)` gives the
    eager steps' tokens and cache bit for bit, past the window / chunk of 8."""
    from tensorrt_model_optimizer_tpu_torch.models import gpt_oss, llama4
    from tensorrt_model_optimizer_tpu_torch.quant import ptq
    from tensorrt_model_optimizer_tpu_torch.serve import engine

    kw = dict(hidden_size=256, intermediate_size=256, num_hidden_layers=4, head_dim=64, capacity_factor=4.0,
              dtype=torch.bfloat16)
    mod, cfg = ((gpt_oss, gpt_oss.GptOssConfig.tiny(**kw)) if family == "gpt_oss"
                else (llama4, llama4.Llama4Config.tiny(**kw)))
    params = mod.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    if family == "gpt_oss":
        params["layers"]["self_attn.sinks"].normal_()
    preset, layout = (("MXFP4_WEIGHT_ONLY_CFG", {}) if family == "gpt_oss"
                      else ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", {"int4_layout": "a8"}))
    cm = compress.compress(ptq.quantize_family(family, cfg, params, preset, device=cuda_device))
    eng = engine.Engine(cm, engine.EngineConfig(max_seq_len=64, kv_dtype=torch.int8, **layout), device=cuda_device)
    prompt = torch.randint(0, cfg.vocab_size, (4, 12), generator=torch.Generator().manual_seed(0)).to(cuda_device)
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
    for key in caches[0]:
        a, b = caches[0][key], caches[1][key]
        assert torch.equal(a.view(torch.uint8) if a.element_size() == 1 else a,
                           b.view(torch.uint8) if b.element_size() == 1 else b), key
