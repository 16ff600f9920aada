"""The port's DeepSeek path on the card (marked `cuda`, skipped elsewhere;
this file imports no JAX): the weight-only GEMMs at DeepSeek-V3's shapes
(kv_a's O = 576, no multiple of 128, included) against their plain
versions on both routes, and a small bf16 DeepSeek's `decode_step(unroll)`
as CUDA-graph replays equal to the eager steps bit for bit."""

import pytest
import torch

from _torch_parity import cuda_device  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu_torch.models import deepseek as tds
from tensorrt_model_optimizer_tpu_torch.serve import deepseek_engine as tdse


# DeepSeek-V3's GEMMs (O, K, rows): q_a, q_b, kv_a (O = 576: no multiple of
# 128), o, the dense gate, an expert's gate and down; decode (8; experts 1)
# and a prefill's rows (a ragged 300 for the projections; experts 1024)
V3_SHAPES = [(1536, 7168, (8, 300)), (24576, 1536, (8, 300)), (576, 7168, (8, 300)), (7168, 16384, (8, 300)),
             (18432, 7168, (8, 300)), (2048, 7168, (1, 1024)), (7168, 2048, (1, 1024))]


@pytest.mark.cuda
@pytest.mark.parametrize("o,k,rows", V3_SHAPES)
def test_v3_gemm_shapes_on_the_card(cuda_device, o, k, rows):
    """INT4 (row 4's kernel), NVFP4 (row 8's) and FP8 / INT8 (rows 13-14's)
    against their plain versions on both routes, within 2^-8 of each
    output plus 1e-3 of the outputs' rms."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm_wo

    g = torch.Generator(device=cuda_device).manual_seed(o + k)

    def rand_bytes(shape):
        return torch.randint(0, 256, shape, generator=g, device=cuda_device, dtype=torch.int32).to(torch.uint8)

    s4 = (torch.rand((k // 128, o), generator=g, device=cuda_device) * 0.02 + 0.005).to(torch.bfloat16).float()
    weights = {"int4": (qmm_wo.int4_wo_matmul, qmm_wo.int4_wo_matmul_plain, (rand_bytes((o, k // 2)), s4)),
               "nvfp4": (qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain,
                         (rand_bytes((o, k // 2)), (rand_bytes((o, k // 16)) % 48 + 0x20).view(torch.float8_e4m3fn),
                          torch.tensor(0.0137, device=cuda_device))),
               "fp8": (qmm_wo.byte_wo_matmul, qmm_wo.byte_wo_matmul_plain,
                       ((rand_bytes((o, k)) % 0x70).view(torch.float8_e4m3fn), torch.tensor(0.01, device=cuda_device))),
               "int8": (qmm_wo.byte_wo_matmul, qmm_wo.byte_wo_matmul_plain,
                        (rand_bytes((o, k)).view(torch.int8), torch.rand((o, 1), generator=g, device=cuda_device) * 1e-3))}
    for n in rows:
        x = torch.randn((n, k), generator=g, device=cuda_device).to(torch.bfloat16)
        for fmt, (fn, plain, w) in weights.items():
            out, ref = fn(x, *w).float(), plain(x, *w, out_dtype=torch.float32)
            tol = 2.0 ** -8 * ref.abs() + 1e-3 * float(ref.square().mean().sqrt())
            assert bool(((out - ref).abs() <= tol).all()), (n, fmt)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "NVFP4_DEFAULT_CFG"])
def test_decode_graph_equals_eager_on_the_card(cuda_device, preset):
    """A small bf16 DeepSeek (hidden 256, 4 layers: 1 dense, 3 MoE):
    `decode_step(unroll=4)` gives the eager steps' tokens and latent cache
    bit for bit, and every layer's GEMMs launched their kernel."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm_wo

    cfg = tds.DeepseekConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=4,
                             num_attention_heads=8, num_key_value_heads=8, q_lora_rank=128, kv_lora_rank=128,
                             qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, n_routed_experts=16,
                             num_experts_per_tok=4, n_group=4, topk_group=2, moe_intermediate_size=128,
                             first_k_dense_replace=1, routed_scaling_factor=2.5, dtype=torch.bfloat16)
    params = tds.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    params["layers_moe"]["moe.e_bias"].normal_(0.0, 0.05)
    calib = [torch.randint(0, 512, (2, 32), generator=torch.Generator().manual_seed(1)).to(cuda_device)]
    cm = tdse.compress(tds.quantize(cfg, params, preset, calib, device=cuda_device))
    eng = tdse.DeepseekEngine(cm, max_seq_len=64, device=cuda_device)
    prompt = torch.randint(0, 512, (4, 12), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    caches = [eng.init_cache(4) for _ in range(2)]
    toks = [torch.argmax(eng.prefill(prompt, c), dim=-1).to(torch.int32)[:, None] for c in caches]
    before = dict(qmm_wo.launches)
    eager = toks[0]
    eng._eager = True
    for _ in range(8):
        eager, _ = eng.decode_step(eager, caches[0])
    eng._eager = False
    kernel = "qmm_int4_wo" if preset.startswith("INT4") else "qmm_fp4_wo"
    assert qmm_wo.launches[kernel] > before[kernel]
    graphed = toks[1]
    for _ in range(2):
        graphed, _ = eng.decode_step(graphed, caches[1], unroll=4)
    assert torch.equal(graphed, eager)
    for key in caches[0]:
        assert torch.equal(caches[0][key], caches[1][key]), key
