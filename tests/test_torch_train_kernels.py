"""The training side's repairs around the kernels (no JAX here).

On the CPU: the engine's refusal predicate for weight-only kernels under
activations other than bf16 (`serve.engine.weight_only_refusal`: an f32
INT4 / NVFP4 / FP8 model on the card is refused naming its dtype, a bf16
one, a plain-GEMM engine, a CPU engine and W8A8's `int8_mm` are not). On
the card (marked `cuda`, skipped elsewhere): `Engine.__init__` refuses that
model; the flash kernel refuses to launch where a gradient would be asked
of it and launches under `no_grad`; a QAT step of a flash config on the card
equals the CPU's within 1e-4 of each tensor's scale (f32, einsum attention
on both)."""

import dataclasses

import pytest
import torch

from _torch_parity import cuda_device, rel_err  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu_torch.models import llama
from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq, qat
from tensorrt_model_optimizer_tpu_torch.serve import engine


def _compressed(preset, dtype=torch.float32, device="cpu"):
    cfg = llama.LlamaConfig.tiny(num_hidden_layers=1, hidden_size=128, intermediate_size=256, dtype=dtype)
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    batches = [torch.randint(0, 256, (2, 16), generator=torch.Generator(device=device).manual_seed(1),
                             device=device)]
    return compress.compress(ptq.quantize(cfg, params, preset, batches, device=device))


@pytest.mark.parametrize("preset", ["INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG",
                                    "INT8_DEFAULT_CFG"])
def test_weight_only_refusal_predicate(preset):
    cm = engine.convert_packed_layouts(_compressed(preset), nvfp4="word2", int4="bd2", mxfp4="word2")  # as served
    cuda = torch.device("cuda")
    said = engine.weight_only_refusal(cm, cuda)
    if preset == "INT8_DEFAULT_CFG":  # W8A8: int8 x int8 through int8_mm, any activation dtype
        assert said is None and not engine.weight_only_kernels(cm)
        return
    assert said is not None and "torch.float32" in said and "bf16" in said
    ops = set(engine.weight_only_kernels(cm).values())
    assert engine.weight_only_refusal(cm, cuda, tuple(ops)) is None
    assert engine.weight_only_refusal(cm, torch.device("cpu")) is None
    bf = dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, dtype=torch.bfloat16))
    assert engine.weight_only_refusal(bf, cuda) is None
    engine.Engine(cm, engine.EngineConfig(max_seq_len=32), device="cpu")  # the CPU serves f32


@pytest.mark.cuda
def test_engine_refuses_f32_weight_only_on_the_card(cuda_device):
    cm = _compressed("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        engine.Engine(cm, engine.EngineConfig(max_seq_len=32), device=cuda_device)
    engine.Engine(cm, engine.EngineConfig(max_seq_len=32, plain_ops=("int4_wo",)), device=cuda_device)


@pytest.mark.cuda
def test_flash_kernel_refuses_grad_on_the_card(cuda_device):
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa

    q, k, v = (torch.randn((1, h, 64, 64), device=cuda_device, dtype=torch.bfloat16) for h in (4, 2, 2))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_gqa.flash_attention_gqa(q, k, v, True)
    with torch.no_grad():
        out = flash_gqa.flash_attention_gqa(q, k, v, True)
        ref = flash_gqa.flash_attention_gqa_plain(q, k, v, True)
    assert rel_err(out.float().cpu().numpy(), ref.float().cpu().numpy()) <= 2e-2


@pytest.mark.cuda
def test_qat_step_of_a_flash_config_on_the_card_equals_the_cpu(cuda_device):
    cfg = llama.LlamaConfig.tiny(attn_impl="flash")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, 256, (2, 17), generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda_device):
        p = {k: (v.to(dev) if torch.is_tensor(v) else {n: t.to(dev) for n, t in v.items()}) for k, v in params.items()}
        # calibrated through the einsum (the flash kernel takes bf16 only), trained as the flash config
        qm = ptq.quantize(qat.train_cfg(cfg), p, "INT8_DEFAULT_CFG", [tokens[:, :-1].to(dev)], device=dev)
        step, init = qat.make_optax_train_step(cfg, qm.layout)
        new, _, _, loss = step(qm.params, qm.qstate, init(qm.params, qm.qstate), tokens.to(dev))
        out[str(torch.device(dev).type)] = (new, float(loss))
    cpu, card = out["cpu"], out["cuda"]
    assert abs(cpu[1] - card[1]) <= 1e-4 * abs(cpu[1])
    for k, v in cpu[0]["layers"].items():
        assert rel_err(card[0]["layers"][k].cpu().numpy(), v.numpy()) <= 1e-4, k
