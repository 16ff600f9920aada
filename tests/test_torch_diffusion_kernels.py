"""The DiT's real-quant denoise step on the weight-only GEMM kernels, on the
card (marked `cuda`, skipped elsewhere; no JAX here: tests/test_torch_dit.py
holds the same step against JAX's on the CPU).

On the CPU: `forward_packed` with the canonical packs equals the step from
the packs in `serving_layouts`, and the f32 refusal is decided from the
device. On the card: DiT-XL/2's block GEMM shapes (qkv 3456 x 1152, proj
1152 x 1152, fc1 4608 x 1152, fc2 1152 x 4608 at N = 2048) per format
within chip_smoke's `_held` rule (2^-8 |ref| + 1e-3 rms(ref)) of the plain
version's f32 result; a small bf16 DiT's step on the kernels within 5e-2 of
eps's scale of the all-plain step at depth 2, each of the three kernels
launched; and an f32 DiT refused with the engine's TypeError unless
`plain_ops` names the kernels."""

import pytest
import torch

from _torch_parity import cuda_device  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu_torch.models import dit

PRESETS = ("FP8_DEFAULT_CFG", "NVFP4_DEFAULT_CFG", "INT4_AWQ_CFG", "MXFP4_DEFAULT_CFG")
PLAIN = ("int4_wo", "fp4_wo", "byte_wo")


def _model(dev, dtype, depth=2):
    cfg = dit.DiTConfig.tiny(hidden_size=128, img_size=16, patch_size=2, depth=depth, dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(3)
    p = dit.init_params(cfg, g, device=dev)

    def rnd(t):
        return (torch.randn(t.shape, generator=g, device=dev) * 0.05).to(t.dtype)

    p["blocks"] = {k: (rnd(v) if k == "adaLN.mod" or k.endswith("__bias") else v) for k, v in p["blocks"].items()}
    p["final_mod"], p["final_proj"] = rnd(p["final_mod"]), rnd(p["final_proj"])
    x = torch.randn((2, 16, 16, 4), generator=g, device=dev).to(dtype)
    t = torch.tensor([100, 700], dtype=torch.int32, device=dev)
    return cfg, p, x, t


@pytest.mark.parametrize("preset", PRESETS)
def test_canonical_and_serving_packs_give_one_step(preset):
    cfg, p, x, t = _model(torch.device("cpu"), torch.float32)
    layout, qstate = dit.quantize_dit(cfg, p, preset, [(x, t)])
    kinds, packed = dit.compress_dit(cfg, p, layout, qstate)
    skinds, spacked = dit.serving_layouts(kinds, packed)
    assert set(skinds.values()) <= {"bf16", "fp8", "nvfp4wo", "int4wo", "mxfp4wo"}
    a = dit.forward_packed(cfg, p, kinds, packed, x, t, layout=layout, qstate=qstate)
    b = dit.forward_packed(cfg, p, skinds, spacked, x, t, layout=layout, qstate=qstate)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


@pytest.mark.cuda
def test_dit_step_on_the_kernels(cuda_device):
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm_wo

    cfg, p, x, t = _model(cuda_device, torch.bfloat16)
    for k in qmm_wo.launches:
        qmm_wo.launches[k] = 0
    for preset in PRESETS:
        layout, qstate = dit.quantize_dit(cfg, p, preset, [(x, t)])
        kinds, packed = dit.serving_layouts(*dit.compress_dit(cfg, p, layout, qstate))
        with torch.no_grad():
            got = dit.forward_packed(cfg, p, kinds, packed, x, t, layout=layout, qstate=qstate)
            want = dit.forward_packed(cfg, p, kinds, packed, x, t, layout=layout, qstate=qstate, plain_ops=PLAIN)
        err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        assert err <= 5e-2, (preset, err)
    assert all(qmm_wo.launches[k] > 0 for k in ("qmm_int4_wo", "qmm_fp4_wo", "qmm_byte_wo")), qmm_wo.launches


@pytest.mark.cuda
def test_f32_dit_is_refused_on_the_card(cuda_device):
    cfg, p, x, t = _model(cuda_device, torch.float32)
    layout, qstate = dit.quantize_dit(cfg, p, "INT4_AWQ_CFG", [(x, t)])
    kinds, packed = dit.compress_dit(cfg, p, layout, qstate)
    with pytest.raises(TypeError, match="bf16 activations"):
        dit.forward_packed(cfg, p, kinds, packed, x, t, layout=layout, qstate=qstate)
    out = dit.forward_packed(cfg, p, kinds, packed, x, t, layout=layout, qstate=qstate, plain_ops=("int4_wo",))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


# DiT-XL/2's block GEMMs at 8 latents x 256 tokens
XL2_SHAPES = [(3456, 1152), (1152, 1152), (4608, 1152), (1152, 4608)]


@pytest.mark.cuda
@pytest.mark.parametrize("o,k", XL2_SHAPES)
def test_dit_xl2_gemm_shapes_on_the_card(cuda_device, o, k):
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm_wo

    g = torch.Generator(device=cuda_device).manual_seed(o + k)

    def rand_bytes(shape):
        return torch.randint(0, 256, shape, generator=g, device=cuda_device, dtype=torch.int32).to(torch.uint8)

    nib = rand_bytes((o, k // 2))
    qb = rand_bytes((o, k))
    cases = {
        "int4": (qmm_wo.int4_wo_matmul, qmm_wo.int4_wo_matmul_plain,
                 (nib, torch.rand((k // 128, o), generator=g, device=cuda_device) * 0.02 + 0.005)),
        "nvfp4": (qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain,
                  (nib, (rand_bytes((o, k // 16)) % 48 + 0x20).view(torch.float8_e4m3fn),
                   torch.tensor(0.0137, device=cuda_device))),
        "mxfp4": (qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain,
                  (nib, (rand_bytes((o, k // 32)) % 9).to(torch.int8) - 8)),
        "fp8": (qmm_wo.byte_wo_matmul, qmm_wo.byte_wo_matmul_plain,
                (torch.where((qb & 0x7F) == 0x7F, qb & 0x80, qb).view(torch.float8_e4m3fn),
                 torch.tensor(0.0021, device=cuda_device))),
    }
    x = torch.randn((2048, k), generator=g, device=cuda_device).to(torch.bfloat16)
    for fmt, (fn, plain, w) in cases.items():
        out = fn(x, *w)
        ref = plain(x, *w, out_dtype=torch.float32)
        tol = 2.0 ** -8 * ref.abs() + 1e-3 * ref.square().mean().sqrt()
        assert bool(((out.float() - ref).abs() <= tol).all()), fmt
