"""The port's weight-only GEMMs (plain versions here; the CUDA kernels on a
card) against JAX's Pallas kernels in interpret mode, on the same packed
weights and bf16 activations.

Tolerance, stated beforehand for an output rounded to bf16 on both sides:
|out - ref| <= 2^-7 |ref| + 1e-3 rms(ref). 2^-7 is two half-ulp roundings
of bf16; the rms term covers f32 sums taken in another order. It holds
against the TPU layouts whose arithmetic the port repeats: bd2 and the plane
kernel for int4 (f32 block sums, then the scale), every NVFP4 / MXFP4 layout
(e2m1 x scale is exact in bf16), int8 and fp8. JAX's int4 word and word2
layouts are looser by design: they round (u - 136) s to bf16 for each weight
before the dot (qmm.py `_int4_word2_kernel`), an error of up to 2^-9 of each
term, so they are held to 2^-7 |ref| + 8e-3 rms(ref)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu.ops.pallas import qmm as jqmm
from tensorrt_model_optimizer_tpu.quant import compress as jc
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm_wo
from tensorrt_model_optimizer_tpu_torch.quant import compress as tc
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig

O, K = 256, 2048
SITE = "model.layers.0.mlp.up_proj.weight_quantizer"


def _held(out, ref, rms_term=1e-3):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    tol = 2.0 ** -7 * np.abs(ref) + rms_term * np.sqrt(np.mean(ref * ref))
    worst = float((np.abs(out - ref) / tol).max())
    assert worst <= 1.0, f"worst err/limit {worst}"


def _packs(preset, o=O, k=K, seed=0):
    """One seeded weight packed by both packages -> (JAX kind, JAX arrays,
    port kind, port arrays)."""
    w = (np.random.default_rng(seed).standard_normal((o, k)) * 0.05).astype(np.float32)
    jk, ja = jc.compress_weight(jnp.asarray(w), jconfig.PRESETS[preset].resolve(SITE), None)
    tk, ta = tc.compress_weight(torch.from_numpy(w), tconfig.PRESETS[preset].resolve(SITE), None)
    return jk, ja, tk, ta


def _x(n, k=K, seed=1):
    x = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _port_matmul(tx, kind, arr):
    if kind == "int4wo":
        return qmm_wo.int4_wo_matmul(tx, arr["packed"], arr["scales"])
    if kind in ("nvfp4wo", "mxfp4wo"):
        return qmm_wo.fp4_wo_matmul(tx, arr["packed"], arr["scales"], arr.get("global_scale"))
    return qmm_wo.byte_wo_matmul(tx, arr["q"], arr["scale"])


@pytest.mark.parametrize("n", [8, 512])
@pytest.mark.parametrize("preset,layout,rms_term", [
    ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "bd2", 1e-3),
    ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "blockdot", 1e-3),
    ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "word2", 8e-3),
    ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "word", 8e-3),
    ("NVFP4_DEFAULT_CFG", "word2", 1e-3),
    ("NVFP4_DEFAULT_CFG", "blockdot", 1e-3),
    ("NVFP4_DEFAULT_CFG", "word", 1e-3),
    ("MXFP4_DEFAULT_CFG", "word2", 1e-3),
])
def test_plain_matches_pallas_4bit(preset, layout, rms_term, n):
    jk, ja, tk, ta = _packs(preset)
    jk2, ja2 = (jk, ja) if layout == "blockdot" else jc.word_convert_site(jk, ja, layout)
    tk2, ta2 = tc.word_convert_site(tk, ta, layout)
    jx, tx = _x(n)
    ref = jqmm.quantized_matmul(jx, jk2, ja2)
    out = _port_matmul(tx, tk2, ta2)
    assert out.dtype == torch.bfloat16 and out.shape == (n, O)
    _held(out.float().numpy(), ref.astype(jnp.float32), rms_term)


@pytest.mark.parametrize("n", [8, 512])
@pytest.mark.parametrize("preset,jfn", [("INT8_DEFAULT_CFG", "qmm_int8"), ("FP8_DEFAULT_CFG", "qmm_fp8")])
def test_plain_matches_pallas_byte(preset, jfn, n):
    """Against the Pallas kernels `qmm_int8` / `qmm_fp8` and against the
    convert-fused dot that the JAX engine serves these kinds with."""
    jk, ja, tk, ta = _packs(preset)
    jx, tx = _x(n)
    out = _port_matmul(tx, tk, ta).float().numpy()
    _held(out, getattr(jqmm, jfn)(jx, ja["q"], ja["scale"]).astype(jnp.float32))
    _held(out, jqmm.quantized_matmul(jx, jk, ja).astype(jnp.float32))
    # the arrays carried across from JAX give the same result as the port's own pack
    carried = convert.params_from_jax(ja)
    assert np.array_equal(_port_matmul(tx, tk, carried).float().numpy(), out)


@pytest.mark.parametrize("preset,layout", [("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "bd2"),
                                           ("NVFP4_DEFAULT_CFG", "word2"), ("MXFP4_DEFAULT_CFG", "word2"),
                                           ("INT8_DEFAULT_CFG", None), ("FP8_DEFAULT_CFG", None)])
def test_plain_ragged_k_equals_dense(preset, layout):
    """K = 704 (the anchor's down_proj: 5.5 int4 blocks, rows padded to 768
    for fp4): the padded tail adds nothing. Held against an f64 dense
    product with the decompressed weight, to the bf16 rounding of the output."""
    _, _, tk, ta = _packs(preset, o=96, k=704, seed=5)
    if layout is not None:
        tk, ta = tc.word_convert_site(tk, ta, layout)
    _, tx = _x(5, k=704)
    ref = tx.double() @ tc.decompress_weight(tk, ta, torch.float32).double().t()
    out = _port_matmul(tx, tk, ta)
    _held(out.float().numpy(), ref.numpy())
    # f32 activations (the tiny test models) take the plain version too and stay f32
    assert _port_matmul(tx.float(), tk, ta).dtype == torch.float32


def test_e4m3_and_e2m1_decode_every_code():
    """The decoders the plain versions share with `decompress_weight`: all
    256 e4m3 codes as torch decodes them, all 16 e2m1 codes, and MXFP4's
    exponent range clamped as JAX's `_exp_to_bf16` clamps it."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    vals = qmm_wo.fp4_rows_scales(codes.view(torch.float8_e4m3fn))
    ref = np.arange(256, dtype=np.uint8).view(jnp.float8_e4m3fn).astype(np.float32)
    np.testing.assert_array_equal(vals.numpy(), ref)
    byte = torch.tensor([[0x10, 0x32, 0x54, 0x76, 0x98, 0xBA, 0xDC, 0xFE]], dtype=torch.uint8)
    np.testing.assert_array_equal(qmm_wo.fp4_rows_values(byte).numpy()[0],
                                  [0, .5, 1, 1.5, 2, 3, 4, 6, -0.0, -.5, -1, -1.5, -2, -3, -4, -6])
    exps = np.array([[-128, -127, -126, -1, 0, 1, 126, 127]], dtype=np.int8)
    packed = torch.zeros((1, 8 * 32), dtype=torch.uint8)
    _, s, _ = qmm_wo.fp4_rows_pack(packed, torch.from_numpy(exps), torch.from_numpy(exps), 32)
    np.testing.assert_array_equal(qmm_wo.fp4_rows_scales(s).numpy()[0],
                                  np.asarray(jc._exp_to_bf16(jnp.asarray(exps[0])).astype(jnp.float32)))


def test_wrappers_reject_bad_inputs():
    _, _, tk, ta = _packs("INT4_BLOCKWISE_WEIGHT_ONLY_CFG")
    _, i4 = tc.word_convert_site(tk, ta, "bd2")
    _, _, tk, ta = _packs("NVFP4_DEFAULT_CFG")
    _, f4 = tc.word_convert_site(tk, ta, "word2")
    _, _, _, i8 = _packs("INT8_DEFAULT_CFG")
    _, tx = _x(8)
    with pytest.raises(ValueError):
        qmm_wo.int4_wo_matmul(tx[:, :1024], i4["packed"], i4["scales"])
    with pytest.raises(TypeError):
        qmm_wo.int4_wo_matmul(tx, i4["packed"], i4["scales"].to(torch.bfloat16))
    with pytest.raises(ValueError):
        qmm_wo.fp4_wo_matmul(tx[:, :1024], f4["packed"], f4["scales"], f4["global_scale"])
    with pytest.raises(TypeError):
        qmm_wo.fp4_wo_matmul(tx, f4["packed"], f4["scales"].float(), f4["global_scale"])
    with pytest.raises(ValueError):
        qmm_wo.byte_wo_matmul(tx[:, :1024], i8["q"], i8["scale"])
    with pytest.raises(TypeError):
        qmm_wo.byte_wo_matmul(tx, i8["q"].float(), i8["scale"])
    with pytest.raises(NotImplementedError):  # 64-wide int4 blocks over K = 256
        tc.word_convert_site("int4", {"packed": torch.zeros((8, 256), dtype=torch.uint8),
                                      "scale_lo": torch.ones((8, 4)), "scale_hi": torch.ones((8, 4))}, "bd2")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 1024])
@pytest.mark.parametrize("preset,layout", [("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "bd2"),
                                           ("NVFP4_DEFAULT_CFG", "word2"), ("MXFP4_DEFAULT_CFG", "word2"),
                                           ("INT8_DEFAULT_CFG", None), ("FP8_DEFAULT_CFG", None)])
def test_kernel_matches_plain(cuda_device, preset, layout, n):
    """On the card: the kernel's bf16 output against the plain version's f32
    result, per element, |out - ref| <= 2^-8 |ref| + 1e-3 rms(ref)."""
    _, _, tk, ta = _packs(preset)
    if layout is not None:
        tk, ta = tc.word_convert_site(tk, ta, layout)
    arr = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v) for k, v in ta.items()}
    tx = _x(n)[1].to(cuda_device)
    out = _port_matmul(tx, tk, arr)
    torch.cuda.synchronize()
    plain = {"int4wo": qmm_wo.int4_wo_matmul_plain, "nvfp4wo": qmm_wo.fp4_wo_matmul_plain,
             "mxfp4wo": qmm_wo.fp4_wo_matmul_plain}.get(tk, qmm_wo.byte_wo_matmul_plain)
    args = [arr[k] for k in (("packed", "scales", "global_scale") if "packed" in arr else ("q", "scale")) if k in arr]
    ref = plain(tx, *args, out_dtype=torch.float32)
    tol = 2.0 ** -8 * ref.abs() + 1e-3 * ref.square().mean().sqrt()
    assert bool(((out.float() - ref).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,o,k", [(1, 24, 128), (17, 66, 256), (100, 130, 704), (129, 64, 96), (16, 2, 64)])
@pytest.mark.parametrize("preset,layout", [("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "bd2"),
                                           ("NVFP4_DEFAULT_CFG", "word2"), ("MXFP4_DEFAULT_CFG", "word2"),
                                           ("INT8_DEFAULT_CFG", None), ("FP8_DEFAULT_CFG", None)])
def test_kernel_ragged_tiles(cuda_device, preset, layout, n, o, k):
    """Shapes that fill no tile: rows, columns and K short of the kernel's
    tiles, in both tile shapes; the masked edges must add nothing and no
    output outside [N, O] may be written (the output is checked whole)."""
    _, _, tk, ta = _packs(preset, o=o, k=k, seed=7)
    if layout is not None:
        tk, ta = tc.word_convert_site(tk, ta, layout)
    arr = {key: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v) for key, v in ta.items()}
    tx = _x(n, k=k)[1]
    out = _port_matmul(tx.to(cuda_device), tk, arr)
    torch.cuda.synchronize()
    ref = tx.double() @ tc.decompress_weight(tk, ta, torch.float32).double().t()
    assert out.shape == (n, o)
    _held(out.float().cpu().numpy(), ref.numpy())


@pytest.mark.cuda
def test_byte_kernel_odd_output_width(cuda_device):
    """An odd O takes the kernel's scalar-store path (pairs of bf16 outputs
    are stored as one word only when rows stay 4-byte aligned)."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.integers(-128, 128, size=(37, 160)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(0.001, 0.01, size=(37, 1)).astype(np.float32))
    for n in (5, 40):
        tx = _x(n, k=160)[1]
        out = qmm_wo.byte_wo_matmul(tx.to(cuda_device), q.to(cuda_device), scale.to(cuda_device))
        torch.cuda.synchronize()
        ref = (tx.double() @ q.double().t()) * scale.double().reshape(1, -1)
        _held(out.float().cpu().numpy(), ref.numpy())
