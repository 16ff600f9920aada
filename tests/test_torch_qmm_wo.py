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
from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm as tqmm
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


# ---- the decode route's split over K (csrc/qmm_wo_common.cuh decode_kernel) ----


def _split_bounds(nkb, n_split):
    """The K blocks [b0, b1) of each split, as the kernel cuts them
    (`decode_kernel`: kb0 = sp * nkb / n_split)."""
    return [(sp * nkb // n_split, (sp + 1) * nkb // n_split) for sp in range(n_split)]


def _int4_split_k(x, packed, scales, n_split):
    """The kernel's int4 order at decode: K blocks of 128 shared out by
    `_split_bounds`; a split's partial is the sum over its blocks, in
    order, of s[b, o] times the block's f32 sum (each product and sum
    rounded to f32, as __fmul_rn / __fadd_rn); the splits' partials add in
    split order 0, 1, ... (the fix-up)."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda.qmm import int4_a8_codes

    nblk, O = scales.shape
    codes = int4_a8_codes(packed).float()
    xp = torch.nn.functional.pad(x.float(), (0, nblk * 128 - x.shape[1]))
    total = None
    for b0, b1 in _split_bounds(nblk, n_split):
        acc = torch.zeros((x.shape[0], O))
        for b in range(b0, b1):
            blk = slice(b * 128, (b + 1) * 128)
            acc = acc + (xp[:, blk] @ codes[:, blk].t()) * scales[b]
        total = acc if total is None else total + acc
    return total


@pytest.mark.parametrize("k,n_split", [(2048, 3), (2048, 16), (2048, 1), (704, 4), (704, 6)])
def test_split_k_order_matches_plain(k, n_split):
    """Whole 128-blocks, splits summed in order: against the plain version
    (blocks in order over all of K) to f32 rounding, and, at K = 2048,
    against JAX's qmm_int4_bd2 (Pallas, interpret mode) to the bf16
    tolerance of this file. 16 blocks in 3 splits (5, 5, 6) leave a split
    the others do not divide; K = 704 is 6 blocks, the last one ragged (JAX's
    bd2 cannot take it: ROADMAP queue 3), held against an f64 dense product."""
    _, _, tk, ta = _packs("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", o=96, k=k, seed=k + n_split)
    tk2, ta2 = tc.word_convert_site(tk, ta, "bd2")
    jx, tx = _x(8, k=k)
    bounds = _split_bounds(ta2["scales"].shape[0], n_split)
    assert bounds[0][0] == 0 and bounds[-1][1] == ta2["scales"].shape[0]
    assert all(b0 < b1 for b0, b1 in bounds) and all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    split = _int4_split_k(tx, ta2["packed"], ta2["scales"], n_split)
    plain = qmm_wo.int4_wo_matmul_plain(tx, ta2["packed"], ta2["scales"], out_dtype=torch.float32)
    assert float((split - plain).abs().max()) <= 1e-5 * float(plain.abs().max())
    if n_split == 1:
        assert torch.equal(split, plain)
    _held(split.to(torch.bfloat16).float().numpy(),
          (tx.double() @ tc.decompress_weight(tk2, ta2, torch.float32).double().t()).numpy())
    if k == 2048:
        jk, ja, _, _ = _packs("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", o=96, k=k, seed=k + n_split)
        jk2, ja2 = jc.word_convert_site(jk, ja, "bd2")
        _held(split.to(torch.bfloat16).float().numpy(), jqmm.quantized_matmul(jx, jk2, ja2).astype(jnp.float32))


# Llama-3.1-8B's projections: (O, K)
PROJ_8B = {"q_proj/o_proj": (4096, 4096), "k_proj/v_proj": (1024, 4096), "gate_proj/up_proj": (14336, 4096),
           "down_proj": (4096, 14336)}


@pytest.mark.parametrize("proj", list(PROJ_8B))
@pytest.mark.parametrize("n", [8, 16])
def test_decode_split_count_at_8b_shapes(proj, n):
    """On an H100 (132 SMs), every 8B projection's decode grid: whole
    128-blocks in each split, MIN_SPLIT_BLOCKS or more in every split; no
    more blocks than one wave holds (DECODE_WAVE a SM); at least 4 row tiles
    of the fix-up (32 output rows, a warp) per SM over all splits, unless the
    splits are as many as MIN_SPLIT_BLOCKS allows. N = 8: down_proj 12
    splits of 9-10 blocks (768 blocks of 64 rows), gate_proj 3 (672),
    q_proj 8 (512), k_proj 8 (128: its 2 MB of weights take one round trip)."""
    O, K = PROJ_8B[proj]
    splits = tqmm.decode_splits(O, K, n, 132)
    nkb = K // 128
    bounds = _split_bounds(nkb, splits)
    assert sum(b1 - b0 for b0, b1 in bounds) == nkb
    assert min(b1 - b0 for b0, b1 in bounds) >= tqmm.MIN_SPLIT_BLOCKS
    blocks = -(-O // tqmm.DECODE_ROWS) * splits
    assert blocks <= tqmm.DECODE_WAVE[n > 8] * 132
    assert -(-O // tqmm.TILE_ROWS) * splits >= 4 * 132 or splits == nkb // tqmm.MIN_SPLIT_BLOCKS
    if n == 8:
        assert splits == {"down_proj": 12, "gate_proj/up_proj": 3, "q_proj/o_proj": 8, "k_proj/v_proj": 8}[proj]
    assert tqmm.decode_splits(O, 64, n, 132) == 1

WO_FORMATS = [("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "bd2"), ("NVFP4_DEFAULT_CFG", "word2"),
              ("MXFP4_DEFAULT_CFG", "word2"), ("INT8_DEFAULT_CFG", None), ("FP8_DEFAULT_CFG", None)]


def _on_card(dev, preset, layout, o, k, seed):
    _, _, tk, ta = _packs(preset, o=o, k=k, seed=seed)
    if layout is not None:
        tk, ta = tc.word_convert_site(tk, ta, layout)
    arr = {key: (v.to(dev) if isinstance(v, torch.Tensor) else v) for key, v in ta.items()}
    return tk, ta, arr


@pytest.mark.cuda
@pytest.mark.parametrize("preset,layout", WO_FORMATS)
def test_decode_route_every_n(cuda_device, preset, layout):
    """The decode route at N = 1 .. 16 (one n8 tile of tokens up to 8, two
    above) at ragged O and K, against an f64 dense product: O = 200 and K =
    704 (6 K blocks, the last ragged, in 2 splits), O = 66 and K = 2432 (19
    blocks in 5 splits of 3 and 4), O = 40 and K = 8192 (16 splits: the
    fix-up reads them in two batches) and O = 130 at K = 128 (one split, no
    fix-up)."""
    for o, k in ((200, 704), (66, 2432), (40, 8192), (130, 128)):
        tk, ta, arr = _on_card(cuda_device, preset, layout, o, k, seed=o + k)
        ref_w = tc.decompress_weight(tk, ta, torch.float32).double()
        for n in range(1, 17):
            tx = _x(n, k=k, seed=n)[1]
            out = _port_matmul(tx.to(cuda_device), tk, arr)
            torch.cuda.synchronize()
            assert out.shape == (n, o)
            _held(out.float().cpu().numpy(), (tx.double() @ ref_w.t()).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("preset,layout", WO_FORMATS)
def test_decode_route_reuses_its_workspace(cuda_device, preset, layout):
    """k_proj's shape (O 1024, K 4096: 8 splits of 4 K blocks): two calls
    with different activations on the one workspace, each within the
    kernel's limit of the plain version, then the first activations again:
    bit-identical to the first call (the splits add in a fixed order, and
    the last arrival set every counter back to 0)."""
    tk, _, arr = _on_card(cuda_device, preset, layout, 1024, 4096, seed=3)
    assert tqmm.decode_splits(1024, 4096, 8, torch.cuda.get_device_properties(cuda_device).multi_processor_count) > 1
    plain = {"int4wo": qmm_wo.int4_wo_matmul_plain, "nvfp4wo": qmm_wo.fp4_wo_matmul_plain,
             "mxfp4wo": qmm_wo.fp4_wo_matmul_plain}.get(tk, qmm_wo.byte_wo_matmul_plain)
    args = [arr[k] for k in (("packed", "scales", "global_scale") if "packed" in arr else ("q", "scale")) if k in arr]
    x1, x2 = (_x(8, k=4096, seed=s)[1].to(cuda_device) for s in (11, 12))
    y1, y2, y1_again = (_port_matmul(x, tk, arr) for x in (x1, x2, x1))
    torch.cuda.synchronize()
    for y, x in ((y1, x1), (y2, x2)):
        ref = plain(x, *args, out_dtype=torch.float32)
        assert bool(((y.float() - ref).abs() <= 2.0 ** -8 * ref.abs() + 1e-3 * ref.square().mean().sqrt()).all())
    assert torch.equal(y1, y1_again)
