"""The port's W4A8 GEMM (plain version here; the CUDA kernel on a card)
against JAX's `qmm_int4_w48` Pallas kernel in interpret mode, on the same
packed weights: the decode shape (N = 8) and the row-tiled prefill shape
(N = 1024, the kernel's gn > 1 path), and the plain version under the
decode route's split of K. Relative error <= 1e-3: both sum the exact int32
block products in f32, in another order.

On a card the kernel is held to its plain version bit for bit (the same
exact block sums, folded in the same order, splits included) on both
routes, at every N of the decode route and at ragged tiles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, rel_err  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu.ops.pallas import qmm as jqmm
from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm as tqmm
from tensorrt_model_optimizer_tpu_torch.quant.config import INT4_PER_BLOCK_128
from tensorrt_model_optimizer_tpu_torch.quant import compress as tc

O, K = 256, 2048
# Llama-3.1-8B's projections: (O, K)
PROJ_8B = {"q_proj/o_proj": (4096, 4096), "k_proj/v_proj": (1024, 4096), "gate_proj/up_proj": (14336, 4096),
           "down_proj": (4096, 14336)}


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x8 = rng.integers(-127, 128, size=(n, K)).astype(np.int8)
    packed = rng.integers(0, 256, size=(O // 2, K), dtype=np.uint8)
    s_lo = rng.uniform(0.5, 2.0, size=(O // 2, K // 128)).astype(np.float32)
    s_hi = rng.uniform(0.5, 2.0, size=(O // 2, K // 128)).astype(np.float32)
    return x8, packed, s_lo, s_hi


@pytest.mark.parametrize("n", [8, 1024])
def test_plain_w4a8_matches_pallas_w48(n):
    x8, packed, s_lo, s_hi = _inputs(n, seed=n)
    pw, sc = jqmm.int4_w48_pack(jnp.asarray(packed), jnp.asarray(s_lo), jnp.asarray(s_hi))
    ref = np.asarray(jqmm.qmm_int4_w48(jnp.asarray(x8), pw, sc))
    a8 = tc.int4_a8_pack(torch.from_numpy(packed), torch.from_numpy(s_lo), torch.from_numpy(s_hi))
    out = tqmm.w4a8_matmul(torch.from_numpy(x8), a8["packed"], a8["scales"])
    assert out.dtype == torch.float32 and out.shape == (n, O)
    assert rel_err(out.numpy(), ref) < 1e-3


def test_plain_w4a8_ragged_k_equals_padded_dense():
    """K = 704 (5.5 blocks): the padded tail adds nothing; equal to an f64
    dense product with the bf16-rounded scales, to f32 rounding."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.standard_normal((96, 704)) * 0.05).astype(np.float32))
    _, arr = tc.compress_weight(w, INT4_PER_BLOCK_128, None)
    a8 = tc.int4_a8_pack(arr["packed"], arr["scale_lo"], arr["scale_hi"])
    x8 = torch.from_numpy(rng.integers(-127, 128, size=(5, 704)).astype(np.int8))
    out = tqmm.w4a8_matmul(x8, a8["packed"], a8["scales"])
    wd = tc.decompress_weight("int4a8", a8, torch.float32).double()
    ref = x8.double() @ wd.t()
    assert rel_err(out.numpy(), ref.numpy()) < 1e-6


def test_wrapper_rejects_bad_shapes():
    x8, packed, s_lo, s_hi = _inputs(8, seed=0)
    a8 = tc.int4_a8_pack(torch.from_numpy(packed), torch.from_numpy(s_lo), torch.from_numpy(s_hi))
    with pytest.raises(ValueError):
        tqmm.w4a8_matmul(torch.zeros((8, K + 128), dtype=torch.int8), a8["packed"], a8["scales"])
    with pytest.raises(TypeError):
        tqmm.w4a8_matmul(torch.zeros((8, K)), a8["packed"], a8["scales"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 1024])
def test_kernel_bit_exact_with_plain(cuda_device, n):
    x8, packed, s_lo, s_hi = _inputs(n, seed=n)
    a8 = tc.int4_a8_pack(torch.from_numpy(packed), torch.from_numpy(s_lo), torch.from_numpy(s_hi))
    args = (torch.from_numpy(x8).to(cuda_device), a8["packed"].to(cuda_device), a8["scales"].to(cuda_device))
    out = tqmm.w4a8_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, tqmm.w4a8_matmul_plain(*args))


def _a8(o, k, seed):
    """Seeded plane-packed int4 codes and f32 block scales of an [o, k]
    weight -> (plane arrays for JAX, "int4a8" arrays)."""
    rng = np.random.default_rng(seed)
    nblk = -(-k // 128)
    packed = rng.integers(0, 256, size=(o // 2, k), dtype=np.uint8)
    s_lo, s_hi = (rng.uniform(0.5, 2.0, size=(o // 2, nblk)).astype(np.float32) for _ in range(2))
    a8 = tc.int4_a8_pack(torch.from_numpy(packed), torch.from_numpy(s_lo), torch.from_numpy(s_hi))
    return (packed, s_lo, s_hi), a8


def _x8(n, k, seed):
    return np.random.default_rng(seed).integers(-127, 128, size=(n, k)).astype(np.int8)


def _fold(x8, packed, scales, bounds):
    """The block folds written out: each run of blocks from 0.0 in order,
    the runs added in order (the schedule the docstring of
    `w4a8_matmul_plain` states)."""
    nblk, o = scales.shape
    codes = tqmm.int4_a8_codes(packed).double()
    xp = torch.nn.functional.pad(x8.double(), (0, nblk * 128 - x8.shape[1]))
    total = None
    for b0, b1 in bounds:
        acc = torch.zeros((x8.shape[0], o), dtype=torch.float32)
        for b in range(b0, b1):
            r = (xp[:, b * 128:(b + 1) * 128] @ codes[:, b * 128:(b + 1) * 128].t()).float()
            acc = acc + r * scales[b].float()
        total = acc if total is None else total + acc
    return total


@pytest.mark.parametrize("k,n_split", [(2048, 1), (2048, 3), (2048, 16), (704, 1), (704, 3), (704, 6)])
def test_plain_split_matches_pallas_w48(k, n_split):
    """The plain version under the decode route's split (1 run; 3 runs of
    5, 5, 6 blocks; one block a run) at N = 8, against JAX's qmm_int4_w48
    (Pallas, interpret mode) at 1e-3. K = 704 (the last block ragged) is
    beyond JAX's tiling (ROADMAP queue 3): JAX gets the same function with
    K padded by zero codes and zero activations to 768."""
    (packed, s_lo, s_hi), a8 = _a8(O, k, seed=k + n_split)
    x8 = _x8(8, k, seed=n_split)
    kp = -(-k // 128) * 128
    pw, sc = jqmm.int4_w48_pack(jnp.asarray(np.pad(packed, ((0, 0), (0, kp - k)))), jnp.asarray(s_lo),
                                jnp.asarray(s_hi))
    ref = np.asarray(jqmm.qmm_int4_w48(jnp.asarray(np.pad(x8, ((0, 0), (0, kp - k)))), pw, sc))
    out = tqmm.w4a8_matmul_plain(torch.from_numpy(x8), a8["packed"], a8["scales"], n_split=n_split)
    assert out.dtype == torch.float32 and out.shape == (8, O)
    assert rel_err(out.numpy(), ref) < 1e-3


@pytest.mark.parametrize("n,k", [(8, 2048), (100, 704), (3, 96)])
def test_plain_one_split_is_the_left_to_right_fold(n, k):
    """n_split = 1, and the default on the CPU, are one fold over all blocks
    in order, bit for bit; other splits fold each run from 0.0 and add the
    runs in order, bit for bit."""
    _, a8 = _a8(64, k, seed=k)
    x8 = torch.from_numpy(_x8(n, k, seed=n))
    nblk = a8["scales"].shape[0]
    one = _fold(x8, a8["packed"], a8["scales"], [(0, nblk)])
    assert torch.equal(tqmm.w4a8_matmul_plain(x8, a8["packed"], a8["scales"], n_split=1), one)
    assert torch.equal(tqmm.w4a8_matmul_plain(x8, a8["packed"], a8["scales"]), one)
    assert torch.equal(tqmm.w4a8_matmul(x8, a8["packed"], a8["scales"]), one)
    if nblk > 1:
        split = tqmm.w4a8_matmul_plain(x8, a8["packed"], a8["scales"], n_split=2)
        assert torch.equal(split, _fold(x8, a8["packed"], a8["scales"], [(0, nblk // 2), (nblk // 2, nblk)]))
    with pytest.raises(ValueError):
        tqmm.w4a8_matmul_plain(x8, a8["packed"], a8["scales"], n_split=nblk + 1)


@pytest.mark.parametrize("proj", list(PROJ_8B))
@pytest.mark.parametrize("n", [8, 16])
def test_w4a8_decode_splits_at_8b_shapes(proj, n):
    """On an H100 (132 SMs), every 8B projection's decode grid: one wave of
    blocks (DECODE_WAVE a SM), whole 128-blocks, MIN_SPLIT_BLOCKS or more in
    every split; the prefill route (N > 16) takes one split."""
    o, k = PROJ_8B[proj]
    splits = tqmm.w4a8_decode_splits(n, k, o, 132)
    nkb = k // 128
    runs = [(sp + 1) * nkb // splits - sp * nkb // splits for sp in range(splits)]
    assert sum(runs) == nkb and min(runs) >= tqmm.MIN_SPLIT_BLOCKS
    assert -(-o // tqmm.DECODE_ROWS) * splits <= tqmm.DECODE_WAVE[n > 8] * 132
    assert splits == tqmm.decode_splits(o, k, n, 132) > 1
    for big in (17, 16384):
        assert tqmm.w4a8_decode_splits(big, k, o, 132) == 1


def _bytes_i8(v):
    """32-bit words [..., W] (int64) -> their 4 bytes as signed ints [..., W, 4]."""
    b = torch.stack([(v >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    return torch.where(b >= 128, b - 256, b)


MAGIC = 0x4B400000  # the bits of 1.5 * 2^23, where the kernel starts each block's int32 sum
MAGIC_F = 12582912.0


def test_fragment_emulation_matches_plain():
    """The kernel's arithmetic, both routes, written out in PyTorch.
    - Codes enter the MMA as 16q: a packed word's high nibbles masked in
      place (k 8g + 4..7), its low ones shifted up and masked (k 8g + 0..3).
    - The decode route's k order: in k32 step s, thread t of a lane quad
      takes k 32t + 8s .. 32t + 8s + 7 of the block for its A and B slots,
      so the four steps cover the block once (the prefill route's wgmma
      takes k in order; an exact int32 sum does not depend on it).
    - Each block's int32 sum starts at MAGIC, so its bits as f32 are
      MAGIC + 16v exactly.
    - The fold: one FFMA with s / 16 and -MAGIC * s / 16 (exact in f64
      here, then one rounding to f32), then an f32 add; the fallback for
      scales of 2^64 or more subtracts MAGIC first and multiplies.
    - Folds and splits follow the plain version's schedule.
    Equal to the plain version bit for bit, split or not, on both folds."""
    n, o, k = 5, 48, 704
    _, a8 = _a8(o, k, seed=7)
    x8 = torch.from_numpy(_x8(n, k, seed=8))
    packed, scales = a8["packed"], a8["scales"]
    nblk = scales.shape[0]
    # every byte through the decode, against the layout's own codes
    words = packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF  # [o, nblk * 16], word g: k 8g .. 8g + 7
    lo, hi = _bytes_i8((words << 4) & 0xF0F0F0F0), _bytes_i8(words & 0xF0F0F0F0)
    codes16 = torch.cat([lo, hi], dim=-1).reshape(o, nblk * 128)
    assert torch.equal(codes16, 16 * tqmm.int4_a8_codes(packed).to(torch.int64))
    # the k order of one block's four k32 steps: a permutation of 0..127
    order = torch.tensor([32 * t + 8 * s + j for s in range(4) for t in range(4) for j in range(8)])
    assert torch.equal(order.sort().values, torch.arange(128))
    xp = torch.nn.functional.pad(x8.to(torch.int64), (0, nblk * 128 - k))
    s16 = scales.float() * 0.0625
    nms = -MAGIC_F * s16
    for n_split in (1, 2, nblk):
        totals = {}
        for fast in (True, False):
            total = None
            for sp in range(n_split):
                acc = torch.zeros((n, o), dtype=torch.float32)
                for b in range(sp * nblk // n_split, (sp + 1) * nblk // n_split):
                    idx = b * 128 + order
                    isum = MAGIC + xp[:, idx] @ codes16[:, idx].t()  # int32 in the kernel: no overflow
                    assert int(isum.max()) < 2 ** 31 and int(isum.min()) > 0
                    f = isum.to(torch.int32).view(torch.float32)
                    if fast:
                        term = (f.double() * s16[b].double() + nms[b].double()).float()
                    else:
                        term = (f - MAGIC_F) * s16[b]
                    acc = acc + term
                total = acc if total is None else total + acc
            totals[fast] = total
        want = tqmm.w4a8_matmul_plain(x8, packed, scales, n_split=n_split)
        assert torch.equal(totals[True], want) and torch.equal(totals[False], want)
    # the magic conversion is exact over the whole range of 16 x a block's sum
    v = torch.arange(-16 * 128 * 127 * 8, 16 * 128 * 127 * 8 + 1, 7, dtype=torch.int64)
    assert torch.equal(((MAGIC + v).to(torch.int32).view(torch.float32) - MAGIC_F).to(torch.int64), v)


@pytest.mark.cuda
@pytest.mark.parametrize("o,k", [(200, 704), (66, 2432), (40, 8192), (1024, 4096)])
def test_decode_route_every_n_bit_exact(cuda_device, o, k):
    """The decode route at N = 1 .. 16 (one n8 tile of tokens up to 8, two
    above) and the prefill route at N = 17, bit for bit against the plain
    version with the kernel's split: O = 200 and K = 704 (6 K blocks, the
    last ragged, 2 splits), O = 66 and K = 2432 (19 blocks in 5 splits of 3
    and 4, a ragged row tile), O = 40 and K = 8192 (16 splits: the fix-up
    reads them in two batches), k_proj's O = 1024 and K = 4096 (8 splits)."""
    _, a8 = _a8(o, k, seed=o + k)
    packed, scales = a8["packed"].to(cuda_device), a8["scales"].to(cuda_device)
    for n in range(1, 18):
        x8 = torch.from_numpy(_x8(n, k, seed=n)).to(cuda_device)
        out = tqmm.w4a8_matmul(x8, packed, scales)
        ref = tqmm.w4a8_matmul_plain(x8, packed, scales)
        torch.cuda.synchronize()
        assert out.shape == (n, o)
        assert torch.equal(out, ref), f"N={n}: max abs diff {float((out - ref).abs().max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,o,k", [(1, 24, 128), (17, 66, 256), (100, 130, 704), (129, 64, 96), (1024, 384, 2048)])
def test_ragged_tiles_bit_exact(cuda_device, n, o, k):
    """Tiles that N, O and K do not fill: one token and a part row tile
    (decode route); N = 17, 100, 129 and O = 66, 130, 64 past the prefill
    route's tiles of 192 output rows x 128 tokens; K = 704 and 96 past the
    128-block (x has K columns, the packed rows Kp); N = 1024."""
    _, a8 = _a8(o, k, seed=n + o + k)
    x8 = torch.from_numpy(_x8(n, k, seed=n)).to(cuda_device)
    args = (x8, a8["packed"].to(cuda_device), a8["scales"].to(cuda_device))
    out = tqmm.w4a8_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, tqmm.w4a8_matmul_plain(*args))


@pytest.mark.cuda
def test_decode_route_reuses_its_workspace(cuda_device):
    """k_proj's shape (O 1024, K 4096: 8 splits of 4 K blocks): two calls
    with different activations on the one workspace, each bit-equal to the
    plain version, then the first activations again: bit-identical to the
    first call (the last arrival set every counter back to 0)."""
    _, a8 = _a8(1024, 4096, seed=3)
    packed, scales = a8["packed"].to(cuda_device), a8["scales"].to(cuda_device)
    assert tqmm.w4a8_decode_splits(8, 4096, 1024, torch.cuda.get_device_properties(cuda_device).multi_processor_count) > 1
    x1, x2 = (torch.from_numpy(_x8(8, 4096, seed=s)).to(cuda_device) for s in (11, 12))
    y1, y2, y1_again = (tqmm.w4a8_matmul(x, packed, scales) for x in (x1, x2, x1))
    torch.cuda.synchronize()
    for y, x in ((y1, x1), (y2, x2)):
        assert torch.equal(y, tqmm.w4a8_matmul_plain(x, packed, scales))
    assert torch.equal(y1, y1_again)
