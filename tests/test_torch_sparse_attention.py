"""The port's `skip_softmax_flash` (its plain version here; the CUDA kernel on
a card) against JAX's `ops/pallas/sparse_attention.skip_softmax_flash`,
which on the CPU takes its emulation `_skip_softmax_ref` (the kernel's keep
semantics exactly). Inputs come from a numpy seed and go to both sides.

Tiles follow the halving rule, so they can be odd, tiny or unequal: S = 5
gives tiles of 5, S = 131 tiles of 1, S = 200 with blocks 128 tiles of 8.
Held: the keep maps bit-equal; f32 outputs within 1e-5 (f32 sums in another
order), bf16 outputs within one bf16 ulp (both sides compute in f32 and
round once)."""

import functools
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu.ops.pallas import sparse_attention as jsa
from tensorrt_model_optimizer_tpu_torch.ops.cuda import sparse_attention as tsa

THRESHOLDS = (1e-30, 1e-3, 1e-2, 0.5, 0.999999, 2.0)
SHAPES = [(S, blocks) for S in (5, 16, 48, 131, 200) for blocks in ((16, 16), (8, 16), (128, 128))]


def _ulp_bf16(x):
    """One bf16 ulp at |x|: 2^(e - 8) for |x| = m 2^e, m in [0.5, 1)."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def _inputs(seed, S, d, dtype, BH=2, spike=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((BH, S, d)).astype(np.float32) for _ in range(3))
    if spike:  # attention concentrated on the first 16 keys
        q[:, :, 0] = 8.0
        k[:, :16, 0] = 8.0
    if dtype == "bf16":
        q, k, v = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    return q, k, v


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


@functools.partial(jax.jit, static_argnums=(5, 6, 7))
def _jax_ref(q, k, v, scale, log_thresh, bq, bk, causal):
    """The emulation JAX's `skip_softmax_flash` runs on the CPU, compiled once
    per shape: the scale and log threshold enter as f32 scalars, as the
    Python floats the public function passes do."""
    return jsa._skip_softmax_ref(q, k, v, scale, log_thresh, bq, bk, causal)


def _jax(q, k, v, threshold, blocks, causal, public):
    q, k, v = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if public:
        return jsa.skip_softmax_flash(q, k, v, threshold=threshold, block_q=blocks[0], block_k=blocks[1],
                                      causal=causal)
    S, d = q.shape[1], q.shape[2]
    return _jax_ref(q, k, v, 1.0 / math.sqrt(d), math.log(max(threshold, 1e-30)),
                    *tsa.tile_sizes(S, *blocks), causal)


def _check(q, k, v, threshold, blocks, causal, public=True):
    jo, jk = _jax(q, k, v, threshold, blocks, causal, public)
    to, tk = tsa.skip_softmax_flash(_torch(q), _torch(k), _torch(v), threshold, blocks[0], blocks[1], causal)
    assert tk.dtype == torch.int32 and to.dtype == _torch(q).dtype
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    want = np.asarray(jo).astype(np.float32)
    got = to.float().numpy()
    if q.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert (np.abs(got - want) <= _ulp_bf16(np.maximum(np.abs(got), np.abs(want)))).all()
    return tk


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,blocks", SHAPES)
def test_plain_matches_jax(S, blocks, causal):
    """Every threshold, d 16 and 32, f32 and bf16, at one tile geometry; the
    public JAX function at threshold 1e-2 (its own halving rule), its
    emulation compiled once for the others."""
    for i, (d, dtype) in enumerate([(16, "f32"), (32, "f32"), (16, "bf16"), (32, "bf16")]):
        q, k, v = _inputs(100 * S + i, S, d, dtype)
        for th in THRESHOLDS:
            _check(q, k, v, th, blocks, causal, public=th == 1e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_spike_skips_and_matches_jax(causal):
    """Attention concentrated on the first 16 keys: threshold 1e-2 skips
    tiles, 1e-30 keeps all but the causal ones, both equal to JAX's."""
    q, k, v = _inputs(7, 128, 32, "f32", spike=True)
    keep = _check(q, k, v, 1e-2, (16, 16), causal).numpy()
    full = _check(q, k, v, 1e-30, (16, 16), causal).numpy()
    structural = 36 / 64 if causal else 1.0  # 8 x 8 tiles, the diagonal and below
    assert full.mean() == structural and keep.mean() < structural


def test_tile_sizes_halving_rule():
    assert tsa.tile_sizes(5, 128, 128) == (5, 5)
    assert tsa.tile_sizes(200, 128, 128) == (8, 8)
    assert tsa.tile_sizes(131, 128, 16) == (1, 1)
    assert tsa.tile_sizes(48, 8, 16) == (8, 16)
    assert tsa.tile_sizes(2048, 128, 64) == (128, 64)


def test_route_from_dtype_head_dim_and_tiles():
    """The tensor cores take bf16, head_dim 32/64/128 and tiles of 64 or 128
    rows (the 8B sparse prefill's 128-tiles, the anchor's 64-tiles); f32, d 16
    and the halving rule's odd tiles go to the CUDA cores."""
    for d in (32, 64, 128):
        for bq in (64, 128):
            for bk in (64, 128):
                assert tsa.route(torch.bfloat16, d, bq, bk) == "tensor_core"
    assert tsa.route(torch.float32, 32, 64, 64) == "cuda_core"      # the RULER anchor
    assert tsa.route(torch.float32, 128, 128, 128) == "cuda_core"
    assert tsa.route(torch.bfloat16, 16, 64, 64) == "cuda_core"
    for S in (131, 200, 5, 48):                                     # tiles of 1, 8, 5, 16
        assert tsa.route(torch.bfloat16, 128, *tsa.tile_sizes(S, 128, 128)) == "cuda_core"
    assert tsa.route(torch.bfloat16, 128, 128, 32) == "cuda_core"


def test_keep_frac_counts_structural_tiles():
    """16 tokens in 8-tiles, causal, nothing skipped by the threshold: 3 of
    the 4 tiles are kept (the keep fraction is over ALL tiles)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 16, 16, "f32"))
    _, keep = tsa.skip_softmax_flash(q, k, v, 1e-30, 8, 8, causal=True)
    assert float(keep.float().mean()) == 0.75


def test_decision_margins():
    """`tile_decisions` keeps a tile iff its margin is >= 0, and the plain
    version's keep map is the decisions over `block_max`."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 48, 16, "f32"))
    bm = tsa.block_max(q, k, 16, 16, True)
    keep, margin = tsa.tile_decisions(bm, tsa.log_threshold(0.5), 16, 16, True)
    structural = torch.arange(3)[None, :, None] >= torch.arange(3)[None, None, :]
    assert torch.equal(keep, (margin >= 0) & structural)
    assert torch.equal(tsa.skip_softmax_flash_plain(q, k, v, 0.5, 16, 16, True)[1], keep.to(torch.int32))


def test_wrapper_rejects_shapes():
    q = torch.zeros((2, 16, 16))
    with pytest.raises(ValueError):
        tsa.skip_softmax_flash(q, q[:, :8], q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,d,blocks", [(5, 16, (16, 16)), (131, 32, (128, 128)), (200, 64, (8, 16)),
                                        (256, 128, (128, 128)), (448, 32, (64, 64)), (256, 64, (64, 64)),
                                        (512, 128, (128, 64)), (512, 32, (64, 128)), (512, 64, (128, 128))])
def test_kernel_matches_plain(cuda_device, S, d, blocks, dtype):
    """The CUDA kernel against its plain version on the card, through the
    route `route` picks (bf16 at 64- and 128-tiles: the tensor cores), on
    random and on spiked inputs (attention concentrated on the first 16
    keys): keep maps equal, outputs within 1e-5 (f32) or 2^-8 of the f32
    result plus 1e-3 of its rms (bf16: the output's rounding)."""
    g = torch.Generator(device=cuda_device).manual_seed(S)
    which = tsa.route(dtype, d, *tsa.tile_sizes(S, *blocks))
    for causal in (True, False):
        for th, spike in ((1e-30, False), (1e-2, False), (0.999999, False), (1e-2, True)):
            q, k, v = (torch.randn((3, S, d), generator=g, device=cuda_device) for _ in range(3))
            if spike:
                q[:, :, 0] = 8.0
                k[:, :16, 0] = 8.0
            q, k, v = (t.to(dtype) for t in (q, k, v))
            n0, r0 = tsa.launches, tsa.route_launches[which]
            out, keep = tsa.skip_softmax_flash(q, k, v, th, blocks[0], blocks[1], causal)
            torch.cuda.synchronize()
            assert tsa.launches == n0 + 1 and tsa.route_launches[which] == r0 + 1
            ref, rkeep = tsa.skip_softmax_flash_plain(q.float(), k.float(), v.float(), th, blocks[0], blocks[1],
                                                      causal)
            assert torch.equal(keep, rkeep)
            diff = (out.float() - ref).abs()
            if dtype == torch.float32:
                assert float(diff.max()) <= 1e-5
            else:
                assert bool((diff <= 2.0 ** -8 * ref.abs() + 1e-3 * ref.square().mean().sqrt()).all())
