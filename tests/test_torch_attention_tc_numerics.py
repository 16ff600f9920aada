"""The arithmetic of the tensor-core attention kernels (`csrc/attn_tc.cuh`,
used by `csrc/flash_gqa.cu` and the tensor-core route of
`csrc/skip_softmax_flash.cu`), emulated in plain PyTorch on the CPU at a
small size, against the port's plain versions.

The emulation walks each q tile's k tiles in order as the kernels do: bf16
q . k^T summed in f32 (bf16 products are exact in f32) and the -1e30 mask,
the f32 online softmax per k tile of 64 or 128 keys in raw-score units
(p = 2^(s c - m c) with c = scale log2(e), so a masked score gives 0; l
summed from the f32 p), P split exactly into three bf16 terms p_hi + p_mid
+ p_lo (8 significant bits each, cut by masks) against bf16 V into one f32
accumulator, and the bf16 output of acc / max(l, 1e-30). For skip-softmax
it also takes each tile's decision from the tile max times the scale (f32)
and the running max of the kept tiles.

Held: every output element to the limit `chip_smoke.py`'s kernels phase
holds the kernels to, |out - ref| <= 2^-8 |ref| + 1e-3 rms(ref), with ref
the plain version's f32 result; skip-softmax keep maps equal to the plain
version's. The same emulation with one bf16 P shows why the kernels split
P: before the output's bf16 rounding, its error is at least 10x the split's
at the median element. With two terms it keeps that limit, but rounds more
than `chip_smoke.py`'s ULP_OFF_MAX of the outputs to another bf16 than the
plain version's; three terms stay under it. Inputs come from a numpy seed.
The skip plain version is also held against JAX's `skip_softmax_flash` at
the tensor-core route's tiles, as `test_torch_sparse_attention.py` does at
the others.
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tensorrt_model_optimizer_tpu.ops.pallas import sparse_attention as jsa
from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa as tflash
from tensorrt_model_optimizer_tpu_torch.ops.cuda import sparse_attention as tsa

MASKED = -1e30


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32."""
    return x.to(torch.bfloat16).float()


def _cut(x: torch.Tensor) -> torch.Tensor:
    """f32 x with the low 16 bits of its pattern cleared: a bf16 value."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _emulate(q, k, v, bq: int, bk: int, causal: bool, terms: int = 3, round_out: bool = True,
             log_thresh=None):
    """The kernels' arithmetic on q, k, v [N, T, d] (bf16 values held in
    f32). `log_thresh` None: flash (every tile up to the causal edge);
    else skip-softmax (S a multiple of both tiles), which also returns the
    keep map [N, T / bq, T / bk]. `terms`: the bf16 terms of P (3 is
    exact)."""
    N, T, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    c = scale * torch.tensor(math.log2(math.e), dtype=torch.float32)
    nq, nk = -(-T // bq), -(-T // bk)
    qp, kp, vp = (torch.cat([x, x.new_zeros((N, n - T, d))], 1) for x, n in ((q, nq * bq), (k, nk * bk),
                                                                           (v, nk * bk)))
    out = torch.empty((N, nq * bq, d))
    keep = torch.zeros((N, nq, nk), dtype=torch.int32)
    for i in range(nq):
        rows = i * bq + torch.arange(bq)
        m = torch.full((N, bq), MASKED)
        lsum = torch.zeros((N, bq))
        acc = torch.zeros((N, bq, d))
        run = torch.full((N,), MASKED)
        last = min(nk - 1, (i * bq + bq - 1) // bk) if causal else nk - 1
        for j in range(last + 1):
            cols = j * bk + torch.arange(bk)
            s = torch.einsum("nqd,nkd->nqk", qp[:, i * bq:(i + 1) * bq], kp[:, j * bk:(j + 1) * bk])
            masked = (cols[None, :] >= T) | ((cols[None, :] > rows[:, None]) if causal else False)
            s = s.masked_fill(masked[None], MASKED)
            kept = torch.ones(N, dtype=torch.bool)
            if log_thresh is not None:
                bm = s.amax(dim=(1, 2)) * scale
                kept = bm >= run + torch.tensor(log_thresh, dtype=torch.float32)
                run = torch.where(kept, torch.maximum(run, bm), run)
                keep[:, i, j] = kept.to(torch.int32)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp2((m - m_new) * c)
            p = torch.exp2(s * c - (m_new * c)[..., None])
            vt = vp[:, j * bk:(j + 1) * bk]
            pv, rest = 0.0, p
            for _ in range(terms):
                term = _cut(rest)
                pv, rest = pv + term @ vt, rest - term
            k3 = kept[:, None]
            lsum = torch.where(k3, lsum * corr + p.sum(dim=-1), lsum)
            acc = torch.where(k3[..., None], acc * corr[..., None] + pv, acc)
            m = torch.where(k3, m_new, m)
        o = acc * (1.0 / lsum.clamp_min(1e-30))[..., None]
        out[:, i * bq:(i + 1) * bq] = _bf16(o) if round_out else o
    return out[:, :T], keep


def _limit(ref32: torch.Tensor) -> torch.Tensor:
    """The kernels phase's per-element limit."""
    return 2.0 ** -8 * ref32.abs() + 1e-3 * ref32.square().mean().sqrt()


def _flash_inputs(seed, B, H, Hkv, T, d):
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
               for s in ((B, H, T, d), (B, Hkv, T, d), (B, Hkv, T, d)))
    return q, k, v


def _flash_emulated(q, k, v, causal, **kw):
    """The kernel's [B, H, T, d] GQA view as N = B H rows of the emulation
    (kv head h / rep, as the kernel reads it)."""
    B, H, T, d = q.shape
    rep = H // k.shape[1]
    kk, vv = (torch.repeat_interleave(x, rep, dim=1).reshape(B * H, T, d) for x in (k, v))
    out, _ = _emulate(q.reshape(B * H, T, d), kk, vv, 128, 64, causal, **kw)
    return out.reshape(B, H, T, d)


@pytest.mark.parametrize("T,d,causal", [(256, 64, True), (200, 128, True), (130, 32, False), (63, 64, True),
                                        (1, 128, True)])
def test_flash_emulation_within_kernel_limit(T, d, causal):
    """128-row q tiles, 64-key k tiles, ragged T: the emulated kernel within
    the kernels phase's per-element limit of the plain version's f32 result."""
    q, k, v = _flash_inputs(T + d, 2, 4, 2, T, d)
    ref32 = tflash.flash_attention_gqa_plain(q, k, v, causal)
    out = _flash_emulated(q, k, v, causal)
    assert bool(((out - ref32).abs() <= _limit(ref32)).all())


@pytest.mark.parametrize("causal", [True, False])
def test_one_bf16_p_is_why_p_is_split(causal):
    """Before the output's rounding, one bf16 P is at least 10x further from
    the plain version's f32 result than the split P, at the median element."""
    q, k, v = _flash_inputs(11, 2, 4, 2, 256, 128)
    ref32 = tflash.flash_attention_gqa_plain(q, k, v, causal)
    err_split = (_flash_emulated(q, k, v, causal, round_out=False) - ref32).abs()
    err_one = (_flash_emulated(q, k, v, causal, terms=1, round_out=False) - ref32).abs()
    assert float(err_one.median()) >= 10 * float(err_split.median())


ULP_OFF_MAX = 1e-3  # chip_smoke.py's: the share of outputs that may round to another bf16


@pytest.mark.parametrize("T,d", [(32, 32), (256, 64)])
def test_two_bf16_terms_round_off_more_outputs(T, d):
    """The bf16 outputs that differ from the plain version's f32 result
    rounded to bf16: two terms of P (~16 bits of p) give more than
    ULP_OFF_MAX of them, three (exact p) stay under it. T 32, d 32 is the
    anchor's prefill."""
    q, k, v = _flash_inputs(T + 3 * d, 4, 8, 4, T, d)
    ref = tflash.flash_attention_gqa_plain(q, k, v, True).to(torch.bfloat16).float()
    share = {t: float((_flash_emulated(q, k, v, True, terms=t) != ref).float().mean()) for t in (2, 3)}
    assert share[3] <= ULP_OFF_MAX < share[2], share


def _skip_inputs(seed, BH, S, d, spike=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((BH, S, d)).astype(np.float32) for _ in range(3))
    if spike:  # attention concentrated on the first 16 keys
        q[:, :, 0] = 8.0
        k[:, :16, 0] = 8.0
    return tuple(a.astype(ml_dtypes.bfloat16) for a in (q, k, v))


def _torch_bf16(a):
    return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)


SKIP_CASES = [(S, d, blocks, th, spike) for S, d in ((256, 64), (512, 32)) for blocks in ((128, 128), (64, 64),
                                                                                           (128, 64), (64, 128))
              for th, spike in ((1e-30, False), (1e-2, True), (0.5, False))]


@pytest.mark.parametrize("S,d,blocks,th,spike", SKIP_CASES)
def test_skip_emulation_matches_plain(S, d, blocks, th, spike):
    """The tensor-core route's tiles, causal: keep maps equal to the plain
    version's, outputs within the kernels phase's per-element limit."""
    q, k, v = (_torch_bf16(a) for a in _skip_inputs(S + d + blocks[1], 2, S, d, spike))
    assert tsa.route(q.dtype, d, *blocks) == "tensor_core"
    ref32, rkeep = tsa.skip_softmax_flash_plain(q.float(), k.float(), v.float(), th, *blocks, True)
    out, keep = _emulate(q.float(), k.float(), v.float(), *blocks, True, log_thresh=tsa.log_threshold(th))
    assert torch.equal(keep, rkeep)
    assert bool(((out - ref32).abs() <= _limit(ref32)).all())


@pytest.mark.parametrize("blocks", [(128, 128), (64, 64), (128, 64)])
@pytest.mark.parametrize("th,spike", [(1e-30, False), (1e-2, True)])
def test_skip_plain_matches_jax_at_tensor_core_tiles(blocks, th, spike):
    """bf16, S 256, d 64: the plain version against JAX's public
    `skip_softmax_flash` (its CPU emulation): keep maps bit-equal, outputs
    within one bf16 ulp (both compute in f32 and round once) plus 1e-6 of
    the output's scale: an output that cancels to ~1e-6 of the scale (the
    spiked inputs give some) carries the f32 rounding of sums taken in
    another order."""
    q, k, v = _skip_inputs(7, 2, 256, 64, spike)
    jo, jk = jsa.skip_softmax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), threshold=th,
                                    block_q=blocks[0], block_k=blocks[1], causal=True)
    to, tk = tsa.skip_softmax_flash(_torch_bf16(q), _torch_bf16(k), _torch_bf16(v), th, *blocks, True)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    want = np.asarray(jo).astype(np.float32)
    got = to.float().numpy()
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= np.ldexp(np.float32(1.0), e - 8) + 1e-6 * np.abs(want).max()).all()
