"""The port's calibration modules (`quant/calib/*`, `sparsity/sparsegpt.
hessian_from_acts`) against the JAX package's, on seeded numpy inputs, the
cases of JAX's TestSmoothQuantMath, TestAWQMath, TestMSE, TestHistogram,
TestGPTQ, TestSVDQuantLSQ and TestLocalHessian.

Parity rules (the tolerances):
 - grids: every grid the searches use equals `jnp.linspace`'s values as the
   searches compute them, inside a jitted function, bit for bit;
 - choices (alpha, ratio, per-block shrink, histogram bin): equal to JAX's
   wherever JAX's own losses for the two candidates differ by more than
   1e-5 relative; any other difference is counted and printed;
 - f32 scales and amaxes: within 4 ulp of JAX's; bf16 folded weights equal
   except at rounding ties, whose share is at most 0.1%;
 - GPTQ: the updated weight within 1e-3 relative of JAX's (the port adds a
   block's errors in one product, JAX one column at a time), its output
   error ||X (Wq - W)^T||^2 within 1% of JAX's;
 - SVDQuant: B @ A and the residual within 1e-4 relative; the factors up
   to the sign of each rank-1 pair;
 - histogram counts and the Hessian: equal, and within 1e-6 relative.
`torch.pow` and XLA's pow differ by one ulp on ~1-2% of f32 inputs, which is
why scales are held to ulps, not bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.ops import numerics as jnum
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.quant.calib import awq as jawq
from tensorrt_model_optimizer_tpu.quant.calib import gptq as jgptq
from tensorrt_model_optimizer_tpu.quant.calib import histogram as jhist
from tensorrt_model_optimizer_tpu.quant.calib import mse as jmse
from tensorrt_model_optimizer_tpu.quant.calib import smoothquant as jsq
from tensorrt_model_optimizer_tpu.quant.calib import svdquant as jsvd
from tensorrt_model_optimizer_tpu.sparsity import sparsegpt as jsgpt
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.ops import numerics as tnum
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.quant.calib import awq as tawq
from tensorrt_model_optimizer_tpu_torch.quant.calib import gptq as tgptq
from tensorrt_model_optimizer_tpu_torch.quant.calib import histogram as thist
from tensorrt_model_optimizer_tpu_torch.quant.calib import linspace
from tensorrt_model_optimizer_tpu_torch.quant.calib import mse as tmse
from tensorrt_model_optimizer_tpu_torch.quant.calib import smoothquant as tsq
from tensorrt_model_optimizer_tpu_torch.quant.calib import svdquant as tsvd
from tensorrt_model_optimizer_tpu_torch.sparsity import sparsegpt as tsgpt

TIE_REL = 1e-5   # a JAX loss gap at most this (relative) may pick either candidate
SCALE_ULP = 4    # f32 scales: within this many ulp of JAX's
BF16_TIES = 1e-3  # share of bf16 folded weights that may sit one rounding tie apart

# every grid of the searches: (start, stop, num) -> where
GRIDS = {(0.0, 1.0, 11): "awq_lite alphas", (1.0, 0.5, 8): "awq_clip ratios",
         (0.25, 1.0, 64): "histogram mse_amax", (0.3, 1.0, 16): "mse_amax_search",
         (0.5, 1.0, 8): "local_hessian_amax_search"}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _ulps(a, b) -> float:
    a, b = np.asarray(_np(a), np.float32), np.asarray(_np(b), np.float32)
    return float(np.max(np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b)).astype(np.float64)))


def _held_choices(what, port_idx, jax_idx, jax_losses):
    """Port and JAX grid choices [...] equal wherever JAX's losses
    [n_grid, ...] at the two choices differ by more than TIE_REL."""
    port_idx, jax_idx, jax_losses = _np(port_idx), _np(jax_idx), np.asarray(jax_losses, np.float64)
    apart = np.argwhere(port_idx != jax_idx)
    for pos in apart:
        pos = tuple(pos)
        lp = jax_losses[(port_idx[pos],) + pos]
        lj = jax_losses[(jax_idx[pos],) + pos]
        gap = abs(lp - lj) / max(abs(lj), 1e-30)
        print(f"{what}: choice at {pos} differs, JAX losses {lj!r} (JAX's) vs {lp!r} (port's), gap {gap:.3g}")
        assert gap <= TIE_REL, f"{what}: choices differ beyond a tie at {pos}"
    print(f"{what}: {len(apart)} of {port_idx.size} choices differ (ties)")


def _index_of(values, grid):
    grid = np.asarray(_np(grid), np.float64)
    return np.argmin(np.abs(np.asarray(_np(values), np.float64)[None] - grid.reshape((-1,) + (1,) * np.ndim(values))),
                     axis=0)


def _bf16_ties_share(a, b) -> float:
    """Share of bf16 elements apart; raises unless every one is one bf16
    step apart (a rounding tie)."""
    a, b = _np(a.float()), np.asarray(b, np.float32)
    apart = a != b
    if apart.any():
        step = np.abs(a[apart] - b[apart]) / np.spacing(np.abs(b[apart]).astype(np.float32)) / 2 ** 16
        assert np.all(step <= 1.0 + 1e-6), "bf16 folded weights more than one step apart"
    return float(apart.mean())


@pytest.mark.parametrize("grid", list(GRIDS), ids=list(GRIDS.values()))
def test_grids_equal_jax_bit_for_bit(grid):
    start, stop, n = grid
    want = np.asarray(jax.jit(lambda: jnp.linspace(start, stop, n))())
    got = linspace(start, stop, n).numpy()
    assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32)), GRIDS[grid]


# --------------------------------------------------------------------------
# SmoothQuant
# --------------------------------------------------------------------------


def _sq_case(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 32)).astype(np.float32) * np.exp(rng.normal(size=32)).astype(np.float32)
    ws = [rng.normal(size=(16, 32)).astype(np.float32), rng.normal(size=(24, 32)).astype(np.float32)]
    return x, ws


@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.85, 1.0])
def test_smoothquant_scales_and_fold_match_jax(alpha):
    x, ws = _sq_case(0)
    act = np.abs(x).max(axis=0)
    act[3] = 0.0  # a degenerate channel keeps scale 1
    js = jsq.smoothquant_scales(jnp.asarray(act), [jnp.asarray(w) for w in ws], alpha)
    ts = tsq.smoothquant_scales(torch.from_numpy(act), [torch.from_numpy(w) for w in ws], alpha)
    assert _ulps(ts, js) <= SCALE_ULP
    wb = [jnp.asarray(w, jnp.bfloat16) for w in ws]
    jf, jp = jsq.apply_smoothquant(jnp.asarray(act), wb, alpha)
    tf, tp = tsq.apply_smoothquant(torch.from_numpy(act), [convert.tensor_from_array(w) for w in wb], alpha)
    assert _ulps(tp, jp) <= SCALE_ULP
    for t, j in zip(tf, jf):
        assert t.dtype == torch.bfloat16
        assert _bf16_ties_share(t, np.asarray(j, np.float32)) <= BF16_TIES


def test_smoothquant_auto_matches_jax():
    rng = np.random.default_rng(3)
    L, n, d = 3, 48, 32
    x = (rng.normal(size=(L, n, d)) * np.exp(rng.normal(size=(L, 1, d)))).astype(np.float32)
    ws = [rng.normal(size=(L, 16, d)).astype(np.float32), rng.normal(size=(L, 8, d)).astype(np.float32)]
    act = np.abs(x).max(axis=1)
    wcfg = jconfig.INT8_PER_CHANNEL
    jq = jptq._weight_qfns([wcfg, wcfg])
    tc = convert.quantizer_cfg_from_jax(wcfg)
    tq = [lambda w: tptq.Q.quantize(w, tptq._dynamic_like(tc), None)] * 2  # the stack, as JAX's closures
    jf, jp, jb = jsq.smoothquant_auto(jnp.asarray(x), jnp.asarray(act), [jnp.asarray(w) for w in ws], jq)
    tf, tp, tb = tsq.smoothquant_auto(torch.from_numpy(x), torch.from_numpy(act), [torch.from_numpy(w) for w in ws],
                                      tq)

    def jax_losses():
        out = []
        for alpha in (None, *jsq.AUTO_ALPHAS):
            s = jnp.ones_like(jnp.asarray(act)) if alpha is None else jsq.smoothquant_scales(
                jnp.asarray(act), [jnp.asarray(w) for w in ws], alpha)
            xs_ = jnp.asarray(x) * (1.0 / s)[:, None, :]
            a_amax = jnp.max(jnp.abs(xs_), axis=(1, 2), keepdims=True)
            a_sc = jnp.where(a_amax == 0, 1.0, a_amax / 127.0)
            xq = jnp.clip(jnp.round(xs_ / a_sc), -128, 127) * a_sc
            err = 0.0
            for w, q in zip(ws, jq):
                wf = jnp.asarray(w)
                err = err + jnp.mean((jnp.einsum("lnk,lok->lno", jnp.asarray(x), wf)
                                      - jnp.einsum("lnk,lok->lno", xq, q(wf * s[:, None, :]))) ** 2, axis=(1, 2))
            out.append(np.asarray(err))
        return np.stack(out)

    _held_choices("smoothquant_auto alpha", tb, np.asarray(jb), jax_losses())
    same = _np(tb) == np.asarray(jb)
    assert _ulps(tp[same], np.asarray(jp)[same]) <= SCALE_ULP
    for t, j in zip(tf, jf):
        assert rel_err(_np(t)[same], np.asarray(j)[same]) <= 1e-6


# --------------------------------------------------------------------------
# AWQ
# --------------------------------------------------------------------------


def _awq_case(seed, L=2):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(L, 64, 256)) * np.exp(rng.normal(size=(L, 1, 256)))).astype(np.float32)
    ws = [rng.normal(size=(L, 32, 256)).astype(np.float32), rng.normal(size=(L, 16, 256)).astype(np.float32)]
    return x, ws


def test_normalize_scale_matches_jax():
    s = np.exp(np.random.default_rng(4).normal(size=(3, 40))).astype(np.float32)
    assert _ulps(tawq._normalize_scale(torch.from_numpy(s)), jawq._normalize_scale(jnp.asarray(s))) <= SCALE_ULP


@pytest.mark.parametrize("wname", ["INT4_PER_BLOCK_128", "NVFP4_BLOCK16", "W4A8_SEQUENTIAL"])
def test_awq_lite_search_matches_jax(wname):
    """The stacked search, as JAX calls it (each closure quantizes the whole
    [L, O, K] stack): alpha choices and scales."""
    x, ws = _awq_case(5)
    am = np.abs(x).mean(axis=1)
    wcfg = getattr(jconfig, wname)
    jq = jptq._weight_qfns([wcfg, wcfg])
    tc = convert.quantizer_cfg_from_jax(wcfg)
    tq = [lambda w: tptq.Q.quantize(w, tptq._dynamic_like(tc), None)] * 2
    ja, js = jawq.awq_lite_search(jnp.asarray(x), [jnp.asarray(w) for w in ws], jq, jnp.asarray(am), 0.1)
    ta, ts = tawq.awq_lite_search(torch.from_numpy(x), [torch.from_numpy(w) for w in ws], tq,
                                  torch.from_numpy(am), 0.1)
    alphas = np.asarray(jax.jit(lambda: jnp.linspace(0.0, 1.0, 11))())

    def jax_losses():
        out = []
        for a in alphas:
            s = jawq._normalize_scale(jnp.power(jnp.maximum(jnp.asarray(am), 1e-8), jnp.float32(a)))
            xs = jnp.asarray(x) / s[..., None, :]
            loss = 0.0
            for w, q in zip(ws, jq):
                ref = jnp.einsum("...ni,...oi->...no", jnp.asarray(x), jnp.asarray(w))
                out_ = jnp.einsum("...ni,...oi->...no", xs, q(jnp.asarray(w) * s[..., None, :]))
                loss = loss + jnp.mean((out_ - ref) ** 2, axis=(-2, -1))
            out.append(np.asarray(loss))
        return np.stack(out)

    _held_choices(f"awq_lite alpha ({wname})", _index_of(ta, alphas), _index_of(ja, alphas), jax_losses())
    same = _np(ta) == np.asarray(ja)
    assert _ulps(ts[torch.from_numpy(same)], np.asarray(js)[same]) <= SCALE_ULP


def test_awq_clip_search_matches_jax():
    x, ws = _awq_case(6)
    w = ws[0]

    def jq(wx, amax_full):
        return jnum.fake_quant_int(wx, amax_full, 4)

    def tq(wx, amax_full):
        return tnum.fake_quant_int(wx, amax_full, 4)

    jb = np.asarray(jawq.awq_clip_search(jnp.asarray(x), jnp.asarray(w), 128, jq))
    tb = tawq.awq_clip_search(torch.from_numpy(x), torch.from_numpy(w), 128, tq).numpy()
    amax0 = np.abs(w).reshape(2, 32, 2, 128).max(-1)
    ratios = np.asarray(jax.jit(lambda: jnp.linspace(1.0, 0.5, 8))())

    def jax_losses():
        ref = jnp.einsum("...ni,...oi->...no", jnp.asarray(x), jnp.asarray(w))
        out = []
        for r in ratios:
            wq = jq(jnp.asarray(w), jnp.repeat(jnp.asarray(amax0) * r, 128, axis=-1))
            out.append(np.asarray(jnp.mean((jnp.einsum("...ni,...oi->...no", jnp.asarray(x), wq) - ref) ** 2,
                                           axis=-2)))
        return np.stack(out)

    _held_choices("awq_clip ratio", _index_of(tb[..., 0] / amax0[..., 0], ratios),
                  _index_of(jb[..., 0] / amax0[..., 0], ratios), jax_losses())
    same = np.isclose(tb / amax0, jb / amax0, rtol=0, atol=1e-6).all(-1)
    assert _ulps(tb[same], jb[same]) <= SCALE_ULP


def test_awq_clip_refuses_a_ragged_k_as_jax_does():
    rng = np.random.default_rng(7)
    x, w = rng.normal(size=(16, 704)).astype(np.float32), rng.normal(size=(8, 704)).astype(np.float32)
    with pytest.raises(Exception):
        jawq.awq_clip_search(jnp.asarray(x), jnp.asarray(w), 128, lambda a, b: jnum.fake_quant_int(a, b, 4))
    with pytest.raises(ValueError, match="704"):
        tawq.awq_clip_search(torch.from_numpy(x), torch.from_numpy(w), 128, lambda a, b: tnum.fake_quant_int(a, b, 4))


# --------------------------------------------------------------------------
# MSE and local Hessian
# --------------------------------------------------------------------------


@pytest.mark.parametrize("per_block", [False, True], ids=["per_tensor", "per_block"])
def test_mse_amax_search_matches_jax(per_block):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(32, 256)).astype(np.float32)
    x[0, 0] = 40.0  # an outlier the search clips
    sizes = ((-1, 128),)
    if per_block:
        amax0 = np.abs(x).reshape(32, 2, 128).max(-1)
        jexp = lambda a: jnum.expand_block_scale(a, x.shape, sizes)  # noqa: E731
        texp = lambda a: tnum.expand_block_scale(a, x.shape, sizes)  # noqa: E731
    else:
        amax0 = np.float32(np.abs(x).max())
        jexp = texp = lambda a: a  # noqa: E731
    jb = jmse.mse_amax_search(jnp.asarray(x), jnp.asarray(amax0), lambda a, m: jnum.fake_quant_int(a, m, 4), jexp)
    tb = tmse.mse_amax_search(torch.from_numpy(x), torch.as_tensor(amax0), lambda a, m: tnum.fake_quant_int(a, m, 4),
                              texp)
    ratios = np.asarray(jax.jit(lambda: jnp.linspace(0.3, 1.0, 16))())
    losses = np.stack([np.asarray(jnp.mean((jnum.fake_quant_int(jnp.asarray(x), jexp(jnp.asarray(amax0) * r), 4)
                                            - jnp.asarray(x)) ** 2)) for r in ratios])
    ti, ji = _index_of(_np(tb).flat[0] / np.asarray(amax0).flat[0], ratios), \
        _index_of(np.asarray(jb).flat[0] / np.asarray(amax0).flat[0], ratios)
    _held_choices("mse ratio", ti, ji, losses)
    if ti == ji:
        assert _ulps(tb, jb) <= SCALE_ULP
    assert float(np.asarray(jb).flat[0]) < float(np.asarray(amax0).flat[0])  # the outlier is clipped


@pytest.mark.parametrize("K", [256, 200], ids=["whole_blocks", "ragged_k"])
def test_local_hessian_amax_search_matches_jax(K):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(48, K)).astype(np.float32)
    w = rng.normal(size=(16, K)).astype(np.float32)
    nblk = -(-K // 128)
    amax0 = np.abs(np.pad(w, ((0, 0), (0, nblk * 128 - K)))).reshape(16, nblk, 128).max(-1)

    def jq(wx, full):
        return jnum.fake_quant_int(wx, full, 4)

    jb = np.asarray(jmse.local_hessian_amax_search(jnp.asarray(x), jnp.asarray(w), jnp.asarray(amax0), jq, 128))
    tb = tmse.local_hessian_amax_search(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(amax0),
                                        lambda wx, full: tnum.fake_quant_int(wx, full, 4), 128).numpy()
    ratios = np.asarray(jax.jit(lambda: jnp.linspace(0.5, 1.0, 8))())
    Kp = nblk * 128
    xp, wp = np.pad(x, ((0, 0), (0, Kp - K))), np.pad(w, ((0, 0), (0, Kp - K)))
    losses = []
    for r in ratios:
        dw = (jnp.asarray(wp) - jq(jnp.asarray(wp), jnp.repeat(jnp.asarray(amax0) * r, 128, axis=-1))).reshape(
            16, nblk, 128)
        e = jnp.einsum("tbk,obk->obt", jnp.asarray(xp).reshape(-1, nblk, 128), dw)
        losses.append(np.asarray(jnp.sum(e * e, axis=-1)))
    _held_choices("local_hessian ratio", _index_of(tb / amax0, ratios), _index_of(jb / amax0, ratios),
                  np.stack(losses))
    same = np.isclose(tb / amax0, jb / amax0, rtol=0, atol=1e-6)
    assert _ulps(tb[same], jb[same]) <= SCALE_ULP


# --------------------------------------------------------------------------
# Histogram
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hist():
    x = np.random.default_rng(10).normal(size=(4096,)).astype(np.float32)
    x[:4] = [9.0, -8.5, 7.0, 12.0]
    amax = float(np.abs(x).max())
    js = jhist.collect_histogram(jnp.asarray(x), jhist.init_histogram(amax))
    ts = thist.collect_histogram(torch.from_numpy(x), thist.init_histogram(amax))
    return js, ts


def test_histogram_counts_equal_jax(hist):
    js, ts = hist
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    assert float(ts.counts.sum()) == 4096.0


@pytest.mark.parametrize("method", ["percentile", "mse", "entropy", "max"])
def test_histogram_amax_equals_jax(hist, method):
    js, ts = hist
    j = np.asarray(jhist.compute_amax(js, method, 99.9))
    t = thist.compute_amax(ts, method, 99.9).numpy()
    assert t.dtype == np.float32 and np.array_equal(t, j), (method, t, j)


# --------------------------------------------------------------------------
# GPTQ and the Hessian
# --------------------------------------------------------------------------


def test_hessian_matches_jax():
    x = np.random.default_rng(11).normal(size=(64, 48)).astype(np.float32)
    assert rel_err(tsgpt.hessian_from_acts(torch.from_numpy(x)).numpy(),
                   np.asarray(jsgpt.hessian_from_acts(jnp.asarray(x)))) <= 1e-6


@pytest.mark.parametrize("wname,K,block", [("INT4_PER_BLOCK_128", 256, 128), ("INT8_PER_CHANNEL", 96, 32),
                                           ("FP8_PER_TENSOR", 64, 128), ("INT4_PER_BLOCK_128", 200, 128)],
                         ids=["int4_block", "int8_channel", "fp8_tensor", "ragged_block_1"])
def test_gptq_matches_jax(wname, K, block):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(128, K)).astype(np.float32)
    w = rng.normal(size=(32, K)).astype(np.float32)
    wcfg = getattr(jconfig, wname)
    jw = np.asarray(jgptq.gptq_calibrate_weight(jnp.asarray(w), jnp.asarray(x), wcfg, block))
    tw = tgptq.gptq_calibrate_weight(torch.from_numpy(w), torch.from_numpy(x),
                                     convert.quantizer_cfg_from_jax(wcfg), block).numpy()
    assert rel_err(tw, jw) <= 1e-3

    def out_err(wq):
        return float(np.sum((x.astype(np.float64) @ (wq - w).T.astype(np.float64)) ** 2))

    assert abs(out_err(tw) - out_err(jw)) <= 0.01 * out_err(jw)
    # and GPTQ beats rounding each weight on its own
    naive = np.asarray(jnum.fake_quant_int(jnp.asarray(w), jgptq.amax_grid_for(jnp.asarray(w), wcfg), 4)) \
        if not wcfg.is_fp and wcfg.num_bits == 4 else None
    if naive is not None:
        assert out_err(tw) < out_err(naive)


# --------------------------------------------------------------------------
# SVDQuant
# --------------------------------------------------------------------------


def test_svd_split_matches_jax():
    w = np.random.default_rng(13).normal(size=(48, 64)).astype(np.float32)
    jA, jB, jr = (np.asarray(a) for a in jsvd.svd_split(jnp.asarray(w), 8))
    tA, tB, tr = (a.numpy() for a in tsvd.svd_split(torch.from_numpy(w), 8))
    assert rel_err(tB @ tA, jB @ jA) <= 1e-4
    assert rel_err(tr, jr) <= 1e-4
    sign = np.sign(np.sum(tA * jA, axis=1))  # each rank-1 pair up to its sign
    assert rel_err(tA * sign[:, None], jA) <= 1e-4 and rel_err(tB * sign[None, :], jB) <= 1e-4


def test_svdquant_weights_layout_matches_jax():
    rng = np.random.default_rng(14)
    layers = {"mlp.up_proj": rng.normal(size=(2, 32, 16)).astype(np.float32)}
    jl, ja = jsvd.svdquant_weights({k: jnp.asarray(v) for k, v in layers.items()}, ["mlp.up_proj"], 4)
    tl, ta = tsvd.svdquant_weights({k: torch.from_numpy(v) for k, v in layers.items()}, ["mlp.up_proj"], 4)
    for k in ("A", "B", "scale"):
        assert tuple(ta["mlp.up_proj"][k].shape) == np.asarray(ja["mlp.up_proj"][k]).shape
    assert rel_err(tl["mlp.up_proj"].numpy(), np.asarray(jl["mlp.up_proj"])) <= 1e-4
    jBA = np.einsum("lor,lrk->lok", np.asarray(ja["mlp.up_proj"]["B"]), np.asarray(ja["mlp.up_proj"]["A"]))
    tBA = torch.einsum("lor,lrk->lok", ta["mlp.up_proj"]["B"], ta["mlp.up_proj"]["A"]).numpy()
    assert rel_err(tBA, jBA) <= 1e-4
