"""The port's hybrid Mamba2 family (`models/mamba.py`, its registry entry,
the carry-over in `convert.py`) against the JAX package on one seeded tiny
f32 model.

Tolerances (f32 on both sides; XLA fuses and orders the SSD's and the
attention's sums apart from eager PyTorch): logits and states within 1e-5
of their scale; the chunked SSD within 2e-4 of the float64 recurrence (the
JAX test's bar); greedy tokens equal. Its PTQ: tests/test_torch_mamba_ptq.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mamba import mamba_pair, tokens
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import mamba as jm
from tensorrt_model_optimizer_tpu.models import registry as jreg
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import mamba as tm
from tensorrt_model_optimizer_tpu_torch.models import registry as treg

TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return mamba_pair(0)


@pytest.fixture(scope="module")
def toks():
    return tokens(1)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _ssd_inputs(T=13, seed=2):
    rng = np.random.default_rng(seed)
    B, H, P, G, N = 2, 4, 8, 2, 16
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, T, G, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, T, G, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("T,chunk", [(13, 4), (16, 8), (5, 8)])
def test_ssd_matches_jax_and_recurrence(T, chunk):
    x, dt, A, Bm, Cm = _ssd_inputs(T)
    s0 = np.random.default_rng(3).standard_normal((2, 4, 8, 16)).astype(np.float32)
    ty, tf = tm._ssd(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk, torch.from_numpy(s0))
    jy, jf = jm._ssd(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk, jnp.asarray(s0))
    assert rel_err(_np(ty), jy) <= TOL and rel_err(_np(tf), jf) <= TOL
    # the float64 per-step recurrence (tests/test_mamba.py's reference)
    rep = 2
    h = s0.astype(np.float64)
    ys = np.zeros(x.shape, np.float64)
    Bn, Cn = np.repeat(Bm.astype(np.float64), rep, axis=2), np.repeat(Cm.astype(np.float64), rep, axis=2)
    for t in range(T):
        dA = np.exp(dt[:, t].astype(np.float64) * A[None, :])
        h = h * dA[..., None, None] + (dt[:, t, :, None] * x[:, t])[..., None] * Bn[:, t, :, None, :]
        ys[:, t] = np.einsum("bhpn,bhn->bhp", h, Cn[:, t])
    np.testing.assert_allclose(_np(ty), ys, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(tf), h, rtol=2e-4, atol=2e-4)


def test_segsum_and_softplus():
    a = np.random.default_rng(4).standard_normal((3, 8)).astype(np.float32)
    ts, js = _np(tm._segsum(torch.from_numpy(a))), np.asarray(jm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(ts), np.isinf(js))
    np.testing.assert_allclose(ts[np.isfinite(ts)], js[np.isfinite(js)], rtol=1e-6, atol=1e-6)
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 25.0, 80.0], np.float32)
    np.testing.assert_allclose(_np(tm.softplus(torch.from_numpy(x))), np.asarray(jax.nn.softplus(x)), rtol=1e-7)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(5)
    xBC = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w, b = rng.standard_normal((12, 4)).astype(np.float32), rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    ty, ts = tm._causal_conv(torch.from_numpy(xBC), torch.from_numpy(w), torch.from_numpy(b),
                             None if st is None else torch.from_numpy(st))
    jy, js = jm._causal_conv(jnp.asarray(xBC), jnp.asarray(w), jnp.asarray(b), None if st is None else jnp.asarray(st))
    assert rel_err(_np(ty), jy) <= 1e-6 and np.array_equal(_np(ts), np.asarray(js))


@pytest.mark.parametrize("branch", ["prefill", "recurrent"])
def test_mixer_both_branches(pair, branch):
    jcfg, jp, tcfg, tp = pair
    T = 9 if branch == "prefill" else 1
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, T, jcfg.hidden_size)).astype(np.float32)
    conv = rng.standard_normal((2, 3, jcfg.conv_dim)).astype(np.float32)
    ssm = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    jlp = {k: v[1] for k, v in jp["layers_mamba"].items()}
    tlp = {k: v[1] for k, v in tp["layers_mamba"].items()}
    lay_j, lay_t = jm.llama.QuantLayout(sites=()), tm.QuantLayout(sites=())
    jo, _, (jc, js), _ = jm._mixer(jcfg, jnp.asarray(x), jlp, None, lay_j, (jnp.asarray(conv), jnp.asarray(ssm)), False)
    to, _, (tc, ts), _ = tm._mixer(tcfg, torch.from_numpy(x), tlp, None, lay_t,
                                   (torch.from_numpy(conv), torch.from_numpy(ssm)), False)
    assert rel_err(_np(to), jo) <= TOL and rel_err(_np(ts), js) <= TOL
    assert rel_err(_np(tc), jc) <= TOL  # the in_proj rows: a matmul apart


def test_forward_and_captures(pair, toks):
    jcfg, jp, tcfg, tp = pair
    jl, _, _, jcaps = jm.forward(jcfg, jp, jnp.asarray(toks), capture=True)
    tl, _, _, tcaps = tm.forward(tcfg, tp, torch.from_numpy(toks), capture=True)
    assert rel_err(_np(tl), jl) <= TOL
    assert set(tcaps) == set(jcaps) == {"block_in", "mixer_out_in", "down_in", "o_in"}
    for k in jcaps:
        assert tcaps[k].shape == jcaps[k].shape and rel_err(_np(tcaps[k]), jcaps[k]) <= TOL, k


def test_cached_forward_and_prefill_decode(pair, toks):
    """Prefill 20 tokens into the cache, 4 recurrent steps: logits and every
    cache entry against JAX's, and against the full forward (the JAX
    package's own parity bar, 2e-4)."""
    jcfg, jp, tcfg, tp = pair
    full = _np(tm.forward(tcfg, tp, torch.from_numpy(toks))[0])
    jc, tc = jm.init_cache(jcfg, 2, 32), tm.init_cache(tcfg, 2, 32, device="cpu")
    assert set(jc) == set(tc) and all(tuple(jc[k].shape) == tuple(tc[k].shape) for k in jc)
    jl, _, jc = jm.forward(jcfg, jp, jnp.asarray(toks[:, :20]), cache=jc)
    tl, _, tc = tm.forward(tcfg, tp, torch.from_numpy(toks[:, :20]), cache=tc)
    assert rel_err(_np(tl), jl) <= TOL
    np.testing.assert_allclose(_np(tl)[:, -1], full[:, 19], rtol=2e-4, atol=2e-4)
    for t in range(20, 24):
        jl, _, jc = jm.forward(jcfg, jp, jnp.asarray(toks[:, t:t + 1]), cache=jc)
        tl, _, tc = tm.forward(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]), cache=tc)
        assert rel_err(_np(tl), jl) <= TOL
        for k in ("conv", "ssm", "k", "v"):
            assert rel_err(_np(tc[k]), jc[k]) <= TOL, k
        assert int(tc["pos"]) == int(jc["pos"])
    assert tc["ssm"].dtype == torch.float32 and tc["pos"].dtype == torch.int32
    np.testing.assert_allclose(_np(tl)[:, -1], full[:, -1], rtol=2e-4, atol=2e-4)
    # the JAX cache crosses with cache_from_jax and continues alike
    carried = convert.cache_from_jax(jc)
    nxt = toks[:, :1]
    jl, _, _ = jm.forward(jcfg, jp, jnp.asarray(nxt), cache=jc)
    tl, _, _ = tm.forward(tcfg, tp, torch.from_numpy(nxt), cache=carried)
    assert rel_err(_np(tl), jl) <= TOL


def test_chunked_prefill(pair, toks):
    jcfg, jp, tcfg, tp = pair
    one = _np(tm.forward(tcfg, tp, torch.from_numpy(toks), cache=tm.init_cache(tcfg, 2, 32, device="cpu"))[0])
    _, _, c2 = tm.forward(tcfg, tp, torch.from_numpy(toks[:, :11]), cache=tm.init_cache(tcfg, 2, 32, device="cpu"))
    two = _np(tm.forward(tcfg, tp, torch.from_numpy(toks[:, 11:]), cache=c2)[0])
    np.testing.assert_allclose(two[:, -1], one[:, -1], rtol=2e-4, atol=2e-4)
    _, _, j2 = jm.forward(jcfg, jp, jnp.asarray(toks[:, :11]), cache=jm.init_cache(jcfg, 2, 32))
    jtwo = jm.forward(jcfg, jp, jnp.asarray(toks[:, 11:]), cache=j2)[0]
    assert rel_err(two, jtwo) <= TOL


def test_generate(pair, toks):
    jcfg, jp, tcfg, tp = pair
    j = np.asarray(jm.generate(jcfg, jp, jnp.asarray(toks[:, :6]), max_new_tokens=8, max_len=16))
    t = tm.generate(tcfg, tp, torch.from_numpy(toks[:, :6]), max_new_tokens=8, max_len=16)
    assert t.dtype == torch.int32 and np.array_equal(_np(t), j)


def test_registry(pair):
    fam = treg.get("mamba")
    assert fam.forward is tm.forward and fam.config_cls is tm.MambaConfig and fam.init_params is tm.init_params
    for mt in ("nemotron_h", "mamba2"):
        assert treg.for_hf_model_type(mt).name == jreg.for_hf_model_type(mt).name == "mamba"
    assert treg.families() == jreg.families()
    jcfg = pair[0]
    assert jax.tree_util.tree_structure(jm.param_specs(jcfg), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)) \
        is not None
    tspecs = tm.param_specs(pair[2])
    jspecs = jm.param_specs(jcfg)
    for group in ("layers_mamba", "layers_attn", "layers_mlp"):
        assert {k: tuple(v) for k, v in jspecs[group].items()} == tspecs[group]


def test_init_params_shapes_and_config():
    tcfg = tm.MambaConfig.tiny()
    p = tm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    j = jm.init_params(jm.MambaConfig.tiny(), jax.random.key(0))
    flat_t = {f"{g}/{k}": v for g, sub in p.items() for k, v in (sub.items() if isinstance(sub, dict) else [("", sub)])}
    flat_j = {f"{g}/{k}": v for g, sub in j.items() for k, v in (sub.items() if isinstance(sub, dict) else [("", sub)])}
    assert {k: tuple(v.shape) for k, v in flat_t.items()} == {k: tuple(v.shape) for k, v in flat_j.items()}
    for k in ("layers_mamba/mixer.A_log", "layers_mamba/mixer.D", "layers_mamba/mixer.dt_bias"):
        np.testing.assert_array_equal(_np(flat_t[k]), np.asarray(flat_j[k]))
    n8 = tm.MambaConfig.nemotron_h_8b()
    assert convert.mamba_cfg_from_jax(jm.MambaConfig.nemotron_h_8b()) == n8
    assert (n8.n_blocks("M"), n8.n_blocks("-"), n8.n_blocks("*"), n8.d_in_proj) == (24, 24, 4, 18560)


