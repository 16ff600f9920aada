"""The port's MoE model (`models/mixtral.py`) against the JAX package's: the
three routing variants (softmax then top-k with and without
`norm_topk_prob`, GPT-OSS's top-k then softmax, Llama4's sigmoid input
scaling), the capacity dispatch at a capacity that drops pairs (the kept and
dropped pairs and the experts' rows bit-equal to JAX's one-hot einsums),
`expert_act` (silu and the clamped swiglu), and the forward, its captures
and its calibration state on the trained `artifacts/anchor-moe` (qwen3_moe,
6 layers, hidden 256, 4 experts, top-2). Tolerances: routing weights within
1e-6; the combined outputs within 1e-6 of their scale (the k terms summed in
another order); logits within 1e-4 of their scale (f32 matmuls in another
order); activation amax within 1e-5; weight amax equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import hf_loader as jload
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.models import mixtral as jmix
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import hf_loader as tload
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.models import mixtral as tmix
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig

ANCHOR = os.path.join(os.path.dirname(__file__), "..", "artifacts", "anchor-moe")
ROUTES = {"softmax_topk_norm": {}, "softmax_topk": dict(norm_topk_prob=False),
          "topk_softmax": dict(router_softmax_after_topk=True),
          "sigmoid_input_scaled": dict(router_sigmoid_input_scaled=True)}


def _cfgs(**kw):
    jcfg = jmix.MixtralConfig.tiny(num_experts=8, **kw)
    return jcfg, convert.llama_cfg_from_jax(jcfg)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_and_dispatch_match_jax(route):
    """24 tokens, top-2 of 8 experts at capacity_factor 0.5 (C = 3): JAX's
    assignment [S, E, C] rebuilt from the port's dispatch is equal, kept and
    dropped pairs alike; the experts' rows equal JAX's dispatch einsum
    bit for bit, the combined output its combine einsum within 1e-6."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5, **ROUTES[route])
    assert type(tcfg) is tmix.MixtralConfig and tcfg.router_softmax_after_topk == jcfg.router_softmax_after_topk
    rng = np.random.default_rng(0)
    S, E, k, H = 24, 8, 2, 16
    logits = rng.standard_normal((S, E)).astype(np.float32)
    jw, ji = jmix.route(jcfg, jnp.asarray(logits))
    tw, ti = tmix.route(tcfg, torch.from_numpy(logits))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert rel_err(tw.numpy(), np.asarray(jw)) < 1e-6
    C = tmix.capacity(tcfg, S)
    assert C == max(int(jcfg.capacity_factor * S * k / E), 1) == 3
    jdisp, jcomb = jmix.dispatch_combine(jcfg, jw, ji, S, C)
    d = tmix.dispatch_combine(tcfg, torch.from_numpy(np.asarray(jw)), torch.from_numpy(np.asarray(ji)), S, C)
    # JAX's assignment: pair (s, j) -> row e * C + c where assign[s, j, e, c] = 1
    onehot = jax.nn.one_hot(ji, E)
    pos = jnp.cumsum(onehot.reshape(S * k, E), axis=0).reshape(S, k, E) - 1.0
    kept_j = np.asarray(jnp.sum(onehot * (pos < C), axis=-1) > 0).reshape(-1)
    np.testing.assert_array_equal(d.keep.numpy(), kept_j)
    assert 0 < int(d.keep.sum()) < S * k  # the capacity drops pairs
    rows = (np.asarray(ji).reshape(-1) * C + np.asarray(jnp.sum(onehot * pos, axis=-1)).reshape(-1)).astype(np.int64)
    np.testing.assert_array_equal(d.dest.numpy(), np.where(kept_j, rows, E * C))
    x = rng.standard_normal((S, H)).astype(np.float32)
    xe_j = np.asarray(jnp.einsum("sec,sh->ech", jdisp, jnp.asarray(x)))
    np.testing.assert_array_equal(tmix.dispatch_tokens(d, torch.from_numpy(x), E).numpy(), xe_j)
    ye = rng.standard_normal((E, C, H)).astype(np.float32)
    yj = np.asarray(jnp.einsum("sec,ech->sh", jcomb, jnp.asarray(ye)))
    assert rel_err(tmix.combine_tokens(d, torch.from_numpy(ye), S, k, torch.float32).numpy(), yj) < 1e-6


@pytest.mark.parametrize("limit", [None, 7.0])
def test_expert_act_matches_jax(limit):
    jcfg, tcfg = _cfgs(swiglu_limit=limit)
    rng = np.random.default_rng(1)
    g, u = (10 * rng.standard_normal((6, 32))).astype(np.float32), (10 * rng.standard_normal((6, 32))).astype(np.float32)
    j = np.asarray(jmix.expert_act(jcfg, jnp.asarray(g), jnp.asarray(u)))
    assert rel_err(tmix.expert_act(tcfg, torch.from_numpy(g), torch.from_numpy(u)).numpy(), j) < 1e-6


@pytest.fixture(scope="module")
def anchor():
    jcfg, jp = jload.load_hf_moe_checkpoint(ANCHOR, dtype=jnp.float32)
    tcfg, tp = tload.load_hf_moe_checkpoint(ANCHOR, dtype=torch.float32, device="cpu")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    return jcfg, jp, tcfg, tp, tokens


def test_anchor_loads_as_jax(anchor):
    jcfg, jp, tcfg, tp, _ = anchor
    assert (tcfg.num_experts, tcfg.top_k, tcfg.qk_norm, tcfg.intermediate_size) == (4, 2, True, 256)
    assert convert.llama_cfg_from_jax(jcfg) == tcfg
    assert set(tp["layers"]) == set(jp["layers"])
    for name in ("moe.router", "moe.down_proj", "self_attn.k_norm"):
        np.testing.assert_array_equal(tp["layers"][name].numpy(), np.asarray(jp["layers"][name]))


def test_anchor_forward_and_captures_match_jax(anchor):
    jcfg, jp, tcfg, tp, tokens = anchor
    jl, _, jcaps = jmix.forward(jcfg, jp, jnp.asarray(tokens), capture_tokens=32)
    tl, _, tcaps = tmix.forward(tcfg, tp, torch.from_numpy(tokens), capture_tokens=32)
    assert rel_err(tl.numpy(), np.asarray(jl)) < 1e-4
    assert set(tcaps) == set(jcaps) == {"attn_in", "moe_in"}
    for key, t in tcaps.items():
        assert t.shape == (6, 32, 256) and rel_err(t.numpy(), np.asarray(jcaps[key])) < 1e-4
    # unrolled with the layers' own layouts gives the same logits
    layout = tmix.build_layout(tcfg, tconfig.get_preset("INT8_DEFAULT_CFG"))
    ul, states = tmix.forward_unrolled(tcfg, tp, torch.from_numpy(tokens), [layout] * 6, calib=True)
    assert rel_err(ul.numpy(), tl.numpy()) < 1e-6 and len(states) == 6 and "moe.gate_proj" in states[0]


@pytest.mark.parametrize("preset", ["NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG", "INT8_SMOOTHQUANT_CFG"])
def test_anchor_layout_state_and_calibration_match_jax(anchor, preset):
    """The layout's sites and configs, the initial state's tree, one
    calibration pass's state (weights per expert, equal; the block input
    and the attention inputs within 1e-5), and (FP8, INT8) a middle layer's
    attention and expert MLP under JAX's state on the same input, within
    1e-5.
    End to end the logits are held (1e-5) only under INT8 activations:
    under FP8 and NVFP4 activations the f32 sums' last bits move a few
    codes, and six layers of routing carry each flip (a whole-forward gap
    of ~1e-2 with every layer equal alone)."""
    jcfg, jp, tcfg, tp, tokens = anchor
    jlay = jmix.build_layout(jcfg, jconfig.get_preset(preset))
    tlay = tmix.build_layout(tcfg, tconfig.get_preset(preset))
    assert convert.layout_from_jax(jlay) == tlay
    jst, tst = jmix.init_quant_state(jcfg, jlay), tmix.init_quant_state(tcfg, tlay, "cpu")
    assert set(jst) == set(tst)
    j1 = jmix.forward(jcfg, jp, jnp.asarray(tokens), layout=jlay, qstate=jst, calib=True)[1]
    t1 = tmix.forward(tcfg, tp, torch.from_numpy(tokens), layout=tlay, qstate=tst, calib=True)[1]
    assert set(j1) == set(t1)
    for name, sub in t1.items():
        for which, st in sub.items():
            j = j1[name][which]
            assert tuple(st.amax.shape) == tuple(np.asarray(j.amax).shape), (name, which)
            if which == "weight":
                np.testing.assert_array_equal(st.amax.numpy(), np.asarray(j.amax))
            else:
                assert rel_err(st.amax.numpy(), np.asarray(j.amax)) < 1e-5, (name, which)
    if preset == "NVFP4_DEFAULT_CFG":
        return
    held = convert.params_from_jax(j1)
    i, T = 2, tokens.shape[1]
    jlp, jls = jax.tree.map(lambda a: a[i], jp["layers"]), jax.tree.map(lambda a: a[i], j1)
    tlp, tls = {k: v[i] for k, v in tp["layers"].items()}, tllama.slice_state(held, i)
    h = np.random.default_rng(3).standard_normal((2, T, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (2, T))
    mask = np.where(np.arange(T)[None, :] <= np.arange(T)[:, None], 0.0, -1e9)[None, None].astype(np.float32)
    # jitted: JAX's layer op by op takes seconds here
    ja = jax.jit(lambda x, p, st: jllama._attention(jcfg, x, p, st, jlay, jnp.asarray(pos), jnp.asarray(mask), None,
                                                    False)[0])(jnp.asarray(h), jlp, jls)
    ta = tllama._attention(tcfg, torch.from_numpy(h), tlp, tls, tlay, torch.from_numpy(pos), torch.from_numpy(mask),
                           False)[0]
    assert rel_err(ta.numpy(), np.asarray(ja)) < 1e-5
    jy = jax.jit(lambda x, p, st: jmix._moe_mlp(jcfg, x, p, st, jlay, False)[0])(jnp.asarray(h), jlp, jls)
    ty = tmix._moe_mlp(tcfg, torch.from_numpy(h), tlp, tls, tlay, False)[0]
    assert rel_err(ty.numpy(), np.asarray(jy)) < 1e-5
    if preset == "INT8_SMOOTHQUANT_CFG":
        jl = np.asarray(jmix.forward(jcfg, jp, jnp.asarray(tokens), layout=jlay, qstate=j1)[0])
        tl = tmix.forward(tcfg, tp, torch.from_numpy(tokens), layout=tlay, qstate=held)[0].numpy()
        assert rel_err(tl, jl) < 1e-5


def test_init_and_specs_match_jax():
    jcfg, tcfg = _cfgs()
    jp = jmix.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmix.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in tp["layers"].items()} == {k: tuple(v.shape) for k, v in jp["layers"].items()}
    specs, jspecs = tmix.param_specs(tcfg), jmix.param_specs(jcfg)
    assert {k: tuple(v) for k, v in jspecs["layers"].items()} == specs["layers"]
    assert tllama.param_specs(tcfg)["embed_tokens"] == tuple(jllama.param_specs(jcfg)["embed_tokens"])
