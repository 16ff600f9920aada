"""The port's DiT (models/dit.py) against the JAX package's on the CPU, on a
tiny f32 DiT whose adaLN-zero tensors are made random (`_torch_diffusion`).

Tolerances (each the max over the output, relative to its largest value):
 - `forward` (and its features), `patchify` / `unpatchify`,
   `timestep_embedding` at t <= 17: 1e-5; the embedding at t up to 999:
   EMBED_TOL = 1e-4 (XLA's f32 exp is an ulp off on some frequencies, and
   999 ulps of angle show);
 - `quantize_dit`'s amax: 1e-5 of each site's largest;
 - `compress_dit`'s packs, from the same calibrated state: bit-equal;
 - `forward_packed` on the plain versions against JAX's Pallas path (in
   interpret mode, as JAX's tests run it), from the same state and packs:
   1e-5 for every kind with the input quantizers off (the GEMMs alone: INT4,
   NVFP4, MXFP4, FP8 and INT8 weight-only), and for INT4_AWQ as calibrated
   (it has no activation quantizer);
 - with an activation quantizer (INT8's int8 W8A8, FP8's and
   W4A8_AWQ_BETA's e4m3, NVFP4's and MXFP4's dynamic 4-bit blocks):
   ACT_TIE_REL = 1e-2, the fake-quant forward too. JAX's blocks run inside
   `lax.scan`, one compiled body, whose f32 sums are a few ulps off eager
   PyTorch's; an activation that lies that near a rounding boundary of its
   grid (or a block amax at a power of two, for MXFP4's E8M0 scale) lands on
   the other side and moves the output by one grid step, about 1e-3 of its
   scale for 8 bits and more for 4 (measured: 1.1e-3 to 7.5e-3). The same
   sites on one identical input agree exactly
   (`test_qlinear_sites_equal_on_one_input`).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_diffusion import dit_pair, latents
from _torch_families import bits
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import dit as jdit
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.quant import quantizer as jquantizer
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import dit as tdit
from tensorrt_model_optimizer_tpu_torch.models import registry as treg
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine

TOL = 1e-5
EMBED_TOL = 1e-4
ACT_TIE_REL = 1e-2
PRESETS = {  # preset -> the kind its block sites pack to, and whether an activation quantizer runs
    "INT8_DEFAULT_CFG": ("int8", True),
    "FP8_DEFAULT_CFG": ("fp8", True),
    "NVFP4_DEFAULT_CFG": ("nvfp4", True),
    "INT4_AWQ_CFG": ("int4", False),
    "W4A8_AWQ_BETA_CFG": ("int4", True),
    "MXFP4_DEFAULT_CFG": ("mxfp4", True),
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def model():
    jcfg, jp, tcfg, tp = dit_pair(0)
    return jcfg, jp, tcfg, tp, latents(jcfg, 2, 7)


@pytest.fixture(scope="module")
def quantized(model):
    """Per preset: JAX's calibration, packs and both forwards, and the
    port's own calibration, its packs and forwards from JAX's state."""
    jcfg, jp, tcfg, tp, batches = model
    x, t = batches[0]
    out = {}

    def weights_only(jl):  # the layout with every input quantizer off
        return jllama.QuantLayout(sites=tuple((k, jquantizer.DISABLED if k.endswith(".input") else c)
                                              for k, c in jl.sites))

    for preset in PRESETS:
        jl, jq = jdit.quantize_dit(jcfg, jp, preset, [(jnp.asarray(a), jnp.asarray(b)) for a, b in batches])
        tl, tq_own = tdit.quantize_dit(tcfg, tp, preset, [(_t(a), _t(b)) for a, b in batches])
        tq = convert.params_from_jax(jq)
        jk, jpk = jdit.compress_dit(jcfg, jp, jl, jq)
        tk, tpk = tdit.compress_dit(tcfg, tp, tl, tq)
        out[preset] = dict(
            jl=jl, jq=jq, tl=tl, tq=tq, tq_own=tq_own, jk=jk, jpk=jpk, tk=tk, tpk=tpk,
            j_fq=np.asarray(jdit.forward(jcfg, jp, jnp.asarray(x), jnp.asarray(t), layout=jl, qstate=jq)[0]),
            t_fq=tdit.forward(tcfg, tp, _t(x), _t(t), layout=tl, qstate=tq_own)[0].numpy(),
            j_packed=np.asarray(jdit.forward_packed(jcfg, jp, jk, jpk, jnp.asarray(x), jnp.asarray(t), layout=jl,
                                                    qstate=jq)),
            t_packed=tdit.forward_packed(tcfg, tp, tk, tpk, _t(x), _t(t), layout=tl, qstate=tq).numpy(),
            j_wo=np.asarray(jdit.forward_packed(jcfg, jp, jk, jpk, jnp.asarray(x), jnp.asarray(t),
                                                layout=weights_only(jl))),
            t_wo=tdit.forward_packed(tcfg, tp, tk, tpk, _t(x), _t(t),
                                     layout=convert.layout_from_jax(weights_only(jl))).numpy())
    return out


def test_forward_and_features_match_jax(model):
    jcfg, jp, tcfg, tp, batches = model
    for x, t in batches:
        je, _, jf = jdit.forward(jcfg, jp, jnp.asarray(x), jnp.asarray(t), return_features=True)
        te, st, tf = tdit.forward(tcfg, tp, _t(x), _t(t), return_features=True)
        assert st is None and te.shape == x.shape
        assert rel_err(te.numpy(), je) <= TOL and rel_err(tf.numpy(), jf) <= TOL
        assert np.abs(np.asarray(je)).max() > 0.1  # the randomized adaLN-zero tensors reach the output


def test_pieces_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    p = tdit.patchify(_t(x), 4)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jdit.patchify(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tdit.unpatchify(p, 16, 4, 4).numpy(), x)
    # XLA's f32 exp is not correctly rounded (15 of the 128 frequencies an
    # ulp off; torch's: 3), and at t = 999 an ulp of a frequency turns the
    # angle by ~6e-5 rad: EMBED_TOL there, TOL at small t
    t = np.array([0, 1, 17, 500, 999], np.int32)
    assert rel_err(tdit.timestep_embedding(_t(t)).numpy(), jdit.timestep_embedding(jnp.asarray(t))) <= EMBED_TOL
    assert rel_err(tdit.timestep_embedding(_t(t[:3])).numpy(), jdit.timestep_embedding(jnp.asarray(t[:3]))) <= TOL


@pytest.mark.parametrize("preset", list(PRESETS))
def test_quantize_dit_matches_jax(quantized, preset):
    q = quantized[preset]
    assert set(q["tq_own"]) == set(q["jq"])
    for name, sub in q["tq_own"].items():
        for which, st in sub.items():
            ja = q["jq"][name][which].amax
            pairs = zip(st.amax, ja) if isinstance(st.amax, tuple) else [(st.amax, ja)]
            for a, b in pairs:  # a sequential site (W4A8's int4 then fp8) has one amax a stage
                assert (a is None) == (b is None) and (a is None or rel_err(a.numpy(), b) <= TOL), (name, which)
    assert "adaLN.mod" not in q["tq_own"]
    tol = ACT_TIE_REL if PRESETS[preset][1] else TOL
    assert rel_err(q["t_fq"], q["j_fq"]) <= tol


@pytest.mark.parametrize("preset", list(PRESETS))
def test_compress_dit_packs_bit_equal(quantized, preset):
    q = quantized[preset]
    kind = PRESETS[preset][0]
    assert q["tk"] == q["jk"] == {**{n: kind for n in tdit.PROJ_NAMES[:4]}, "adaLN.mod": "bf16"}
    for name, arrays in q["tpk"].items():
        assert set(arrays) == set(q["jpk"][name])
        for k, a in arrays.items():
            np.testing.assert_array_equal(bits(a), bits(q["jpk"][name][k]), err_msg=f"{preset} {name}.{k}")


@pytest.mark.parametrize("preset", list(PRESETS))
def test_forward_packed_matches_jax_pallas(quantized, preset):
    q = quantized[preset]
    tol = ACT_TIE_REL if PRESETS[preset][1] else TOL
    assert rel_err(q["t_packed"], q["j_packed"]) <= tol
    # the GEMMs alone, every input quantizer off (INT8 then runs weight-only): TOL for every kind
    assert rel_err(q["t_wo"], q["j_wo"]) <= TOL
    # the real-quant step tracks its own fake-quant model (JAX's gap, < 5e-2)
    assert rel_err(q["t_packed"], q["t_fq"]) <= 5e-2


def test_serving_layouts_run_the_weight_only_kernels(quantized, model):
    """The packs' serving kinds are the kernels' (W8A8 stays int8_mm), and
    forward_packed gives the same output from them as from the canonical
    packs."""
    jcfg, jp, tcfg, tp, batches = model
    x, t = batches[0]
    served = {}
    for preset in PRESETS:
        q = quantized[preset]
        kinds, packs = tdit.serving_layouts(q["tk"], q["tpk"])
        cm = SimpleNamespace(kinds=kinds, layout=q["tl"])
        served[preset] = sorted(set(tengine.weight_only_kernels(cm).values()))
        again = tdit.forward_packed(tcfg, tp, kinds, packs, _t(x), _t(t), layout=q["tl"], qstate=q["tq"])
        np.testing.assert_array_equal(again.numpy(), q["t_packed"])
    assert served == {"INT8_DEFAULT_CFG": [], "FP8_DEFAULT_CFG": ["byte_wo"], "NVFP4_DEFAULT_CFG": ["fp4_wo"],
                      "INT4_AWQ_CFG": ["int4_wo"], "W4A8_AWQ_BETA_CFG": ["int4_wo"],
                      "MXFP4_DEFAULT_CFG": ["fp4_wo"]}


def test_qlinear_sites_equal_on_one_input(quantized):
    """The 8-bit activation sites alone: JAX's engine `_qlinear` and the
    port's on one identical input, exactly equal (W8A8's int8 dot, FP8's
    fake-quantized activations times the e4m3 weights)."""
    rng = np.random.default_rng(5)
    x = (3 * rng.standard_normal((64, 128))).astype(np.float32)
    for preset in ("INT8_DEFAULT_CFG", "FP8_DEFAULT_CFG"):
        q = quantized[preset]
        name = "attn.qkv"
        jarr = jax.tree.map(lambda a: a[0], q["jpk"][name])
        jist = jax.tree.map(lambda a: a[0], q["jq"][name]["input"])
        jy = jengine._qlinear(jnp.asarray(x), name, q["jk"][name], jarr, SimpleNamespace(layout=q["jl"]),
                              "pallas", jist)
        tarr = {k: v[0] for k, v in q["tpk"][name].items()}
        tist = convert.params_from_jax(jist)
        ty = tengine._qlinear(_t(x), name, q["tk"][name], tarr, SimpleNamespace(layout=q["tl"]), tist,
                              tengine._ops(()))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy), err_msg=preset)


def test_forward_packed_refuses_f32_on_the_card(quantized, model):
    """On the card the weight-only kernels take bf16 activations: an f32 DiT
    is refused with the engine's reason unless plain_ops names the kernels;
    bf16 and W8A8 (no weight-only kernel) pass. Decided from the device, so
    it is checked here without a card."""
    jcfg, jp, tcfg, tp, batches = model
    cuda = torch.device("cuda")
    q = quantized["NVFP4_DEFAULT_CFG"]
    kinds, _ = tdit.serving_layouts(q["tk"], q["tpk"])
    why = tdit.packed_refusal(tcfg, kinds, q["tl"], cuda)
    assert why is not None and "fp4_wo" in why and "bf16" in why
    assert tdit.packed_refusal(tcfg, kinds, q["tl"], cuda, ("fp4_wo",)) is None
    assert tdit.packed_refusal(tcfg, kinds, q["tl"], torch.device("cpu")) is None
    bf16 = tdit.DiTConfig(**{**tcfg.__dict__, "dtype": torch.bfloat16})
    assert tdit.packed_refusal(bf16, kinds, q["tl"], cuda) is None
    w8a8 = quantized["INT8_DEFAULT_CFG"]
    assert tdit.packed_refusal(tcfg, w8a8["tk"], w8a8["tl"], cuda) is None


def test_registry_has_dit():
    fam = treg.get("dit")
    assert fam.forward is tdit.forward and fam.config_cls is tdit.DiTConfig and fam.hf_model_types == ()
    assert "dit" in treg.families()


def test_init_params_shapes_match_jax():
    jcfg = jdit.DiTConfig.tiny()
    tcfg = convert.dit_cfg_from_jax(jcfg)
    jp = jdit.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tdit.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert len(flat_j) == len(flat_t)
    for k, v in flat_j:
        assert tuple(flat_t[jax.tree_util.keystr(k)].shape) == v.shape
    for k in ("final_mod", "final_proj"):
        assert not tp[k].any()
    assert not tp["blocks"]["adaLN.mod"].any()
    jlay = jdit.build_layout(jcfg, jconfig.get_preset("NVFP4_DEFAULT_CFG"))
    assert convert.layout_from_jax(jlay) == tdit.build_layout(tcfg, tconfig.get_preset("NVFP4_DEFAULT_CFG"))
    assert isinstance(jlay, jllama.QuantLayout)
