"""The port's UNet (models/unet.py) against the JAX package's on the CPU, on
a tiny f32 UNet whose zero-initialised `conv_out` and biases are made
random (on zeros the output reads 0 in both).

Tolerances (max over the output, relative to its largest value):
 - `forward`, unquantized: 1e-5; the stride-2 convolutions' XLA "SAME"
   padding (one row and column, at the high end) is what a symmetric
   padding would miss;
 - `quantize_unet`'s amax: 1e-5 of each site's largest;
 - the fake-quant forward from JAX's calibrated state (INT8, FP8 and NVFP4,
   weights on the flattened [O, I kh kw] views, with their activation
   quantizers): 1e-5 (measured: equal). From each
   package's own state the amaxes differ in their last bits, which moves
   the activations' grids: a value at a rounding boundary then lands a grid
   step away in one package (2.8e-2 of the output's scale measured for
   INT8), which is not the function under test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import unet as junet
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import unet as tunet

TOL = 1e-5
PRESETS = ("INT8_DEFAULT_CFG", "FP8_DEFAULT_CFG", "NVFP4_DEFAULT_CFG")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def model():
    # ch_mult (1, 2, 2): two downsamples, so a stride-2 conv meets an even
    # size twice, and the skips' channel counts differ
    jcfg = junet.UNetConfig.tiny(ch_mult=(1, 2, 2))
    rng = np.random.default_rng(1)
    p = jax.tree.map(np.asarray, junet.init_params(jcfg, jax.random.PRNGKey(0)))
    p["conv_out"] = (0.1 * rng.standard_normal(p["conv_out"].shape)).astype(np.float32)
    for k in p:
        if k.endswith("__bias"):
            p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    return jcfg, jax.tree.map(jnp.asarray, p), convert.unet_cfg_from_jax(jcfg), convert.params_from_jax(p), x, t


@pytest.fixture(scope="module")
def quantized(model):
    jcfg, jp, tcfg, tp, x, t = model
    out = {}
    for preset in PRESETS:
        jl, jq = junet.quantize_unet(jcfg, jp, preset, [(jnp.asarray(x), jnp.asarray(t))])
        tl, tq = tunet.quantize_unet(tcfg, tp, preset, [(_t(x), _t(t))])
        # jitted: one compile of the whole forward, not one per op (the same values)
        jfwd = jax.jit(lambda p, xx, tt, q, jl=jl: junet.forward(jcfg, p, xx, tt, layout=jl, qstate=q)[0])
        out[preset] = dict(jl=jl, jq=jq, tl=tl, tq=tq, j=np.asarray(jfwd(jp, jnp.asarray(x), jnp.asarray(t), jq)),
                           t=tunet.forward(tcfg, tp, _t(x), _t(t), layout=tl,
                                           qstate=convert.params_from_jax(jq))[0].numpy())
    return out


def test_forward_matches_jax(model):
    jcfg, jp, tcfg, tp, x, t = model
    je = np.asarray(jax.jit(lambda p, xx, tt: junet.forward(jcfg, p, xx, tt)[0])(jp, jnp.asarray(x), jnp.asarray(t)))
    te, st = tunet.forward(tcfg, tp, _t(x), _t(t))
    assert st is None and te.shape == x.shape
    assert rel_err(te.numpy(), je) <= TOL and np.abs(je).max() > 0.1


def test_plan_and_layout_match_jax(model):
    jcfg, jp, tcfg, tp, x, t = model
    assert tunet._plan(tcfg) == junet._plan(jcfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    g = tunet.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in g.items()} == {k: v.shape for k, v in jp.items()}
    assert not g["conv_out"].any()


def test_same_padding_and_resize_are_xla_s():
    rng = np.random.default_rng(2)
    for size in (8, 7):
        x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
        w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
        params = {"c": w, "c__bias": np.zeros(6, np.float32)}
        lay = junet.llama.QuantLayout(sites=())
        jy = np.asarray(junet._conv(jnp.asarray(x), jax.tree.map(jnp.asarray, params), "c", lay, None, False, {},
                                    stride=2))
        ty = tunet.conv(_t(x), convert.params_from_jax(params), "c", tunet.QuantLayout(sites=()), None, False, {},
                        stride=2)
        assert ty.shape == jy.shape and rel_err(ty.numpy(), jy) <= TOL
        for hw in ((2 * size, 2 * size), (size + 3, size - 2)):
            jr = np.asarray(jax.image.resize(jnp.asarray(x), (1, *hw, 4), "nearest"))
            np.testing.assert_array_equal(tunet.resize_nearest(_t(x), *hw).numpy(), jr)


@pytest.mark.parametrize("preset", PRESETS)
def test_quantize_unet_matches_jax(quantized, preset):
    q = quantized[preset]
    assert set(q["tq"]) == set(q["jq"])
    for name, sub in q["tq"].items():
        assert set(sub) == set(q["jq"][name])
        for which, st in sub.items():
            if st.amax is not None:
                assert rel_err(st.amax.numpy(), q["jq"][name][which].amax) <= TOL, (name, which)
    assert rel_err(q["t"], q["j"]) <= TOL
    assert q["tl"] == convert.layout_from_jax(q["jl"])
