"""The port's CV FastNAS / GradNAS (nas/cv.py) against the JAX package's on
the CPU, on a tiny f32 ConvNet with random biases.

Tolerances: the forward (logits) and the INT8 fake-quant forward from
JAX's calibrated state: 1e-5 of the logits' largest; the magnitude scores:
1e-5; the GradNAS scores (summed squared gradients): 1e-4 relative
Frobenius; `slice_model` on the same scores: equal parameters; and
`fastnas_prune` in both modes: the same width ratio, the same widths and
the same kept channels (JAX's scores, or each package's own: the argsort
orders agree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.nas import cv as jcv
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.nas import cv as tcv

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _frob(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def model():
    jcfg = jcv.CVConfig.tiny(widths=(16, 32))
    rng = np.random.default_rng(0)
    p = jax.tree.map(np.asarray, jcv.init_params(jcfg, jax.random.PRNGKey(0)))
    for k in p:
        if k.endswith("__bias"):
            p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    batches = [(rng.normal(size=(4, 16, 16, 3)).astype(np.float32), rng.integers(0, 10, 4).astype(np.int32))
               for _ in range(2)]
    return jcfg, jax.tree.map(jnp.asarray, p), convert.cv_cfg_from_jax(jcfg), convert.params_from_jax(p), batches


def test_forward_and_int8_match_jax(model):
    jcfg, jp, tcfg, tp, batches = model
    x = batches[0][0]
    jl = np.asarray(jcv.forward(jcfg, jp, jnp.asarray(x))[0])
    tl, st = tcv.forward(tcfg, tp, _t(x))
    assert st is None and rel_err(tl.numpy(), jl) <= TOL
    from tensorrt_model_optimizer_tpu.quant.config import get_preset

    lay = jcv.build_layout(jcfg, get_preset("INT8_DEFAULT_CFG"))
    _, jq = jcv.forward(jcfg, jp, jnp.asarray(x), layout=lay, calib=True)
    _, tq = tcv.forward(tcfg, tp, _t(x), layout=convert.layout_from_jax(lay), calib=True)
    assert set(tq) == set(jq)
    for name, sub in tq.items():
        for which, s in sub.items():
            assert rel_err(s.amax.numpy(), jq[name][which].amax) <= TOL
    jy = np.asarray(jcv.forward(jcfg, jp, jnp.asarray(x), layout=lay, qstate=jq)[0])
    ty = tcv.forward(tcfg, tp, _t(x), layout=convert.layout_from_jax(lay), qstate=convert.params_from_jax(jq))[0]
    assert rel_err(ty.numpy(), jy) <= TOL


def test_scores_and_slice_match_jax(model):
    jcfg, jp, tcfg, tp, batches = model
    jm, tm = jcv.magnitude_scores(jcfg, jp), tcv.magnitude_scores(tcfg, tp)
    for k in jm:
        assert rel_err(tm[k], jm[k]) <= TOL
    jb = [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches]
    jg, tg = jcv.gradnas_scores(jcfg, jp, jb), tcv.gradnas_scores(tcfg, tp, [(_t(x), _t(y)) for x, y in batches])
    for k in jg:
        assert _frob(tg[k], jg[k]) <= 1e-4
        np.testing.assert_array_equal(np.argsort(-tg[k]), np.argsort(-jg[k]))
    jc, jsub = jcv.slice_model(jcfg, jp, jm, 0.5)
    tc, tsub = tcv.slice_model(tcfg, tp, jm, 0.5)
    assert tc == convert.cv_cfg_from_jax(jc)
    for k, v in jsub.items():
        np.testing.assert_array_equal(tsub[k].numpy(), np.asarray(v), err_msg=k)


# budgets under which the search both accepts and refuses cuts on this
# random model (its loss does not grow with pruning at a looser one): the
# ratios found are 0.8828125 (12, 28) and 0.5078125 (8, 16)
@pytest.mark.parametrize("mode,budget,ratio", [("magnitude", 0.0, 0.8828125), ("gradnas", -0.005, 0.5078125)])
def test_fastnas_prune_matches_jax(model, mode, budget, ratio):
    jcfg, jp, tcfg, tp, batches = model
    jc, jsub, jr = jcv.fastnas_prune(jcfg, jp, [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches],
                                     max_loss_increase=budget, steps=6, score_mode=mode)
    tc, tsub, tr = tcv.fastnas_prune(tcfg, tp, [(_t(x), _t(y)) for x, y in batches], max_loss_increase=budget,
                                     steps=6, score_mode=mode)
    assert tr == jr == ratio and tc.widths == tuple(jc.widths)
    for k, v in jsub.items():
        np.testing.assert_array_equal(tsub[k].numpy(), np.asarray(v), err_msg=k)
    assert np.isfinite(tcv.forward(tc, tsub, _t(batches[0][0]))[0].numpy()).all()
