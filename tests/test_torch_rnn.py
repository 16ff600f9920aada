"""The port's quantized LSTM and GRU (models/rnn.py) against the JAX
package's on the CPU: JAX's own cell formulas (LSTM gates i, f, g, o with c
in f32; GRU's one bias on the hidden side, inside the reset product), with
the zero-initialised biases made random.

Tolerances (max over the output, relative to its largest value): the f32
forward (outputs and final hidden states), unquantized, from a given h0 and
fake-quantized from JAX's calibrated state: 1e-5; `quantize_rnn`'s amax:
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import rnn as jrnn
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import rnn as trnn

TOL = 1e-5
PRESETS = ("INT8_DEFAULT_CFG", "FP8_DEFAULT_CFG", "NVFP4_DEFAULT_CFG")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(cell: str):
    jcfg = jrnn.RNNConfig.tiny(cell=cell)
    rng = np.random.default_rng({"lstm": 1, "gru": 2}[cell])
    p = jax.tree.map(np.asarray, jrnn.init_params(jcfg, jax.random.PRNGKey(0)))
    for k in p:
        if k.endswith("bias"):
            p[k] = (0.3 * rng.standard_normal(p[k].shape)).astype(np.float32)
    x = rng.standard_normal((2, 12, jcfg.input_size)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((jcfg.num_layers, 2, jcfg.hidden_size))).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, p), convert.rnn_cfg_from_jax(jcfg), convert.params_from_jax(p), x, h0


@pytest.fixture(scope="module", params=["lstm", "gru"])
def model(request):
    return _pair(request.param)


def test_forward_matches_jax(model):
    jcfg, jp, tcfg, tp, x, h0 = model
    for h in (None, h0):
        jo, jh, _ = jrnn.forward(jcfg, jp, jnp.asarray(x), h0=None if h is None else jnp.asarray(h))
        to, th, st = trnn.forward(tcfg, tp, _t(x), h0=None if h is None else _t(h))
        assert st is None and to.shape == jo.shape and th.shape == jh.shape
        assert rel_err(to.numpy(), jo) <= TOL and rel_err(th.numpy(), jh) <= TOL


@pytest.mark.parametrize("preset", PRESETS)
def test_quantize_rnn_matches_jax(model, preset):
    jcfg, jp, tcfg, tp, x, h0 = model
    jl, jq = jrnn.quantize_rnn(jcfg, jp, preset, [jnp.asarray(x)])
    tl, tq = trnn.quantize_rnn(tcfg, tp, preset, [_t(x)])
    assert tl == convert.layout_from_jax(jl) and set(tq) == set(jq)
    for name, sub in tq.items():
        assert set(sub) == set(jq[name])
        for which, st in sub.items():
            if st.amax is not None:
                assert rel_err(st.amax.numpy(), jq[name][which].amax) <= TOL, (name, which)
    jo, jh, _ = jrnn.forward(jcfg, jp, jnp.asarray(x), layout=jl, qstate=jq)
    to, th, _ = trnn.forward(tcfg, tp, _t(x), layout=tl, qstate=convert.params_from_jax(jq))
    assert rel_err(to.numpy(), jo) <= TOL and rel_err(th.numpy(), jh) <= TOL


def test_init_params_shapes():
    for cell in ("lstm", "gru"):
        jcfg = jrnn.RNNConfig.tiny(cell=cell)
        jp = jrnn.init_params(jcfg, jax.random.PRNGKey(0))
        tp = trnn.init_params(convert.rnn_cfg_from_jax(jcfg), torch.Generator().manual_seed(0), device="cpu")
        assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
