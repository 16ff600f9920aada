"""The port's accuracy probes (`utils/evaluate.py`) against the JAX
package's on the trained anchor (`artifacts/anchor-llama`, f32), on the
batches of JAX's accuracy gate (`tests/test_accuracy_anchor.py`):

 - `perplexity` of the unquantized model within 1e-4 relative of JAX's
   (f32 logits, log-softmax and NLL sums in another order), and of each
   quantized preset tested within 1e-3 (both packages calibrate on the same
   tokens; a rounding tie in an amax or a code moves the fake-quant logits);
 - `logit_divergence` within 1e-5 absolute + 1e-2 relative;
 - the port's Δppl of the flagship presets and of the three this slice
   brings (NF4, MXFP6, MXFP8) under JAX's pinned budgets
   (`round(max(3 x measured, 0) + 0.01, 4)`, `_MEASURED_DPPL`).
The NLL is taken over slices of T; a slice width that does not divide T
gives the same value."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_accuracy_anchor import _MEASURED_DPPL, _pin
from tensorrt_model_optimizer_tpu.models import hf_loader as jhf
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.utils import evaluate as jev
from tensorrt_model_optimizer_tpu.utils import synthlang as jsynth
from tensorrt_model_optimizer_tpu_torch.models import hf_loader as thf
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.utils import evaluate as tev

ANCHOR = os.path.join(os.path.dirname(__file__), "..", "artifacts", "anchor-llama")
NEW_FORMATS = ("NF4_WEIGHT_ONLY_CFG", "MXFP6_DEFAULT_CFG", "MXFP8_DEFAULT_CFG")
FLAGSHIP = ("NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG", "INT4_AWQ_CFG")


@pytest.fixture(scope="module")
def anchor():
    lang = jsynth.SynthLang(0)
    ev = [np.asarray(b) for b in lang.eval_batches(2, 8, 256, seed=999)]
    calib = [np.asarray(b) for b in lang.eval_batches(4, 4, 256, seed=555)]
    jcfg, jp = jhf.load_hf_checkpoint(ANCHOR, dtype=jnp.float32)
    tcfg, tp = thf.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device="cpu")
    return jcfg, jp, tcfg, tp, ev, calib


@pytest.fixture(scope="module")
def port_models(anchor):
    """The port's calibrated model and its ppl per preset, and the
    unquantized ppl, made once for both tests that read them."""
    _, _, tcfg, tp, ev, calib = anchor
    cache = {}

    def get(preset):
        if preset not in cache:
            if preset is None:
                cache[None] = (None, tev.perplexity(tcfg, tp, ev))
            else:
                tm = tptq.quantize(tcfg, tp, preset, [torch.from_numpy(c) for c in calib], device="cpu")
                cache[preset] = (tm, tev.perplexity(tcfg, tm.params, ev, layout=tm.layout, qstate=tm.qstate,
                                                    adapters=tm.adapters))
        return cache[preset]

    return get


def test_perplexity_unquantized(anchor):
    jcfg, jp, tcfg, tp, ev, _ = anchor
    j, t = jev.perplexity(jcfg, jp, ev), tev.perplexity(tcfg, tp, ev)
    assert abs(t - j) <= 1e-4 * j, (t, j)
    t_odd = tev.perplexity(tcfg, tp, [torch.from_numpy(b) for b in ev])  # tensors too
    assert abs(t_odd - t) <= 1e-6 * t


def test_nll_slices_do_not_change_the_sum(monkeypatch, anchor):
    _, _, tcfg, tp, ev, _ = anchor
    whole = tev.perplexity(tcfg, tp, ev[:1])
    monkeypatch.setattr(tev, "T_SLICE", 100)  # 255 rows in slices of 100, 100, 55
    assert abs(tev.perplexity(tcfg, tp, ev[:1]) - whole) <= 1e-6 * whole


@pytest.mark.parametrize("preset", ["NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG", *NEW_FORMATS])
def test_perplexity_and_kl_of_quantized_presets(anchor, port_models, preset):
    """ppl within 1e-3; KL within 1e-5 + 1e-2 relative, except under
    NVFP4_DEFAULT_CFG's 4-bit activations: there the calibrated input
    amaxes lie up to 4.5e-7 relative apart (the calibration forward's f32
    sums in another order), a moved global amax moves E4M3 block scales and
    E2M1 codes, and the two fake-quant forwards' logits lie 3.9e-4 of their
    scale apart (median over tokens); KL, ~2.4e-3, then reads 7% apart
    (2.26e-3 against 2.43e-3), so it is held within 10% relative
    (`test_kl_function_on_equal_logits` holds the function itself)."""
    jcfg, jp, tcfg, tp, ev, calib = anchor
    jm = jptq.quantize(jcfg, jp, preset, [jnp.asarray(c) for c in calib])
    tm, t = port_models(preset)
    j = jev.perplexity(jcfg, jm.params, ev, layout=jm.layout, qstate=jm.qstate, adapters=jm.adapters)
    assert abs(t - j) <= 1e-3 * j, (t, j)
    jk = jev.logit_divergence(jcfg, jm.params, ev, jm.layout, jm.qstate)
    tk = tev.logit_divergence(tcfg, tm.params, ev, tm.layout, tm.qstate)
    limit = 0.1 * abs(jk) if preset == "NVFP4_DEFAULT_CFG" else 1e-5 + 1e-2 * abs(jk)
    assert abs(tk - jk) <= limit, (tk, jk)


def test_kl_function_on_equal_logits():
    """The KL sum over T slices against JAX's formula on the same seeded
    logits: within 1e-5 absolute + 1e-2 relative (f32 sums in another
    order; read ~1e-7)."""
    import jax

    rng = np.random.default_rng(3)
    ref = rng.standard_normal((2, 300, 512)).astype(np.float32) * 4
    q = ref + rng.standard_normal(ref.shape).astype(np.float32) * 0.3
    p = jax.nn.softmax(jnp.asarray(ref), axis=-1)
    jk = float(jnp.mean(jnp.sum(p * (jax.nn.log_softmax(jnp.asarray(ref), -1) - jax.nn.log_softmax(jnp.asarray(q), -1)),
                                axis=-1)))
    tk = float(tev._kl_sum(torch.from_numpy(ref), torch.from_numpy(q))) / (2 * 300)
    assert abs(tk - jk) <= 1e-5 + 1e-2 * abs(jk), (tk, jk)


@pytest.mark.parametrize("preset", [*FLAGSHIP, *NEW_FORMATS])
def test_port_dppl_under_jax_pins(port_models, preset):
    """JAX's accuracy gate, run on the port: Δppl under JAX's pinned budget."""
    base, q = port_models(None)[1], port_models(preset)[1]
    assert q - base < _pin(_MEASURED_DPPL[preset]), (preset, q - base)
