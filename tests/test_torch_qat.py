"""The port's QAT (`quant/qat.py`) against the JAX package on a tiny Llama,
the same seeded weights in both.

Each package calibrates its own quantizer state on the same calibration
tokens (max calibration), and both train on other tokens: a state carried
across would put an f32 ulp of the other package's activations at the
calibration maximum on the wrong side of the straight-through clip.

 - Loss within 1e-6 relative and every gradient within 1e-5 of its
   tensor's scale of `jax.value_and_grad`'s (f32 sums in another order),
   for static int (INT8_DEFAULT), FP8, NVFP4 and LSQ (the amax gradients
   too).
 - One SGD step, and three Adam steps at JAX's default lr 1e-4 (LSQ's with
   `train_amax`), in f32: every parameter (and LSQ's amax) within 1e-5 of
   its tensor's scale. Adam's normalized update turns a gradient's last
   bits into a sign where the gradient is near zero, so the steps' own
   lr is kept at the default.
 - The loss and gradients against JAX's compiled `value_and_grad` (its QAT
   step runs compiled; XLA's reciprocal for the division by LSQ's bound
   decides the clip at a channel's largest weight, `test_torch_ste.py`).
 - `Adam.update` on the same gradients as `optax.adam` (jitted): the
   parameters within 1e-6 (f32) and 2^-7 (bf16, one ulp) of their scale
   after four steps (XLA fuses the moment updates).
 - Twenty bf16 Adam steps (INT8_DEFAULT, lr 1e-4): the losses within 5e-3
   relative at every step (the first step's bf16 forwards already lie 6e-4
   apart: XLA keeps f32 between fused bf16 ops; measured at most 2.0e-3).
 - The Mixtral `forward_fn`: its first loss within 1e-5 relative, four
   Adam steps' losses within 1e-4 and the parameters within 1e-3 of their
   scale (random routing has near ties: an f32 ulp moves a token to another
   expert, as the MoE engine tests know; measured 1.8e-5 and 4.9e-4).
 - Sparsity masks re-projecting the weights after a step, and a flash
   config's step equal to the einsum config's (training reads flash as
   einsum)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.models import mixtral as jmixtral
from tensorrt_model_optimizer_tpu.quant import get_preset as jget
from tensorrt_model_optimizer_tpu.quant import qat as jqat
from tensorrt_model_optimizer_tpu.quant.config import make_config as jmake
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.models import mixtral as tmixtral
from tensorrt_model_optimizer_tpu_torch.quant import qat as tqat

GRAD_TOL = 1e-5
STEP_TOL = 1e-5
BF16_LOSS_TOL = 5e-3
MOE_LOSS_TOL = 1e-4
MOE_STEP_TOL = 1e-3
LSQ = jmake({"*weight_quantizer": {"num_bits": 4, "learn_amax": True, "axis": 0},
             "*input_quantizer": {"enable": False}, "*lm_head*": {"enable": False}})
PRESETS = {"int8_static": "INT8_DEFAULT_CFG", "fp8": "FP8_DEFAULT_CFG", "nvfp4": "NVFP4_DEFAULT_CFG", "lsq": LSQ}


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    pnp = llama_params_np(jcfg, seed=0)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 17)).astype(np.int32)
    return jcfg, tree_map(jnp.asarray, pnp), convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp), tokens


def calibrated(tiny, preset):
    """(JAX layout, JAX qstate, port layout, port qstate), each package's
    state max-calibrated by its own forward on the same calibration tokens
    (not the training tokens: some training activations then clip)."""
    jcfg, jp, tcfg, tp, _ = tiny
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 17)).astype(np.int32)
    qcfg = jget(preset) if isinstance(preset, str) else preset
    jlay = jllama.build_layout(jcfg, qcfg)
    _, jqs, _ = jllama.forward(jcfg, jp, jnp.asarray(tokens[:, :-1]), layout=jlay,
                               qstate=jllama.init_quant_state(jcfg, jlay), calib=True)
    tlay = convert.layout_from_jax(jlay)
    with torch.no_grad():
        _, tqs, _ = tllama.forward(tcfg, tp, torch.from_numpy(tokens[:, :-1]).long(), layout=tlay,
                                   qstate=tllama.init_quant_state(tcfg, tlay, "cpu"), calib=True)
    return jlay, jqs, tlay, tqs


def _flat(tree, prefix=""):
    """name -> numpy array of a params or qstate tree (amaxes by site)."""
    if isinstance(tree, dict):
        return {k: v for n, sub in tree.items() for k, v in _flat(sub, f"{prefix}{n}.").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    if type(tree).__name__ == "QuantizerState":
        return {} if tree.amax is None or isinstance(tree.amax, tuple) else _flat(tree.amax, prefix + "amax.")
    if tree is None:
        return {}
    return {prefix[:-1]: tree.float().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree, np.float32)}


def _worst(t_tree, j_tree) -> tuple:
    t, j = _flat(t_tree), _flat(j_tree)
    assert set(t) == set(j)
    errs = {k: rel_err(t[k], j[k]) for k in t}
    k = max(errs, key=errs.get)
    return errs[k], k


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_loss_and_gradients_equal_jax(tiny, name):
    jcfg, jp, tcfg, tp, tokens = tiny
    jlay, jqs, tlay, tqs = calibrated(tiny, PRESETS[name])
    lsq = name == "lsq"
    jloss, jg = jax.jit(jax.value_and_grad(lambda pq: jqat.qat_loss(jcfg, jlay, pq[0], pq[1] if lsq else jqs,
                                                                    jnp.asarray(tokens))))((jp, jqs if lsq else None))
    tloss, tg = tqat.value_and_grad(lambda pq: tqat.qat_loss(tcfg, tlay, pq[0], pq[1] if lsq else tqs,
                                                             torch.from_numpy(tokens)), (tp, tqs if lsq else None))
    jqs_g = jg[1] if lsq else None
    assert abs(float(tloss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    err, where = _worst(tg[0], jg[0])
    assert err <= GRAD_TOL, (name, where, err)
    if lsq:
        err, where = _worst(tg[1], jqs_g)
        assert err <= GRAD_TOL, ("amax", where, err)
    if name == "int8_static":  # the clip mask is live: the pass-through gradient differs
        through = tllama.QuantLayout(sites=tuple((k, c.replace(pass_through_bwd=True)) for k, c in tlay.sites))
        _, tg2 = tqat.value_and_grad(lambda p: tqat.qat_loss(tcfg, through, p, tqs, torch.from_numpy(tokens)), tp)
        assert not torch.equal(tg2["embed_tokens"], tg[0]["embed_tokens"])


def test_sgd_step_equals_jax(tiny):
    jcfg, jp, tcfg, tp, tokens = tiny
    jlay, jqs, tlay, tqs = calibrated(tiny, "INT8_DEFAULT_CFG")
    jnew, jloss = jax.jit(jqat.make_train_step(jcfg, jlay, lr=5e-2))(jp, jqs, jnp.asarray(tokens))
    tnew, tloss = tqat.make_train_step(tcfg, tlay, lr=5e-2)(tp, tqs, torch.from_numpy(tokens))
    assert abs(float(tloss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    err, where = _worst(tnew, jnew)
    assert err <= STEP_TOL, (where, err)
    assert not tnew["layers"]["mlp.up_proj"].requires_grad and not torch.equal(tnew["layers"]["mlp.up_proj"],
                                                                                  tp["layers"]["mlp.up_proj"])


@pytest.mark.parametrize("name", ["int8_static", "lsq"])
def test_adam_steps_equal_jax(tiny, name):
    jcfg, jp, tcfg, tp, tokens = tiny
    jlay, jqs, tlay, tqs = calibrated(tiny, PRESETS[name])
    lsq = name == "lsq"
    jstep, jinit = jqat.make_optax_train_step(jcfg, jlay, optax.adam(1e-4), train_amax=lsq)
    tstep, tinit = tqat.make_optax_train_step(tcfg, tlay, tqat.Adam(1e-4), train_amax=lsq)
    jstep = jax.jit(jstep)
    jo, to = jinit(jp, jqs), tinit(tp, tqs)
    for _ in range(3):
        jp, jqs, jo, jloss = jstep(jp, jqs, jo, jnp.asarray(tokens))
        tp, tqs, to, tloss = tstep(tp, tqs, to, torch.from_numpy(tokens))
        assert abs(float(tloss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    err, where = _worst(tp, jp)
    assert err <= STEP_TOL, (where, err)
    if lsq:
        err, where = _worst(tqs, jqs)
        assert err <= STEP_TOL, ("amax", where, err)
        assert not np.allclose(_flat(tqs)["mlp.down_proj.weight.amax"],
                               _flat(calibrated(tiny, LSQ)[3])["mlp.down_proj.weight.amax"])
    assert int(to["count"]) == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_update_equals_optax(dtype):
    rng = np.random.default_rng(4)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    p = {"w": rng.standard_normal((8, 16)).astype(np.float32), "b": rng.standard_normal(16).astype(np.float32)}
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}
    opt, topt = optax.adam(3e-3), tqat.Adam(3e-3)
    jo, to = opt.init(jp), topt.init(tp)
    upd = jax.jit(opt.update)
    for step in range(4):
        g = {k: (rng.standard_normal(v.shape) * 10.0 ** -step).astype(np.float32) for k, v in p.items()}
        ju, jo = upd({k: jnp.asarray(v).astype(jdt) for k, v in g.items()}, jo)
        tu, to = topt.update({k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, to)
        jp, tp = optax.apply_updates(jp, ju), tqat.apply_updates(tp, tu)
        for k in p:
            a, b = tp[k].float().numpy(), np.asarray(jp[k].astype(jnp.float32))
            assert rel_err(a, b) <= (1e-6 if dtype == "float32" else 2.0 ** -7), (step, k, rel_err(a, b))
        assert tp["w"].dtype == tdt and to["mu"]["w"].dtype == tdt


def test_bf16_trajectory_equals_jax(tiny):
    """Twenty Adam steps of a bf16 model under INT8_DEFAULT: the losses
    within BF16_LOSS_TOL relative at every step, falling."""
    jcfg, jp, tcfg, tp, tokens = tiny
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = tree_map(lambda t: t.to(torch.bfloat16), tp)
    bf = (jcfg, jp, tcfg, tp, tokens)
    jlay, jqs, tlay, tqs = calibrated(bf, "INT8_DEFAULT_CFG")
    jstep, jinit = jqat.make_optax_train_step(jcfg, jlay, optax.adam(1e-4))
    tstep, tinit = tqat.make_optax_train_step(tcfg, tlay, tqat.Adam(1e-4))
    jstep = jax.jit(jstep)
    jo, to = jinit(jp, jqs), tinit(tp, tqs)
    jl, tl = [], []
    for _ in range(20):
        jp, jqs, jo, jloss = jstep(jp, jqs, jo, jnp.asarray(tokens))
        tp, tqs, to, tloss = tstep(tp, tqs, to, torch.from_numpy(tokens))
        jl.append(float(jloss))
        tl.append(float(tloss))
    gaps = [abs(a - b) / abs(b) for a, b in zip(tl, jl)]
    assert max(gaps) <= BF16_LOSS_TOL, gaps
    assert tl[-1] < tl[0] - 0.1 and jl[-1] < jl[0] - 0.1 and tp["lm_head"].dtype == torch.bfloat16


def test_mixtral_forward_fn_equals_jax():
    jcfg = jmixtral.MixtralConfig.tiny(capacity_factor=4.0)
    jp = jmixtral.init_params(jcfg, jax.random.PRNGKey(30))
    tcfg, tp = convert.llama_cfg_from_jax(jcfg), convert.params_from_jax(jp)
    toks = np.random.default_rng(30).integers(0, 256, (4, 17)).astype(np.int32)
    cal = np.random.default_rng(31).integers(0, 256, (4, 16)).astype(np.int32)
    jlay = jmixtral.build_layout(jcfg, jget("FP8_DEFAULT_CFG"))
    _, jqs = jmixtral.forward(jcfg, jp, jnp.asarray(cal), layout=jlay,
                              qstate=jmixtral.init_quant_state(jcfg, jlay), calib=True)
    tlay = convert.layout_from_jax(jlay)
    with torch.no_grad():
        _, tqs = tmixtral.forward(tcfg, tp, torch.from_numpy(cal).long(), layout=tlay,
                                  qstate=tmixtral.init_quant_state(tcfg, tlay, "cpu"), calib=True)
    jstep, jinit = jqat.make_optax_train_step(jcfg, jlay, forward_fn=jmixtral.forward)
    tstep, tinit = tqat.make_optax_train_step(tcfg, tlay, forward_fn=tmixtral.forward)
    jstep = jax.jit(jstep)
    jo, to = jinit(jp, jqs), tinit(tp, tqs)
    losses = []
    for i in range(4):
        jp, jqs, jo, jloss = jstep(jp, jqs, jo, jnp.asarray(toks))
        tp, tqs, to, tloss = tstep(tp, tqs, to, torch.from_numpy(toks))
        assert abs(float(tloss) - float(jloss)) <= (1e-5 if i == 0 else MOE_LOSS_TOL) * abs(float(jloss))
        losses.append(float(tloss))
    assert losses[-1] < losses[0]
    err, where = _worst(tp, jp)
    assert err <= MOE_STEP_TOL, (where, err)


def test_masks_are_refused_naming_weight_sparsity(tiny):
    """Sparsity masks came with weight sparsity: the step takes them and
    re-projects the weights after the update (JAX's step; the masked steps
    against JAX's are in test_torch_sparsity.py): the maskless step's
    params with the masked-off weights at 0."""
    from tensorrt_model_optimizer_tpu_torch.sparsity import sparsify

    _, _, tcfg, tp, tokens = tiny
    lay = tllama.QuantLayout(sites=())
    sp, masks = sparsify.sparsify(tcfg, tp)
    step_m, init_m = tqat.make_optax_train_step(tcfg, lay, masks=masks)
    step, init = tqat.make_optax_train_step(tcfg, lay)
    pm, _, _, lm = step_m(sp, None, init_m(sp, None), torch.from_numpy(tokens))
    p, _, _, l = step(sp, None, init(sp, None), torch.from_numpy(tokens))
    assert float(lm) == float(l)
    for k, v in p["layers"].items():
        want = v * masks[k].to(v.dtype) if k in masks else v
        assert torch.equal(pm["layers"][k], want), k
        if k in masks:
            assert (pm["layers"][k][~masks[k]] == 0).all() and not (v[~masks[k]] == 0).all()


def test_flash_config_trains_through_the_einsum(tiny):
    """A step on an attn_impl="flash" config equals the einsum config's
    (the flash kernel has no backward; its plain version would train, the
    card's kernel would refuse)."""
    _, _, tcfg, tp, tokens = tiny
    _, _, tlay, tqs = calibrated(tiny, "INT8_DEFAULT_CFG")
    fcfg = dataclasses.replace(tcfg, attn_impl="flash")
    assert tqat.train_cfg(fcfg) == tcfg and tqat.train_cfg(tcfg) is tcfg
    step_f, init_f = tqat.make_optax_train_step(fcfg, tlay)
    step_e, init_e = tqat.make_optax_train_step(tcfg, tlay)
    pf, _, _, lf = step_f(tp, tqs, init_f(tp, tqs), torch.from_numpy(tokens))
    pe, _, _, le = step_e(tp, tqs, init_e(tp, tqs), torch.from_numpy(tokens))
    assert float(lf) == float(le)
    for k in pf["layers"]:
        assert torch.equal(pf["layers"][k], pe["layers"][k]), k


def test_qat_recovery_recipe_equals_jax():
    """The accuracy tool's QAT recovery (`tools/torch_accuracy_table.py`
    `qat_recover`) against JAX's tool's loop, verbatim, on the trained
    anchor (f32; INT8_DEFAULT max-calibrated on one of the tool's
    calibration batches): the same token windows, and three steps' losses
    within 1e-3 relative. Under `jax.jit` XLA divides by the int grid's
    bound as a product by its f32 reciprocal, so JAX's compiled fake quant
    moves the anchor's codes at ties that its eager form and the port keep
    (step 0 reads 2.2e-4 apart); the single-step parity is held above on
    the tiny model."""
    import importlib.util
    import os

    from tensorrt_model_optimizer_tpu.models import hf_loader as jhf
    from tensorrt_model_optimizer_tpu.quant import ptq as jptq
    from tensorrt_model_optimizer_tpu.utils import synthlang as jsl
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader as thf
    from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq

    root = os.path.join(os.path.dirname(__file__), "..")
    spec = importlib.util.spec_from_file_location("torch_accuracy_table", os.path.join(root, "tools",
                                                                                       "torch_accuracy_table.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    anchor = os.path.join(root, "artifacts", "anchor-llama")
    calib = jsl.SynthLang(0).eval_batches(1, 4, 256, seed=555)
    jcfg, jp = jhf.load_hf_checkpoint(anchor, dtype=jnp.float32)
    tcfg, tp = thf.load_hf_checkpoint(anchor, dtype=torch.float32, device="cpu")
    jm = jptq.quantize(jcfg, jp, "INT8_DEFAULT_CFG", [jnp.asarray(b) for b in calib])
    tm = tptq.quantize(tcfg, tp, "INT8_DEFAULT_CFG", [torch.from_numpy(b) for b in calib], device="cpu")
    _, losses = tool.qat_recover(tm, "cpu", steps=3)
    windows = list(tool.qat_windows(3))
    step, init = jqat.make_optax_train_step(jcfg, jm.layout, optax.adam(2e-4))
    step = jax.jit(step)
    p, qs, opt = jm.params, jm.qstate, init(jm.params, jm.qstate)
    stream = jsl.SynthLang(0).token_stream(600 * 8 * 129, seed=123)  # JAX's tool, verbatim
    rng = np.random.default_rng(5)
    for i in range(3):
        starts = rng.integers(0, stream.size - 130, size=8)
        toks = np.stack([stream[s:s + 129] for s in starts])
        assert np.array_equal(windows[i], toks)
        p, qs, opt, loss = step(p, qs, opt, jnp.asarray(toks))
        assert abs(losses[i] - float(loss)) <= 1e-3 * float(loss), (i, losses[i], float(loss))
    assert tool.QAT_RECIPE["lr"] == 2e-4 and tool.QAT_RECIPE["steps"] == 600
