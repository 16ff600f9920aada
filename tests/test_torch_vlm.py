"""The port's VLM (models/vlm.py), its calibration pairs and its export
against the JAX package's on the CPU, on the tiny f32 VLM (a 2-block ViT
and a 2-layer Llama LM).

Tolerances (max over the logits, relative to their largest value):
 - `encode_image` and `forward`: 1e-5;
 - `quantize_vlm`'s amax: 1e-5 of each site's largest;
 - the fake-quant forward from JAX's calibrated state: 1e-5 for the
   weight-only INT4_AWQ; where activation quantizers run (NVFP4, FP8), twice
   the port's own response to an f32 ulp of its input (the pixels times
   1 + 1e-7), or 1e-5 if that is larger. An activation at a rounding
   boundary of its grid lands a grid step away under an ulp of change, and
   FP8's per-tensor grid on this tiny random model turns that into a
   7.6e-2 move of the logits (measured: the port against itself); the two
   packages' f32 sums differ by such ulps (XLA's fused, compiled ops against
   eager PyTorch's), so that is the gap a right port can show. NVFP4 comes
   out equal to 3e-7;
 - `export_vlm_checkpoint`: every file byte-equal to JAX's.

The text embedding's quantizer is a deliberate difference (ROADMAP queue
3): the port applies it, as `llama.forward` does for tokens, and JAX's VLM
does not; no preset enables the site, and a config that does shows both.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.export import hf_export as jexport
from tensorrt_model_optimizer_tpu.models import vlm as jvlm
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.utils import dataset as jds
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.export import hf_export as texport
from tensorrt_model_optimizer_tpu_torch.models import vlm as tvlm
from tensorrt_model_optimizer_tpu_torch.quant import quantizer as tq
from tensorrt_model_optimizer_tpu_torch.utils import dataset as tds

TOL = 1e-5
PRESETS = {"NVFP4_DEFAULT_CFG": True, "FP8_DEFAULT_CFG": True, "INT4_AWQ_CFG": False}  # -> activation quantizers


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def model():
    jcfg = jvlm.VLMConfig.tiny()
    p = jax.tree.map(np.asarray, jvlm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    for k in p["vision"]["blocks"]:
        if k.endswith("__bias"):
            p["vision"]["blocks"][k] = (0.1 * rng.standard_normal(p["vision"]["blocks"][k].shape)).astype(np.float32)
    p["vision"]["ln_f"] = (1 + 0.1 * rng.standard_normal(p["vision"]["ln_f"].shape)).astype(np.float32)
    # the synthetic pairs' text ids run past the tiny LM's 256 rows (JAX's
    # gather clamps them, torch's raises): taken mod 256 here
    batches = [(px, tk % jcfg.lm.vocab_size) for px, tk in tds.vlm_calib_batches(2, batch=2, img=64, seq=12)]
    return jcfg, jax.tree.map(jnp.asarray, p), convert.vlm_cfg_from_jax(jcfg), convert.params_from_jax(p), batches


@pytest.fixture(scope="module")
def quantized(model):
    jcfg, jp, tcfg, tp, batches = model
    px, tk = batches[0]
    out = {}
    for preset in PRESETS:
        jl, jq = jvlm.quantize_vlm(jcfg, jp, preset, [(jnp.asarray(a), jnp.asarray(b)) for a, b in batches])
        tl, tq_own = tvlm.quantize_vlm(tcfg, tp, preset, [(_t(a), _t(b)) for a, b in batches])
        tqs = convert.params_from_jax(jq)
        t = tvlm.forward(tcfg, tp, _t(px), _t(tk), layout=tl, qstate=tqs)[0].numpy()
        nudged = tvlm.forward(tcfg, tp, _t(px * np.float32(1 + 1e-7)), _t(tk), layout=tl, qstate=tqs)[0].numpy()
        out[preset] = dict(
            jl=jl, jq=jq, tl=tl, tq_own=tq_own, tq=tqs, t=t, ulp_response=rel_err(nudged, t),
            j=np.asarray(jvlm.forward(jcfg, jp, jnp.asarray(px), jnp.asarray(tk), layout=jl, qstate=jq)[0]))
    return out


def test_forward_matches_jax(model):
    jcfg, jp, tcfg, tp, batches = model
    px, tk = batches[0]
    ji, _ = jvlm.encode_image(jcfg, jp, jnp.asarray(px))
    ti, st = tvlm.encode_image(tcfg, tp, _t(px))
    assert st == {} and rel_err(ti.numpy(), ji) <= TOL
    jl, _ = jvlm.forward(jcfg, jp, jnp.asarray(px), jnp.asarray(tk))
    tl, st = tvlm.forward(tcfg, tp, _t(px), _t(tk))
    assert st is None and tl.shape == (2, 12, jcfg.lm.vocab_size) and rel_err(tl.numpy(), jl) <= TOL
    # the image conditions the text logits
    moved = tvlm.forward(tcfg, tp, torch.roll(_t(px), 7, dims=1), _t(tk))[0]
    assert float((moved - tl).abs().max()) > 1e-3


@pytest.mark.parametrize("preset", list(PRESETS))
def test_quantize_vlm_matches_jax(quantized, preset):
    q = quantized[preset]
    assert q["tl"] == convert.layout_from_jax(q["jl"]) and set(q["tq_own"]) == set(q["jq"])
    for name, sub in q["tq_own"].items():
        for which, st in (sub.items() if isinstance(sub, dict) else [("", sub)]):
            j = q["jq"][name][which] if which else q["jq"][name]
            pairs = zip(st.amax, j.amax) if isinstance(st.amax, tuple) else [(st.amax, j.amax)]
            for a, b in pairs:
                assert (a is None) == (b is None) and (a is None or rel_err(a.numpy(), b) <= TOL), (name, which)
    assert any(k.startswith("vision.") for k in q["tq_own"]) and "proj.fc1" in q["tq_own"]
    tol = max(TOL, 2 * q["ulp_response"]) if PRESETS[preset] else TOL
    assert rel_err(q["t"], q["j"]) <= tol


@pytest.mark.parametrize("preset", ["NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG", "INT4_AWQ_CFG", "INT8_DEFAULT_CFG"])
def test_export_vlm_checkpoint_byte_equal(model, quantized, preset, tmp_path):
    jcfg, jp, tcfg, tp, batches = model
    if preset in quantized:
        jl, jq = quantized[preset]["jl"], quantized[preset]["jq"]
    else:
        jl, jq = jvlm.quantize_vlm(jcfg, jp, preset, [(jnp.asarray(a), jnp.asarray(b)) for a, b in batches[:1]])
    jh = jexport.export_vlm_checkpoint(jcfg, jp, jl, jq, str(tmp_path / "jax"), quant_cfg=preset)
    th = texport.export_vlm_checkpoint(tcfg, tp, convert.layout_from_jax(jl), convert.params_from_jax(jq),
                                       str(tmp_path / "port"), quant_cfg=preset)
    assert th == jh
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == ["config.json", "hf_quant_config.json",
                                                              "model.safetensors"]
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_embedding_quantizer_is_applied(model):
    """A config that enables `model.embed_tokens.weight_quantizer` (no preset
    does): JAX's VLM looks the text rows up unquantized, the port applies
    the quantizer as `llama.forward` does for tokens."""
    jcfg, jp, tcfg, tp, batches = model
    px, tk = batches[0]
    base = jconfig.get_preset("INT4_AWQ_CFG")  # weight-only: no activation grid to tie on
    emb = jconfig.QuantizerConfig(num_bits=4, axis=(0,))
    qcfg = dataclasses.replace(base, rules=base.rules + (("*embed_tokens.weight_quantizer", emb),))
    assert all(not jconfig.get_preset(p).resolve("model.embed_tokens.weight_quantizer").enable
               for p in jconfig.PRESETS)
    jl, jq = jvlm.quantize_vlm(jcfg, jp, qcfg, [(jnp.asarray(px), jnp.asarray(tk))])
    assert jl.get("embed_tokens.weight").enable and "embed_tokens.weight" in jq
    tl, tqs = convert.layout_from_jax(jl), convert.params_from_jax(jq)
    ours = tvlm.forward(tcfg, tp, _t(px), _t(tk), layout=tl, qstate=tqs)[0]
    # JAX: the unquantized table, equal to the port with the site off
    off = convert.layout_from_jax(dataclasses.replace(jl, sites=tuple(
        (k, jconfig.QuantizerConfig(enable=False) if k == "embed_tokens.weight" else c) for k, c in jl.sites)))
    theirs = np.asarray(jvlm.forward(jcfg, jp, jnp.asarray(px), jnp.asarray(tk), layout=jl, qstate=jq)[0])
    skipped = tvlm.forward(tcfg, tp, _t(px), _t(tk), layout=off, qstate=tqs)[0]
    assert rel_err(skipped.numpy(), theirs) <= TOL
    assert rel_err(ours.numpy(), theirs) > 1e3 * TOL  # 4-bit rows move the logits
    # ... and the port's is the lookup in the quantized table
    table = tq.quantize(tp["lm"]["embed_tokens"], tl.get("embed_tokens.weight"), tqs["embed_tokens.weight"])
    img, _ = tvlm.encode_image(tcfg, tp, _t(px), layout=tl, qstate=tqs)
    from tensorrt_model_optimizer_tpu_torch.models import llama as tllama

    direct = tllama.forward(tcfg.lm, tp["lm"], None, input_embeds=torch.cat([img, table[_t(tk).long()]], dim=1),
                            layout=tl, qstate=tvlm._lm_only(tqs))[0][:, img.shape[1]:]
    np.testing.assert_array_equal(ours.numpy(), direct.numpy())


def test_init_params_shapes_match_jax():
    jcfg = jvlm.VLMConfig.tiny()
    jp = jvlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tvlm.init_params(convert.vlm_cfg_from_jax(jcfg), torch.Generator().manual_seed(0), device="cpu")
    flat_j = {jax.tree_util.keystr(k): v.shape for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert flat_t == flat_j
    assert jds.vlm_calib_batches(1)[0][0].shape == tds.vlm_calib_batches(1)[0][0].shape == (2, 64, 64, 3)
