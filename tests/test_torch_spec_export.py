"""The port's speculative-draft export (`export/spec_export.py`) against
JAX's: the Medusa and EAGLE files are byte-equal to JAX's for the same
drafts (f32, and bf16 stored as f32), `load_medusa` reads back what either
package wrote, and `drafts_from_jax` keeps a draft's structure. Also the
port's speculative-decoding example, every mode, on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.export import spec_export as jexport
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.speculative import eagle as jeagle
from tensorrt_model_optimizer_tpu.speculative import medusa as jmedusa
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.export import spec_export as texport
from tensorrt_model_optimizer_tpu_torch.speculative import eagle as teagle
from tensorrt_model_optimizer_tpu_torch.speculative import medusa as tmedusa

FILES = {"medusa": ("medusa_heads.safetensors", "medusa_config.json"),
         "eagle": ("eagle_draft.safetensors", "eagle_config.json")}


def _cfg(dtype):
    return jllama.LlamaConfig.tiny(dtype=dtype, rope_scaling=jllama.RopeScaling())


def _drafts(dtype):
    jcfg = _cfg(dtype)
    return jcfg, {"medusa": jmedusa.init_medusa(jcfg, jmedusa.MedusaConfig(num_heads=2, num_layers=2),
                                                jax.random.PRNGKey(5)),
                  "eagle": jeagle.init_eagle(jcfg, jeagle.EagleConfig(num_layers=2), jax.random.PRNGKey(6)),
                  "eagle3": jeagle.init_eagle3(jcfg, jeagle.EagleConfig(), jax.random.key(7))}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["medusa", "eagle", "eagle3"])
def test_export_bytes_equal_jax(tmp_path, kind, dtype):
    jcfg, drafts = _drafts(dtype)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    exp = "medusa" if kind == "medusa" else "eagle"
    jinfo = getattr(jexport, f"export_{exp}")(drafts[kind], jcfg, jdir)
    tinfo = getattr(texport, f"export_{exp}")(convert.drafts_from_jax(drafts[kind]), tcfg, tdir)
    assert tinfo == jinfo
    for name in FILES[exp]:
        assert _read(os.path.join(tdir, name)) == _read(os.path.join(jdir, name)), name


def test_load_medusa_round_trips(tmp_path):
    """The port reads JAX's export and its own (f32, as stored) on the CPU,
    and the heads compute what the exported ones did."""
    jcfg, drafts = _drafts(jnp.float32)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    heads = convert.drafts_from_jax(drafts["medusa"])
    jexport.export_medusa(drafts["medusa"], jcfg, str(tmp_path / "jax"))
    texport.export_medusa(heads, tcfg, str(tmp_path / "port"))
    for d in ("jax", "port"):
        loaded = texport.load_medusa(str(tmp_path / d), device="cpu")
        assert len(loaded["heads"]) == 2 and len(loaded["heads"][0]["blocks"]) == 2
        for a, b in zip(loaded["heads"], heads["heads"]):
            assert torch.equal(a["lm"], b["lm"]) and all(torch.equal(x, y) for x, y in zip(a["blocks"], b["blocks"]))
            assert a["lm"].dtype == torch.float32
    jl = jexport.load_medusa(str(tmp_path / "port"))
    params = tree_map(torch.from_numpy, llama_params_np(jcfg, seed=0))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, size=(1, 8)))
    _, want = tmedusa.medusa_logits(tcfg, params, heads, tokens)
    _, got = tmedusa.medusa_logits(tcfg, params, texport.load_medusa(str(tmp_path / "port"), device="cpu"), tokens)
    assert torch.equal(got, want)
    assert all(np.array_equal(np.asarray(j["lm"]), t["lm"].numpy()) for j, t in zip(jl["heads"], heads["heads"]))


def test_drafts_from_jax_keeps_the_structure():
    jcfg, drafts = _drafts(jnp.bfloat16)
    m = convert.drafts_from_jax(drafts["medusa"])
    assert isinstance(m["heads"], list) and isinstance(m["heads"][0]["blocks"], list)
    assert m["heads"][0]["lm"].dtype == torch.bfloat16
    e3 = convert.drafts_from_jax(drafts["eagle3"])
    assert e3["aux_layer_ids"] == (0, 1) and set(e3) == set(drafts["eagle3"])
    # a jitted JAX train step hands the tap ids back as arrays: still ints here
    stepped = dict(drafts["eagle3"], aux_layer_ids=tuple(jnp.asarray(i) for i in drafts["eagle3"]["aux_layer_ids"]))
    assert convert.drafts_from_jax(stepped)["aux_layer_ids"] == (0, 1)
    assert rel_err(convert.drafts_from_jax(drafts["eagle"])["fc"].float().numpy(),
                   np.asarray(drafts["eagle"]["fc"], np.float32)) == 0


def test_init_on_the_port():
    """The port's own inits: shapes and dtypes as JAX's, seeded."""
    tcfg = convert.llama_cfg_from_jax(_cfg(jnp.bfloat16))
    g = torch.Generator().manual_seed(0)
    med = tmedusa.init_medusa(tcfg, tmedusa.MedusaConfig(num_heads=2), g, device="cpu")
    assert med["heads"][1]["lm"].shape == (256, 64) and med["heads"][0]["blocks"][0].dtype == torch.bfloat16
    e3 = teagle.init_eagle3(tcfg, teagle.EagleConfig(), g, device="cpu")
    jshapes = tree_map(lambda a: a.shape, {k: v for k, v in _drafts(jnp.bfloat16)[1]["eagle3"].items()
                                           if k != "aux_layer_ids"})
    assert tree_map(lambda t: tuple(t.shape), {k: v for k, v in e3.items() if k != "aux_layer_ids"}) == jshapes


@pytest.mark.parametrize("argv", [["--mode", "medusa"], ["--mode", "medusa", "--tree"],
                                  ["--mode", "medusa", "--engine"], ["--mode", "eagle"], ["--mode", "dflash"]],
                         ids=["medusa_chain", "medusa_tree", "medusa_engine", "eagle", "dflash"])
def test_example_runs_on_the_cpu(argv):
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "speculative_decoding_torch.py")
    spec = importlib.util.spec_from_file_location("speculative_decoding_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(argv + ["--device", "cpu", "--train_steps", "3", "--decode_steps", "6"])
    assert np.isfinite(out["loss"])
    if argv[1] != "eagle":
        assert 0.0 <= out["acceptance"] <= 1.0 and len(out["tokens"]) >= 6
    else:
        assert len(out["accs"]) == 2
