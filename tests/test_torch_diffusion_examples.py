"""The port's diffusion and VLM examples (`examples/diffusion_ptq_torch.py`,
`examples/vlm_ptq_torch.py`) on the CPU: each backbone and preset runs
end to end with `--device cpu`, and its readings hold the bars JAX's own
tests hold the JAX examples' models to (tests/test_dit.py,
tests/test_unet.py, tests/test_vlm.py: correlation with the unquantized
model > 0.95, > 0.9 for the 4-bit activations), the DDIM sample is finite,
the DiT's real-quant step lies within 5e-2 of its fake-quant model, and the
DMD2 student loss and the VLM export come out."""

import importlib.util
import json
import os

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("backbone,qformat", [("dit", "NVFP4_DEFAULT_CFG"), ("dit", "INT4_AWQ_CFG"),
                                              ("dit", "FP8_DEFAULT_CFG"), ("unet", "FP8_DEFAULT_CFG"),
                                              ("unet", "INT8_DEFAULT_CFG")])
def test_diffusion_ptq_example(backbone, qformat):
    out = _example("diffusion_ptq_torch").main(["--device", "cpu", "--backbone", backbone, "--qformat", qformat]
                                               + (["--dmd"] if qformat == "NVFP4_DEFAULT_CFG" else []))
    assert out["corr"] > (0.9 if "NVFP4" in qformat else 0.95) and out["finite"]
    if backbone == "dit":
        assert out["packed_rel"] <= 5e-2
    if "dmd" in out:
        assert np.isfinite(out["dmd"]["vsd"]) and np.isfinite(out["dmd"]["gan_gen"])


@pytest.mark.parametrize("qformat", ["NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG"])
def test_vlm_ptq_example(qformat, tmp_path):
    out = _example("vlm_ptq_torch").main(["--device", "cpu", "--qformat", qformat, "--calib_batches", "2",
                                          "--export_path", str(tmp_path)])
    assert out["corr"] > (0.9 if "NVFP4" in qformat else 0.95) and out["delta"] > 1e-3
    assert out["quant_algo"] == json.load(open(tmp_path / "hf_quant_config.json"))["quantization"]["quant_algo"]
    assert out["quant_algo"] == ("NVFP4" if "NVFP4" in qformat else "FP8")
