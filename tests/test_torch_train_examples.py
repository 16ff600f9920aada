"""The port's QAT, eval and serving examples on the CPU at the tiny size:
`examples/llm_qat_torch.py` (plain QAT, `--qad`, `--lsq` with `--save_state`,
the saved directory restoring in the JAX package), `llm_eval_torch.py` (ppl
before and after a preset) and `serve_demo_torch.py` (quantize -> export ->
load -> serve, every request answered)."""

import importlib.util
import os

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", [[], ["--qad"], ["--lsq", "--qformat", "INT8_DEFAULT_CFG"]],
                         ids=["qat", "qad", "lsq"])
def test_llm_qat_example(mode, tmp_path):
    out = _load("examples/llm_qat_torch.py").main(["--device", "cpu", "--steps", "8", "--lr", "1e-3", *mode,
                                                   "--save_state", str(tmp_path)])
    losses = out["losses"]
    assert len(losses) == 8 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    from tensorrt_model_optimizer_tpu.opt import state as jstate

    back = jstate.restore(str(tmp_path))
    assert np.array_equal(np.asarray(back.params["layers"]["mlp.up_proj"]),
                          out["model"].params["layers"]["mlp.up_proj"].numpy())


def test_llm_eval_and_serve_demo_examples():
    ev = _load("examples/llm_eval_torch.py").main(["--device", "cpu", "--qformat", "NVFP4_DEFAULT_CFG"])
    assert np.isfinite(ev["ppl"]) and np.isfinite(ev["ppl_q"]) and "mmlu" not in ev
    outs = _load("examples/serve_demo_torch.py").main(["--device", "cpu", "--num_requests", "3",
                                                       "--max_new_tokens", "4", "--qformat", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"])
    assert sorted(outs) == [0, 1, 2] and all(len(t) == 4 for t in outs.values())
