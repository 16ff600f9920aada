"""The port's sparsity and pruning examples on the CPU at the tiny size:
`examples/llm_sparsity_torch.py` (magnitude and SparseGPT, then PTQ),
`prune_distill_torch.py` (Minitron prune, KD healing with falling loss) and
`chained_optimization_torch.py` (sparsify -> heal with the masks re-applied
-> PTQ -> export, the checkpoint loading back with its masked weights at
0). Each prints its lines and returns finite numbers."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("method", ["magnitude", "sparsegpt"])
def test_llm_sparsity_example(method, capsys):
    out = _load("examples/llm_sparsity_torch.py").main(["--device", "cpu", "--model", "tiny", "--method", method,
                                                        "--qformat", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"])
    printed = capsys.readouterr().out
    assert f"[llm_sparsity] {method} 2:4 ppl" in printed and "+ INT4_BLOCKWISE_WEIGHT_ONLY_CFG: ppl" in printed
    assert all(np.isfinite(out[k]) for k in ("ppl", "ppl_sparse", "ppl_quant"))
    assert out["sparsity"] == 0.5 and out["ppl_sparse"] != out["ppl"]
    for name, m in out["masks"].items():
        assert (out["params"]["layers"][name][~m] == 0).all(), name


def test_prune_distill_example(capsys):
    out = _load("examples/prune_distill_torch.py").main(["--device", "cpu", "--model", "tiny", "--distill_steps", "6"])
    printed = capsys.readouterr().out
    assert "[prune_distill] pruned to I=64 H=48" in printed and "[prune_distill] healed ppl" in printed
    assert (out["cfg"].intermediate_size, out["cfg"].hidden_size, out["cfg"].hd) == (64, 48, 16)
    assert all(np.isfinite(out[k]) for k in ("ppl_teacher", "ppl_pruned", "ppl_healed"))
    assert all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]
    assert out["params"]["layers"]["mlp.down_proj"].shape == (2, 48, 64)


def test_chained_optimization_example(tmp_path, capsys):
    out = _load("examples/chained_optimization_torch.py").main(["--device", "cpu", "--heal_steps", "4",
                                                                 "--export_path", str(tmp_path)])
    printed = capsys.readouterr().out
    for line in ("[chained] dense ppl", "[chained] 2:4 magnitude ppl", "masks intact", "sparse+quantized (FP8_DEFAULT_CFG)",
                 "[chained] exported FP8", "[chained] done"):
        assert line in printed, line
    assert all(np.isfinite(out[k]) for k in ("ppl_dense", "ppl_sparse", "ppl_healed", "ppl_quant", "loss"))
    with open(tmp_path / "hf_quant_config.json") as f:
        assert json.load(f)["quantization"]["quant_algo"] == out["quant_config"]["quantization"]["quant_algo"]
    from tensorrt_model_optimizer_tpu_torch.serve import loader

    cm = loader.load_quantized_checkpoint(str(tmp_path), device="cpu")
    masks = out["masks"]
    for name in ("mlp.down_proj", "self_attn.q_proj"):
        q = cm.params["layers"][name]["q"]
        assert cm.kinds[name] == "fp8" and q.dtype == torch.float8_e4m3fn, name
        assert (q.float()[~masks[name]] == 0).all() and (q.float()[masks[name]] != 0).any(), name
