"""The port's PTQ entry point (`examples/hf_ptq_torch.py`) against JAX's
(`examples/hf_ptq.py`), and the port's accuracy-table tool
(`tools/torch_accuracy_table.py`), on the CPU.

Both CLIs run on artifacts/anchor-llama (bf16, as both load it) with a
recipe, its overrides and a tokens file of the anchor's language written
here: the unquantized ppl and the quantized ppl within 1e-3 relative of
JAX's printed value (JAX prints 3 decimals; the bf16 forwards' rounding
moves calibrated amaxes, read: 7e-4 and 9e-4 relative); the export's
quant_algo is JAX's. A family not ported raises, naming its ROADMAP queue
1 item; `--save_state` and `--auto_quantize_bits` run (once refused)."""

import importlib.util
import json
import os
import re
import sys

import numpy as np
import torch
import pytest

from tensorrt_model_optimizer_tpu_torch.utils import synthlang

ROOT = os.path.join(os.path.dirname(__file__), "..")
ANCHOR = os.path.join(ROOT, "artifacts", "anchor-llama")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tokens(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("toks") / "toks.npy")
    np.save(p, synthlang.SynthLang(0).token_stream(2 * 2 * 128 * 2, seed=555))
    return p


@pytest.mark.parametrize("recipe,algo", [("nvfp4_ptq.yaml", "NVFP4"), ("w4a8_awq.yaml", None)])
def test_cli_ppl_equals_jax_cli(recipe, algo, tokens, tmp_path, monkeypatch, capsys):
    """W4A8 does not export on the anchor in either package: INT4's unified
    layout has no ragged last block and the anchor's down_proj has K = 704
    (ROADMAP queue 3)."""
    args = ["--model", ANCHOR, "--recipe", recipe, "--calib_data", tokens, "--override", "calib.num_batches=2",
            "--override", "calib.seq_len=128"]
    monkeypatch.setattr(sys, "argv", ["hf_ptq.py", *args])
    assert _load("examples/hf_ptq.py", "hf_ptq_jax").main() == 0
    printed = capsys.readouterr().out
    jb = float(re.search(r"bf16 ppl ([\d.]+)", printed).group(1))
    jq = float(re.search(r"quantized ppl ([\d.]+)", printed).group(1))
    export = ["--export_path", str(tmp_path / "out")] if algo else []
    out = _load("examples/hf_ptq_torch.py", "hf_ptq_torch").main([*args, "--device", "cpu", *export])
    assert abs(out["ppl_before"] - jb) <= 1e-3 * jb, (out["ppl_before"], jb)
    assert abs(out["ppl_after"] - jq) <= 1e-3 * jq, (out["ppl_after"], jq)
    if algo:
        with open(tmp_path / "out" / "hf_quant_config.json") as f:
            assert json.load(f)["quantization"]["quant_algo"] == algo == out["quant_algo"]


def test_cli_moe_family_equals_jax_cli(tokens, tmp_path, monkeypatch, capsys):
    """artifacts/anchor-moe through both CLIs (the registry sends qwen3_moe
    to the mixtral family and `quantize_family`): INT4 weight-only on the
    anchor's language, ppl before and after within 1e-3 relative of JAX's
    printed values, the exported quant_algo JAX's (W4A16_AWQ)."""
    moe = os.path.join(ROOT, "artifacts", "anchor-moe")
    args = ["--model", moe, "--qformat", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "--calib_data", tokens,
            "--calib_batches", "2", "--calib_seq_len", "128"]
    monkeypatch.setattr(sys, "argv", ["hf_ptq.py", *args, "--export_path", str(tmp_path / "jax")])
    assert _load("examples/hf_ptq.py", "hf_ptq_jax").main() == 0
    printed = capsys.readouterr().out
    jb = float(re.search(r"bf16 ppl ([\d.]+)", printed).group(1))
    jq = float(re.search(r"quantized ppl ([\d.]+)", printed).group(1))
    out = _load("examples/hf_ptq_torch.py", "hf_ptq_torch").main(
        [*args, "--device", "cpu", "--export_path", str(tmp_path / "port")])
    assert abs(out["ppl_before"] - jb) <= 1e-3 * jb, (out["ppl_before"], jb)
    assert abs(out["ppl_after"] - jq) <= 1e-3 * jq, (out["ppl_after"], jq)
    assert out["quant_algo"] == "W4A16_AWQ" and out["model"].forward_fn is not None
    aq = _load("examples/hf_ptq_torch.py", "hf_ptq_torch").main(
        ["--device", "cpu", "--model", moe, "--qformat", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "--calib_data", tokens,
         "--calib_batches", "1", "--calib_seq_len", "64", "--auto_quantize_bits", "5"])
    assert aq["auto_quantize_bits"] <= 5 + 1e-9  # auto_quantize_moe's active-expert costing, within the budget


@pytest.mark.parametrize("extra,item", [(["--auto_quantize_bits", "5"], "item 8"), (["--save_state", "/tmp/s"], "item 10")])
def test_cli_unported_arguments_raise(extra, item, tmp_path):
    """The two arguments once refused (naming ROADMAP's items 8 and 10) now
    run: AutoQuantize within its budget to a finite mixed forward, and the
    mto state saved where asked and restored to the quantized model."""
    cli = _load("examples/hf_ptq_torch.py", "hf_ptq_torch")
    base = ["--device", "cpu", "--calib_batches", "2", "--calib_seq_len", "32"]
    if extra[0] == "--save_state":
        out = cli.main([*base, "--save_state", str(tmp_path / "s")])
        from tensorrt_model_optimizer_tpu_torch.opt import state

        back = state.restore(str(tmp_path / "s"), device="cpu")
        assert back.quant_cfg == out["model"].quant_cfg
        assert torch.equal(back.params["layers"]["mlp.up_proj"], out["model"].params["layers"]["mlp.up_proj"])
        return
    out = cli.main([*base, "--qformat", "NVFP4_DEFAULT_CFG", *extra])  # against FP8_DEFAULT_CFG
    assert out["auto_quantize_bits"] <= 5 + 1e-9 and out["mixed_logits_finite"] and "ppl_after" not in out


def test_cli_refuses_other_families(tmp_path):
    # mixtral, qwen3_moe and dbrx run since the MoE-families slice (test_torch_moe_ptq.py),
    # gpt_oss and llama4 since the GPT-OSS / Llama4 slice; nemotron_h is the
    # mamba family since the hybrid slice, and both CLIs send it to the MoE
    # loader, which has no Nemotron-H reader (JAX: hf_loader.py:608-609)
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "nemotron_h"}))
    with pytest.raises(NotImplementedError, match="MoE model_type 'nemotron_h'"):
        _load("examples/hf_ptq_torch.py", "hf_ptq_torch").main(["--device", "cpu", "--model", str(tmp_path)])


def test_cli_tiny_model_runs(tmp_path):
    out = _load("examples/hf_ptq_torch.py", "hf_ptq_torch").main(
        ["--device", "cpu", "--qformat", "MXFP8_DEFAULT_CFG", "--calib_batches", "2", "--calib_seq_len", "32",
         "--export_path", str(tmp_path)])
    assert out["quant_algo"] == "MXFP8" and np.isfinite(out["ppl_after"])


def test_accuracy_tool_writes_only_its_own_file(tmp_path, monkeypatch):
    """Two presets, 2 questions a subject: the table's keys, JAX's QAT row
    null with its reason (neither preset loses more than JAX's 0.005), the bf16 row's ppl JAX's record's
    (artifacts/accuracy_table.json, f32 on both sides: 1e-5 relative)."""
    monkeypatch.setenv("ACC_PRESETS", "NF4_WEIGHT_ONLY_CFG,MXFP6_DEFAULT_CFG")
    monkeypatch.setenv("ACC_MMLU_N", "2")
    record = os.path.join(ROOT, "artifacts", "accuracy_table.json")
    before = os.path.getmtime(record), os.path.getmtime(os.path.join(ROOT, "ACCURACY.md"))
    tool = _load("tools/torch_accuracy_table.py", "torch_accuracy_table")
    out = tool.main(["--device", "cpu", "--out", str(tmp_path / "t.json")])
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert set(out["presets"]) == {"NF4_WEIGHT_ONLY_CFG", "MXFP6_DEFAULT_CFG"}
    for row in out["presets"].values():
        assert {"ppl", "d_ppl", "kl", "mmlu", "mmlu_ci95", "mmlu_n", "d_mmlu_pct"} <= set(row)
        assert row["mmlu_n"] == 10
    # both presets lie within JAX's 0.005: no QAT row, by JAX's rule (the recipe: test_qat_recovery_recipe)
    assert out["qat_recovery"] is None and "0.005" in out["qat_recovery_reason"]
    with open(record) as f:
        assert abs(out["bf16"]["ppl"] - json.load(f)["bf16"]["ppl"]) <= 1e-5 * out["bf16"]["ppl"]
    assert (os.path.getmtime(record), os.path.getmtime(os.path.join(ROOT, "ACCURACY.md"))) == before
    assert tool.OUT.endswith(os.path.join("artifacts", "accuracy_table_torch.json"))
