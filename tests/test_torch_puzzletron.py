"""The port's Puzzletron (`puzzletron/puzzle.py`) against the JAX package on
one seeded tiny Llama (2 layers, f32).

 - The library: every candidate's name, cost and score (the local output
   MSE) within 1e-5 relative, `attn2mamba` included: the port distils from
   JAX's initial mixer (`init_mixers`) with `qat.Adam` (optax.adam's
   arithmetic) for JAX's 120 steps; the distilled mixer's weights within
   1e-3 relative (Adam divides by sqrt(nu): where a gradient is near 0, its
   f32 ulps move a weight by up to lr a step), the others equal.
 - `run_puzzle` and `run_puzzle_constrained`: the same choices on these
   seeds; `subblock_stats` equal field for field under JAX's TPU constants
   passed to both (the port's defaults are the H100's: ROADMAP queue 3).
 - `forward_hetero` logits within 1e-5; `heal_child`'s KD losses within
   1e-4 relative and its healed logits within 1e-4 (ten Adam steps of f32
   gradients).
 - `save_child` / `load_child` across the packages both ways.
 - Shared by both packages: a saved child keeps no mixer config, so a
   loaded `attn2mamba` layer has `mamba_cfg` None (ROADMAP queue 3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jl
from tensorrt_model_optimizer_tpu.models import mamba as jm
from tensorrt_model_optimizer_tpu.puzzletron import puzzle as jpz
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.puzzletron import puzzle as tpz

KINDS = jpz.build_and_score_library.__defaults__[0] + ("attn2mamba",)
TPU = dict(hbm_gbps=819.0, tflops=197.0)


@pytest.fixture(scope="module")
def libs():
    jc = jl.LlamaConfig.tiny(num_hidden_layers=2, dtype=jnp.float32)
    tc = convert.llama_cfg_from_jax(jc)
    pn = llama_params_np(jc, 0)
    jp, tp = tree_map(jnp.asarray, pn), tree_map(torch.from_numpy, pn)
    batches = [np.random.default_rng(s).integers(0, jc.vocab_size, (2, 16)).astype(np.int32) for s in (1, 2)]
    jlib = jpz.build_and_score_library(jc, jp, [jnp.asarray(b) for b in batches], kinds=KINDS)
    inits = []
    for i in range(jc.num_hidden_layers):  # JAX's initial mixers (seed = layer index)
        mp = jm.init_params(jlib[i][-1].mamba_cfg, jax.random.key(i))
        inits.append({k: torch.from_numpy(np.array(v[0])) for k, v in mp["layers_mamba"].items()
                      if k.startswith("mixer.")})
    tlib = tpz.build_and_score_library(tc, tp, [torch.from_numpy(b) for b in batches], kinds=KINDS,
                                       init_mixers=inits)
    return jc, jp, tc, tp, batches, jlib, tlib


def test_library(libs):
    *_, jlib, tlib = libs
    for jcands, tcands in zip(jlib, tlib):
        assert [c.name for c in tcands] == [c.name for c in jcands]
        assert [c.cost for c in tcands] == [c.cost for c in jcands]
        assert [c.skip for c in tcands] == [c.skip for c in jcands]
        for a, b in zip(tcands, jcands):
            assert rel_err(a.score, b.score) <= 1e-5, a.name
        assert convert.mamba_cfg_from_jax(jcands[-1].mamba_cfg) == tcands[-1].mamba_cfg


def test_candidate_params(libs):
    *_, jlib, tlib = libs
    for jcands, tcands in zip(jlib, tlib):
        for a, b in zip(tcands, jcands):
            if b.params is None:
                assert a.params is None
                continue
            assert set(a.params) == set(b.params), a.name
            for k, v in b.params.items():
                assert rel_err(a.params[k].numpy(), v) <= (1e-3 if a.name == "attn2mamba" else 0), (a.name, k)


@pytest.mark.parametrize("ratio", [0.5, 0.7, 0.9])
def test_run_puzzle_and_forward_hetero(libs, ratio):
    jc, jp, tc, tp, batches, jlib, tlib = libs
    jr, tr = jpz.run_puzzle(jlib, ratio), tpz.run_puzzle(tlib, ratio)
    assert tr.choices == jr.choices and (tr.total_params, tr.full_params) == (jr.total_params, jr.full_params)
    tok = batches[1]
    assert rel_err(tpz.forward_hetero(tc, tp, tr, torch.from_numpy(tok)).numpy(),
                   jpz.forward_hetero(jc, jp, jr, jnp.asarray(tok))) <= 1e-5


def test_subblock_stats(libs):
    *_, jlib, tlib = libs
    for a, b in zip(tlib[0], jlib[0]):
        assert dataclasses.astuple(tpz.subblock_stats(a, **TPU)) == dataclasses.astuple(jpz.subblock_stats(b, **TPU))
        kw = dict(batch=4, seq_len=1024, weight_bytes=0.5, kv_bytes=1.0, **TPU)
        assert dataclasses.astuple(tpz.subblock_stats(a, **kw)) == dataclasses.astuple(jpz.subblock_stats(b, **kw))
    # the deliberate difference: the port's defaults are the H100's rates, JAX's a TPU's
    full, jfull = tlib[0][0], jlib[0][0]
    assert tpz.subblock_stats(full) == tpz.subblock_stats(full, hbm_gbps=3350.0, tflops=989.0)
    assert dataclasses.astuple(jpz.subblock_stats(jfull)) == dataclasses.astuple(tpz.subblock_stats(full, **TPU))
    assert tpz.subblock_stats(full).decode_ms < jpz.subblock_stats(jfull).decode_ms


@pytest.mark.parametrize("budgets", [dict(memory_budget_mib=0.9), dict(decode_budget_ms=0.0014),
                                     dict(memory_budget_mib=1.0, param_budget_ratio=0.6)])
def test_run_puzzle_constrained(libs, budgets):
    *_, jlib, tlib = libs
    jr = jpz.run_puzzle_constrained(jlib, stats_kw=TPU, **budgets)
    tr = tpz.run_puzzle_constrained(tlib, stats_kw=TPU, **budgets)
    assert tr.choices == jr.choices and tr.total_params == jr.total_params
    with pytest.raises(ValueError, match="budget"):
        tpz.run_puzzle_constrained(tlib)


def test_solve_multi_ilp_greedy_fallback(monkeypatch):
    """Without scipy, JAX's greedy upgrade pass: equal picks."""
    import builtins

    rng = np.random.default_rng(7)
    scores, rows = rng.random((4, 3)), [rng.random((4, 3)), rng.random((4, 3))]
    want = jpz._solve_multi_ilp(scores, rows, [1.5, 1.6])
    assert np.array_equal(tpz._solve_multi_ilp(scores, rows, [1.5, 1.6]), want)
    real = builtins.__import__

    def no_scipy(name, *a, **k):
        if name.startswith("scipy"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_scipy)
    greedy = tpz._solve_multi_ilp(scores, rows, [1.5, 1.6])
    assert all(r[np.arange(4), greedy].sum() <= b for r, b in zip(rows, [1.5, 1.6]))


def test_heal_child(libs):
    jc, jp, tc, tp, batches, jlib, tlib = libs
    jr, tr = jpz.run_puzzle(jlib, 0.7), tpz.run_puzzle(tlib, 0.7)
    jh, jlog = jpz.heal_child(jc, jp, jr, [jnp.asarray(b) for b in batches], steps=10, lr=1e-3)
    th, tlog = tpz.heal_child(tc, tp, tr, [torch.from_numpy(b) for b in batches], steps=10, lr=1e-3)
    for k in ("kd_loss_first", "kd_loss_last"):
        assert rel_err(tlog[k], jlog[k]) <= 1e-4, k
    tok = batches[0]
    assert rel_err(tpz.forward_hetero(tc, tp, th, torch.from_numpy(tok)).numpy(),
                   jpz.forward_hetero(jc, jp, jh, jnp.asarray(tok))) <= 1e-4


def test_save_load_child_across_packages(libs, tmp_path):
    jc, jp, tc, tp, batches, jlib, tlib = libs
    jr, tr = jpz.run_puzzle(jlib, 0.6), tpz.run_puzzle(tlib, 0.6)
    assert "attn2mamba" not in tr.choices  # the shared gap below: a loaded mixer layer cannot run
    jpz.save_child(str(tmp_path / "j"), jc, jp, jr)
    tpz.save_child(str(tmp_path / "t"), tc, tp, tr)
    tok = batches[1]
    want = tpz.forward_hetero(tc, tp, tr, torch.from_numpy(tok))
    for path in ("j", "t"):
        bc, bp, res = tpz.load_child(str(tmp_path / path))
        assert bc == tc and res.choices == tr.choices and res.total_params == tr.total_params
        assert rel_err(tpz.forward_hetero(bc, bp, res, torch.from_numpy(tok)).numpy(), want.numpy()) <= 1e-6
        jbc, jbp, jres = jpz.load_child(str(tmp_path / path))
        assert jres.choices == jr.choices
        assert rel_err(np.asarray(jpz.forward_hetero(jbc, jbp, jres, jnp.asarray(tok))), want.numpy()) <= 1e-5


def test_loaded_mixer_layer_has_no_config(libs, tmp_path):
    """Shared by both packages: `save_child` writes no mixer config."""
    jc, jp, tc, tp, batches, jlib, tlib = libs
    pick = [len(c) - 1 for c in tlib]  # attn2mamba everywhere
    res = tpz.PuzzleResult([tlib[i][p].name for i, p in enumerate(pick)], [tlib[i][p] for i, p in enumerate(pick)],
                           0, 0)
    tpz.save_child(str(tmp_path / "m"), tc, tp, res)
    _, _, back = tpz.load_child(str(tmp_path / "m"))
    _, _, jback = jpz.load_child(str(tmp_path / "m"))
    assert [c.skip for c in back.layers] == ["mamba"] * 2 and all(c.mamba_cfg is None for c in back.layers)
    assert all(c.mamba_cfg is None for c in jback.layers)
    with pytest.raises(AttributeError):
        tpz.forward_hetero(tc, tp, back, torch.from_numpy(batches[0]))
