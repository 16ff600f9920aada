"""The port's search framework (`opt/{hparam,searcher,dependency}.py`) and
AutoNAS / FastNAS (`nas/autonas.py`) against the JAX package.

 - `Hparam` / `SearchSpace`: defaults, choices, slots, configs and samples
   equal to JAX's from the same `np.random.default_rng` seed; `SearchState`
   saved by either package loads in the other; a `BaseSearcher` resumes
   from its checkpoint.
 - `binary_search` and `evolutionary_search` (a numpy score, no model):
   every probe, the history and the best config identical to JAX's.
 - The unmeetable budget: JAX's first-population loop never ends (it is
   stopped here by its sample function, past the port's draw limit); the
   port raises `ValueError` after `MAX_DRAWS` samples.
 - `LLAMA_DIM_GROUPS` equal; `validate_groups` gives JAX's findings on a
   consistent and a broken tree.
 - `profile`, `convert`, `subnet_params` equal; `materialize` bit-equal
   (JAX's scores fed to both); FastNAS's ratio equal; a two-iteration AutoNAS
   `search` visits the same candidates: history scores within 1e-5
   relative, the same best config (JAX recompiles its eager forward per
   subnet shape, so its search is held at two iterations).
 - `convert_traced` (the tracer's search space) on the tiny Llama: JAX's
   hparam names and choices (every family: tests/test_torch_trace.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.nas import autonas as jnas
from tensorrt_model_optimizer_tpu.opt import dependency as jdep
from tensorrt_model_optimizer_tpu.opt import hparam as jhp
from tensorrt_model_optimizer_tpu.opt import searcher as jsearch
from tensorrt_model_optimizer_tpu.prune import minitron as jmin
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.nas import autonas as tnas
from tensorrt_model_optimizer_tpu_torch.opt import dependency as tdep
from tensorrt_model_optimizer_tpu_torch.opt import hparam as thp
from tensorrt_model_optimizer_tpu_torch.opt import searcher as tsearch


def _spaces(mod):
    return mod.SearchSpace({
        "ffn": mod.Hparam("ffn", (64, 96, 128), importance=[0.1, 0.9, 0.5]),
        "depth": mod.Hparam("depth", (1, 2, 4)),
        "fmt": mod.Hparam("fmt", ("nvfp4", "int4", "fp8")),
        "fixed": mod.Hparam("fixed", (7,)),
    })


def test_hparam_and_search_space_match_jax():
    js, ts = _spaces(jhp), _spaces(thp)
    assert ts.config() == js.config() == {"ffn": 128, "depth": 4, "fmt": "nvfp4", "fixed": 7}
    assert ts.size() == js.size() == 27
    for k in ts.hparams:
        assert ts.hparams[k].is_configurable == js.hparams[k].is_configurable
        assert ts.hparams[k].top_slots(2) == js.hparams[k].top_slots(2)
    new = {"ffn": 96, "fmt": "fp8"}
    assert ts.set_config(new).config() == js.set_config(new).config()
    assert ts.config()["ffn"] == 128  # set_config returns a new space
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    assert [ts.sample(tr) for _ in range(20)] == [js.sample(jr) for _ in range(20)]
    for mod in (jhp, thp):
        with pytest.raises(ValueError, match="not in"):
            mod.Hparam("x", (1, 2), active=3)
        with pytest.raises(ValueError, match="not in"):
            mod.Hparam("x", (1, 2)).set_active(5)


def test_search_state_round_trips_across_packages(tmp_path):
    st = tsearch.SearchState({"depth": 2, "layers.0.ffn": 64}, 1.25, [{"iter": 0, "score": 1.5}])
    st.save(str(tmp_path / "t.json"))
    back = jsearch.SearchState.load(str(tmp_path / "t.json"))
    assert dataclasses.asdict(back) == dataclasses.asdict(st)
    jsearch.SearchState(best_config={"a": 1}, best_score=0.5, history=[]).save(str(tmp_path / "j.json"))
    assert dataclasses.asdict(tsearch.SearchState.load(str(tmp_path / "j.json"))) == {
        "best_config": {"a": 1}, "best_score": 0.5, "history": []}

    class Counter(tsearch.BaseSearcher):
        def run_search(self):
            self.state.history.append({"iter": len(self.state.history), "score": 0.0})

    path = str(tmp_path / "ckpt.json")
    assert len(Counter(path).search().history) == 1
    assert len(Counter(path).search().history) == 2  # resumed from the checkpoint
    with pytest.raises(NotImplementedError):
        tsearch.BaseSearcher().search()


def test_binary_search_probes_equal_jax():
    probes = {"jax": [], "port": []}

    def feasible(who):
        return lambda x: probes[who].append(x) or x * x <= 0.37

    assert tsearch.binary_search(0.0, 1.0, feasible("port"), 12) == jsearch.binary_search(0.0, 1.0, feasible("jax"), 12)
    assert probes["port"] == probes["jax"]


def _evo_problem():
    space = _spaces(thp)
    w = {"nvfp4": 0.25, "int4": 0.5, "fp8": 1.0}

    def score(c):
        return float(np.log1p(c["ffn"]) * c["depth"] + w[c["fmt"]])

    def mutate(c, rng):
        keys = list(space.hparams)
        k = keys[rng.integers(0, len(keys))]
        c[k] = space.hparams[k].choices[rng.integers(0, len(space.hparams[k].choices))]
        return c

    return space.sample, mutate, score, lambda c: c["ffn"] * c["depth"] <= 256


@pytest.mark.parametrize("seed", [0, 3])
def test_evolutionary_search_history_equals_jax(seed):
    sample, mutate, score, ok = _evo_problem()
    js = jsearch.evolutionary_search(sample, mutate, score, ok, iterations=40, population=5, seed=seed)
    ts = tsearch.evolutionary_search(sample, mutate, score, ok, iterations=40, population=5, seed=seed)
    assert ts.history == js.history and len(ts.history) > 10
    assert ts.best_config == js.best_config and ts.best_score == js.best_score


def test_unmeetable_budget_raises_where_jax_loops(monkeypatch):
    sample, mutate, score, _ = _evo_problem()
    limit = 2000
    draws = []

    def counted(rng):
        draws.append(1)
        if len(draws) > 3 * limit:
            raise RuntimeError("still drawing")
        return sample(rng)

    with pytest.raises(RuntimeError, match="still drawing"):  # JAX: no sample meets it, the loop goes on
        jsearch.evolutionary_search(counted, mutate, score, lambda c: False, population=2)
    draws.clear()
    with pytest.raises(ValueError, match="100000 samples met the constraint 0 times"):
        tsearch.evolutionary_search(sample, mutate, score, lambda c: False)
    monkeypatch.setattr(tsearch, "MAX_DRAWS", limit)
    with pytest.raises(ValueError, match=f"{limit} samples met the constraint 0 times"):
        tsearch.evolutionary_search(counted, mutate, score, lambda c: False, population=2)
    assert len(draws) == limit


def test_dim_groups_and_validation_match_jax():
    assert [dataclasses.asdict(g) for g in tdep.LLAMA_DIM_GROUPS] == [dataclasses.asdict(g) for g in jdep.LLAMA_DIM_GROUPS]
    jcfg = jllama.LlamaConfig.tiny()
    pnp = llama_params_np(jcfg, seed=0)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    tp = tree_map(torch.from_numpy, pnp)
    assert tdep.validate_groups(tp, tcfg) == jdep.validate_groups(tree_map(jnp.asarray, pnp), jcfg) == []
    pnp["layers"]["mlp.down_proj"] = pnp["layers"]["mlp.down_proj"][:, :, :96]
    del pnp["lm_head"]
    found = tdep.validate_groups(tree_map(torch.from_numpy, pnp), tcfg)
    assert found == jdep.validate_groups(tree_map(jnp.asarray, pnp), jcfg)
    assert found == ["intermediate: layers/mlp.down_proj axis 2 is 96, expected 128"]


@pytest.fixture(scope="module")
def small():
    jcfg = jllama.LlamaConfig.tiny(num_hidden_layers=4)
    pnp = llama_params_np(jcfg, seed=2)
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32) for _ in range(2)]
    return (jcfg, tree_map(jnp.asarray, pnp), [jnp.asarray(b) for b in batches],
            convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp),
            [torch.from_numpy(b).long() for b in batches])


def test_profile_convert_and_materialize_match_jax(small):
    jcfg, jp, jb, tcfg, tp, _ = small
    assert tnas.profile(tcfg, 16) == jnas.profile(jcfg, 16)
    js, ts = jnas.convert(jcfg), tnas.convert(tcfg)
    assert {k: h.choices for k, h in ts.hparams.items()} == {k: h.choices for k, h in js.hparams.items()}
    assert ts.config() == js.config()
    scores = jmin.importance(jcfg, jp, jb, capture_tokens=32)
    rng = np.random.default_rng(1)
    for _ in range(3):
        c = js.sample(rng)
        assert tnas.subnet_params(tcfg, c) == jnas.subnet_params(jcfg, c)
        jc, jpp = jnas.materialize(jcfg, jp, scores, c)
        tc, tpp = tnas.materialize(tcfg, tp, scores, c)
        assert (tc.num_hidden_layers, tc.intermediate_size, tc.head_dim) == (
            jc.num_hidden_layers, jc.intermediate_size, jc.head_dim)
        for k in jpp["layers"]:
            assert np.array_equal(tpp["layers"][k].numpy().view(np.uint32),
                                  np.asarray(jpp["layers"][k]).view(np.uint32)), (c, k)


def test_fastnas_ratio_equals_jax(small):
    jcfg, jp, jb, tcfg, tp, tb = small
    jc, _, jratio = jnas.fastnas_prune(jcfg, jp, jb, max_loss_increase=0.02, steps=4)
    tc, tpp, tratio = tnas.fastnas_prune(tcfg, tp, tb, max_loss_increase=0.02, steps=4)
    assert tratio == jratio and 0.1 <= tratio < 1.0
    assert tc.intermediate_size == jc.intermediate_size < tcfg.intermediate_size
    assert tpp["layers"]["mlp.gate_proj"].shape[1] == tc.intermediate_size


def test_autonas_search_equals_jax(small):
    jcfg, jp, jb, tcfg, tp, tb = small
    space = dict(ffn_ratios=(0.5, 1.0))
    jst, jc, _ = jnas.search(jcfg, jp, jnas.convert(jcfg, **space), jb, param_budget_ratio=0.9, iterations=2, seed=1)
    tst, tc, tpp = tnas.search(tcfg, tp, tnas.convert(tcfg, **space), tb, param_budget_ratio=0.9, iterations=2,
                               seed=1)
    assert tst.best_config == jst.best_config
    assert rel_err(tst.best_score, jst.best_score) <= 1e-5
    assert [h["iter"] for h in tst.history] == [h["iter"] for h in jst.history]
    assert rel_err([h["score"] for h in tst.history] or [0.0], [h["score"] for h in jst.history] or [0.0]) <= 1e-5
    assert tc.num_hidden_layers == jc.num_hidden_layers and tc.intermediate_size == jc.intermediate_size
    assert tnas.subnet_params(tcfg, tst.best_config) <= 0.9 * tnas.profile(tcfg)["params"]


def test_convert_traced_names_the_tracer():
    """Was the refusal naming the tracer; the tracer is ported, so this holds
    the traced search space to JAX's."""
    jcfg = jllama.LlamaConfig.tiny(num_hidden_layers=2)
    pn = llama_params_np(jcfg, 3)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    js = jnas.convert_traced(lambda p, t: jllama.forward(jcfg, p, t)[0], tree_map(jnp.asarray, pn), jcfg)
    ts = tnas.convert_traced(lambda p, t: tllama.forward(tcfg, p, t)[0], tree_map(torch.from_numpy, pn), tcfg)
    assert {k: h.choices for k, h in ts.hparams.items()} == {k: h.choices for k, h in js.hparams.items()}
    assert ts.hparams["depth.layers"].choices == (1, 2)
