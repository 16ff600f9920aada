"""The port's hybrid Minitron (`prune/minitron_hybrid.py`) against the JAX
package on one seeded tiny hybrid model: importance scores within 1e-5
relative (f32 captures on both sides; JAX's come from a jitted forward),
the kept indices of every selection equal (both rank on numpy, so ties
break alike: each plan is checked from JAX's own scores as well), the
pruned params equal, the pruned model's logits within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mamba import mamba_pair, tokens
from _torch_parity import rel_err
from tensorrt_model_optimizer_tpu.models import mamba as jm
from tensorrt_model_optimizer_tpu.prune import minitron_hybrid as jmh
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import mamba as tm
from tensorrt_model_optimizer_tpu_torch.prune import minitron_hybrid as tmh

FIELDS = ("mamba_head", "kv_group", "ffn", "hidden", "block")
PLAN = ("keep_mamba_heads", "keep_kv_groups", "keep_ffn", "keep_hidden", "keep_blocks")


@pytest.fixture(scope="module")
def scored():
    jcfg, jp, tcfg, tp = mamba_pair(3, hybrid_pattern="MM*M-M*-", mamba_num_heads=8, n_groups=2)
    batches = [tokens(s, (2, 16)) for s in (4, 5)]
    js = jmh.importance(jcfg, jp, [jnp.asarray(b) for b in batches])
    ts = tmh.importance(tcfg, tp, [torch.from_numpy(b) for b in batches])
    return jcfg, jp, tcfg, tp, js, ts, batches


def test_importance(scored):
    *_, js, ts, _ = scored
    for f in FIELDS:
        a, b = getattr(ts, f), getattr(js, f)
        assert a.shape == np.asarray(b).shape and rel_err(a, b) <= 1e-5, f


def test_mamba_row_index():
    cfg = jm.MambaConfig.tiny(mamba_num_heads=8)
    keep = np.array([1, 2, 5, 7])
    for a, b in zip(tmh._mamba_row_index(convert.mamba_cfg_from_jax(cfg), keep), jmh._mamba_row_index(cfg, keep)):
        np.testing.assert_array_equal(a, b)


TARGETS = [dict(mamba_num_heads=4), dict(num_kv_heads=1), dict(intermediate_size=64), dict(hidden_size=48),
           dict(num_blocks=5), dict(mamba_num_heads=4, num_kv_heads=1, intermediate_size=96, hidden_size=48,
                                    num_blocks=6), dict(num_blocks=2)]


@pytest.mark.parametrize("kw", TARGETS, ids=lambda kw: "+".join(kw))
def test_prune(scored, kw):
    jcfg, jp, tcfg, tp, js, ts, batches = scored
    jc, jpp, jplan = jmh.prune(jcfg, jp, js, **kw)
    tc, tpp, tplan = tmh.prune(tcfg, tp, ts, **kw)
    tc2, tpp2, tplan2 = tmh.prune(tcfg, tp, js, **kw)  # JAX's scores: JAX's plan bit for bit
    for f in PLAN:
        a, b, c = getattr(tplan, f), getattr(jplan, f), getattr(tplan2, f)
        assert (a is None) == (b is None) == (c is None), f
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
            np.testing.assert_array_equal(c, b, err_msg=f)
    assert tplan.new_pattern == jplan.new_pattern and tc == convert.mamba_cfg_from_jax(jc)
    assert set(tpp) == set(jpp)
    for g, sub in jpp.items():
        if isinstance(sub, dict):
            assert set(tpp[g]) == set(sub)
            for k, v in sub.items():
                np.testing.assert_array_equal(tpp[g][k].numpy(), np.asarray(v), err_msg=f"{g}/{k}")
        else:
            np.testing.assert_array_equal(tpp[g].numpy(), np.asarray(sub), err_msg=g)
    tok = batches[0]
    assert rel_err(tm.forward(tc, tpp, torch.from_numpy(tok))[0].numpy(), jm.forward(jc, jpp, jnp.asarray(tok))[0]) \
        <= 1e-5


def test_heads_stay_divisible(scored):
    _, _, tcfg, tp, _, ts, _ = scored
    with pytest.raises(ValueError, match="n_groups"):
        tmh.prune(tcfg, tp, ts, mamba_num_heads=3)
