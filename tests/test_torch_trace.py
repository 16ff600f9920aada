"""The port's tracer (`trace/tracer.py`, the aten graph of `make_fx`) and
`nas.autonas.convert_traced` against the JAX package's (the jaxpr) on the
tiny configs of every family both trace: llama, mixtral, deepseek,
gpt_oss, llama4 and mamba, one seeded model in both packages.

The groups are equal as sets: name (the `.n` suffixes included), size,
sites and coupled sites; the ungrouped axes are equal. The list order is
not compared: JAX lists groups in the order of its union-find roots' reprs,
which deepseek's and gpt_oss's aten graphs reach through other roots
(ROADMAP queue 3). Depth: the port marks the stacks JAX scans
(`trace.scanned`), so llama, mixtral, gpt_oss and llama4 give one `depth`
group and deepseek two, and mamba (a Python loop in both) none."""

import jax
import numpy as np
import pytest
import torch

from tensorrt_model_optimizer_tpu.models import deepseek as jds
from tensorrt_model_optimizer_tpu.models import gpt_oss as jgo
from tensorrt_model_optimizer_tpu.models import llama as jl
from tensorrt_model_optimizer_tpu.models import llama4 as jl4
from tensorrt_model_optimizer_tpu.models import mamba as jm
from tensorrt_model_optimizer_tpu.models import mixtral as jmx
from tensorrt_model_optimizer_tpu.nas import autonas as jnas
from tensorrt_model_optimizer_tpu.trace import trace_dim_groups as jtrace
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import deepseek as tds
from tensorrt_model_optimizer_tpu_torch.models import gpt_oss as tgo
from tensorrt_model_optimizer_tpu_torch.models import llama as tl
from tensorrt_model_optimizer_tpu_torch.models import llama4 as tl4
from tensorrt_model_optimizer_tpu_torch.models import mamba as tm
from tensorrt_model_optimizer_tpu_torch.models import mixtral as tmx
from tensorrt_model_optimizer_tpu_torch.nas import autonas as tnas
from tensorrt_model_optimizer_tpu_torch.trace import scanned, trace_dim_groups as ttrace

FAMILIES = {"llama": (jl, tl, "LlamaConfig"), "mixtral": (jmx, tmx, "MixtralConfig"),
            "deepseek": (jds, tds, "DeepseekConfig"), "gpt_oss": (jgo, tgo, "GptOssConfig"),
            "llama4": (jl4, tl4, "Llama4Config"), "mamba": (jm, tm, "MambaConfig")}
DEPTHS = {"llama": 1, "mixtral": 1, "deepseek": 2, "gpt_oss": 1, "llama4": 1, "mamba": 0}


def _pair(family):
    jmod, tmod, cls = FAMILIES[family]
    jc = getattr(jmod, cls).tiny()
    jp = jmod.init_params(jc, jax.random.key(0))
    tc = convert.mamba_cfg_from_jax(jc) if family == "mamba" else convert.llama_cfg_from_jax(jc)
    return jc, jp, tc, convert.params_from_jax(jax.tree.map(np.asarray, jp)), jmod, tmod


@pytest.fixture(scope="module", params=list(FAMILIES))
def traced(request):
    jc, jp, tc, tp, jmod, tmod = _pair(request.param)
    jr = jtrace(lambda p, t: jmod.forward(jc, p, t)[0], jp, jc)
    tr = ttrace(lambda p, t: tmod.forward(tc, p, t)[0], tp, tc)
    return request.param, jr, tr, (jc, jp, tc, tp, jmod, tmod)


def _groups(res):
    return sorted((g.name, g.size, g.sites, g.coupled) for g in res["groups"])


def test_groups_equal(traced):
    family, jr, tr, _ = traced
    assert _groups(tr) == _groups(jr)
    assert sorted(tr["ungrouped"]) == sorted(jr["ungrouped"])
    assert sum(g.name.startswith("depth") for g in tr["groups"]) == DEPTHS[family]


def test_convert_traced_equal(traced):
    family, _, _, (jc, jp, tc, tp, jmod, tmod) = traced
    kw = dict(width_ratios=(0.25, 0.5, 1.0), min_width=4)
    js = jnas.convert_traced(lambda p, t: jmod.forward(jc, p, t)[0], jp, jc, **kw)
    ts = tnas.convert_traced(lambda p, t: tmod.forward(tc, p, t)[0], tp, tc, **kw)
    assert {k: h.choices for k, h in ts.hparams.items()} == {k: h.choices for k, h in js.hparams.items()}
    assert ts.hparams


def test_scanned_is_the_identity_outside_a_trace():
    tree = {"a": torch.zeros(2, 3)}
    assert scanned(tree) is tree


def test_unknown_ops_stay_unlabelled():
    """An op the tracer has no rule for and whose output rank exceeds its
    inputs' labels nothing: no false merge."""
    params = {"w": torch.randn(4, 6), "v": torch.randn(6, 4)}

    def fwd(p, t):
        return torch.outer(p["w"][0], p["v"][:, 0])  # 1-D operands, 2-D output

    res = ttrace(fwd, params)
    assert res["groups"] == []
