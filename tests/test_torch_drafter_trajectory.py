"""Ten EAGLE-1 and EAGLE-3 TTT training steps, the port against the JAX
package from the same initial drafts (JAX's, carried across by
`convert.drafts_from_jax`) on a tiny f32 Llama, the same seeded weights and
batches in both: every step's loss within 1e-5 relative, every step's TTT
accuracies equal, and the drafts after ten steps within 1e-4 of each
tensor's scale (SGD at lr 1e-2: ten updates of f32 gradients summed in
another order). `test_torch_speculative.py` holds the first step alone;
`tools/torch_specdec_parity.py` runs the 300-step comparison on the anchor
(PERF.md §6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.speculative import eagle as jeagle
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.speculative import eagle as teagle

STEPS = 10
LOSS_TOL = 1e-5
DRAFT_TOL = 1e-4


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for n, sub in tree.items() for k, v in _flat(sub, f"{prefix}{n}.").items()}
    if isinstance(tree, (tuple, int)) or (isinstance(tree, list) and not tree):
        return {}
    return {prefix[:-1]: tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


@pytest.mark.parametrize("method", ["eagle", "eagle3"])
def test_ten_ttt_steps_equal_jax(method):
    jcfg = jllama.LlamaConfig.tiny()
    pnp = llama_params_np(jcfg, seed=0)
    jp, tp = tree_map(jnp.asarray, pnp), tree_map(torch.from_numpy, pnp)
    tcfg = convert.llama_cfg_from_jax(jcfg)
    init = jeagle.init_eagle if method == "eagle" else jeagle.init_eagle3
    jd = init(jcfg, jeagle.EagleConfig(), jax.random.key(2 if method == "eagle" else 4))
    td = convert.drafts_from_jax(jd)
    make_j = jeagle.make_eagle_ttt_train_step if method == "eagle" else jeagle.make_eagle3_ttt_train_step
    make_t = teagle.make_eagle_ttt_train_step if method == "eagle" else teagle.make_eagle3_ttt_train_step
    jstep, tstep = jax.jit(make_j(jcfg, ttt_steps=3, lr=1e-2)), make_t(tcfg, ttt_steps=3, lr=1e-2)
    rng = np.random.default_rng(3)
    losses = []
    for i in range(STEPS):
        b = rng.integers(0, jcfg.vocab_size, size=(4, 17)).astype(np.int32)
        jd, jloss, jaccs = jstep(jd, jp, jnp.asarray(b))
        td, tloss, taccs = tstep(td, tp, torch.from_numpy(b).long())
        assert abs(float(tloss) - float(jloss)) <= LOSS_TOL * abs(float(jloss)), (i, float(tloss), float(jloss))
        assert [float(a) for a in taccs] == [float(a) for a in jaccs], i
        losses.append(float(tloss))
    jf, tf = _flat(jd), _flat(td)
    assert set(jf) == set(tf)
    for k in tf:
        assert rel_err(tf[k], jf[k]) <= DRAFT_TOL, k
    assert losses[-1] < losses[0]
