"""The port's speculative drafters (`speculative/{tree,medusa,eagle,dflash}.py`,
`quant/qat.py`'s `cross_entropy`) against the JAX package on a tiny f32
Llama, the same seeded weights in both and the drafts carried across by
`convert.drafts_from_jax`.

Exact: the tree's topology, masks, positions, candidates and acceptance;
the TTT mask; every `propose_and_verify` (tokens and rate). Within 1e-5 of
their scale (f32 sums in another order): the drafts' forwards, the base
hidden states under a fake-quant layout, and one step of each train step
from the same weights (its loss and every updated parameter; the update
itself, new - old, within 1e-3 of its own scale, since it is lr times a
gradient that is summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.quant import qat as jqat
from tensorrt_model_optimizer_tpu.speculative import dflash as jdflash
from tensorrt_model_optimizer_tpu.speculative import eagle as jeagle
from tensorrt_model_optimizer_tpu.speculative import medusa as jmedusa
from tensorrt_model_optimizer_tpu.speculative import tree as jtree
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa
from tensorrt_model_optimizer_tpu_torch.quant import qat as tqat
from tensorrt_model_optimizer_tpu_torch.speculative import dflash as tdflash
from tensorrt_model_optimizer_tpu_torch.speculative import eagle as teagle
from tensorrt_model_optimizer_tpu_torch.speculative import medusa as tmedusa
from tensorrt_model_optimizer_tpu_torch.speculative import tree as ttree

TOL = 1e-5        # f32 forwards, losses and updated parameters, of their scale
STEP_TOL = 1e-3   # the SGD update new - old, of its own scale
PATHS = ([[0], [1], [0, 0], [0, 1], [1, 0], [0, 0, 0]], [[0], [1], [2], [0, 0], [0, 1], [2, 0], [0, 0, 0], [0, 0, 1]],
         [[0]])


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    pnp = llama_params_np(jcfg, seed=0)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    return jcfg, tree_map(jnp.asarray, pnp), convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp), tokens


@pytest.fixture(scope="module")
def drafts(tiny):
    """JAX's seeded drafts, and the port's copies of them."""
    jcfg = tiny[0]
    j = {"medusa": jmedusa.init_medusa(jcfg, jmedusa.MedusaConfig(num_heads=3), jax.random.PRNGKey(1)),
         "eagle": jeagle.init_eagle(jcfg, jeagle.EagleConfig(), jax.random.PRNGKey(2)),
         "eagle3": jeagle.init_eagle3(jcfg, jeagle.EagleConfig(), jax.random.key(5)),
         "dflash": jdflash.init_dflash(jcfg, jdflash.DFlashConfig(block_size=3), jax.random.PRNGKey(7))}
    return j, {k: convert.drafts_from_jax(v) for k, v in j.items()}


def _flat(tree, prefix=""):
    """name -> array of a draft tree (ints and tuples left out)."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items() for k, v in _flat(sub, f"{prefix}{name}.").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    if isinstance(tree, (tuple, int)):
        return {}
    return {prefix[:-1]: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


def to_jax(tree):
    """A port draft -> JAX arrays of the same structure."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


# ---------------------------------------------------------------- the tree


@pytest.mark.parametrize("paths", PATHS, ids=["default", "wide", "one"])
def test_tree_topology_masks_and_positions_match_jax(paths):
    jt, tt = jtree.build_tree(paths), ttree.build_tree(paths)
    assert (tt.n_nodes, tt.parent, tt.depth, tt.choice, tt.max_depth) == \
        (jt.n_nodes, jt.parent, jt.depth, jt.choice, jt.max_depth)
    np.testing.assert_array_equal(tt.attn_mask, jt.attn_mask)
    assert all(tt.children(i) == jt.children(i) for i in range(tt.n_nodes))
    for P in (1, 5):
        np.testing.assert_array_equal(ttree.tree_attention_mask(tt, P).numpy(), np.asarray(jtree.tree_attention_mask(jt, P)))
        np.testing.assert_array_equal(ttree.tree_position_ids(tt, P).numpy(), np.asarray(jtree.tree_position_ids(jt, P)))


def test_default_tree_is_jaxs():
    assert ttree.DEFAULT_TREE_PATHS == jtree.DEFAULT_TREE_PATHS
    assert ttree.build_tree().depth == (0, 1, 1, 2, 2, 2, 3)


def test_incomplete_path_raises_as_jax():
    for build in (jtree.build_tree, ttree.build_tree):
        with pytest.raises(ValueError, match="incomplete tree path"):
            build([[0], [1, 0]])


@pytest.mark.parametrize("paths", PATHS, ids=["default", "wide", "one"])
def test_candidates_and_greedy_acceptance_match_jax(paths):
    """Random head picks and verify argmaxes over a 6-token vocabulary (so
    paths get accepted to every depth)."""
    jt, tt = jtree.build_tree(paths), ttree.build_tree(paths)
    rng = np.random.default_rng(3)
    k = max(tt.choice) + 1
    depths = set()
    for _ in range(200):
        topk = rng.integers(0, 6, size=(tt.max_depth, k)).astype(np.int32)
        base = int(rng.integers(0, 6))
        cand = ttree.assemble_candidates(tt, base, topk)
        np.testing.assert_array_equal(cand, jtree.assemble_candidates(jt, base, topk))
        ver = rng.integers(0, 6, size=tt.n_nodes)
        got = ttree.greedy_accept(tt, cand, ver)
        assert got == jtree.greedy_accept(jt, cand, ver)
        depths.add(len(got[0]))
    assert depths == set(range(1, tt.max_depth + 2))


def test_ttt_attention_mask_matches_jax():
    for T, steps in ((4, 3), (5, 2), (1, 3)):
        for s in range(steps):
            np.testing.assert_array_equal(teagle.ttt_attention_mask(T, s, steps * T).numpy(),
                                          np.asarray(jeagle.ttt_attention_mask(T, s, steps * T)))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((2, 7, 33))).astype(np.float32)
    targets = rng.integers(0, 33, size=(2, 7)).astype(np.int32)
    want = float(jqat.cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(tqat.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert abs(got - want) <= TOL * abs(want)


# ---------------------------------------------------------------- forwards


def test_medusa_logits_and_apply_heads_match_jax(tiny, drafts):
    jcfg, jp, tcfg, tp, tokens = tiny
    jm, tm = drafts[0]["medusa"], drafts[1]["medusa"]
    jb, jh = jmedusa.medusa_logits(jcfg, jp, jm, jnp.asarray(tokens))
    tb, th = tmedusa.medusa_logits(tcfg, tp, tm, torch.from_numpy(tokens))
    assert th.shape == (3, 2, 16, tcfg.vocab_size)
    assert rel_err(tb.numpy(), jb) < TOL and rel_err(th.numpy(), jh) < TOL
    hid = np.random.default_rng(4).standard_normal((2, 5, tcfg.hidden_size)).astype(np.float32)
    want = jmedusa.apply_heads(jm, jnp.asarray(hid), jp["lm_head"])
    assert rel_err(tmedusa.apply_heads(tm, torch.from_numpy(hid), tp["lm_head"]).numpy(), want) < TOL


def test_hidden_states_under_a_fake_quant_layout_match_jax():
    """`_hidden_states` with INT4 weights fake-quantized (hidden 128: whole
    128-blocks), the per-layer state only, as JAX's."""
    jcfg = jllama.LlamaConfig.tiny(hidden_size=128, intermediate_size=256)
    pnp = llama_params_np(jcfg, seed=5)
    jq = jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), "INT4_BLOCKWISE_WEIGHT_ONLY_CFG")
    tq = convert.quantized_from_jax(jq)
    tokens = np.random.default_rng(6).integers(0, 256, size=(2, 12)).astype(np.int32)
    want = jmedusa._hidden_states(jcfg, jq.params, jnp.asarray(tokens), jq.layout, jq.qstate)
    got = tmedusa._hidden_states(tq.model_cfg, tq.params, torch.from_numpy(tokens), tq.layout, tq.qstate)
    plain = tmedusa._hidden_states(tq.model_cfg, tq.params, torch.from_numpy(tokens))
    assert rel_err(got.numpy(), want) < TOL
    assert rel_err(plain.numpy(), want) > 1e-3  # the layout acts


def test_eagle_forward_matches_jax(tiny, drafts):
    jcfg, jp, tcfg, tp, tokens = tiny
    je, te = drafts[0]["eagle"], drafts[1]["eagle"]
    hid = jmedusa._hidden_states(jcfg, jp, jnp.asarray(tokens))
    thid = tmedusa._hidden_states(tcfg, tp, torch.from_numpy(tokens))
    assert rel_err(thid.numpy(), hid) < TOL
    jph, jl = jeagle.eagle_forward(jcfg, jp, je, jnp.asarray(tokens), hid)
    tph, tl = teagle.eagle_forward(tcfg, tp, te, torch.from_numpy(tokens), torch.from_numpy(np.array(hid)))
    assert rel_err(tph.numpy(), jph) < TOL and rel_err(tl.numpy(), jl) < TOL


def test_eagle_ttt_forward_matches_jax(tiny, drafts):
    jcfg, jp, tcfg, tp, tokens = tiny
    je, te = drafts[0]["eagle"], drafts[1]["eagle"]
    hid = np.asarray(jmedusa._hidden_states(jcfg, jp, jnp.asarray(tokens)))
    jo = jeagle.eagle_ttt_forward(jcfg, jp, je, jnp.asarray(tokens), jnp.asarray(hid), 3)
    to = teagle.eagle_ttt_forward(tcfg, tp, te, torch.from_numpy(tokens), torch.from_numpy(hid), 3)
    assert len(to) == len(jo) == 3
    for (tph, tl), (jph, jl) in zip(to, jo):
        assert rel_err(tph.numpy(), jph) < TOL and rel_err(tl.numpy(), jl) < TOL


def test_aux_hidden_states_and_eagle3_fuse_match_jax(tiny, drafts):
    jcfg, jp, tcfg, tp, tokens = tiny
    j3, t3 = drafts[0]["eagle3"], drafts[1]["eagle3"]
    assert t3["aux_layer_ids"] == tuple(jeagle.default_aux_layer_ids(2)) == (0, 1)
    assert teagle.default_aux_layer_ids(32) == jeagle.default_aux_layer_ids(32) == [1, 15, 28]
    for ids in ([1], [0, 1]):
        jaux = jeagle.aux_hidden_states(jcfg, jp, jnp.asarray(tokens), ids)
        taux = teagle.aux_hidden_states(tcfg, tp, torch.from_numpy(tokens), ids)
        assert taux.shape == (2, 16, len(ids) * tcfg.hidden_size) and rel_err(taux.numpy(), jaux) < TOL
    assert rel_err(teagle.eagle3_fuse(t3, taux).numpy(), jeagle.eagle3_fuse(j3, jaux)) < TOL


def test_dflash_logits_match_jax(tiny, drafts):
    jcfg, jp, tcfg, tp, tokens = tiny
    jb, jblk = jdflash.dflash_logits(jcfg, jp, drafts[0]["dflash"], jnp.asarray(tokens))
    tb, tblk = tdflash.dflash_logits(tcfg, tp, drafts[1]["dflash"], torch.from_numpy(tokens))
    assert tblk.shape == (3, 2, 16, tcfg.vocab_size)
    assert rel_err(tb.numpy(), jb) < TOL and rel_err(tblk.numpy(), jblk) < TOL


def test_draft_forward_never_takes_flash(tiny, drafts, monkeypatch):
    """A base config with attn_impl="flash": the base hidden states may take
    the flash path (no gradient there), the draft's layers never do (the
    kernel has no backward)."""
    import dataclasses

    _, _, tcfg, tp, tokens = tiny
    calls = []
    real = flash_gqa.flash_attention_gqa
    monkeypatch.setattr(flash_gqa, "flash_attention_gqa", lambda *a, **k: calls.append(1) or real(*a, **k))
    fcfg = dataclasses.replace(tcfg, attn_impl="flash")
    hid = tmedusa._hidden_states(fcfg, tp, torch.from_numpy(tokens))
    assert len(calls) == tcfg.num_hidden_layers
    calls.clear()
    step = teagle.make_eagle_ttt_train_step(fcfg, ttt_steps=2)
    teagle.eagle_forward(fcfg, tp, drafts[1]["eagle"], torch.from_numpy(tokens), hid)
    _, loss, _ = step(drafts[1]["eagle"], tp, torch.from_numpy(tokens))
    assert len(calls) == tcfg.num_hidden_layers and torch.isfinite(loss)  # the base's hidden states only


# ---------------------------------------------------------------- training

TRAIN = {  # name -> (draft, JAX step factory, port step factory)
    "medusa": ("medusa", lambda c: jmedusa.make_medusa_train_step(c, lr=5e-2),
               lambda c: tmedusa.make_medusa_train_step(c, lr=5e-2)),
    "eagle": ("eagle", lambda c: jeagle.make_eagle_train_step(c, lr=2e-2),
              lambda c: teagle.make_eagle_train_step(c, lr=2e-2)),
    "eagle_ttt": ("eagle", lambda c: jeagle.make_eagle_ttt_train_step(c, ttt_steps=2, lr=5e-3),
                  lambda c: teagle.make_eagle_ttt_train_step(c, ttt_steps=2, lr=5e-3)),
    "eagle3_ttt": ("eagle3", lambda c: jeagle.make_eagle3_ttt_train_step(c, ttt_steps=2, lr=1e-2),
                   lambda c: teagle.make_eagle3_ttt_train_step(c, ttt_steps=2, lr=1e-2)),
    "dflash_soft": ("dflash", lambda c: jdflash.make_dflash_train_step(c, jdflash.DFlashConfig(block_size=3), lr=2e-2),
                    lambda c: tdflash.make_dflash_train_step(c, tdflash.DFlashConfig(block_size=3), lr=2e-2)),
    "dflash_hard": ("dflash", lambda c: jdflash.make_dflash_train_step(
        c, jdflash.DFlashConfig(block_size=3, self_logit_distillation=False), lr=2e-2),
        lambda c: tdflash.make_dflash_train_step(c, tdflash.DFlashConfig(block_size=3, self_logit_distillation=False),
                                                 lr=2e-2)),
}


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_matches_jax(tiny, drafts, name):
    """One step from the same weights: the loss (and TTT's accuracies), every
    updated parameter, and the update itself; EAGLE-3's aux_layer_ids pass
    through; the port's inputs are not written."""
    jcfg, jp, tcfg, tp, tokens = tiny
    kind, jmake, tmake = TRAIN[name]
    jd, td = drafts[0][kind], drafts[1][kind]
    before = {k: v.copy() for k, v in _flat(td).items()}
    jout = jax.jit(jmake(jcfg))(jd, jp, jnp.asarray(tokens))
    tout = tmake(tcfg)(td, tp, torch.from_numpy(tokens))
    assert len(tout) == len(jout)
    assert abs(float(tout[1]) - float(jout[1])) <= TOL * abs(float(jout[1]))
    if len(tout) == 3:  # TTT: per-step accuracies (the counts of equal argmaxes)
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    jnew, tnew = _flat(jout[0]), _flat(tout[0])
    assert set(jnew) == set(tnew) == set(before)
    for k, old in before.items():
        assert rel_err(tnew[k], jnew[k]) < TOL, k
        delta = jnew[k] - old
        if np.abs(delta).max() > 0:
            assert rel_err(tnew[k] - old, delta) < STEP_TOL, k
    for k, old in before.items():
        np.testing.assert_array_equal(_flat(td)[k], old)
    if kind == "eagle3":
        assert tout[0]["aux_layer_ids"] == td["aux_layer_ids"]


@pytest.mark.parametrize("name", ["medusa", "eagle", "eagle_ttt", "eagle3_ttt", "dflash_soft"])
def test_training_lowers_the_loss(tiny, drafts, name):
    _, _, tcfg, tp, tokens = tiny
    kind, _, tmake = TRAIN[name]
    step = tmake(tcfg)
    d = drafts[1][kind]
    first = None
    for _ in range(8):
        out = step(d, tp, torch.from_numpy(tokens))
        d = out[0]
        first = float(out[1]) if first is None else first
    assert float(out[1]) < first


def test_train_step_reaches_only_the_draft(tiny, drafts):
    """The base stays frozen: its tensors take no gradient and keep their values."""
    _, _, tcfg, tp, tokens = tiny
    snap = {k: v.clone() for k, v in tp["layers"].items()}
    teagle.make_eagle_ttt_train_step(tcfg, ttt_steps=2)(drafts[1]["eagle"], tp, torch.from_numpy(tokens))
    assert all(torch.equal(v, snap[k]) and v.grad is None and not v.requires_grad for k, v in tp["layers"].items())


# ---------------------------------------------------------------- verifiers


def _greedy(tcfg, tp, prompt: np.ndarray, n: int) -> list:
    from tensorrt_model_optimizer_tpu_torch.models import llama as tllama

    toks = torch.from_numpy(prompt)
    for _ in range(n):
        logits, _, _ = tllama.forward(tcfg, tp, toks)
        toks = torch.cat([toks, torch.argmax(logits[:, -1:], dim=-1).to(toks.dtype)], dim=1)
    return toks[0].tolist()


VERIFY = {  # name -> (draft, JAX call, port call)
    "medusa_chain": ("medusa", lambda c, p, d, x: jmedusa.propose_and_verify(c, p, d, x, steps=4),
                     lambda c, p, d, x: tmedusa.propose_and_verify(c, p, d, x, steps=4)),
    "medusa_tree": ("medusa", lambda c, p, d, x: jtree.tree_propose_and_verify(c, p, d, x, steps=8),
                    lambda c, p, d, x: ttree.tree_propose_and_verify(c, p, d, x, steps=8)),
    "eagle": ("eagle", lambda c, p, d, x: jeagle.propose_and_verify(c, p, d, x, steps=4, draft_len=2),
              lambda c, p, d, x: teagle.propose_and_verify(c, p, d, x, steps=4, draft_len=2)),
    "eagle3": ("eagle3", lambda c, p, d, x: jeagle.propose_and_verify(c, p, d, x, steps=4, draft_len=2),
               lambda c, p, d, x: teagle.propose_and_verify(c, p, d, x, steps=4, draft_len=2)),
    "dflash": ("dflash", lambda c, p, d, x: jdflash.propose_and_verify(c, p, d, x, steps=4),
               lambda c, p, d, x: tdflash.propose_and_verify(c, p, d, x, steps=4)),
}


@pytest.fixture(scope="module")
def copycat(tiny):
    """Medusa heads that learn the base's greedy continuations of the test
    prompt (so drafts are accepted), trained in the port, carried to JAX."""
    _, _, tcfg, tp, tokens = tiny
    seq = torch.tensor([_greedy(tcfg, tp, tokens[:1, :8], 24)])
    heads = tmedusa.init_medusa(tcfg, tmedusa.MedusaConfig(num_heads=3), torch.Generator().manual_seed(3),
                                device="cpu")
    step = tmedusa.make_medusa_train_step(tcfg, lr=0.5)
    for _ in range(60):
        heads, _ = step(heads, tp, seq)
    return heads


@pytest.mark.parametrize("name", list(VERIFY))
def test_propose_and_verify_matches_jax(tiny, drafts, name):
    """Tokens and acceptance rate equal JAX's; the tokens are plain greedy decoding's."""
    jcfg, jp, tcfg, tp, tokens = tiny
    kind, jcall, tcall = VERIFY[name]
    prompt = tokens[:1, :8]
    jt, jr = jcall(jcfg, jp, drafts[0][kind], jnp.asarray(prompt))
    tt, tr = tcall(tcfg, tp, drafts[1][kind], torch.from_numpy(prompt))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tr == jr and 0.0 <= tr <= 1.0
    assert tt[0].tolist() == _greedy(tcfg, tp, prompt, tt.shape[1] - 8)


@pytest.mark.parametrize("tree_verifier", [False, True], ids=["chain", "tree"])
def test_medusa_verifiers_accept_with_trained_heads(tiny, copycat, tree_verifier):
    """Heads that predict the greedy continuation: drafts get accepted, the
    tokens and the rate equal JAX's (the same heads), the tokens stay greedy."""
    jcfg, jp, tcfg, tp, tokens = tiny
    prompt = tokens[:1, :8]
    jheads = to_jax(copycat)
    if tree_verifier:
        jt, jr = jtree.tree_propose_and_verify(jcfg, jp, jheads, jnp.asarray(prompt), steps=12)
        tt, tr = ttree.tree_propose_and_verify(tcfg, tp, copycat, torch.from_numpy(prompt), steps=12)
    else:
        jt, jr = jmedusa.propose_and_verify(jcfg, jp, jheads, jnp.asarray(prompt), steps=12)
        tt, tr = tmedusa.propose_and_verify(tcfg, tp, copycat, torch.from_numpy(prompt), steps=12)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tr == jr and tr > 0.3
    assert tt[0].tolist() == _greedy(tcfg, tp, prompt, tt.shape[1] - 8)


@pytest.mark.parametrize("name", list(VERIFY))
def test_verifiers_refuse_a_batch(tiny, drafts, name):
    _, _, tcfg, tp, tokens = tiny
    kind, _, tcall = VERIFY[name]
    with pytest.raises(ValueError, match="single-sequence"):
        tcall(tcfg, tp, drafts[1][kind], torch.from_numpy(tokens[:, :8]))
