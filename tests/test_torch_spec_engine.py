"""The port's tree-speculative decoding in the einsum engine
(`Engine.generate_speculative`, `_model_step(positions=, mask=,
return_hidden=)`) against the JAX engine's (`backend="xla"`) on a tiny f32
Llama wide enough for whole 128-blocks of INT4 weights, carried across by
`convert.py`, under INT8_DEFAULT (W8A8) and INT4 weight-only with a bf16 and
an int8 KV cache.

Exact: the speculative tokens and the acceptance rate (JAX's engine's, and
the tokens the port's own `generate`); after one verify round with oracle
candidates (the greedy continuation laid on the tree's deepest path, so a =
max_depth + 1 nodes are accepted), the compacted rows pos .. pos + a - 1
equal JAX's bit for bit in the int8, fp8 and packed NVFP4 caches, within
1e-5 of their scale in the bf16 one, and the cache decodes on to the greedy
tokens. The verify forward's logits and hidden state: 1e-3 of their scale,
as `test_torch_dense_engine.py` holds the einsum engines' logits. The
refusals: batch 2 (JAX asserts), the kernel engine (JAX raises), a tree
past the cache (JAX fails on its host-side mask; ROADMAP queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu.speculative import tree as jtree
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.quant import qat as tqat
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.speculative import medusa as tmedusa
from tensorrt_model_optimizer_tpu_torch.speculative import tree as ttree

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)
PRESETS = ("INT8_DEFAULT_CFG", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG")
KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8),
      "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn), "nvfp4": ("nvfp4", "nvfp4")}
MAX_SEQ = 48
NEW = 16


@pytest.fixture(scope="module")
def models():
    """preset -> (JAX compressed model, the port's), the same seeded f32
    Llama; the prompt; a dict for `_heads`."""
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    pnp = llama_params_np(jcfg, seed=0)
    calib = [np.random.default_rng(1).integers(0, 256, size=(2, 16)).astype(np.int32)]
    out = {}
    for preset in PRESETS:
        jcm = jcompress.compress(jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), preset,
                                               [jnp.asarray(b) for b in calib]))
        out[preset] = (jcm, convert.compressed_from_jax(jcm))
    prompt = np.random.default_rng(5).integers(0, 256, size=(1, 8)).astype(np.int32)
    return out, prompt, {}


def _heads(models, te, key) -> dict:
    """Medusa heads (made once per `key`) trained in the port on the served
    hidden states of the engine's own greedy continuation of the prompt,
    so drafts get accepted."""
    trained = models[2]
    if key not in trained:
        prompt = torch.from_numpy(models[1]).long()
        seq = torch.cat([prompt, te.generate(prompt, 32).long()], dim=1)
        _, hidden = te._model_step(seq, te.init_cache(1), full_logits=True, return_hidden=True)
        hidden = hidden.clone()  # out of inference mode
        heads = tmedusa.init_medusa(te.cfg, tmedusa.MedusaConfig(num_heads=3), torch.Generator().manual_seed(3),
                                    device="cpu")

        def loss(h):
            lg = tmedusa.apply_heads(h, hidden, None)
            return sum(tqat.cross_entropy(lg[i][:, :-(i + 2)], seq[:, i + 2:]) for i in range(3)) / 3

        for _ in range(60):
            heads, _ = tmedusa.sgd_step(heads, loss, 0.5)
        trained[key] = heads
    return trained[key]


def _engines(models, preset, kv):
    jcm, tcm = models[0][preset]
    jkv, tkv = KV[kv]
    return (jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=MAX_SEQ, backend="xla", kv_dtype=jkv)),
            tengine.Engine(tcm, tengine.EngineConfig(max_seq_len=MAX_SEQ, kv_dtype=tkv), device="cpu"))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("preset", PRESETS)
def test_generate_speculative_matches_jax_and_greedy(models, preset, kv):
    je, te = _engines(models, preset, kv)
    prompt, heads = models[1], _heads(models, te, (preset, kv))
    jt, jr = je.generate_speculative(jnp.asarray(prompt), _to_jax(heads), max_new_tokens=NEW)
    tt, tr = te.generate_speculative(torch.from_numpy(prompt), heads, max_new_tokens=NEW)
    assert isinstance(tt, list) and len(tt) == NEW
    assert tt == [int(t) for t in jt] and tr == jr
    assert tt == te.generate(torch.from_numpy(prompt), NEW)[0].tolist()
    assert tr > 0.2  # drafts were accepted: compaction moved rows


def _oracle(tree, greedy: list) -> np.ndarray:
    """Candidates with the greedy continuation on the tree's deepest path
    (node 0 = greedy[0]) and tokens outside it on every other node."""
    deepest = max(range(tree.n_nodes), key=lambda i: (tree.depth[i], -i))
    chain = [deepest]
    while tree.parent[chain[-1]] >= 0:
        chain.append(tree.parent[chain[-1]])
    cand = np.zeros(tree.n_nodes, np.int32)
    others = iter(t for t in range(256) if t not in greedy)
    for i in range(tree.n_nodes):
        cand[i] = next(others)
    for node in chain:
        cand[node] = greedy[tree.depth[node]]
    return cand


def _jax_round(je, prompt, cand, tree):
    """JAX's generate_speculative prefill and one round of it, as written in
    `serve/engine.py:1657-1748`: -> (verify logits [N, V], hidden [N, H],
    the compacted cache, the accepted nodes)."""
    step_h = jax.jit(lambda p, q, t, c, po, m: jengine._model_step(
        je.cfg, je.ecfg, je.cm, je.backend, p, q, t, c, po, mask_override=m, full_logits=True,
        return_hidden=True))
    cache = je.init_cache(1)
    T0 = prompt.shape[1]
    _, cache, _ = step_h(je.cm.params, je.cm.qstate, jnp.asarray(prompt), cache, jnp.arange(T0)[None, :], None)
    pos, N, S = T0, tree.n_nodes, cache["k"].shape[2]
    allow = np.zeros((N, S), bool)
    allow[:, :pos] = True
    allow[:, pos:pos + N] = np.asarray(tree.attn_mask)
    mask = jnp.asarray(np.where(allow, 0.0, -1e9), jnp.float32)[None, None]
    tpos = (pos + jnp.asarray(tree.depth, jnp.int32))[None, :]
    v_logits, v_cache, v_hid = step_h(je.cm.params, je.cm.qstate, jnp.asarray(cand[None]), cache, tpos, mask)
    ver = np.asarray(jnp.argmax(v_logits[0], axis=-1))
    node, nodes = 0, [0]  # JAX's walk (serve/engine.py:1713-1726)
    while True:
        nxt = next((ch for ch in tree.children(node) if int(cand[ch]) == int(ver[node])), None)
        if nxt is None:
            break
        nodes.append(nxt)
        node = nxt
    a = len(nodes)
    take = jnp.asarray([pos + i for i in nodes], jnp.int32)
    new = {"k": v_cache["k"].at[:, :, pos:pos + a].set(jnp.take(v_cache["k"], take, axis=2)),
           "v": v_cache["v"].at[:, :, pos:pos + a].set(jnp.take(v_cache["v"], take, axis=2)),
           "pos": jnp.asarray(pos + a, jnp.int32)}
    return np.asarray(v_logits[0]), np.asarray(v_hid[0]), new, nodes


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.uint8) if t.element_size() == 1 else t).numpy()


@pytest.mark.parametrize("preset,kv", [("INT8_DEFAULT_CFG", "bf16"), ("INT8_DEFAULT_CFG", "int8"),
                                       ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "bf16"),
                                       ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "int8"),
                                       ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "fp8"),
                                       ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "nvfp4")])
def test_oracle_round_compacts_as_jax(models, preset, kv):
    je, te = _engines(models, preset, kv)
    prompt = models[1]
    greedy = te.generate(torch.from_numpy(prompt), 10)[0].tolist()
    tree = ttree.build_tree()
    cand = _oracle(tree, greedy)
    jl, jh, jcache, jnodes = _jax_round(je, prompt, cand, jtree.build_tree())
    cache, _, _ = te._spec_prefill(torch.from_numpy(prompt))
    logits, hidden, pos = te._verify_round(cache, cand, tree)
    assert pos == prompt.shape[1] and int(cache["pos"]) == pos + tree.n_nodes
    assert rel_err(logits.numpy(), jl) < 1e-3 and rel_err(hidden.numpy(), jh) < 1e-3
    nodes, bonus = ttree.accept_nodes(tree, cand, torch.argmax(logits, dim=-1).numpy())
    a = tree.max_depth + 1
    assert nodes == jnodes and len(nodes) == a and nodes != list(range(a))  # slots != rows
    assert [int(cand[i]) for i in nodes] + [bonus] == greedy[:a + 1]
    te._compact(cache, pos, nodes)
    assert int(cache["pos"]) == pos + a
    want = convert.cache_from_jax(jcache)
    for name in ("k", "v"):
        got, ref = cache[name][:, :, :pos + a], want[name][:, :, :pos + a]
        if kv == "bf16":
            assert rel_err(got.float().numpy(), ref.float().numpy()) < 1e-5, name
        else:
            np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=name)
    # the compacted cache decodes on to the greedy tokens
    more = te.decode(torch.tensor([[bonus]]), cache, 10 - a - 1)
    assert more[0].tolist() == greedy[a + 1:]


def test_model_step_mask_and_positions_match_a_causal_step(models):
    """The mask over cache rows and explicit positions: a causal mask and
    the default positions give the plain step's logits, hidden included."""
    _, te = _engines(models, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "int8")
    prompt = torch.from_numpy(models[1])
    a, b = te.init_cache(1), te.init_cache(1)
    want = te._model_step(prompt, a, full_logits=True)
    T, S = prompt.shape[1], te._cache_rows(b)
    mask = torch.where(torch.arange(S)[None, :] <= torch.arange(T)[:, None], 0.0, -1e9)[None, None]
    got, hidden = te._model_step(prompt, b, full_logits=True, positions=torch.arange(T, dtype=torch.int32)[None],
                                 mask=mask, return_hidden=True)
    assert torch.equal(got, want) and hidden.shape == (1, T, DIMS["hidden_size"])
    assert torch.equal(a["k"], b["k"]) and int(b["pos"]) == T


def test_refusals(models):
    """Batch 2 (JAX asserts), the kernel engine (JAX's step raises at
    `serve/engine.py:818`; its generate_speculative fails before, building
    its host-side mask from the kernel layout's axis 2, n_kv), and a tree
    past the cache: JAX fails there on its host-side mask (numpy cannot
    broadcast the tree's 7 columns into the rows left), before any write;
    the port raises through `_room`."""
    jcm, tcm = models[0]["INT4_BLOCKWISE_WEIGHT_ONLY_CFG"]
    prompt = models[1]
    te = tengine.Engine(tcm, tengine.EngineConfig(max_seq_len=MAX_SEQ), device="cpu")
    heads = _heads(models, te, ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "model_dtype"))
    with pytest.raises(ValueError, match="single-sequence"):
        te.generate_speculative(torch.from_numpy(np.repeat(prompt, 2, axis=0)), heads, 4)
    kernel = tengine.Engine(tcm, tengine.EngineConfig(max_seq_len=MAX_SEQ, kv_attention_kernel=True), device="cpu")
    with pytest.raises(NotImplementedError, match="kv_attention_kernel"):
        kernel.generate_speculative(torch.from_numpy(prompt), heads, 4)
    with pytest.raises(NotImplementedError, match="kv_attention_kernel"):
        kernel._model_step(torch.from_numpy(prompt), kernel.init_cache(1), mask=torch.zeros(1, 1, 8, MAX_SEQ))
    je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=MAX_SEQ, backend="xla", kv_attention_kernel=True))
    with pytest.raises(NotImplementedError, match="mask_override"):
        jengine._model_step(je.cfg, je.ecfg, je.cm, je.backend, je.cm.params, je.cm.qstate, jnp.asarray(prompt),
                            je.init_cache(1), jnp.arange(8)[None], mask_override=jnp.zeros((1, 1, 8, MAX_SEQ)))
    with pytest.raises(ValueError, match="could not broadcast"):  # its host mask reads S off the wrong axis first
        je.generate_speculative(jnp.asarray(prompt), _to_jax(heads), max_new_tokens=4)
    short = 12  # prompt 8 + the 7-node tree run past 12 rows
    jshort = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=short, backend="xla"))
    with pytest.raises(ValueError, match="could not broadcast"):
        jshort.generate_speculative(jnp.asarray(prompt), _to_jax(heads), max_new_tokens=4)
    tshort = tengine.Engine(tcm, tengine.EngineConfig(max_seq_len=short), device="cpu")
    with pytest.raises(ValueError, match="cache holds 12 rows, step needs 15"):
        tshort.generate_speculative(torch.from_numpy(prompt), heads, 4)
