"""Paged continuous-batching serving of the port against the JAX package:
`paged_cache` and `Scheduler` step by step, and `Engine.serve` /
`prefill_chunked` / `paged_decode_step` with int8 pages on an f32 tiny Llama
carried across by `convert.py` (the JAX engine runs its Pallas kernels in
interpret mode; the port its plain versions, on the CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu.serve import paged_cache as jpc
from tensorrt_model_optimizer_tpu.serve import scheduler as jsched
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.serve import paged_cache as tpc
from tensorrt_model_optimizer_tpu_torch.serve import scheduler as tsched

# ---- paged_cache ----


def _pools():
    rng = np.random.default_rng(0)
    L, n_pages, page, n_kv, hd, B, maxP = 2, 7, 4, 2, 8, 3, 3
    jc = jpc.init_paged(L, n_pages, page, n_kv, hd, B, maxP, jnp.float32)
    bt = np.asarray([[1, 2, -1], [3, 4, 5], [0, 0, 0]], np.int32)
    lens = np.asarray([3, 8, 0], np.int32)
    jc = dataclasses.replace(jc, block_table=jnp.asarray(bt), seq_lens=jnp.asarray(lens))
    tc = tpc.init_paged(L, n_pages, page, n_kv, hd, B, maxP, torch.float32)
    tc.block_table, tc.seq_lens = torch.from_numpy(bt.copy()), torch.from_numpy(lens.copy())
    steps = [(rng.standard_normal((L, B, n_kv, hd)).astype(np.float32),
              rng.standard_normal((L, B, n_kv, hd)).astype(np.float32)) for _ in range(3)]
    return jc, tc, steps


def test_append_token_kv_matches_jax():
    jc, tc, steps = _pools()
    for k, v in steps:
        jc = jpc.append_token_kv(jc, jnp.asarray(k), jnp.asarray(v))
        assert tpc.append_token_kv(tc, torch.from_numpy(k), torch.from_numpy(v)) is tc  # in place
        got = convert.paged_from_jax(jc)
        for name in ("k_pages", "v_pages", "block_table", "seq_lens"):
            assert torch.equal(getattr(tc, name), getattr(got, name)), name
    assert tc.seq_lens.tolist() == [6, 11, 3] and tc.k_scales is None and not tc.packed_nvfp4


def test_gather_sequence_kv_matches_jax():
    jc, tc, steps = _pools()
    for k, v in steps:
        jc = jpc.append_token_kv(jc, jnp.asarray(k), jnp.asarray(v))
        tpc.append_token_kv(tc, torch.from_numpy(k), torch.from_numpy(v))
    jk, jv = jpc.gather_sequence_kv(jc, jc.k_pages[1], jc.v_pages[1])
    tk, tv = tpc.gather_sequence_kv(tc, tc.k_pages[1], tc.v_pages[1])
    assert tk.shape == (3, 12, 2, 8)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tpc.gather_sequence_kv(tc, tc.k_pages[0], tc.v_pages[0], torch.bfloat16)[0].dtype == torch.bfloat16


def test_init_paged_packed_pool_shapes():
    tc = tpc.init_paged(2, 5, 8, 2, 32, 3, 4, packed_nvfp4=True)
    jc = jpc.init_paged(2, 5, 8, 2, 32, 3, 4, packed_nvfp4=True)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales", "block_table", "seq_lens"):
        a, b = getattr(tc, name), np.asarray(getattr(jc, name))
        assert tuple(a.shape) == b.shape and np.array_equal(a.numpy(), b), name
    assert tc.packed_nvfp4 and tc.page_size == 8 and tc.max_pages == 4


# ---- Scheduler ----


def _state(s):
    return dict(free=list(s.free_pages), slot_pages=[list(p) for p in s.slot_pages],
                slots=[None if r is None else r.rid for r in s.slots], pending=[r.rid for r in s.pending],
                refs=dict(s.page_refs), prefix=dict(s.prefix_map), keys=dict(s.page_key))


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_scheduler_matches_jax_step_by_step(prefix_cache):
    """The same request sequence through both schedulers: block tables,
    lengths, free list, prefix map and refcounts agree after every admit,
    record and retire (tokens are made up: the scheduler only counts them,
    and stops request 2 at its EOS)."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 50, size=(17,))
    spec = [(np.concatenate([shared, rng.integers(0, 50, size=(n,))]).astype(np.int32), new, eos)
            for n, new, eos in ((5, 9, None), (2, 3, None), (9, 6, 7), (0, 4, None), (30, 5, None))]
    geom = dict(max_slots=2, n_pages=24, page_size=8, max_pages_per_seq=8)
    js = jsched.Scheduler(prefix_cache=prefix_cache, **geom)
    ts = tsched.Scheduler(prefix_cache=prefix_cache, **geom)
    for i, (p, new, eos) in enumerate(spec):
        js.submit(jsched.Request(rid=i, prompt=p, max_new_tokens=new, eos_token=eos))
        ts.submit(tsched.Request(rid=i, prompt=p, max_new_tokens=new, eos_token=eos))
    jc = jpc.init_paged(1, 24, 8, 1, 8, 2, 8, jnp.float32)
    tc = tpc.init_paged(1, 24, 8, 1, 8, 2, 8, torch.float32)

    def same(when):
        assert _state(ts) == _state(js), when
        assert tc.block_table.tolist() == np.asarray(jc.block_table).tolist(), when
        assert tc.seq_lens.tolist() == np.asarray(jc.seq_lens).tolist(), when

    step, shared_admissions = 0, 0
    while js.has_work:
        assert ts.has_work
        jc, jadm = js.admit(jc)
        _, tadm = ts.admit(tc)
        assert [(s, r.rid) for s, r in tadm] == [(s, r.rid) for s, r in jadm]
        same(f"admit {step}")
        for slot, req in jadm:
            shared_admissions += int(np.asarray(jc.seq_lens)[slot]) > 0
            # what the engine's prefill does to the lengths
            jc = dataclasses.replace(jc, seq_lens=jc.seq_lens.at[slot].set(len(req.prompt)))
            tc.seq_lens[slot] = len(req.prompt)
            js.register_prefix(slot)
            ts.register_prefix(slot)
        same(f"register {step}")
        assert ts.active_mask().tolist() == js.active_mask().tolist()
        toks = rng.integers(0, 9, size=(2, 2))
        if step % 2:
            js.record_tokens(toks[:, 0])
            ts.record_tokens(toks[:, 0])
        else:
            js.record_token_block(toks)
            ts.record_token_block(toks)
        for a, b in zip(ts.slots, js.slots):
            assert (a is None) == (b is None) and (a is None or (a.output == b.output and a.done == b.done))
        jc = js.retire(jc)
        assert ts.retire(tc) is tc
        same(f"retire {step}")
        step += 1
    assert not ts.has_work and sorted(ts.free_pages) == list(range(1, 24))
    assert (shared_admissions > 0) == prefix_cache  # the run really shares prefix pages


def test_scheduler_rejects_a_request_that_cannot_fit():
    """A deliberate difference: JAX caps the page count at admit and the
    engine clamps the overflowing writes into the last page."""
    ts = tsched.Scheduler(max_slots=2, n_pages=24, page_size=8, max_pages_per_seq=4)
    ts.submit(tsched.Request(rid=0, prompt=np.zeros(20, np.int32), max_new_tokens=4))  # 3 pages + 1
    with pytest.raises(ValueError, match="max_pages_per_seq"):
        ts.submit(tsched.Request(rid=1, prompt=np.zeros(20, np.int32), max_new_tokens=5))
    assert [r.rid for r in ts.pending] == [0]


# ---- the engine ----

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)
SERVE = dict(n_pages=48, page_size=8, max_slots=2, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def engines():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    pnp = llama_params_np(jcfg, seed=0)
    jcm = jcompress.compress(jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"))
    cm = convert.compressed_from_jax(jcm)

    def pair(paged_kernel=True):
        je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=64, backend="pallas", kv_dtype=jnp.int8,
                                                      kv_attention_kernel=True, paged_attention_kernel=paged_kernel))
        te = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=64, kv_dtype=torch.int8, kv_attention_kernel=True,
                                                     paged_attention_kernel=paged_kernel), device="cpu")
        return je, te

    return pair(True), pair(False)


def _requests(cls, new=(9, 3, 5), eos=None):
    """Three requests of unequal length behind a 16-token shared prefix, over
    2 slots: request 2 is admitted when request 1 retires, while request 0
    still publishes the prefix pages."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 256, size=(16,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 256, size=(3 + 2 * i,)).astype(np.int32)]) for i in range(3)]
    return [cls(rid=i, prompt=p, max_new_tokens=n, eos_token=eos) for i, (p, n) in enumerate(zip(prompts, new))]


def _ints(outs):
    return {k: [int(t) for t in v] for k, v in outs.items()}


def test_serve_single_request_matches_jax_and_generate(engines):
    (je, te), _ = engines
    prompt = np.random.default_rng(2).integers(0, 256, size=(8,)).astype(np.int32)
    jo = je.serve([jsched.Request(rid=0, prompt=prompt, max_new_tokens=6)], **SERVE)
    to = te.serve([tsched.Request(rid=0, prompt=prompt, max_new_tokens=6)], **SERVE)
    assert to == _ints(jo)
    assert to[0] == te.generate(torch.from_numpy(prompt[None]), 6)[0].tolist()


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_serve_unequal_requests_over_fewer_slots(engines, prefix_cache):
    (je, te), _ = engines
    jo = je.serve(_requests(jsched.Request), prefix_cache=prefix_cache, **SERVE)
    to, m = te.serve(_requests(tsched.Request), prefix_cache=prefix_cache, collect_metrics=True, **SERVE)
    assert to == _ints(jo) and [len(to[i]) for i in range(3)] == [9, 3, 5]
    # with the prefix cache request 2 shares request 0's two full prefix pages
    # and prefills only its tail, through the paged chunk steps
    assert (m["dense_prefills"], m["chunked_prefills"]) == ((2, 1) if prefix_cache else (3, 0))
    assert m["free_pages"] == SERVE["n_pages"] - 1 and 0 < m["slot_utilization"] <= 1
    for r in _requests(tsched.Request):  # each request alone, through the dense cache
        assert to[r.rid] == te.generate(torch.from_numpy(r.prompt[None]), r.max_new_tokens)[0].tolist()


def test_prefix_pages_are_shared(engines):
    """Admitting a request whose prefix is published maps the SAME pages into
    its table and starts it past them."""
    (_, te), _ = engines
    reqs = _requests(tsched.Request)
    sched = tsched.Scheduler(SERVE["max_slots"], SERVE["n_pages"], SERVE["page_size"], SERVE["max_pages_per_seq"],
                             prefix_cache=True)
    cache = te.init_paged_cache(**SERVE)
    sched.submit(reqs[0])
    sched.admit(cache)
    te.prefill_into_slot(cache, 0, torch.from_numpy(reqs[0].prompt[None]))
    sched.register_prefix(0)
    sched.submit(reqs[2])
    _, adm = sched.admit(cache)
    assert [(s, r.rid) for s, r in adm] == [(1, 2)]
    assert cache.block_table[1, :2].tolist() == cache.block_table[0, :2].tolist()
    assert cache.seq_lens.tolist() == [len(reqs[0].prompt), 16]
    assert all(sched.page_refs[p] == 2 for p in cache.block_table[0, :2].tolist())


def test_serve_stops_at_eos(engines):
    (je, te), _ = engines
    free = te.serve(_requests(tsched.Request), **SERVE)
    eos = free[0][2]
    jo = je.serve(_requests(jsched.Request, eos=eos), **SERVE)
    to = te.serve(_requests(tsched.Request, eos=eos), **SERVE)
    assert to == _ints(jo) and to[0][-1] == eos and len(to[0]) <= 3


def test_serve_unroll_4_equals_unroll_1(engines):
    (je, te), _ = engines
    one = te.serve(_requests(tsched.Request), prefix_cache=True, **SERVE)
    four, m = te.serve(_requests(tsched.Request), prefix_cache=True, unroll=4, collect_metrics=True, **SERVE)
    assert four == one and m["unroll"] == 4
    assert four == _ints(je.serve(_requests(jsched.Request), prefix_cache=True, unroll=4, **SERVE))
    with pytest.raises(ValueError):
        te.serve(_requests(tsched.Request), unroll=9, **SERVE)


def test_serve_gather_path_matches_jax(engines):
    _, (je, te) = engines
    jo = je.serve(_requests(jsched.Request), prefix_cache=True, **SERVE)
    to = te.serve(_requests(tsched.Request), prefix_cache=True, **SERVE)
    assert to == _ints(jo)


def _slot_cache(eng, table, jax_side):
    cache = eng.init_paged_cache(**SERVE)
    if jax_side:
        return dataclasses.replace(cache, block_table=jnp.asarray(table))
    cache.block_table = torch.from_numpy(table.copy())
    return cache


@pytest.mark.parametrize("paged_kernel", [True, False], ids=["kernel_path", "gather_path"])
def test_prefill_chunked_matches_prefill_into_slot_and_jax(engines, paged_kernel):
    je, te = engines[0] if paged_kernel else engines[1]
    prompt = np.random.default_rng(9).integers(0, 256, size=(1, 21)).astype(np.int32)
    table = np.full((2, 8), -1, np.int32)
    table[0, :5] = [1, 2, 3, 4, 5]
    table[1, :] = 0
    dense_cache = _slot_cache(te, table, False)
    dense = te.prefill_into_slot(dense_cache, 0, torch.from_numpy(prompt))[0]
    chunk_cache = _slot_cache(te, table, False)
    chunked = te.prefill_chunked(chunk_cache, 0, torch.from_numpy(prompt), chunk=8)  # 8 + 8 + 5 x 1 tokens
    jl, jc = je.prefill_chunked(_slot_cache(je, table, True), 0, jnp.asarray(prompt), chunk=8)
    # f32 model: 1e-4 of the logits' scale (sums taken in another order; the
    # dense route rounds q.k and the context once less than the paged one)
    assert rel_err(chunked.numpy(), np.asarray(jl)) < 1e-4
    assert rel_err(chunked.numpy(), dense.numpy()) < 1e-4
    assert chunk_cache.seq_lens.tolist() == [21, 0] == np.asarray(jc.seq_lens).tolist()
    # the pages both routes wrote: int8 codes of k/v that agree to f32
    # rounding, so a code may differ by one step at a rounding boundary
    jc = convert.paged_from_jax(jc)
    for pages in ("k_pages", "v_pages"):
        a, b, c = (getattr(x, pages)[:, 1:6].to(torch.int32) for x in (chunk_cache, dense_cache, jc))
        assert int((a - b).abs().max()) <= 1 and int((a - c).abs().max()) <= 1
        assert (a == c).float().mean() > 0.999
    # decode goes on identically from both caches
    tok = torch.zeros((2, 1), dtype=torch.int32)
    tok[0] = int(chunked.argmax())
    act = torch.tensor([True, False])
    la, lb = te.paged_step(tok, chunk_cache, act), te.paged_step(tok, dense_cache, act)
    assert rel_err(la[0].numpy(), lb[0].numpy()) < 1e-4


def test_paged_decode_step_unroll_matches_stepwise(engines):
    (_, te), _ = engines
    prompt = np.random.default_rng(5).integers(0, 256, size=(1, 9)).astype(np.int32)
    table = np.full((2, 8), -1, np.int32)
    table[0, :4] = [1, 2, 3, 4]
    table[1, :] = 0
    c1, c2 = _slot_cache(te, table, False), _slot_cache(te, table, False)
    first = te.prefill_into_slot(c1, 0, torch.from_numpy(prompt)).argmax(-1)
    te.prefill_into_slot(c2, 0, torch.from_numpy(prompt))
    tok = torch.zeros((2, 1), dtype=torch.int32)
    tok[0] = int(first)
    act = torch.tensor([True, False])
    stepwise, t = [], tok
    for _ in range(3):
        t = te.paged_decode_step(t, c1, act)
        stepwise.append(int(t[0]))
    block = te.paged_decode_step(tok, c2, act, unroll=3, return_all=True)
    assert block.shape == (2, 3) and block[0].tolist() == stepwise
    assert c1.seq_lens.tolist() == c2.seq_lens.tolist() == [12, 0]  # the idle slot keeps its length
    assert torch.equal(c1.k_pages[:, 1:5], c2.k_pages[:, 1:5])


def test_engine_lands_on_cuda_by_default(engines):
    """`Engine(...)` with no `device` asks for the card: on a machine
    without one it raises instead of running on the CPU."""
    (_, te), _ = engines
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a card")
    with pytest.raises((RuntimeError, ValueError, AssertionError)):
        tengine.Engine(te.cm, te.ecfg)
