"""Rank workers of the port's multi-GPU parity tests (tests/test_torch_tp.py,
test_torch_deepseek_tp.py, test_torch_sharded_ptq.py,
test_torch_ring_attention.py, test_torch_pipeline.py).

Each test file starts its gloo ranks on the CPU once (`launch`: spawned
processes, one intra-op thread each, a `file://` rendezvous under the
test's own tmp_path, so pytest-xdist workers never meet), hands every rank
the whole list of its cases, and compares what the ranks return with the
JAX package and the port's single-process results computed in the pytest
process. Nothing here imports JAX: the ranks get numpy and the port's
tensors."""

import copy

import numpy as np
import torch

from tensorrt_model_optimizer_tpu_torch.parallel import mesh as M
from tensorrt_model_optimizer_tpu_torch.serve import engine as E
from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Request


def launch(fn, world: int, tmp_path, *args) -> list:
    """fn(rank, *args) on `world` gloo ranks on the CPU; each rank's result.
    The arguments go as deep copies: the launch moves their tensors'
    storage to shared memory, and a tensor whose memory JAX shares (one
    made from a JAX array's numpy view, or given to JAX as one) must not
    move under it while JAX's references compute beside the ranks."""
    return M.launch(fn, world, backend="gloo", args=copy.deepcopy(args), threads=1, workdir=str(tmp_path),
                    timeout_s=300)


def requests(spec) -> list:
    """The paged cases' requests from (seed, count, base length, new tokens):
    JAX's test_paged_serve_parity draws."""
    seed, count, base, new = spec
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, 256, size=(base + i,)), max_new_tokens=new) for i in range(count)]


def run_engine(cm, ecfg: dict, prompt, n: int, mesh=None, serve=None):
    """(prefill logits, greedy tokens) of an engine over `cm`, or the served
    {rid: tokens} where `serve` holds (request spec, serve arguments)."""
    eng = E.Engine(cm, E.EngineConfig(mesh=mesh, **ecfg), device="cpu")
    if serve is not None:
        spec, kw = serve
        return {k: list(v) for k, v in eng.serve(requests(spec), **kw).items()}
    p = torch.from_numpy(prompt)
    logits = eng.prefill(p, eng.init_cache(p.shape[0]))
    return logits.numpy(), eng.generate(p, n).numpy()


def engine_cases(rank: int, cases: list) -> dict:
    """Every case of test_torch_tp.py on this rank: name -> result. A case
    is a dict: cm, ecfg (EngineConfig fields), axes (the mesh), prompt, n,
    and optionally serve (see `run_engine`) or mode "no_max" (W4A8 with
    the per-token amax left local: the fault the MAX reduction prevents) /
    "refuse_i8" (the name of the error the engine raises)."""
    out = {}
    for name, c in cases:
        mesh = M.Mesh(c["axes"])
        mode = c.get("mode")
        if mode == "refuse_i8":
            try:
                E.Engine(c["cm"], E.EngineConfig(mesh=mesh, **c["ecfg"]), device="cpu")
                out[name] = None
            except Exception as e:  # the test asserts which error the engine raised
                out[name] = type(e).__name__
            continue
        if mode == "no_max":
            keep = E._token_int8_acts
            E._token_int8_acts = lambda x, red=None: keep(x, None)
            try:
                out[name] = run_engine(c["cm"], c["ecfg"], c["prompt"], c["n"], mesh)
            finally:
                E._token_int8_acts = keep
            continue
        out[name] = run_engine(c["cm"], c["ecfg"], c["prompt"], c["n"], mesh, c.get("serve"))
    return out


def deepseek_cases(rank: int, cases: list) -> dict:
    """test_torch_deepseek_tp.py's cases on this rank: name -> (prefill
    logits, greedy tokens) of `DeepseekEngine` under a ("rep", "tp") mesh
    (tp 2 or 4 of the 4 ranks)."""
    from tensorrt_model_optimizer_tpu_torch.serve import deepseek_engine as dse

    out = {}
    for name, c in cases:
        mesh = M.Mesh(c["axes"])
        eng = dse.DeepseekEngine(c["cm"], max_seq_len=48, device="cpu", mesh=mesh)
        p = torch.from_numpy(c["prompt"])
        out[name] = (eng.prefill(p, eng.init_cache(p.shape[0])).numpy(), eng.generate(p, c["n"]).numpy())
    return out


def ring_cases(rank: int, q, k, v) -> dict:
    """Ring attention over a 4-rank "context" axis, causal and not: the
    whole sequence gathered back (`ring_attention_sharded`), and this
    rank's own block through `ring_attention` in bf16."""
    from tensorrt_model_optimizer_tpu_torch.parallel import ring_attention as ra

    mesh = M.make_mesh(context=4)
    out = {c: ra.ring_attention_sharded(q, k, v, mesh, "context", c).numpy() for c in (True, False)}
    t = q.shape[1] // 4
    blk = [x[:, rank * t:(rank + 1) * t].to(torch.bfloat16) for x in (q, k, v)]
    out["bf16_block"] = ra.ring_attention(*blk, mesh, "context", True).float().numpy()
    return out


def pipeline_cases(rank: int, cfg, params, tokens, layout, qstate) -> dict:
    """The GPipe forward over a 4-rank "pipe" axis: 4 and 2 microbatches,
    and the quantized variant."""
    from tensorrt_model_optimizer_tpu_torch.parallel import pipeline

    mesh = M.make_mesh(pipe=4)
    return {"m4": pipeline.pipeline_forward(cfg, params, tokens, mesh, num_microbatches=4).numpy(),
            "m2": pipeline.pipeline_forward(cfg, params, tokens, mesh, num_microbatches=2).numpy(),
            "fp8": pipeline.pipeline_forward(cfg, params, tokens, mesh, num_microbatches=4, layout=layout,
                                             qstate=qstate).numpy()}


def state_cases(rank: int, model, path: str) -> dict:
    """`save_sharded` of the whole quantized model on a ("rep", "tensor")
    mesh of 2 x 2, then `restore_sharded` of each rank's own shards."""
    from tensorrt_model_optimizer_tpu_torch.opt import state

    mesh = M.Mesh({"rep": 2, "tensor": 2})
    state.save_sharded(model, path, mesh)
    local = state.restore_sharded(path, mesh)
    return {"params": local.params, "coords": mesh.coords}
