#!/usr/bin/env python3
"""Which collectives a gloo group runs on CUDA tensors itself, on the card.

    python3 tools/torch_gloo_cuda_probe.py

Two gloo ranks on cuda:0 (`parallel.mesh.launch`, a new pair of processes
for each collective: a refused one can leave gloo's connection broken) try
each collective the port's mesh helpers use (all_reduce SUM / MAX in f32 and
bf16, all_gather, send / recv through batch_isend_irecv) on CUDA tensors
directly, not through the helpers, and check the values; prints one JSON
line {op: "ok" or the error}. `parallel/mesh.py`'s ON_CUDA table says which of them the helpers
run on the card and which they stage through host memory.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


OPS = ("all_reduce_sum_float32", "all_reduce_max_float32", "all_reduce_sum_bfloat16", "all_reduce_max_bfloat16",
       "all_gather", "send_recv")


def probe(rank: int, which: str) -> dict:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    out = {}

    def attempt(name, fn, want):
        try:
            got = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if torch.equal(got.cpu().float(), want) else f"wrong values {got.cpu().tolist()}"
        except Exception as e:  # the probe records what the backend refuses
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"

    for dt in (torch.float32, torch.bfloat16):
        for op, red, want in (("sum", dist.ReduceOp.SUM, 3.0), ("max", dist.ReduceOp.MAX, 2.0)):
            def run(dt=dt, red=red):
                t = torch.full((4,), float(rank + 1), dtype=dt, device=dev)
                dist.all_reduce(t, op=red)
                return t
            if which == f"all_reduce_{op}_{str(dt)[6:]}":
                attempt(which, run, torch.full((4,), want))

    def gather():
        parts = [torch.empty(2, device=dev) for _ in range(2)]
        dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
        return torch.cat(parts)
    if which == "all_gather":
        attempt(which, gather, torch.tensor([0.0, 0.0, 1.0, 1.0]))

    def sendrecv():
        send = torch.full((3,), float(rank), device=dev)
        recv = torch.empty(3, device=dev)
        ops = [dist.P2POp(dist.isend, send, 1 - rank), dist.P2POp(dist.irecv, recv, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return recv
    if which == "send_recv":
        attempt(which, sendrecv, torch.full((3,), float(1 - rank)))
    return out


def main() -> int:
    import torch

    from tensorrt_model_optimizer_tpu_torch.parallel import mesh as M

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    res = {}
    for which in OPS:
        try:
            res.update(M.launch(probe, 2, backend="gloo", devices=["cuda:0", "cuda:0"], args=(which,),
                                timeout_s=60)[0])
        except RuntimeError as e:  # the ranks broke after the collective: what the backend did is the reading
            res[which] = f"the ranks failed after it: {e}"
    print(json.dumps({"gloo_on_cuda": res, "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
