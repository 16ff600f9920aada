"""The mesh of named axes over `torch.distributed` ranks (port of
`parallel/mesh.py`), its collectives, and a launcher of rank processes.

JAX's `Mesh` places devices on named axes and `shard_map` runs one program
per device; here each rank is its own process, and a `Mesh` names the axes
of the ranks of the default process group: the rank's index on each axis,
one process group per axis (the ranks that differ only on that axis), and
the rank's device. Ranks are laid out row-major over the axes in their
order, as JAX reshapes its device array: the first axis varies slowest.

The caller sets up the default group with the backend of its choice:
`nccl` with one card per rank, `gloo` on the CPU, or `gloo` with every rank
on one card. The collectives (`all_reduce`, `all_gather`, `ring_shift`,
JAX's `psum` / `pmax`, `all_gather` and `ppermute`) run on the tensors'
own device where the group's backend runs that collective on CUDA tensors
(`ON_CUDA`); under the others they copy the tensor to host memory, run the
collective there and copy the result back. The compute stays on the card.

`launch` starts one process per rank (the `spawn` start method), sets up
the default group through a file rendezvous, runs a function in each and
returns what each rank returned; a rank that fails fails the launch.
"""

from __future__ import annotations

import datetime
import itertools
import math
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# The collectives each backend runs on CUDA tensors itself; under the others
# a helper stages the tensor through host memory. gloo reduces (f32 and bf16,
# SUM and MAX) and gathers CUDA tensors; a send / recv of a CUDA tensor breaks
# its connection (`writev ... Bad address`): `tools/torch_gloo_cuda_probe.py`
# on the H100, torch 2.11.
ON_CUDA = {
    "nccl": frozenset({"all_reduce", "all_gather", "send_recv"}),
    "gloo": frozenset({"all_reduce", "all_gather"}),
}

CANONICAL_AXES = ("data", "pipe", "expert", "tensor", "context")

_LAUNCH_DEVICE: Optional[torch.device] = None  # the device `launch` gave this rank


class Mesh:
    """Named axes over the ranks of the default process group.

    `axes` maps each axis name to its size, in order (slowest first); their
    product is the world size. Every rank builds the same mesh (each group
    is made by every rank, in the same order). `device` is the rank's device:
    by default the one `launch` gave it, else cuda:<local rank mod the
    cards> wherever there is a card, whatever the backend (the CPU only
    where there is none, or where the caller passes it)."""

    def __init__(self, axes, device=None):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs torch.distributed's default group: init_process_group first")
        axes = dict(axes)
        self.names = tuple(axes)
        self.shape = {n: int(s) for n, s in axes.items()}
        world, rank = dist.get_world_size(), dist.get_rank()
        if math.prod(self.shape.values()) != world:
            raise ValueError(f"mesh axes {self.shape} (product {math.prod(self.shape.values())}) != world size {world}")
        self.rank, self.world = rank, world
        self.backend = dist.get_backend()
        sizes = [self.shape[n] for n in self.names]
        coords = []
        r = rank
        for s in reversed(sizes):
            coords.append(r % s)
            r //= s
        self.coords = dict(zip(self.names, reversed(coords)))
        self.groups = {}
        self.group_ranks = {}
        for i, name in enumerate(self.names):
            if sizes[i] == 1:
                continue
            others = [range(s) for j, s in enumerate(sizes) if j != i]
            for rest in itertools.product(*others):
                ranks = [_ravel(list(rest[:i]) + [k] + list(rest[i:]), sizes) for k in range(sizes[i])]
                group = dist.new_group(ranks)
                if rank in ranks:
                    self.groups[name], self.group_ranks[name] = group, ranks
        if device is None:
            device = _LAUNCH_DEVICE
        if device is None:
            device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
                      if torch.cuda.is_available() else torch.device("cpu"))
        self.device = torch.device(device)

    def size(self, axis: Optional[str]) -> int:
        """The axis' size (1 for None or an axis the mesh lacks)."""
        return self.shape.get(axis, 1) if axis else 1

    def index(self, axis: Optional[str]) -> int:
        """This rank's index on the axis (0 for None or an axis it lacks)."""
        return self.coords.get(axis, 0) if axis else 0

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank}, {self.backend}, {self.device})"


def _ravel(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def make_mesh(*, data: int = 1, pipe: int = 1, expert: int = 1, tensor: int = 1, context: int = 1,
              device=None) -> Mesh:
    """The canonical mesh (JAX's `make_mesh`): axes data, pipe, expert,
    tensor, context, slowest first, so the axes that cross hosts come first
    and the ones inside a host last. Their product is the world size."""
    return Mesh(dict(zip(CANONICAL_AXES, (data, pipe, expert, tensor, context))), device)


def _host_staged(op: str, backend: str, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and op not in ON_CUDA.get(backend, frozenset())


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: Optional[str], op: str = "sum") -> torch.Tensor:
    """The SUM ("sum", JAX's psum) or MAX ("max", pmax) of t over the axis:
    a new tensor of t's dtype on t's device (t itself where the axis has
    one rank)."""
    if mesh is None or mesh.size(axis) == 1:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    work = t.cpu() if _host_staged("all_reduce", mesh.backend, t) else t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(work, op=red, group=mesh.groups[axis])
    return work.to(t.device)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: Optional[str], dim: int = 0) -> torch.Tensor:
    """Every rank's t on the axis, concatenated along `dim` in axis order."""
    if mesh is None or mesh.size(axis) == 1:
        return t
    work = t.cpu() if _host_staged("all_gather", mesh.backend, t) else t
    work = work.contiguous()
    parts = [torch.empty_like(work) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, work, group=mesh.groups[axis])
    return torch.cat(parts, dim=dim).to(t.device)


def all_gather_object(obj, mesh: Mesh, axis: Optional[str]) -> list:
    """Every rank's picklable `obj` on the axis, in axis order."""
    if mesh is None or mesh.size(axis) == 1:
        return [obj]
    out = [None] * mesh.size(axis)
    dist.all_gather_object(out, obj, group=mesh.groups[axis])
    return out


def ring_shift(t: torch.Tensor, mesh: Mesh, axis: Optional[str], shift: int = 1) -> torch.Tensor:
    """JAX's `ppermute` with perm [(i, i + shift mod P)]: this rank's t goes
    to the rank `shift` places on along the axis, and the result is what the
    rank `shift` places back sent."""
    n = mesh.size(axis) if mesh is not None else 1
    if n == 1 or shift % n == 0:
        return t
    ranks, i = mesh.group_ranks[axis], mesh.index(axis)
    dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
    staged = _host_staged("send_recv", mesh.backend, t)
    send = (t.cpu() if staged else t).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group=mesh.groups[axis]),
           dist.P2POp(dist.irecv, recv, src, group=mesh.groups[axis])]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return recv.to(t.device)


class Axis:
    """One axis of a mesh, as the serving code reduces over it (None mesh or
    axis: one rank, and every collective is the identity)."""

    def __init__(self, mesh: Optional[Mesh], name: Optional[str]):
        self.mesh, self.name = mesh, name
        self.size = mesh.size(name) if mesh is not None else 1
        self.index = mesh.index(name) if mesh is not None else 0

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.mesh, self.name, "sum")

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.mesh, self.name, "max")

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return all_gather(t, self.mesh, self.name, dim)


# ---------------------------------------------------------------- launching


def rank_devices(world: int, cpu: bool = False) -> tuple[str, list]:
    """The backend and the per-rank devices of `world` ranks: gloo on the
    CPU where `cpu`; else nccl with rank r on cuda:r where there are that
    many cards, gloo with every rank on cuda:0 where there are fewer."""
    if cpu:
        return "gloo", ["cpu"] * world
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass cpu=True to run the ranks on the CPU")
    if torch.cuda.device_count() >= world:
        return "nccl", [f"cuda:{r}" for r in range(world)]
    return "gloo", ["cuda:0"] * world


def launch_device() -> Optional[torch.device]:
    """The device `launch` gave this rank (None outside a launched rank)."""
    return _LAUNCH_DEVICE


def _rank_entry(rank: int, world: int, backend: str, init_file: str, device: str, fn, args: tuple,
                out_path: str, threads: Optional[int], timeout_s: float) -> None:
    global _LAUNCH_DEVICE
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _LAUNCH_DEVICE = dev
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, *args)
        torch.save(result, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn, world_size: int, *, backend: str, devices: Sequence = None, args: tuple = (),
           rank_args: Optional[Sequence[tuple]] = None, threads: Optional[int] = None, timeout_s: float = 900.0,
           workdir: Optional[str] = None) -> list:
    """Run `fn(rank, *args, *rank_args[rank])` in `world_size` spawned
    processes, each in the default process group of `backend` (set up
    through a file under `workdir`, a new temporary directory by default,
    removed after) on `devices[rank]` (default: the CPU), with `threads`
    intra-op threads where given. `fn` must be importable by name (a
    module's function). Each rank gets only its own `rank_args`; tensors in
    them are shared, not copied (CUDA IPC on the card, shared memory on the
    host). Returns each rank's return value (loaded to the CPU), in rank
    order. A rank that exits with an error (or a collective that outlasts
    `timeout_s`) stops the others, and the launch raises naming it."""
    import torch.multiprocessing as mp  # registers the tensor reductions the children's arguments need

    devices = list(devices) if devices is not None else ["cpu"] * world_size
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="ranks_") if own else workdir
    init_file = os.path.join(workdir, "rendezvous")
    if os.path.exists(init_file):
        os.remove(init_file)
    ctx = mp.get_context("spawn")
    procs = []
    try:
        for r in range(world_size):
            extra = tuple(rank_args[r]) if rank_args is not None else ()
            p = ctx.Process(target=_rank_entry, args=(r, world_size, backend, init_file, str(devices[r]), fn,
                                                      tuple(args) + extra, os.path.join(workdir, f"rank{r}.pt"),
                                                      threads, timeout_s))
            p.start()
            procs.append(p)
        deadline = time.time() + timeout_s + 120.0
        while any(p.exitcode is None for p in procs):
            bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0][0]} exited with code {bad[0][1]} (its traceback is above)")
            if time.time() > deadline:
                raise RuntimeError(f"ranks still running after {timeout_s + 120.0:.0f} s")
            time.sleep(0.05)
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"rank {bad[0][0]} exited with code {bad[0][1]} (its traceback is above)")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), map_location="cpu", weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
        for p in procs:
            p.join(timeout=30)
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
