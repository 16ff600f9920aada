"""Build and load the package's CUDA kernels (route (b): nvcc + ctypes).

Every `csrc/*.cu` source compiles, at first use, into its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/cuda_kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, of the `csrc/*.cuh` headers
that sources share, and of the flags, so an edited source rebuilds and an
unchanged one is reused. `start_all` starts one
`nvcc` per source, all at once, and returns; `load` waits for the one
source it needs, `build_all` for every source it names. Entry points take every pointer and the
stream as `void*` and return `cudaGetLastError()` as an int; `check`
raises when it is not 0. Kernels allocate nothing: wrappers allocate with
`torch.empty` and launch on `torch.cuda.current_stream()`.

A ctypes launch writes into a tensor that autograd never sees, so the
kernels have no backward: every wrapper calls `refuse_grad` before it
launches, and raises where a gradient would have been asked of it (grad
mode on and an input that requires grad) instead of returning a detached
output. Training reads `attn_impl="flash"` as the einsum attention
(`quant/qat.py` `train_cfg`).
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import threading
import time
from ctypes import c_float, c_int, c_void_p  # noqa: F401  (argtypes for the wrappers)

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "cuda_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
_pending: dict[str, tuple] = {}   # name -> (nvcc process, the thread that waits for it)
_report: dict[str, dict] = {}     # name -> the finished build's seconds, output and exit code


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _target(name: str) -> tuple[str, list[str]]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha1(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for path in [src] + sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v", "-o", out + ".tmp", src]
    return out, cmd


def start_all(names=None) -> None:
    """Start one nvcc per named source (default: all) that has no
    up-to-date library and is not building already, and return at once.
    A thread waits for each process and records its seconds and output;
    `wait` joins them. The compilers run at the lowest CPU priority, so
    that work on the card meanwhile is not starved of the host. Processes
    still running when Python exits are killed with their children."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _build_lock:
        for name in list(names or sources()):
            out, cmd = _target(name)
            if name in _pending:
                continue
            if os.path.exists(out):
                _report[name] = {"seconds": 0.0, "built": False, "ptxas": "", "returncode": 0}
                continue
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                    start_new_session=True)  # its own group: cicc and ptxas die with it
            try:  # below the process that launches and times kernels while the rest compiles
                os.setpriority(os.PRIO_PGRP, proc.pid, 19)
            except ProcessLookupError:
                pass

            def finish(name=name, proc=proc, t0=t0, out=out):
                log, _ = proc.communicate()
                if proc.returncode == 0:
                    os.replace(out + ".tmp", out)
                _report[name] = {"seconds": time.perf_counter() - t0, "built": True, "ptxas": log,
                                 "returncode": proc.returncode}

            thread = threading.Thread(target=finish, name=f"nvcc {name}", daemon=True)
            thread.start()
            _pending[name] = (proc, thread)


def wait(names=None) -> dict[str, dict]:
    """Wait for the named sources' builds (default: all) started by
    `start_all`. Returns {name: {"seconds", "built", "ptxas"}} ("built"
    False where the library was already there); raises naming each source
    that failed to compile."""
    names = list(names or sources())
    report, failed = {}, []
    for name in names:
        with _build_lock:
            entry = _pending.get(name)
        if entry is not None:
            entry[1].join()
            with _build_lock:
                _pending.pop(name, None)
        r = _report[name]
        if r["returncode"] != 0:
            failed.append(f"{name}: nvcc exit {r['returncode']}\n{r['ptxas']}")
        report[name] = {k: r[k] for k in ("seconds", "built", "ptxas")}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def build_all(names=None) -> dict[str, dict]:
    """Compile every named source (default: all) that has no up-to-date
    library, one nvcc per source in parallel, and wait for them. Returns
    {name: {"seconds", "built", "ptxas"}}."""
    start_all(names)
    return wait(names)


@atexit.register
def _kill_pending() -> None:
    with _build_lock:
        procs = [proc for proc, _ in _pending.values()]
    for proc in procs:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, _ = _target(name)
            if name in _pending or not os.path.exists(out):
                build_all([name])
            lib = ctypes.CDLL(out)
            _libs[name] = lib
        return lib


def function(name: str, fn_name: str, argtypes: list):
    """C entry `fn_name` of `csrc/<name>.cu` with its argtypes declared
    (`c_void_p` for every pointer and the stream) and an int return."""
    fn = getattr(load(name), fn_name)
    fn.argtypes = argtypes
    fn.restype = c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def needs_grad(*tensors) -> bool:
    """Whether autograd would track an op on these inputs: grad mode is on
    and one of them (None and non-tensors skipped) requires grad."""
    import torch

    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise where a kernel launched through ctypes would silently drop the
    gradient of its output (`needs_grad`)."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward, and an input requires grad; "
                           "run it under torch.no_grad() or train through the plain PyTorch path")
