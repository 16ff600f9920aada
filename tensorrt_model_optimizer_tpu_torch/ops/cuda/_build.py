"""Build and load the package's CUDA kernels (route (b): nvcc + ctypes).

Every `csrc/*.cu` source compiles, at first use, into its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/cuda_kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, of the `csrc/*.cuh` headers
that sources share, and of the flags, so an edited source rebuilds and an
unchanged one is reused. `build_all` starts one
`nvcc` per source, all at once. Entry points take every pointer and the
stream as `void*` and return `cudaGetLastError()` as an int; `check`
raises when it is not 0. Kernels allocate nothing: wrappers allocate with
`torch.empty` and launch on `torch.cuda.current_stream()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
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


def build_all(names=None) -> dict[str, dict]:
    """Compile every source that has no up-to-date library, one nvcc per
    source in parallel. Returns {name: {"seconds", "built", "ptxas"}}."""
    names = list(names or sources())
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, report = {}, {}
    for name in names:
        out, cmd = _target(name)
        if os.path.exists(out):
            report[name] = {"seconds": 0.0, "built": False, "ptxas": ""}
            continue
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), time.perf_counter(), out)
    failed = []
    for name, (proc, t0, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "built": True, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(out + ".tmp", out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, _ = _target(name)
            if not os.path.exists(out):
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
