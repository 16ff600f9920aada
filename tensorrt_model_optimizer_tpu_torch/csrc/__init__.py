"""The host packer: `pack_ext.cpp` through ctypes (port of the JAX
package's `csrc/__init__.py`; this module reads nothing of it).

The library builds with the system C++ compiler (`$CXX`, else `g++`) at the
first call, never at import, into `build/pack_ext/libpack_ext-<hash>.so`
beside the CUDA kernels' `build/cuda_kernels/` (the hash covers the source
and the flags, so an edited source rebuilds). A failed build raises with
the compiler's output: there is no Python fallback. The CUDA kernels
(`*.cu` here) are built by `ops/cuda/_build.py`, not by this module.

Every function takes and returns numpy arrays, as JAX's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "pack_ext.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "pack_ext")
# No -fopenmp: a toolchain installed without libgomp builds the library too (the
# loops' `omp` pragmas are then ignored, and each call runs on one thread).
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_U8 = ctypes.POINTER(ctypes.c_uint8)
_I8 = ctypes.POINTER(ctypes.c_int8)
_F32 = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (set $CXX): the host packer builds from csrc/pack_ext.cpp")
    return cxx


def build() -> str:
    """Compile the library if this source and these flags have not been
    built yet -> its path. Raises on a failed build."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libpack_ext-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"pack_ext build failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build finds a whole file or none
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library (built on the first call)."""
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.int4_round_and_pack.argtypes = [_F32, _F32, _U8, _I64, _I64, _I64]
            lib.nvfp4_quantize_and_pack.argtypes = [_F32, _U8, _F32, ctypes.c_float, _I64, _I64, _I64]
            lib.int4_unpack.argtypes = [_U8, _I8, _I64]
            lib.nf4_quantize_and_pack.argtypes = [_F32, _U8, _F32, _I64, _I64]
            lib.nf4_dequantize.argtypes = [_U8, _F32, _F32, _I64, _I64]
            _LIB = lib
        return _LIB


def _f32(a: np.ndarray):
    return a.ctypes.data_as(_F32)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8)


def int4_round_and_pack(w: np.ndarray, scale: np.ndarray, block: int) -> np.ndarray:
    """INT4 round (to nearest even) + adjacent-nibble pack. w [R, C] f32,
    scale [R, C / block] -> [R, C / 2] uint8, the even column low."""
    lib = get_lib()
    w = np.ascontiguousarray(w, np.float32)
    scale = np.ascontiguousarray(scale, np.float32)
    rows, cols = w.shape
    out = np.empty((rows, cols // 2), np.uint8)
    lib.int4_round_and_pack(_f32(w), _f32(scale), _u8(out), rows, cols, block)
    return out


def nvfp4_quantize_and_pack(w: np.ndarray, global_scale: float, block: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """NVFP4 quantize + pack -> (packed [R, C / 2] uint8, block scales
    [R, C / block] f32: the e4m3-rounded scale codes)."""
    lib = get_lib()
    w = np.ascontiguousarray(w, np.float32)
    rows, cols = w.shape
    out = np.empty((rows, cols // 2), np.uint8)
    scales = np.empty((rows, cols // block), np.float32)
    lib.nvfp4_quantize_and_pack(_f32(w), _u8(out), _f32(scales), ctypes.c_float(global_scale), rows, cols, block)
    return out, scales


def int4_unpack(packed: np.ndarray) -> np.ndarray:
    """uint8 nibbles [..., n] -> int8 [..., 2 n] in [-8, 7]."""
    lib = get_lib()
    packed = np.ascontiguousarray(packed, np.uint8)
    out = np.empty(packed.shape[:-1] + (packed.shape[-1] * 2,), np.int8)
    lib.int4_unpack(_u8(packed), out.ctypes.data_as(_I8), packed.size)
    return out


def nf4_quantize_and_pack(w: np.ndarray, block: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """NF4 quantize + pack over the flattened array -> (packed [n / 2]
    uint8, absmax [n / block] f32)."""
    lib = get_lib()
    w = np.ascontiguousarray(w, np.float32).reshape(-1)
    if w.size % block:
        raise ValueError(f"{w.size} values do not split into blocks of {block}")
    out = np.empty(w.size // 2, np.uint8)
    am = np.empty(w.size // block, np.float32)
    lib.nf4_quantize_and_pack(_f32(w), _u8(out), _f32(am), w.size, block)
    return out, am


def nf4_dequantize(packed: np.ndarray, absmax: np.ndarray, block: int = 64) -> np.ndarray:
    """NF4 packs and their block absmax -> f32 [2 n]."""
    lib = get_lib()
    packed = np.ascontiguousarray(packed, np.uint8)
    out = np.empty(packed.size * 2, np.float32)
    lib.nf4_dequantize(_u8(packed), _f32(np.ascontiguousarray(absmax, np.float32)), _f32(out), out.size, block)
    return out
