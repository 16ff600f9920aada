#!/usr/bin/env python3
"""Where the W4A8 GEMM's prefill route spends its time, on one CUDA card.

    python3 tools/torch_w4a8_probe.py

Builds `tensorrt_model_optimizer_tpu_torch/csrc/qmm_w4a8.cu` as it is and
in timing-only variants (their outputs are wrong by construction and are
not checked), and times each with CUDA events (median of 20 launches after
a warm-up) at gate_proj (O 14336, K 4096) and down_proj (O 4096, K 14336),
N = 16384:
  kernel         the source as it is;
  no_fold        each block's int32 sum added to the f32 result as its raw
                 bits (one FADD) instead of the exact scale fold;
  no_copies      no TMA copies after the first stages: every K block reads
                 stage 0 (the barriers stay);
  no_wgmma       no tensor-core work (copies, decode, fold, barriers stay).
Then the ceilings of the tensor-core instructions on the card: a loop of
wgmma.m64n128k32 s8 from shared memory as the kernel runs them (3
warpgroups a block, 4 wgmmas a commit and a wait), and a loop of mma.sync
m16n8k32 s8 (8 warps a block, 16 independent accumulators a warp), one
block an SM. Prints one JSON line per reading and the card's name and
power limit. Needs nvcc and one card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "tensorrt_model_optimizer_tpu_torch", "csrc", "qmm_w4a8.cu")
OUT = os.path.join(HERE, "build", "w4a8_probe")
NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
FOLD = "acc[i] = fold<true>(acc[i], d[i], sc[(i >> 1) & 1]);"
RAW = "acc[i] += __int_as_float(d[i]);"
LOADS = "    if (tid == 0 && kb + STAGES - 1 < nblk) load_stage(kb + STAGES - 1);\n"
WAIT = "    mbar_wait(bar + kb % STAGES, (kb / STAGES) & 1);\n"
STAGE = "    const uint8_t* xs = stage_of(kb);\n"
WGMMA = "for (int step = 0; step < 4; ++step) wgmma_m64n128k32(d, da0 + 2 * step, db0 + 2 * step);"
MMA_LOOP = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) loop(int* out, int iters, uint32_t seed) {
  uint32_t a[4] = {seed, seed * 3u, seed * 5u, seed * 7u}, b[2] = {seed ^ 1u, seed ^ 2u};
  int c[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
      asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+r"(c[q][0]), "+r"(c[q][1]), "+r"(c[q][2]), "+r"(c[q][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  int s = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) s += c[q][0] + c[q][1] + c[q][2] + c[q][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_loop(void* out, int blocks, int iters, void* st) {
  loop<<<blocks, 256, 0, (cudaStream_t)st>>>((int*)out, iters, 12345u);
  return (int)cudaGetLastError();
}
'''


def wgmma_loop(src: str) -> str:
    """The kernel's own wgmma helper and descriptors in a loop over one
    resident A (192 x 128 bytes) and B (128 x 128 bytes) tile."""
    start = src.index("// d (64 int32 a thread) += A")
    helper = src[start:src.index("\n}\n", start) + 3]
    return (r'''
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint64_t sdesc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
''' + helper + r'''
__global__ void __launch_bounds__(384, 1) loop(int* out, int iters) {
  extern __shared__ __align__(1024) uint8_t sm[];
  uint8_t* base = sm + ((1024 - ((uint32_t)__cvta_generic_to_shared(sm) & 1023)) & 1023);
  for (int i = threadIdx.x; i < (192 + 128) * 128 / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(base)[i] = make_uint4(i, 3 * i, 5 * i, 7 * i);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const uint64_t da = sdesc((uint32_t)__cvta_generic_to_shared(base + wg * 64 * 128));
  const uint64_t db = sdesc((uint32_t)__cvta_generic_to_shared(base + 192 * 128));
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int step = 0; step < 4; ++step) wgmma_m64n128k32(d, da + 2 * step, db + 2 * step);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_loop(void* out, int blocks, int iters, void* st) {
  const int smem = 1024 + (192 + 128) * 128;
  cudaFuncSetAttribute(loop, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  loop<<<blocks, 384, smem, (cudaStream_t)st>>>((int*)out, iters);
  return (int)cudaGetLastError();
}
''')


def variants() -> dict:
    src = open(SRC).read()
    for anchor in (FOLD, LOADS, WAIT, STAGE, WGMMA):
        if anchor not in src:
            raise RuntimeError("qmm_w4a8.cu moved on: update the probe's text anchors")
    no_copies = (src.replace(LOADS, "").replace(WAIT, "    if (kb < STAGES - 1) mbar_wait(bar + kb, 0);\n")
                 .replace(STAGE, "    const uint8_t* xs = stage_of(0);\n"))
    return {"kernel": src, "no_fold": src.replace(FOLD, RAW), "no_copies": no_copies,
            "no_wgmma": src.replace(WGMMA, ""), "wgmma_loop": wgmma_loop(src), "mma_loop": MMA_LOOP}


def build(srcs: dict) -> None:
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name, text in srcs.items():
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs.append((name, subprocess.Popen(NVCC + ["-o", path[:-3] + ".so", path], stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        regs = [line.split(":")[-1].strip() for line in log.splitlines() if "registers" in line]
        print(json.dumps({"built": name, "ptxas": regs}), flush=True)


def median_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[reps // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_w4a8_probe: no CUDA device", file=sys.stderr)
        return 2
    srcs = variants()
    build(srcs)
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    g = torch.Generator(device=dev).manual_seed(0)
    for O, K, label in ((14336, 4096, "gate_proj"), (4096, 14336, "down_proj")):
        N, nblk = 16384, K // 128
        packed = torch.randint(0, 256, (O, K // 2), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
        scales = (torch.rand((nblk, O), generator=g, device=dev) * 1.5 + 0.5).to(torch.bfloat16)
        x8 = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
        y = torch.empty((N, O), dtype=torch.float32, device=dev)
        for name in srcs:
            if name.endswith("_loop"):
                continue
            fn = ctypes.CDLL(os.path.join(OUT, name + ".so")).w4a8_gemm
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                                                               ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call():
                if fn(x8.data_ptr(), packed.data_ptr(), scales.data_ptr(), y.data_ptr(), N, K, O, nblk, None, None,
                      1, stream):
                    raise RuntimeError(f"{name}: launch failed")

            print(json.dumps({"shape": f"{label} N={N} O={O} K={K}", "variant": name, "ms": median_ms(call)}),
                  flush=True)
        del packed, scales, x8, y
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 384, dtype=torch.int32, device=dev)
    iters = 2000
    # loop -> (threads a block, int8 MACs a block an iteration)
    loops = {"wgmma_loop": (384, 3 * 4 * 64 * 128 * 32), "mma_loop": (256, 8 * 16 * 16 * 8 * 32)}
    for name, (threads, macs) in loops.items():
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        lib.run_loop.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        ms = median_ms(lambda: lib.run_loop(out.data_ptr(), sms, iters, stream), 5)
        print(json.dumps({"loop": name, "blocks": sms, "threads": threads, "ms": ms,
                          "tera_ops_per_s": 2.0 * macs * sms * iters / ms / 1e9}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
