// One-token GQA decode attention over a paged KV pool behind a block table,
// pages in stored form (bf16, int8 or fp8 e4m3 codes, or plane-packed
// NVFP4 with a parallel pool of E4M3 block scales), for Hopper (sm_90a).
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/paged_attention.py
// paged_attention_decode (_kernel), formats raw and nvfp4.
//
//   q        [B, n_kv*rep, hd] f32 (k's global scale folded in by the caller)
//   kp, vp   [n_pages, n_kv, page, C] stored pages, kv-head-major; C = hd, or
//            hd/2 for NVFP4 with ksp, vsp [n_pages, n_kv, page, hd/16]
//   bt       [B, max_pages] int32 page ids; -1 (unused) reads as page 0
//   lens     [B] int32 live rows of each sequence, the current token
//            included: the caller has written its k/v into its page
//   out      [B, n_kv*rep, hd] f32 (caller applies v's global scale)
// Scores are divided by sqrt(hd) here. Online softmax in f32 with the
// reference's constants (kv_common.cuh): a sequence of length 0 gives 0.
//
// What bounds it on an H100: the live page bytes, each read once. At
// Llama-3.1-8B, 8 sequences of 2048 int8 rows: 33.5 MB per layer, >= 10 us at
// 3.35 TB/s. What the design does about it: the TPU grid (B, max_pages)
// walks every column of the table in order and carries the softmax state
// from one grid step to the next; here one block per (sequence, kv head)
// loops over the live rows only, ceil(len / page) pages, and never touches a
// table entry past them. A warp takes four rows in turn: it reads their
// table entries, then the rows (one page row of one kv head is one coalesced
// read of the warp), for all `rep` query heads at once; the warps' states
// merge in shared memory. Sequences of very different length give blocks of
// very different length, and B * n_kv = 64 blocks leave half of the 132 SMs
// idle: a split over the pages with a second pass is later work.

#include <math.h>

#include "kv_common.cuh"

namespace {

using kvc::NW;
using kvc::UNROLL;

template <typename T, int HD, int REP>
__global__ void __launch_bounds__(NW * 32) paged_decode_kernel(
    const float* __restrict__ q, const void* __restrict__ kp, const void* __restrict__ vp,
    const void* __restrict__ ksp, const void* __restrict__ vsp, const int* __restrict__ bt,
    const int* __restrict__ lens, float* __restrict__ out, int n_kv, int page, int max_pages,
    float scale) {
  constexpr int E = HD / 32;  // dims per lane
  __shared__ kvc::Merge<REP, HD> sm;
  const int g = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = (size_t)b * n_kv + g;
  const float* qb = q + head * REP * HD + lane * E;
  const kvc::Rows<T, HD> K(kp, ksp, lane), V(vp, vsp, lane);
  const int* table = bt + (size_t)b * max_pages;
  const int len = min(lens[b], max_pages * page);  // live rows: the last page is cut here

  float qr[REP][E];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] = qb[r * HD + e];
  }
  kvc::Softmax<REP, E> st;
  st.init();

  for (int base = warp * UNROLL; base < len; base += NW * UNROLL) {
    float kr[UNROLL][E], vr[UNROLL][E];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = base + u;
      if (s < len) {
        const int pid = max(table[s / page], 0);
        const size_t row = ((size_t)pid * n_kv + g) * page + s % page;
        K.load(row, kr[u]);
        V.load(row, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u >= len) break;
      st.fold(qr, kr[u], vr[u], scale);
    }
  }

  sm.put(st, warp, lane);
  __syncthreads();  // every warp arrives: none returned above
  if (warp != 0) return;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float M, L, A[E];
    sm.get(r, lane, M, L, A);
    L = fmaxf(L, 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) out[(head * REP + r) * HD + lane * E + e] = A[e] / L;
  }
}

struct Launch {
  const void *q, *kp, *vp, *ksp, *vsp, *bt, *lens;
  void* out;
  int B, n_kv, page, max_pages;
  cudaStream_t st;

  template <typename T, int HD, int REP>
  int run() const {
    paged_decode_kernel<T, HD, REP><<<dim3(n_kv, B), NW * 32, 0, st>>>(
        static_cast<const float*>(q), kp, vp, ksp, vsp, static_cast<const int*>(bt),
        static_cast<const int*>(lens), static_cast<float*>(out), n_kv, page, max_pages,
        1.0f / sqrtf((float)HD));
    return (int)cudaGetLastError();
  }
};

}  // namespace

// fmt: 0 = bf16, 1 = int8, 2 = fp8 e4m3, 3 = NVFP4 (ksp, vsp: the scale pools; else unused).
extern "C" int paged_attention_decode(int fmt, int hd, int rep, const void* q, const void* kp,
                                      const void* vp, const void* ksp, const void* vsp,
                                      const void* bt, const void* lens, void* out, int B, int n_kv,
                                      int page, int max_pages, void* stream) {
  return kvc::dispatch(fmt, hd, rep, Launch{q, kp, vp, ksp, vsp, bt, lens, out, B, n_kv, page,
                                            max_pages, static_cast<cudaStream_t>(stream)});
}
