// One-token GQA decode attention over a paged KV pool behind a block table,
// pages in stored form (bf16, int8 or fp8 e4m3 codes, or plane-packed
// NVFP4 with a parallel pool of E4M3 block scales), for Hopper (sm_90a).
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/paged_attention.py
// paged_attention_decode (_kernel), formats raw and nvfp4.
//
//   q        [B, n_kv*rep, hd] bf16 or f32 (k's global scale folded in by the caller)
//   kp, vp   [n_pages, n_kv, page, C] stored pages, kv-head-major; C = hd, or
//            hd/2 for NVFP4 with ksp, vsp [n_pages, n_kv, page, hd/16]
//   bt       [B, max_pages] int32 page ids; -1 (unused) reads as page 0
//   lens     [B] int32 live rows of each sequence, the current token
//            included: the caller has written its k/v into its page
//   out      [B, n_kv*rep, hd] in q's dtype (caller applies v's global scale)
// Scores are scaled by 1/sqrt(hd) here (folded into q as it is loaded). f32
// inside, with the reference's constants (kv_common.cuh): a sequence of
// length 0 gives 0.
//
// What bounds it on an H100: the live page bytes, each read once. At
// Llama-3.1-8B, 8 sequences of 2048 int8 rows: 33.5 MB per layer, >= 10 us at
// 3.35 TB/s. What the design does about it: the TPU grid (B, max_pages)
// walks every column of the table in order and carries the softmax state
// from one grid step to the next; here the rows are split over blocks
// (flash-decoding), as the dense decode does (kv_decode_attention.cu):
//   - paged_decode_split: the grid is (n_split, n_kv, B), n_split =
//     ceil(max_pages * page / 256) from the table's width alone (no read of
//     the lengths on the host), so at the 8B shape a 130-page table makes
//     9 x 64 = 576 blocks. Split sp owns rows [256 sp, min(256 (sp + 1),
//     len)) of its (sequence, kv head); a split wholly past the length
//     writes (-1e30, 0, 0) and returns. The block first looks up each of its
//     rows' pages, table[s / page] (any page size; pages past the length are
//     never dereferenced), into shared memory, then runs the split body
//     shared with the dense decode (kvc::split_attend): 16-byte row loads by
//     groups of hd/16 lanes, four rows a group in flight, scores
//     to shared memory, each head's exact max and denominator, then p v.
//   - paged_decode_merge: one block per (sequence, kv head) rescales the
//     splits to their common max (kvc::merge_splits), divides and writes the
//     result in q's dtype, so a call is two launches and no copy.

#include <math.h>

#include "kv_common.cuh"

namespace {

using kvc::SNT;
using kvc::SPLIT_MAX;

template <typename T, int HD, int REP>
__global__ void __launch_bounds__(SNT) paged_decode_split(
    const void* __restrict__ q, int q_bf16, const void* __restrict__ kp, const void* __restrict__ vp,
    const void* __restrict__ ksp, const void* __restrict__ vsp, const int* __restrict__ bt,
    const int* __restrict__ lens, float* __restrict__ part_ml, float* __restrict__ part_acc, int n_kv,
    int page, int max_pages) {
  __shared__ kvc::SplitSmem<REP, HD> sm;
  __shared__ uint32_t rows[SPLIT_MAX];  // stored row of each of the split's rows
  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z, n_split = gridDim.x;
  const size_t head = (size_t)b * n_kv + g, part = head * n_split + sp;
  const int len = min(lens[b], max_pages * page);  // live rows: the last page is cut here
  const int r0 = sp * SPLIT_MAX, n = min(SPLIT_MAX, len - r0);
  if (n <= 0) {
    kvc::split_empty<REP, HD>(part_ml + part * REP * 2, part_acc + part * REP * HD);
    return;
  }
  const int* table = bt + (size_t)b * max_pages;
  for (int i = threadIdx.x; i < n; i += SNT) {
    const int s = r0 + i;
    const int pid = max(__ldg(table + s / page), 0);
    rows[i] = ((uint32_t)pid * n_kv + g) * page + s % page;
  }
  const int li = (threadIdx.x & 31) % (HD / 16);
  const kvc::Lane16<T, HD> K(kp, ksp, li), V(vp, vsp, li);
  const float scale = 1.f / sqrtf((float)HD);
  float qr[REP][16];
#pragma unroll
  for (int h = 0; h < REP; ++h)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const size_t at = (head * REP + h) * HD + K.dim(e);
      qr[h][e] = scale * (q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at])
                                 : static_cast<const float*>(q)[at]);
    }
  __syncthreads();  // rows[]
  kvc::split_attend<T, HD, REP>(K, V, qr, n, [&](int i) { return (size_t)rows[i]; }, part_ml + part * REP * 2,
                                part_acc + part * REP * HD, sm);
}

template <int HD, int REP>
__global__ void __launch_bounds__(SNT) paged_decode_merge(const float* __restrict__ part_ml,
                                                          const float* __restrict__ part_acc, void* __restrict__ out,
                                                          int out_bf16, int n_kv, int n_split) {
  const size_t head = (size_t)blockIdx.y * n_kv + blockIdx.x;
  const float* ml = part_ml + head * n_split * REP * 2;
  const float* acc = part_acc + head * n_split * REP * HD;
  for (int idx = threadIdx.x; idx < REP * HD; idx += SNT) {
    const float v = kvc::merge_splits<HD, REP>(ml, acc, n_split, idx, -1e30f, 0.f, 0.f);
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[head * REP * HD + idx] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[head * REP * HD + idx] = v;
  }
}

struct Launch {
  const void *q, *kp, *vp, *ksp, *vsp, *bt, *lens;
  void *part_ml, *part_acc, *out;
  int q_bf16, B, n_kv, page, max_pages, n_split;
  cudaStream_t st;

  template <typename T, int HD, int REP>
  int run() const {
    paged_decode_split<T, HD, REP><<<dim3(n_split, n_kv, B), SNT, 0, st>>>(
        q, q_bf16, kp, vp, ksp, vsp, static_cast<const int*>(bt), static_cast<const int*>(lens),
        static_cast<float*>(part_ml), static_cast<float*>(part_acc), n_kv, page, max_pages);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    paged_decode_merge<HD, REP><<<dim3(n_kv, B), SNT, 0, st>>>(
        static_cast<const float*>(part_ml), static_cast<const float*>(part_acc), out, q_bf16, n_kv, n_split);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// fmt: 0 = bf16, 1 = int8, 2 = fp8 e4m3, 3 = NVFP4 (ksp, vsp: the scale pools; else unused).
// q_bf16: q and out are bf16 (else f32). part_ml [B, n_kv, n_split, rep, 2] and
// part_acc [B, n_kv, n_split, rep, hd] f32 scratch; n_split * 256 >= max_pages * page.
extern "C" int paged_attention_decode(int fmt, int hd, int rep, const void* q, const void* kp,
                                      const void* vp, const void* ksp, const void* vsp,
                                      const void* bt, const void* lens, void* part_ml, void* part_acc,
                                      void* out, int q_bf16, int B, int n_kv, int page, int max_pages,
                                      int n_split, void* stream) {
  if (page < 1 || max_pages < 1 || n_split < 1 || (long long)n_split * SPLIT_MAX < (long long)max_pages * page)
    return (int)cudaErrorInvalidValue;
  return kvc::dispatch(fmt, hd, rep, Launch{q, kp, vp, ksp, vsp, bt, lens, part_ml, part_acc, out, q_bf16, B,
                                            n_kv, page, max_pages, n_split, static_cast<cudaStream_t>(stream)});
}
