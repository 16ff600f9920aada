// Chunked-prefill GQA attention over a paged KV pool: T query tokens of each
// sequence attend to the sequence's paged context and, causally, to the
// chunk's own k/v, all in stored form (bf16, int8 or fp8 e4m3 codes, or
// plane-packed NVFP4 with E4M3 block scales), for Hopper (sm_90a).
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/paged_attention.py
// paged_attention_prefill (_prefill_kernel), formats raw and nvfp4.
//
//   q        [B, T, n_kv*rep, hd] f32 (k's global scale folded in by the caller)
//   kp, vp   [n_pages, n_kv, page, C] stored pages, kv-head-major; C = hd, or
//            hd/2 for NVFP4 with ksp, vsp [n_pages, n_kv, page, hd/16]
//   bt       [B, max_pages] int32 page ids; -1 (unused) reads as page 0
//   lens     [B] int32 context rows of each sequence BEFORE the chunk
//   ck, cv   [B, T, n_kv, C] the chunk's k/v in stored form (NVFP4: cks, cvs
//            [B, T, n_kv, hd/16]); token t sees chunk columns <= t
//   out      [B, T, n_kv*rep, hd] f32 (caller applies v's global scale)
// The page walk stops at lens[b]: the chunk's rows are read from ck / cv,
// never from the pages, so a sequence whose page writes went elsewhere still
// attends to its own chunk. Scores are divided by sqrt(hd) here; online
// softmax in f32 with the reference's constants (kv_common.cuh).
//
// What bounds it on an H100: at Llama-3.1-8B (T = 64, 8 sequences with 1024
// context rows) the 4 B n_heads T (ctx + T) hd = 9.1 GFLOP a layer, >= 9 us
// at the bf16 peak, against 17 MB of int8 context, >= 5 us. What the design
// does about it, so far only as much as makes it right: the TPU grid (B,
// max_pages + 1) carries one softmax state per sequence through the pages in
// order; here every (sequence, kv head, token) is one warp with its own
// state, 8 tokens a block, so nothing is merged and no barrier is needed. A
// warp walks the context's live pages and then the chunk rows <= t, four rows
// at a time, for all `rep` query heads at once. The products run on the CUDA
// cores with a warp-wide sum per score, and the 8 warps of a block re-read
// the same context rows through L1 / L2: tiles of queries on the tensor
// cores (mma.sync as in qmm_wo_common.cuh) are later work.

#include <math.h>

#include "kv_common.cuh"

namespace {

using kvc::NW;
using kvc::UNROLL;

template <typename F, int HD, int REP>
__global__ void __launch_bounds__(NW * 32) paged_prefill_kernel(
    const float* __restrict__ q, const void* __restrict__ kp, const void* __restrict__ vp,
    const void* __restrict__ ksp, const void* __restrict__ vsp, const int* __restrict__ bt,
    const int* __restrict__ lens, const void* __restrict__ ck, const void* __restrict__ cv,
    const void* __restrict__ cks, const void* __restrict__ cvs, float* __restrict__ out, int n_kv,
    int page, int max_pages, int T, float scale) {
  constexpr int E = HD / 32;  // dims per lane
  const int g = blockIdx.x, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.y * NW + warp;
  if (t >= T) return;  // this kernel has no block-wide barrier
  const size_t qrow = ((size_t)b * T + t) * n_kv + g;  // also the chunk's row index
  const float* qb = q + qrow * REP * HD + lane * E;
  const int* table = bt + (size_t)b * max_pages;
  const int ctx = min(lens[b], max_pages * page);

  float qr[REP][E];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] = qb[r * HD + e];
  }
  kvc::Softmax<REP, E> st;
  st.init();

  {  // the paged context, rows [0, ctx)
    const kvc::Rows<F, HD> K(kp, ksp, lane), V(vp, vsp, lane);
    for (int base = 0; base < ctx; base += UNROLL) {
      float kr[UNROLL][E], vr[UNROLL][E];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int s = base + u;
        if (s < ctx) {
          const int pid = max(table[s / page], 0);
          const size_t row = ((size_t)pid * n_kv + g) * page + s % page;
          K.load(row, kr[u]);
          V.load(row, vr[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (base + u >= ctx) break;
        st.fold(qr, kr[u], vr[u], scale);
      }
    }
  }
  {  // the chunk itself, causal: columns j <= t
    const kvc::Rows<F, HD> K(ck, cks, lane), V(cv, cvs, lane);
    for (int base = 0; base <= t; base += UNROLL) {
      float kr[UNROLL][E], vr[UNROLL][E];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u;
        if (j <= t) {
          const size_t row = ((size_t)b * T + j) * n_kv + g;
          K.load(row, kr[u]);
          V.load(row, vr[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (base + u > t) break;
        st.fold(qr, kr[u], vr[u], scale);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float L = fmaxf(st.l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) out[(qrow * REP + r) * HD + lane * E + e] = st.acc[r][e] / L;
  }
}

struct Launch {
  const void *q, *kp, *vp, *ksp, *vsp, *bt, *lens, *ck, *cv, *cks, *cvs;
  void* out;
  int B, T, n_kv, page, max_pages;
  cudaStream_t st;

  template <typename F, int HD, int REP>
  int run() const {
    paged_prefill_kernel<F, HD, REP><<<dim3(n_kv, (T + NW - 1) / NW, B), NW * 32, 0, st>>>(
        static_cast<const float*>(q), kp, vp, ksp, vsp, static_cast<const int*>(bt),
        static_cast<const int*>(lens), ck, cv, cks, cvs, static_cast<float*>(out), n_kv, page,
        max_pages, T, 1.0f / sqrtf((float)HD));
    return (int)cudaGetLastError();
  }
};

}  // namespace

// fmt: 0 = bf16, 1 = int8, 2 = fp8 e4m3, 3 = NVFP4 (ksp, vsp, cks, cvs: the scale bytes; else unused).
extern "C" int paged_attention_prefill(int fmt, int hd, int rep, const void* q, const void* kp,
                                       const void* vp, const void* ksp, const void* vsp,
                                       const void* bt, const void* lens, const void* ck,
                                       const void* cv, const void* cks, const void* cvs, void* out,
                                       int B, int T, int n_kv, int page, int max_pages,
                                       void* stream) {
  return kvc::dispatch(fmt, hd, rep, Launch{q, kp, vp, ksp, vsp, bt, lens, ck, cv, cks, cvs, out, B,
                                            T, n_kv, page, max_pages,
                                            static_cast<cudaStream_t>(stream)});
}
