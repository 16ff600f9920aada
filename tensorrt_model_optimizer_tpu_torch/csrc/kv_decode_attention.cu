// One-token GQA decode attention over a stored-form, kv-head-major KV cache
// (bf16, int8 or fp8 e4m3 codes, or plane-packed NVFP4), for Hopper (sm_90a).
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/kv_attention.py
// kv_decode_attention (_decode_kernel), formats bf16 / int8 / fp8 / nvfp4.
//
//   q    [B, n_kv*rep, hd] f32, pre-scaled (k's global scale / sqrt(hd))
//   k, v [B, n_kv, S, hd] stored codes; rows < pos are valid. NVFP4:
//        [B, n_kv, S, hd/2] plane-packed bytes with ks, vs [B, n_kv, S, hd/16]
//        E4M3 block-scale bytes (layout and decode: kv_common.cuh)
//   kn, vn [B, n_kv, hd] f32, the current token's code-domain k/v, folded last
//   out  [B, n_kv*rep, hd] f32 code-domain context (caller applies v's scale)
// with hd in {32, 64, 128} and rep in {1, 2, 4, 8}.
//
// Online softmax in f32 with the reference's constants: running max starts
// at -1e30, and the denominator is clamped at 1e-30.
//
// What bounds it on an H100: the cache bytes. At Llama-3.1-8B, batch 8,
// pos 2048, int8: 8 x 8 x 2048 x 128 x 2 = 33.5 MB per layer, >= 10 us at
// 3.35 TB/s. What this design does about it: one block per (batch, kv head)
// reads each cached row once for all `rep` query heads; it loops only over
// the rows < pos (never the dead rows above, which the TPU's fixed grid
// reads); each warp takes rows in turn with 4-row unrolled loads, a lane
// holding hd/32 dims, so a row is one coalesced read of the warp;
// warps keep private online-softmax state and merge in shared memory.
// NVFP4 rows are 72 bytes where int8 rows are 128: the decode (two integer
// ops and a multiply per element) then weighs more than the bytes.
// Known limit: B * n_kv = 64 blocks leave half of the 132 SMs idle; a split
// over S (flash-decoding) is later work.

#include "kv_common.cuh"

namespace {

using kvc::NW;
using kvc::UNROLL;

template <typename T, int HD, int REP>
__global__ void __launch_bounds__(NW * 32) kv_decode_kernel(
    const float* __restrict__ q, const void* __restrict__ kc, const void* __restrict__ vc,
    const void* __restrict__ ks, const void* __restrict__ vs, const float* __restrict__ kn,
    const float* __restrict__ vn, float* __restrict__ out, int n_kv, int S, int pos) {
  constexpr int E = HD / 32;  // dims per lane
  __shared__ kvc::Merge<REP, HD> sm;
  const int g = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = (size_t)b * n_kv + g;
  const float* qb = q + head * REP * HD + lane * E;
  const kvc::Rows<T, HD> K(kc, ks, lane), V(vc, vs, lane);
  const size_t row0 = head * S;

  float qr[REP][E];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] = qb[r * HD + e];
  }
  kvc::Softmax<REP, E> st;
  st.init();

  for (int base = warp * UNROLL; base < pos; base += NW * UNROLL) {
    float kr[UNROLL][E], vr[UNROLL][E];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u < pos) {
        K.load(row0 + base + u, kr[u]);
        V.load(row0 + base + u, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u >= pos) break;
      st.fold(qr, kr[u], vr[u], 1.f);
    }
  }

  sm.put(st, warp, lane);
  __syncthreads();
  if (warp != 0) return;

  float knr[E], vnr[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    knr[e] = kn[head * HD + lane * E + e];
    vnr[e] = vn[head * HD + lane * E + e];
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float M, L, A[E];
    sm.get(r, lane, M, L, A);
    // the current token, folded in last
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) d += qr[r][e] * knr[e];
    const float s = kvc::warp_sum(d);
    const float m2 = fmaxf(M, s);
    const float corr = expf(M - m2);
    const float p = expf(s - m2);
    L = fmaxf(L * corr + p, 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e)
      out[(head * REP + r) * HD + lane * E + e] = (A[e] * corr + p * vnr[e]) / L;
  }
}

struct Launch {
  const void *q, *k, *v, *ks, *vs, *kn, *vn;
  void* out;
  int B, n_kv, S, pos;
  cudaStream_t st;

  template <typename T, int HD, int REP>
  int run() const {
    kv_decode_kernel<T, HD, REP><<<dim3(n_kv, B), NW * 32, 0, st>>>(
        static_cast<const float*>(q), k, v, ks, vs, static_cast<const float*>(kn),
        static_cast<const float*>(vn), static_cast<float*>(out), n_kv, S, pos);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// fmt: 0 = bf16, 1 = int8, 2 = fp8 e4m3, 3 = NVFP4 (ks, vs: the block-scale bytes; else unused).
extern "C" int kv_decode_attention(int fmt, int hd, int rep, const void* q, const void* k,
                                   const void* v, const void* ks, const void* vs, const void* kn,
                                   const void* vn, void* out, int B, int n_kv, int S, int pos,
                                   void* stream) {
  return kvc::dispatch(fmt, hd, rep, Launch{q, k, v, ks, vs, kn, vn, out, B, n_kv, S, pos,
                                            static_cast<cudaStream_t>(stream)});
}
