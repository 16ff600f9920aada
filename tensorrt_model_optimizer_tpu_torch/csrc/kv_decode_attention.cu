// One-token GQA decode attention over a stored-form, kv-head-major KV cache
// (bf16, int8 or fp8 e4m3 codes), for Hopper (sm_90a).
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/kv_attention.py
// kv_decode_attention (_decode_kernel), formats bf16 / int8 / fp8.
//
//   q    [B, n_kv*rep, hd] f32, pre-scaled (k's global scale / sqrt(hd))
//   k, v [B, n_kv, S, hd] stored codes; rows < pos are valid
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
// Known limit: B * n_kv = 64 blocks leave half of the 132 SMs idle; a split
// over S (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;  // warps per block
constexpr int UNROLL = 4;

// E consecutive stored elements -> f32 (E = head_dim / 32 per lane)
template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* f) {
  if constexpr (E % 2 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + e));
      f[e] = t.x;
      f[e + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = __bfloat162float(p[e]);
  }
}
template <int E>
__device__ __forceinline__ void load_row(const int8_t* p, float* f) {
  if constexpr (E == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = (float)p[e];
  }
}
template <int E>
__device__ __forceinline__ void load_row(const __nv_fp8_e4m3* p, float* f) {
#pragma unroll
  for (int e = 0; e < E; ++e) f[e] = float(p[e]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int HD, int REP>
__global__ void __launch_bounds__(NW * 32) kv_decode_kernel(const float* __restrict__ q,
                                                            const T* __restrict__ kc,
                                                            const T* __restrict__ vc,
                                                            const float* __restrict__ kn,
                                                            const float* __restrict__ vn,
                                                            float* __restrict__ out, int n_kv,
                                                            int S, int pos) {
  constexpr int E = HD / 32;  // dims per lane
  __shared__ float sm_m[NW][REP], sm_l[NW][REP];
  __shared__ float sm_acc[NW][REP][HD];
  const int g = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = (size_t)b * n_kv + g;
  const float* qb = q + head * REP * HD + lane * E;
  const T* kb = kc + head * S * HD + lane * E;
  const T* vb = vc + head * S * HD + lane * E;

  float qr[REP][E], acc[REP][E], m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[r][e] = qb[r * HD + e];
      acc[r][e] = 0.f;
    }
    m[r] = -1e30f;
    l[r] = 0.f;
  }

  for (int base = warp * UNROLL; base < pos; base += NW * UNROLL) {
    float kr[UNROLL][E], vr[UNROLL][E];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u < pos) {
        load_row<E>(kb + (size_t)(base + u) * HD, kr[u]);
        load_row<E>(vb + (size_t)(base + u) * HD, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u >= pos) break;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qr[r][e] * kr[u][e];
        const float s = warp_sum(d);
        const float m_new = fmaxf(m[r], s);
        const float corr = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        l[r] = l[r] * corr + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = acc[r][e] * corr + p * vr[u][e];
        m[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][r][lane * E + e] = acc[r][e];
  }
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
    float M = -1e30f;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, A[E];
#pragma unroll
    for (int e = 0; e < E; ++e) A[e] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][r] - M);
      L += sm_l[w][r] * c;
#pragma unroll
      for (int e = 0; e < E; ++e) A[e] += sm_acc[w][r][lane * E + e] * c;
    }
    // the current token, folded in last
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) d += qr[r][e] * knr[e];
    const float s = warp_sum(d);
    const float m2 = fmaxf(M, s);
    const float corr = expf(M - m2);
    const float p = expf(s - m2);
    L = fmaxf(L * corr + p, 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e)
      out[(head * REP + r) * HD + lane * E + e] = (A[e] * corr + p * vnr[e]) / L;
  }
}

template <typename T, int HD>
int launch(int rep, const void* q, const void* k, const void* v, const void* kn, const void* vn,
           void* out, int B, int n_kv, int S, int pos, cudaStream_t st) {
  dim3 grid(n_kv, B);
#define KV_CASE(R)                                                                          \
  case R:                                                                                   \
    kv_decode_kernel<T, HD, R><<<grid, NW * 32, 0, st>>>(                                   \
        static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v),   \
        static_cast<const float*>(kn), static_cast<const float*>(vn),                       \
        static_cast<float*>(out), n_kv, S, pos);                                            \
    break;
  switch (rep) {
    KV_CASE(1)
    KV_CASE(2)
    KV_CASE(4)
    KV_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KV_CASE
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, int rep, const void* q, const void* k, const void* v, const void* kn,
              const void* vn, void* out, int B, int n_kv, int S, int pos, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(rep, q, k, v, kn, vn, out, B, n_kv, S, pos, st);
    case 64:
      return launch<T, 64>(rep, q, k, v, kn, vn, out, B, n_kv, S, pos, st);
    case 128:
      return launch<T, 128>(rep, q, k, v, kn, vn, out, B, n_kv, S, pos, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fmt: 0 = bf16, 1 = int8, 2 = fp8 e4m3.
extern "C" int kv_decode_attention(int fmt, int hd, int rep, const void* q, const void* k,
                                   const void* v, const void* kn, const void* vn, void* out, int B,
                                   int n_kv, int S, int pos, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0:
      return launch_hd<__nv_bfloat16>(hd, rep, q, k, v, kn, vn, out, B, n_kv, S, pos, st);
    case 1:
      return launch_hd<int8_t>(hd, rep, q, k, v, kn, vn, out, B, n_kv, S, pos, st);
    case 2:
      return launch_hd<__nv_fp8_e4m3>(hd, rep, q, k, v, kn, vn, out, B, n_kv, S, pos, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
