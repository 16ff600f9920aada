// Shared pieces of the KV-cache attention kernels for Hopper (sm_90a):
// kv_decode_attention.cu (dense cache), paged_attention_decode.cu and
// paged_attention_prefill.cu (page pool behind a block table).
//
// All three are GQA attention of a few query rows over K/V rows kept in
// STORED form, with an online softmax in f32 that keeps the reference's
// constants: the running max starts at -1e30 and the denominator is clamped
// at 1e-30, so a sequence with no live row gives exactly 0.
//
// One warp reads one K/V row at a time: a lane holds E = head_dim / 32
// consecutive dims of the row (one coalesced read of the warp), of each of
// the REP query heads that share the row's kv head, and of their
// accumulators; a score is a warp-wide sum. Rows<T, HD> turns a stored row
// into f32:
//   __nv_bfloat16, int8_t, __nv_fp8_e4m3   HD elements a row, converted
//   Fp4   NVFP4: HD/2 plane-packed bytes (byte j = code[j] | code[j + HD/2]
//         << 4) and, in a parallel array, HD/16 E4M3 block-scale bytes (block
//         b scales dims [16b, 16b + 16)). The lane that owns dims d..d+E-1
//         reads bytes (d mod HD/2).. and takes the low nibbles for d < HD/2,
//         the high ones above, and scale byte d / 16: lanes l and l + 16
//         share their bytes. Decoded exactly (fp_decode.cuh); the f32 global
//         scale stays with the caller.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_decode.cuh"

namespace kvc {

constexpr int NW = 8;      // warps per block
constexpr int UNROLL = 4;  // rows a warp loads before it folds them

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

struct Fp4 {};  // tag of the NVFP4 stored form

// This lane's view of an array of stored rows; `row` counts rows from the
// array's start.
template <typename T, int HD>
struct Rows {
  static constexpr int E = HD / 32;
  const T* p;
  __device__ __forceinline__ Rows(const void* base, const void*, int lane)
      : p(static_cast<const T*>(base) + lane * E) {}
  __device__ __forceinline__ void load(size_t row, float* f) const { load_row<E>(p + row * HD, f); }
};

template <int HD>
struct Rows<Fp4, HD> {
  static constexpr int E = HD / 32;
  const uint8_t* p;
  const uint8_t* s;
  int shift;
  __device__ __forceinline__ Rows(const void* base, const void* scales, int lane)
      : p(static_cast<const uint8_t*>(base) + (lane & 15) * E),
        s(static_cast<const uint8_t*>(scales) + lane * E / 16),
        shift((lane >> 4) * 4) {}
  __device__ __forceinline__ void load(size_t row, float* f) const {
    const uint8_t* b = p + row * (HD / 2);
    uint32_t w;
    if constexpr (E == 4)
      w = *reinterpret_cast<const uint32_t*>(b);
    else if constexpr (E == 2)
      w = *reinterpret_cast<const uint16_t*>(b);
    else
      w = *b;
    w >>= shift;
    const float sc = fpdec::e4m3_to_float(s[row * (HD / 16)]);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = fpdec::e2m1_to_float(w >> (8 * e)) * sc;
  }
};

// A warp's online-softmax state for REP query heads: each lane holds the
// same m and l, and its own E dims of the accumulators.
template <int REP, int E>
struct Softmax {
  float m[REP], l[REP], acc[REP][E];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      m[r] = -1e30f;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
    }
  }

  // fold one K/V row (this lane's E dims of each); the score is q.k * scale
  __device__ __forceinline__ void fold(const float (&q)[REP][E], const float* k, const float* v,
                                       float scale) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d += q[r][e] * k[e];
      const float s = warp_sum(d) * scale;
      const float m_new = fmaxf(m[r], s);
      const float corr = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      l[r] = l[r] * corr + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = acc[r][e] * corr + p * v[e];
      m[r] = m_new;
    }
  }
};

// The block's NW warp states in shared memory, merged by one warp.
template <int REP, int HD>
struct Merge {
  float m[NW][REP], l[NW][REP], acc[NW][REP][HD];

  __device__ __forceinline__ void put(const Softmax<REP, HD / 32>& st, int warp, int lane) {
    constexpr int E = HD / 32;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (lane == 0) {
        m[warp][r] = st.m[r];
        l[warp][r] = st.l[r];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) acc[warp][r][lane * E + e] = st.acc[r][e];
    }
  }

  // after __syncthreads(): head r over all warps (max M, denominator L, this
  // lane's E dims of the accumulator A)
  __device__ __forceinline__ void get(int r, int lane, float& M, float& L,
                                      float (&A)[HD / 32]) const {
    constexpr int E = HD / 32;
    M = -1e30f;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, m[w][r]);
    L = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) A[e] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(m[w][r] - M);
      L += l[w][r] * c;
#pragma unroll
      for (int e = 0; e < E; ++e) A[e] += acc[w][r][lane * E + e] * c;
    }
  }
};

// f.run<T, HD, REP>() for the stored form (0 bf16, 1 int8, 2 fp8 e4m3, 3
// NVFP4), head_dim in {32, 64, 128} and rep in {1, 2, 4, 8}.
template <typename T, int HD, typename F>
int dispatch_rep(int rep, const F& f) {
  switch (rep) {
    case 1:
      return f.template run<T, HD, 1>();
    case 2:
      return f.template run<T, HD, 2>();
    case 4:
      return f.template run<T, HD, 4>();
    case 8:
      return f.template run<T, HD, 8>();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename F>
int dispatch_hd(int hd, int rep, const F& f) {
  switch (hd) {
    case 32:
      return dispatch_rep<T, 32>(rep, f);
    case 64:
      return dispatch_rep<T, 64>(rep, f);
    case 128:
      return dispatch_rep<T, 128>(rep, f);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int dispatch(int fmt, int hd, int rep, const F& f) {
  switch (fmt) {
    case 0:
      return dispatch_hd<__nv_bfloat16>(hd, rep, f);
    case 1:
      return dispatch_hd<int8_t>(hd, rep, f);
    case 2:
      return dispatch_hd<__nv_fp8_e4m3>(hd, rep, f);
    case 3:
      return dispatch_hd<Fp4>(hd, rep, f);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace kvc
