// Shared pieces of the KV-cache attention kernels for Hopper (sm_90a):
// kv_decode_attention.cu (dense cache), paged_attention_decode.cu and
// paged_attention_prefill.cu (page pool behind a block table).
//
// All three are GQA attention of a few query rows over K/V rows kept in
// STORED form, with an online softmax in f32 that keeps the reference's
// constants: the running max starts at -1e30 and the denominator is clamped
// at 1e-30, so a sequence with no live row gives exactly 0.
//
// Rows<T, HD> (the paged kernels' CUDA-core walk): one warp reads one K/V
// row at a time; a lane holds E = head_dim / 32 consecutive dims of the row
// (one coalesced read of the warp), of each of the REP query heads that
// share the row's kv head, and of their accumulators; a score is a warp-wide
// sum. Rows<T, HD> turns a stored row into f32:
//   __nv_bfloat16, int8_t, __nv_fp8_e4m3   HD elements a row, converted
//   Fp4   NVFP4: HD/2 plane-packed bytes (byte j = code[j] | code[j + HD/2]
//         << 4) and, in a parallel array, HD/16 E4M3 block-scale bytes (block
//         b scales dims [16b, 16b + 16)). The lane that owns dims d..d+E-1
//         reads bytes (d mod HD/2).. and takes the low nibbles for d < HD/2,
//         the high ones above, and scale byte d / 16: lanes l and l + 16
//         share their bytes. Decoded exactly (fp_decode.cuh); the f32 global
//         scale stays with the caller.
//
// Lane16<T, HD> (the split decode of kv_decode_attention.cu): a group of
// HD/16 lanes reads one row, lane li holding 16 of its dims: 16li .. 16li +
// 15 of a bf16 row (two 16-byte loads), of an int8 or e4m3 row (one), and of
// NVFP4 dims 8li .. 8li + 7 and HD/2 + 8li .. (8 plane bytes, two scale
// bytes). `fetch` only loads, so that several rows' loads are in flight
// before `decode` turns them into f32.
//
// decode16 / decode16_fp4 turn those stored chunks into 16 f32 values,
// exactly; Lane16 and the tensor-core prefill's tile stage
// (paged_attention_prefill.cu, which packs them into bf16) share them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// 16 int8 codes or e4m3 values (byte e is value e) -> f[0..15]
template <typename T>
__device__ __forceinline__ void decode16(const uint4& raw, float (&f)[16]) {
  static_assert(sizeof(T) == 1, "one-byte stored forms");
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = fpdec::s8_to_float(w[e / 4] ^ 0x80808080u, e % 4);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float2 p = fpdec::e4m3x2_to_float2(w[k / 2] >> (16 * (k % 2)));
      f[2 * k] = p.x;
      f[2 * k + 1] = p.y;
    }
  }
}

// 8 NVFP4 plane bytes (byte e holds the E2M1 codes of dim d + e in its low
// nibble and of dim HD/2 + d + e in its high one) under their two E4M3 scale
// bytes (sc: the low dims' block byte | the high dims' << 8) -> f[e] the low
// dims, f[8 + e] the high ones
__device__ __forceinline__ void decode16_fp4(const uint2& planes, uint32_t sc, float (&f)[16]) {
  const float lo = fpdec::e4m3_to_float(sc & 0xffu), hi = fpdec::e4m3_to_float(sc >> 8);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t byte = ((e < 4 ? planes.x : planes.y) >> (8 * (e % 4))) & 0xffu;
    f[e] = fpdec::e2m1_to_float(byte) * lo;
    f[8 + e] = fpdec::e2m1_to_float(byte >> 4) * hi;
  }
}

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

// One lane's 16 dims of a stored row (Lane16 above): fetch -> Raw, decode ->
// f32, dim(e) the row dim of value e.
template <typename T, int HD>
struct Lane16 {  // int8 codes and e4m3 values
  static_assert(sizeof(T) == 1, "one-byte stored forms");
  using Raw = uint4;
  const uint8_t* p;
  int li;
  __device__ __forceinline__ Lane16(const void* base, const void*, int li_)
      : p(static_cast<const uint8_t*>(base) + li_ * 16), li(li_) {}
  __device__ __forceinline__ int dim(int e) const { return 16 * li + e; }
  __device__ __forceinline__ Raw fetch(size_t row) const {
    return __ldg(reinterpret_cast<const uint4*>(p + row * HD));
  }
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void decode(const Raw& r, float (&f)[16]) const { decode16<T>(r, f); }
};

template <int HD>
struct Lane16<__nv_bfloat16, HD> {
  struct Raw {
    uint4 a, b;
  };
  const __nv_bfloat16* p;
  int li;
  __device__ __forceinline__ Lane16(const void* base, const void*, int li_)
      : p(static_cast<const __nv_bfloat16*>(base) + li_ * 16), li(li_) {}
  __device__ __forceinline__ int dim(int e) const { return 16 * li + e; }
  __device__ __forceinline__ Raw fetch(size_t row) const {
    const uint4* s = reinterpret_cast<const uint4*>(p + row * HD);
    return {__ldg(s), __ldg(s + 1)};
  }
  static __device__ __forceinline__ Raw zero() { return {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)}; }
  __device__ __forceinline__ void decode(const Raw& r, float (&f)[16]) const {
    const uint32_t w[8] = {r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

template <int HD>
struct Lane16<Fp4, HD> {
  struct Raw {
    uint2 planes;
    uint32_t scales;  // the low block's byte | the high block's << 8
  };
  const uint8_t* p;
  const uint8_t* s;
  int li;
  __device__ __forceinline__ Lane16(const void* base, const void* scales, int li_)
      : p(static_cast<const uint8_t*>(base) + li_ * 8), s(static_cast<const uint8_t*>(scales) + li_ / 2), li(li_) {}
  __device__ __forceinline__ int dim(int e) const { return e < 8 ? 8 * li + e : HD / 2 + 8 * li + e - 8; }
  __device__ __forceinline__ Raw fetch(size_t row) const {
    const uint8_t* sr = s + row * (HD / 16);
    return {__ldg(reinterpret_cast<const uint2*>(p + row * (HD / 2))),
            (uint32_t)__ldg(sr) | ((uint32_t)__ldg(sr + HD / 32) << 8)};
  }
  static __device__ __forceinline__ Raw zero() { return {make_uint2(0u, 0u), 0u}; }
  __device__ __forceinline__ void decode(const Raw& r, float (&f)[16]) const {
    decode16_fp4(r.planes, r.scales, f);
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
