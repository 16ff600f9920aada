// Weight-only one-byte GEMM for Hopper (sm_90a): bf16 activations x int8 or
// e4m3 weights, the scale (per tensor or per output channel) on the output.
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/qmm.py qmm_int8
// (_int8_kernel) and qmm_fp8 (_fp8_kernel).
//
//   y[n, o] = scale[o] * sum_k x[n, k] * q[o, k]   (f32 sum over the whole K)
//
// Both byte formats are exact in bf16 (int8: 8 significant bits; e4m3: 4),
// so the weights decode to bf16 in shared memory and the products run on the
// tensor cores; e4m3 decodes by bit manipulation (wo::e4m3_to_float, all 256
// codes). Layout: q [O, K] as `compress_weight` makes it ("int8" / "fp8"),
// K a multiple of 16; scale [O] f32 (the wrapper broadcasts a scalar). What
// bounds the kernel and what the main loop does about it: qmm_wo_common.cuh.

#include "qmm_wo_common.cuh"

namespace bytewo {  // named: the decoders are template arguments of a __global__ function

template <bool FP8>
struct ByteDec {
  static constexpr int EPC = 16;
  struct Raw {
    uint4 v;
  };
  const uint8_t* w;
  int K;

  __device__ __forceinline__ Raw load(int o, int chunk) const {
    Raw r;
    r.v = chunk * 16 < K ? *reinterpret_cast<const uint4*>(w + (size_t)o * K + (size_t)chunk * 16)
                         : make_uint4(0u, 0u, 0u, 0u);
    return r;
  }

  static __device__ __forceinline__ float value(uint32_t w, int i) {
    if (FP8) return wo::e4m3_to_float((w >> (8 * i)) & 0xFFu);
    return (float)(((int32_t)(w << (24 - 8 * i))) >> 24);  // signed byte i
  }

  static __device__ __forceinline__ void store(const Raw& r, wo::bf16* dst) {
    const uint32_t v[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // words 2h, 2h + 1: k = 8h .. 8h + 7
      uint4 out;
      out.x = wo::pack_bf16(value(v[2 * h], 0), value(v[2 * h], 1));
      out.y = wo::pack_bf16(value(v[2 * h], 2), value(v[2 * h], 3));
      out.z = wo::pack_bf16(value(v[2 * h + 1], 0), value(v[2 * h + 1], 1));
      out.w = wo::pack_bf16(value(v[2 * h + 1], 2), value(v[2 * h + 1], 3));
      *reinterpret_cast<uint4*>(dst + 8 * h) = out;
    }
  }
};

template <bool FP8>
int run(const void* x, const void* w, const void* scale, void* y, int N, int K, int O, void* stream) {
  ByteDec<FP8> dec{static_cast<const uint8_t*>(w), K};
  return (int)wo::launch<128, 128, 2, 4, 0, ByteDec<FP8>>(x, dec, nullptr,
                                                          static_cast<const float*>(scale), nullptr, y,
                                                          N, K, O, K, static_cast<cudaStream_t>(stream));
}

}  // namespace bytewo

// x [N, K] bf16, w [O, K] int8 (fp8 = 0) or e4m3 (fp8 = 1) with K % 16 == 0, scale [O] f32, y [N, O] bf16.
extern "C" int byte_wo_gemm(const void* x, const void* w, const void* scale, void* y, int N, int K,
                            int O, int fp8, void* stream) {
  return fp8 ? bytewo::run<true>(x, w, scale, y, N, K, O, stream)
             : bytewo::run<false>(x, w, scale, y, N, K, O, stream);
}
