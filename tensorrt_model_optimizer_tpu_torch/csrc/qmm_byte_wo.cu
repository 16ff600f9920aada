// Weight-only one-byte GEMM for Hopper (sm_90a): bf16 activations x int8 or
// e4m3 weights, the scale (per tensor or per output channel) on the output.
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/qmm.py qmm_int8
// (_int8_kernel) and qmm_fp8 (_fp8_kernel).
//
//   y[n, o] = scale[o] * sum_k x[n, k] * q[o, k]   (f32 sum over the whole K)
//
// Both byte formats are exact in bf16 (int8: 8 significant bits; e4m3: 4),
// so the weights decode to bf16 and the products run on the tensor cores;
// e4m3 decodes by the hardware's e4m3x2 conversion (all 256 codes), int8 by
// a byte permute and an add. Layout: q [O, K] as `compress_weight` makes it
// ("int8" / "fp8"), K a multiple of 16; scale [O] f32 (the wrapper
// broadcasts a scalar). What bounds the kernel and what the main loops do
// about it: qmm_wo_common.cuh.

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

  // word -> its four values as two bf16 pairs, exactly: int8 by a byte
  // permute and an add (fpdec::s8_to_float), e4m3 by the hardware's e4m3x2
  // conversion
  static __device__ __forceinline__ void word_pairs(uint32_t w, uint32_t* p) {
    if (FP8) {
      const float2 lo = fpdec::e4m3x2_to_float2(w), hi = fpdec::e4m3x2_to_float2(w >> 16);
      p[0] = wo::pack_bf16(lo.x, lo.y);
      p[1] = wo::pack_bf16(hi.x, hi.y);
    } else {
      const uint32_t f = w ^ 0x80808080u;
      p[0] = wo::pack_bf16(fpdec::s8_to_float(f, 0), fpdec::s8_to_float(f, 1));
      p[1] = wo::pack_bf16(fpdec::s8_to_float(f, 2), fpdec::s8_to_float(f, 3));
    }
  }

  // words 2q, 2q + 1: k = 8q .. 8q + 7
  static __device__ __forceinline__ uint4 octet(const Raw& r, int q) {
    uint32_t p[4];
    word_pairs(q == 0 ? r.v.x : r.v.z, p);
    word_pairs(q == 0 ? r.v.y : r.v.w, p + 2);
    return make_uint4(p[0], p[1], p[2], p[3]);
  }
};

template <bool FP8>
int run(const void* x, const void* w, const void* scale, void* y, int N, int K, int O, void* ws,
        void* counters, int n_split, void* stream) {
  ByteDec<FP8> dec{static_cast<const uint8_t*>(w), K};
  return (int)wo::launch<128, 128, 2, 4, 0, ByteDec<FP8>>(
      x, dec, nullptr, static_cast<const float*>(scale), nullptr, y, N, K, O, K, static_cast<float*>(ws),
      static_cast<int*>(counters), n_split, static_cast<cudaStream_t>(stream));
}

}  // namespace bytewo

// x [N, K] bf16, w [O, K] int8 (fp8 = 0) or e4m3 (fp8 = 1) with K % 16 == 0, scale [O] f32, y [N, O] bf16;
// ws, counters, n_split: the decode route's split over K (qmm_wo_common.cuh `launch`).
extern "C" int byte_wo_gemm(const void* x, const void* w, const void* scale, void* y, int N, int K,
                            int O, int fp8, void* ws, void* counters, int n_split, void* stream) {
  return fp8 ? bytewo::run<true>(x, w, scale, y, N, K, O, ws, counters, n_split, stream)
             : bytewo::run<false>(x, w, scale, y, N, K, O, ws, counters, n_split, stream);
}
