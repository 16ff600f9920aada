// Weight-only FP4 GEMM for Hopper (sm_90a): bf16 activations x E2M1 weights
// with a scale per K block; one source for NVFP4 (16-wide blocks, e4m3
// scales, f32 global scale) and MXFP4 (32-wide blocks, power-of-two scales
// stored as int8 exponents, no global scale).
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/qmm.py qmm_nvfp4_word2
// (_nvfp4_word2_kernel, which also serves MXFP4 with block_size 32),
// qmm_nvfp4 (_nvfp4_kernel), qmm_nvfp4_perm, qmm_nvfp4_word
// (_nvfp4_word_kernel) and qmm_nvfp4_bd4: one function in five TPU layouts.
//
//   y[n, o] = gs * sum_k x[n, k] * (e2m1[o, k] * s[o, k / bsz])   (f32 sum)
//
// e2m1 x e4m3 (or x 2^e) has at most 6 significant bits, so the product is
// exact in bf16 (the JAX kernels rely on the same fact) and goes to the
// tensor cores as it is; gs multiplies the f32 result once. The codes are
// the natural E2M1 codes (sign | index into 0, .5, 1, 1.5, 2, 3, 4, 6): no
// remapped slots, no K-lane permutation. Layout ("nvfp4wo" / "mxfp4wo",
// ops/cuda/qmm_wo.py): packed [O, Kp/2] uint8, byte i of a row =
// code(k = 2i) | code(k = 2i + 1) << 4; scales [O, Kp/16] e4m3 bytes or
// [O, Kp/32] int8 exponents in [-126, 127]. A 16-byte load holds 32 codes:
// two NVFP4 blocks or one MXFP4 block. What bounds the kernel and what the
// main loop does about it: qmm_wo_common.cuh.

#include "qmm_wo_common.cuh"

namespace fp4wo {  // named: the decoders are template arguments of a __global__ function

template <bool MX>
struct Fp4Dec {
  static constexpr int EPC = 32;
  struct Raw {
    uint4 v;
    uint32_t s;
  };
  const uint8_t* w;
  const uint8_t* s;
  int row_bytes;   // Kp / 2
  int row_scales;  // Kp / 16 (NVFP4) or Kp / 32 (MXFP4)

  __device__ __forceinline__ Raw load(int o, int chunk) const {
    Raw r;
    if (chunk * 16 < row_bytes) {
      r.v = *reinterpret_cast<const uint4*>(w + (size_t)o * row_bytes + (size_t)chunk * 16);
      const uint8_t* sp = s + (size_t)o * row_scales;
      r.s = MX ? (uint32_t)sp[chunk] : (uint32_t) * reinterpret_cast<const uint16_t*>(sp + 2 * chunk);
    } else {
      r.v = make_uint4(0u, 0u, 0u, 0u);
      r.s = 0u;
    }
    return r;
  }

  static __device__ __forceinline__ float e2m1(uint32_t c) { return fpdec::e2m1_to_float(c); }

  static __device__ __forceinline__ void store(const Raw& r, wo::bf16* dst) {
    float s0, s1;
    if (MX) {
      const int e = max(((int32_t)(r.s << 24)) >> 24, -126);
      s0 = s1 = __uint_as_float((uint32_t)(e + 127) << 23);
    } else {
      s0 = wo::e4m3_to_float(r.s & 0xFFu);
      s1 = wo::e4m3_to_float((r.s >> 8) & 0xFFu);
    }
    const uint32_t v[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // word j: k = 8j .. 8j + 7, low nibble first
      const float sc = j < 2 ? s0 : s1;
      uint4 out;
      out.x = wo::pack_bf16(e2m1(v[j]) * sc, e2m1(v[j] >> 4) * sc);
      out.y = wo::pack_bf16(e2m1(v[j] >> 8) * sc, e2m1(v[j] >> 12) * sc);
      out.z = wo::pack_bf16(e2m1(v[j] >> 16) * sc, e2m1(v[j] >> 20) * sc);
      out.w = wo::pack_bf16(e2m1(v[j] >> 24) * sc, e2m1(v[j] >> 28) * sc);
      *reinterpret_cast<uint4*>(dst + 8 * j) = out;
    }
  }
};

template <bool MX>
int run(const void* x, const void* w, const void* s, const void* gs, void* y, int N, int K, int O,
        int Kp, void* stream) {
  Fp4Dec<MX> dec{static_cast<const uint8_t*>(w), static_cast<const uint8_t*>(s), Kp / 2,
                 Kp / (MX ? 32 : 16)};
  return (int)wo::launch<128, 128, 2, 4, 0, Fp4Dec<MX>>(x, dec, nullptr, nullptr,
                                                        static_cast<const float*>(gs), y, N, K, O, Kp,
                                                        static_cast<cudaStream_t>(stream));
}

}  // namespace fp4wo

// x [N, K] bf16 (K % 8 == 0, Kp - 64 < K <= Kp), w [O, Kp/2] uint8, s [O, Kp/16] e4m3 bytes
// (mx = 0) or [O, Kp/32] int8 exponents (mx = 1), gs one f32 on the device or null, y [N, O] bf16.
extern "C" int fp4_wo_gemm(const void* x, const void* w, const void* s, const void* gs, void* y,
                           int N, int K, int O, int Kp, int mx, void* stream) {
  return mx ? fp4wo::run<true>(x, w, s, gs, y, N, K, O, Kp, stream)
            : fp4wo::run<false>(x, w, s, gs, y, N, K, O, Kp, stream);
}
