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
// tensor cores as it is; gs multiplies the f32 result once. A code decodes
// by a byte-permute table lookup into bf16 and one bf16x2 multiply. The codes are
// the natural E2M1 codes (sign | index into 0, .5, 1, 1.5, 2, 3, 4, 6): no
// remapped slots, no K-lane permutation. Layout ("nvfp4wo" / "mxfp4wo",
// ops/cuda/qmm_wo.py): packed [O, Kp/2] uint8, byte i of a row =
// code(k = 2i) | code(k = 2i + 1) << 4; scales [O, Kp/16] e4m3 bytes or
// [O, Kp/32] int8 exponents in [-126, 127]. A 16-byte load holds 32 codes:
// two NVFP4 blocks or one MXFP4 block. What bounds the kernel and what the
// main loops do about it: qmm_wo_common.cuh.

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

  // Bytes of the bf16 magnitudes of the 8 E2M1 codes 0, .5, 1, 1.5, 2, 3, 4, 6 (0x0000, 0x3F00, 0x3F80,
  // 0x3FC0, 0x4000, 0x4040, 0x4080, 0x40C0), low bytes and high bytes as 8-byte tables for __byte_perm
  static constexpr uint32_t LO0 = 0xC0800000u, LO1 = 0xC0804000u, HI0 = 0x3F3F3F00u, HI1 = 0x40404040u;

  // four codes (nibbles of `sel`, sign bits cleared) -> their magnitudes as two bf16 pairs
  static __device__ __forceinline__ void magnitudes(uint32_t sel, uint32_t& p01, uint32_t& p23) {
    const uint32_t lo = __byte_perm(LO0, LO1, sel), hi = __byte_perm(HI0, HI1, sel);
    p01 = __byte_perm(lo, hi, 0x5140);
    p23 = __byte_perm(lo, hi, 0x7362);
  }

  static __device__ __forceinline__ uint32_t times(uint32_t pair, __nv_bfloat162 sc) {
    __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&pair), sc);
    return *reinterpret_cast<uint32_t*>(&v);
  }

  // word q: k = 8q + i in nibble i, low nibble first; scale block q / 2 (NVFP4) or the chunk's (MXFP4).
  // Each code's magnitude is looked up by a byte permute, its sign (nibble bit 3) set in bit 15 of
  // its bf16, and the pair multiplied by the scale in bf16: code x scale has at most 6 significant
  // bits, so the product is exact (E2M1 x E4M3 is at least 2^-10; an MXFP4 product below 2^-126
  // would be a bf16 subnormal).
  static __device__ __forceinline__ uint4 octet(const Raw& r, int q) {
    float sc;
    if (MX) {
      const int e = max(((int32_t)(r.s << 24)) >> 24, -126);
      sc = __uint_as_float((uint32_t)(e + 127) << 23);
    } else {
      sc = wo::e4m3_to_float(q < 2 ? r.s & 0xFFu : (r.s >> 8) & 0xFFu);
    }
    const __nv_bfloat162 sc2 = __float2bfloat162_rn(sc);  // exact: a power of two, or an e4m3 value
    const uint32_t v = q == 0 ? r.v.x : q == 1 ? r.v.y : q == 2 ? r.v.z : r.v.w;
    const uint32_t idx = v & 0x77777777u;
    uint32_t p01, p23, p45, p67;
    magnitudes(idx, p01, p23);
    magnitudes(idx >> 16, p45, p67);
    p01 |= ((v << 12) & 0x8000u) | ((v << 24) & 0x80000000u);  // signs of codes 0, 1: bits 3, 7
    p23 |= ((v << 4) & 0x8000u) | ((v << 16) & 0x80000000u);   // 11, 15
    p45 |= ((v >> 4) & 0x8000u) | ((v << 8) & 0x80000000u);    // 19, 23
    p67 |= ((v >> 12) & 0x8000u) | (v & 0x80000000u);          // 27, 31
    return make_uint4(times(p01, sc2), times(p23, sc2), times(p45, sc2), times(p67, sc2));
  }
};

template <bool MX>
int run(const void* x, const void* w, const void* s, const void* gs, void* y, int N, int K, int O,
        int Kp, void* ws, void* counters, int n_split, void* stream) {
  Fp4Dec<MX> dec{static_cast<const uint8_t*>(w), static_cast<const uint8_t*>(s), Kp / 2,
                 Kp / (MX ? 32 : 16)};
  return (int)wo::launch<128, 128, 2, 4, 0, Fp4Dec<MX>>(
      x, dec, nullptr, nullptr, static_cast<const float*>(gs), y, N, K, O, Kp, static_cast<float*>(ws),
      static_cast<int*>(counters), n_split, static_cast<cudaStream_t>(stream));
}

}  // namespace fp4wo

// x [N, K] bf16 (K % 8 == 0, Kp - 64 < K <= Kp), w [O, Kp/2] uint8, s [O, Kp/16] e4m3 bytes
// (mx = 0) or [O, Kp/32] int8 exponents (mx = 1), gs one f32 on the device or null, y [N, O] bf16;
// ws, counters, n_split: the decode route's split over K (qmm_wo_common.cuh `launch`).
extern "C" int fp4_wo_gemm(const void* x, const void* w, const void* s, const void* gs, void* y,
                           int N, int K, int O, int Kp, int mx, void* ws, void* counters, int n_split,
                           void* stream) {
  return mx ? fp4wo::run<true>(x, w, s, gs, y, N, K, O, Kp, ws, counters, n_split, stream)
            : fp4wo::run<false>(x, w, s, gs, y, N, K, O, Kp, ws, counters, n_split, stream);
}
