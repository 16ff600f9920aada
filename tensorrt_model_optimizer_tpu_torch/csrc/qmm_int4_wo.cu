// Weight-only INT4 GEMM for Hopper (sm_90a): bf16 activations x int4
// block-128 or block-64 weights (NF4_WEIGHT_ONLY_CFG, which JAX quantizes
// and packs as INT4 at 64-blocks), f32 block scales.
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/qmm.py qmm_int4_bd2
// (_int4_bd2_kernel / _int4_bd3_kernel), qmm_int4 (_int4_kernel),
// qmm_int4_word (_int4_word_kernel) and qmm_int4_word2 (_int4_word2_kernel):
// one function in four TPU layouts.
//
//   y[n, o] = sum_b s[b, o] * (sum_{k in block b} x[n, k] * q[o, k])   (f32, blocks in order)
//
// Each block's sum is taken on the tensor cores in f32, multiplied by the
// block's scale and added to the result (__fmul_rn / __fadd_rn, so the plain
// version can repeat the order). The codes are two's complement: there is no
// +128 / -136 offset and no side dot. Layout ("int4wo", ops/cuda/qmm_wo.py):
// packed [O, Kp/2] uint8, rows contiguous in K, inside each 8-group of k
// byte i = nib(k_i) | nib(k_{i+4}) << 4 (the byte order of "int4a8"), so a
// 32-bit word decodes by two byte permutes into the bf16 pairs of 8
// consecutive k (`octet`); scales [Kp/B, O] f32 for blocks of B = 128 or 64
// (Kp a multiple of 128 either way). At decode the split over K is in whole
// 128-blocks, so a split's partial is the sum of its blocks' scaled sums, in
// order, and the splits add in order; at B = 64 a thread reads 16 k of each
// half of a 128-block (`load_halves`), so each MMA sums one 64-block. What bounds the kernel
// and what the main loops do about it: qmm_wo_common.cuh.

#include "qmm_wo_common.cuh"

namespace int4wo {  // named: the decoders are template arguments of a __global__ function

struct Int4Dec {
  static constexpr int EPC = 32;
  struct Raw {
    uint4 v;
  };
  const uint8_t* w;
  int row_bytes;  // Kp / 2

  __device__ __forceinline__ Raw load(int o, int chunk) const {
    Raw r;
    r.v = chunk * 16 < row_bytes
              ? *reinterpret_cast<const uint4*>(w + (size_t)o * row_bytes + (size_t)chunk * 16)
              : make_uint4(0u, 0u, 0u, 0u);
    return r;
  }

  // k 128 kb + 16 t .. + 15 (words 0, 1) and 128 kb + 64 + 16 t .. + 15
  // (words 2, 3): 8 bytes from each half of 128-block kb
  __device__ __forceinline__ Raw load_halves(int o, int kb, int t) const {
    const uint8_t* p = w + (size_t)o * row_bytes + (size_t)kb * 64 + 8 * t;
    const uint2 a = *reinterpret_cast<const uint2*>(p), b = *reinterpret_cast<const uint2*>(p + 32);
    Raw r;
    r.v = make_uint4(a.x, a.y, b.x, b.y);
    return r;
  }

  // bf16 with bits 0x4300 | u is 128 + u (u < 128), so a nibble u = code ^ 8
  // placed in the mantissa and 136 subtracted gives the code, exactly: a byte
  // permute, a shift, a mask-or and a bf16x2 subtract per two codes
  static __device__ __forceinline__ uint32_t nib_pair(uint32_t bits) {
    const uint32_t v = (bits & 0x000F000Fu) | 0x43004300u;
    __nv_bfloat162 b = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), __floats2bfloat162_rn(136.f, 136.f));
    return *reinterpret_cast<uint32_t*>(&b);
  }

  // word q: k = 8q + i in the low nibble of byte i, 8q + 4 + i in its high one
  static __device__ __forceinline__ uint4 octet(const Raw& r, int q) {
    const uint32_t w = (q == 0 ? r.v.x : q == 1 ? r.v.y : q == 2 ? r.v.z : r.v.w) ^ 0x88888888u;
    const uint32_t b01 = __byte_perm(w, 0u, 0x4140), b23 = __byte_perm(w, 0u, 0x4342);  // bytes 0|1, 2|3 as halves
    return make_uint4(nib_pair(b01), nib_pair(b23), nib_pair(b01 >> 4), nib_pair(b23 >> 4));
  }
};

}  // namespace int4wo

// x [N, K] bf16 (K % 8 == 0), w [O, Kp / 2] uint8 (Kp % 128 == 0), s [Kp / block, O] f32, y [N, O]
// bf16, block 128 or 64; ws, counters, n_split: the decode route's split over K (qmm_wo_common.cuh `launch`).
extern "C" int int4_wo_gemm(const void* x, const void* w, const void* s, void* y, int N, int K, int O, int Kp,
                            int block, void* ws, void* counters, int n_split, void* stream) {
  if (Kp % 128 || (block != 128 && block != 64)) return (int)cudaErrorInvalidValue;
  int4wo::Int4Dec dec{static_cast<const uint8_t*>(w), Kp / 2};
  const float* sp = static_cast<const float*>(s);
  float* wsp = static_cast<float*>(ws);
  int* cp = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block == 64)
    return (int)wo::launch<128, 64, 4, 2, 64, int4wo::Int4Dec>(x, dec, sp, nullptr, nullptr, y, N, K, O, Kp, wsp, cp,
                                                               n_split, st);
  return (int)wo::launch<128, 64, 4, 2, 128, int4wo::Int4Dec>(x, dec, sp, nullptr, nullptr, y, N, K, O, Kp, wsp, cp,
                                                              n_split, st);
}
