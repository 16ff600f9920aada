// Weight-only INT4 GEMM for Hopper (sm_90a): bf16 activations x int4
// block-128 weights, f32 block scales.
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/qmm.py qmm_int4_bd2
// (_int4_bd2_kernel / _int4_bd3_kernel), qmm_int4 (_int4_kernel),
// qmm_int4_word (_int4_word_kernel) and qmm_int4_word2 (_int4_word2_kernel):
// one function in four TPU layouts.
//
//   y[n, o] = sum_b s[b, o] * (sum_{k in block b} x[n, k] * q[o, k])   (f32, blocks in order)
//
// Each 128-block's sum is taken on the tensor cores in f32, multiplied by the
// block's scale and added to the result (__fmul_rn / __fadd_rn, so the plain
// version can repeat the order). The codes are two's complement: there is no
// +128 / -136 offset and no side dot. Layout ("int4wo", ops/cuda/qmm_wo.py):
// packed [O, Kp/2] uint8, rows contiguous in K, inside each 8-group of k
// byte i = nib(k_i) | nib(k_{i+4}) << 4 (the byte order of "int4a8"), so a
// 32-bit word decodes with two masks and one byte-wise subtract into the
// codes of 8 consecutive k; scales [Kp/128, O] f32. What bounds the kernel
// and what the main loop does about it: qmm_wo_common.cuh.

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

  static __device__ __forceinline__ float byte_at(uint32_t w, int i) {
    return (float)(((int32_t)(w << (24 - 8 * i))) >> 24);  // signed byte i
  }

  static __device__ __forceinline__ void store(const Raw& r, wo::bf16* dst) {
    const uint32_t v[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // four 4-bit two's complement values in the low nibble of each byte -> int8x4
      const uint32_t lo = __vsub4((v[j] & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);         // k = 8j + 0..3
      const uint32_t hi = __vsub4(((v[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);  // k = 8j + 4..7
      uint4 out;
      out.x = wo::pack_bf16(byte_at(lo, 0), byte_at(lo, 1));
      out.y = wo::pack_bf16(byte_at(lo, 2), byte_at(lo, 3));
      out.z = wo::pack_bf16(byte_at(hi, 0), byte_at(hi, 1));
      out.w = wo::pack_bf16(byte_at(hi, 2), byte_at(hi, 3));
      *reinterpret_cast<uint4*>(dst + 8 * j) = out;
    }
  }
};

}  // namespace int4wo

// x [N, K] bf16 (K % 8 == 0), w [O, nblk * 64] uint8, s [nblk, O] f32, y [N, O] bf16.
extern "C" int int4_wo_gemm(const void* x, const void* w, const void* s, void* y, int N, int K,
                            int O, int nblk, void* stream) {
  int4wo::Int4Dec dec{static_cast<const uint8_t*>(w), nblk * 64};
  return (int)wo::launch<128, 64, 4, 2, 128, int4wo::Int4Dec>(x, dec, static_cast<const float*>(s), nullptr,
                                                      nullptr, y, N, K, O, nblk * 128,
                                                      static_cast<cudaStream_t>(stream));
}
