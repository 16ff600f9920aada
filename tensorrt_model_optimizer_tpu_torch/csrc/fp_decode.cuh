// Exact f32 decoders of the small float formats, shared by the weight-only
// GEMMs (qmm_wo_common.cuh, qmm_fp4_wo.cu) and the KV-cache attention
// kernels (kv_common.cuh).

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fpdec {

// OFP8 e4m3 ("fn": no inf, 0x7f / 0xff are NaN) -> f32, all 256 codes.
__device__ __forceinline__ float e4m3_to_float(uint32_t b) {
  const uint32_t mag = b & 0x7Fu;
  const uint32_t sign = (b & 0x80u) << 24;
  uint32_t bits;
  if (mag >= 8u)
    bits = (mag << 20) + (120u << 23);  // exponent field e + 120, mantissa m << 20
  else
    bits = __float_as_uint((float)mag * 0.001953125f);  // subnormal: m * 2^-9
  if (mag == 0x7Fu) bits = 0x7FC00000u;
  return __uint_as_float(bits | sign);
}

// Two e4m3 codes (the low 16 bits of `two`, the low byte first) -> f32 pair,
// by the hardware's e4m3x2 -> f16x2 conversion (sm_89 and later): exact, as
// every e4m3 value is an f16 value; 0x7f / 0xff give NaN.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// Int8 code k (0..3) of the word w -> f32, exactly: the float with bits
// 0x4B0000uu is 2^23 + uu, and uu = code + 128 (the sign bit flipped), so one
// byte permute and one add replace an extract and an int-to-float convert.
__device__ __forceinline__ float s8_to_float(uint32_t w_flipped, int k) {
  return __uint_as_float(__byte_perm(w_flipped, 0x4B000000u, 0x7650u | k)) - 8388736.f;  // 2^23 + 128
}

// E2M1 code in the low 4 bits of c (sign | index into 0, .5, 1, 1.5, 2, 3, 4,
// 6; higher bits ignored) -> f32.
__device__ __forceinline__ float e2m1_to_float(uint32_t c) {
  const uint32_t idx = c & 7u;
  // f32 bits are affine in the index from 1.0 up: (idx + 252) << 22; 0.5 and 0 below
  const uint32_t mag = idx >= 2u ? (idx + 252u) << 22 : idx * 0x3F000000u;
  return __uint_as_float(mag | ((c & 8u) << 28));
}

}  // namespace fpdec
