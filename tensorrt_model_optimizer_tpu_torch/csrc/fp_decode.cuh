// Exact f32 decoders of the small float formats, shared by the weight-only
// GEMMs (qmm_wo_common.cuh, qmm_fp4_wo.cu) and the KV-cache attention
// kernels (kv_common.cuh).

#pragma once

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

// E2M1 code in the low 4 bits of c (sign | index into 0, .5, 1, 1.5, 2, 3, 4,
// 6; higher bits ignored) -> f32.
__device__ __forceinline__ float e2m1_to_float(uint32_t c) {
  const uint32_t idx = c & 7u;
  // f32 bits are affine in the index from 1.0 up: (idx + 252) << 22; 0.5 and 0 below
  const uint32_t mag = idx >= 2u ? (idx + 252u) << 22 : idx * 0x3F000000u;
  return __uint_as_float(mag | ((c & 8u) << 28));
}

}  // namespace fpdec
