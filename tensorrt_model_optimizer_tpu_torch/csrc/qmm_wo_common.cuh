// Shared main loop of the weight-only GEMMs for Hopper (sm_90a):
//
//   y[n, o] = epilogue( sum_k x[n, k] * w[o, k] ),  x bf16 [N, K],  y bf16 [N, O]
//
// qmm_int4_wo.cu, qmm_fp4_wo.cu and qmm_byte_wo.cu include it and supply a
// decoder that turns 16 bytes of a packed weight row into bf16 values. Every
// format decodes to bf16 exactly, so the products run on the tensor cores
// (mma.sync m16n8k16, bf16 x bf16 -> f32) and lose nothing before the f32 sum.
//
// What bounds these GEMMs on an H100: at decode (N = 8) the packed weight
// bytes, read once (gate_proj 14336 x 4096: 29.4 MB of 4-bit codes, >= 9 us
// at 3.35 TB/s; 58.7 MB for one byte a weight); at prefill (N = 16384) the
// 2 N O K operations (1.92 TFLOP for gate_proj, >= 1.95 ms at the 989
// TFLOP/s bf16 peak). What the design does about it: weights are read once
// per N-tile with 16-byte loads and decoded once into shared memory, where
// all warps of the block reuse them; the next K tile's global loads are
// issued into registers before the current tile's math. mma.sync reaches a
// fraction of the wgmma rate, and there is no TMA or multi-stage ring yet:
// both are later work.
//
// Block = WARPS_M x WARPS_N warps; a warp owns a (BM / WARPS_M) x (BN /
// WARPS_N) tile as m16 x n8 fragments. Shared rows are padded by 8 bf16, so
// the 32-bit fragment reads of a warp (8 rows x 4 words) hit 32 distinct
// banks. Rows past N, columns past O and k past K are masked to zero; the
// packed rows themselves are padded to whole K tiles by the packers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_decode.cuh"

namespace wo {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half), .y = hi
  return *reinterpret_cast<uint32_t*>(&v);
}

using fpdec::e4m3_to_float;  // all 256 codes, exactly

__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Dec (passed by value) supplies:
//   static constexpr int EPC      bf16 values in one 16-byte chunk of a row (32 or 16)
//   struct Raw                    what a thread holds of a chunk between load and store
//   Raw load(int o, int chunk)    chunk `chunk` of weight row o (o < O; past the row's end: zeros)
//   static void store(const Raw&, bf16* dst)   EPC decoded values to 16-byte aligned dst
//
// GROUP > 0: every GROUP K tiles (one 128-wide block) the tile sums are
// multiplied by blk_scale[block, o] and added to the result, blocks in
// order. Epilogue: times col_scale[o] if given, else times gs[0] if given.
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int GROUP, class Dec>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    gemm_kernel(const bf16* __restrict__ x, const Dec dec, const float* __restrict__ blk_scale,
                const float* __restrict__ col_scale, const float* __restrict__ gs,
                bf16* __restrict__ y, int N, int K, int O, int ktiles) {
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int LDS = BK + 8;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16, NTL = WTN / 8;
  constexpr int XPR = BK / 8, XCH = BM * XPR, XC = (XCH + NT - 1) / NT;
  constexpr int CPR = BK / Dec::EPC, WCH = BN * CPR, WC = (WCH + NT - 1) / NT;
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && BK % 16 == 0 && BK % Dec::EPC == 0, "tile shape");

  __shared__ __align__(16) bf16 xs[BM * LDS];
  __shared__ __align__(16) bf16 ws[BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * BM, o0 = blockIdx.x * BN;

  uint4 xr[XC];
  typename Dec::Raw wr[WC];
  auto load = [&](int kt) {
#pragma unroll
    for (int i = 0; i < XC; ++i) {
      const int c = tid + i * NT;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < XCH) {
        const int n = n0 + c / XPR, k = kt * BK + (c % XPR) * 8;
        if (n < N && k < K) v = *reinterpret_cast<const uint4*>(x + (size_t)n * K + k);
      }
      xr[i] = v;
    }
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      const int c = tid + i * NT;
      typename Dec::Raw r = {};
      if (c < WCH) {
        const int o = o0 + c / CPR;
        if (o < O) r = dec.load(o, kt * CPR + c % CPR);
      }
      wr[i] = r;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < XC; ++i) {
      const int c = tid + i * NT;
      if (c < XCH) *reinterpret_cast<uint4*>(xs + (c / XPR) * LDS + (c % XPR) * 8) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      const int c = tid + i * NT;
      if (c < WCH) Dec::store(wr[i], ws + (c / CPR) * LDS + (c % CPR) * Dec::EPC);
    }
  };

  float acc[MT][NTL][4];
  float part[GROUP > 0 ? MT : 1][GROUP > 0 ? NTL : 1][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][j][r] = 0.f;
        if constexpr (GROUP > 0) part[i][j][r] = 0.f;
      }

  load(0);
  for (int kt = 0; kt < ktiles; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < ktiles) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NTL][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const bf16* p = xs + (wm * WTM + i * 16 + g) * LDS + kk + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const bf16* p = ws + (wn * WTN + j * 8 + g) * LDS + kk + 2 * t;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          if constexpr (GROUP > 0)
            mma_m16n8k16(part[i][j], a[i], b[j]);
          else
            mma_m16n8k16(acc[i][j], a[i], b[j]);
        }
    }
    if constexpr (GROUP > 0) {
      if (kt % GROUP == GROUP - 1) {
        const float* srow = blk_scale + (size_t)(kt / GROUP) * O;
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          const int o = o0 + wn * WTN + j * 8 + 2 * t;
          const float s0 = o < O ? srow[o] : 0.f, s1 = o + 1 < O ? srow[o + 1] : 0.f;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            acc[i][j][0] = __fadd_rn(acc[i][j][0], __fmul_rn(part[i][j][0], s0));
            acc[i][j][1] = __fadd_rn(acc[i][j][1], __fmul_rn(part[i][j][1], s1));
            acc[i][j][2] = __fadd_rn(acc[i][j][2], __fmul_rn(part[i][j][2], s0));
            acc[i][j][3] = __fadd_rn(acc[i][j][3], __fmul_rn(part[i][j][3], s1));
            part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
          }
        }
      }
    }
    __syncthreads();
  }

  const float g_all = (col_scale == nullptr && gs != nullptr) ? gs[0] : 1.f;
  const bool pair_ok = (O & 1) == 0;
#pragma unroll
  for (int j = 0; j < NTL; ++j) {
    const int o = o0 + wn * WTN + j * 8 + 2 * t;
    if (o >= O) continue;
    const float c0 = col_scale ? col_scale[o] : g_all;
    const float c1 = (col_scale && o + 1 < O) ? col_scale[o + 1] : g_all;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wm * WTM + i * 16 + g + 8 * h;
        if (n >= N) continue;
        const float v0 = acc[i][j][2 * h] * c0, v1 = acc[i][j][2 * h + 1] * c1;
        bf16* dst = y + (size_t)n * O + o;
        if (pair_ok) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (o + 1 < O) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// Two tile shapes: decode (N <= 16: 16 x 32 tiles over 128-wide K tiles, 4
// warps, so that a tall-K projection still spreads over the SMs) and prefill
// (PM x PN tiles over 64-wide K tiles, 8 warps as PWM x PWN). BLOCK is the
// width of a scaled K block (128 for int4) or 0.
template <int PM, int PN, int PWM, int PWN, int BLOCK, class Dec>
cudaError_t launch(const void* x, const Dec& dec, const float* blk_scale, const float* col_scale,
                   const float* gs, void* y, int N, int K, int O, int Kp, cudaStream_t st) {
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* yp = static_cast<bf16*>(y);
  if (N <= 16) {
    constexpr int BM = 16, BN = 32, BK = 128;
    dim3 grid((O + BN - 1) / BN, (N + BM - 1) / BM);
    gemm_kernel<BM, BN, BK, 1, 4, BLOCK / BK, Dec><<<grid, 128, 0, st>>>(
        xp, dec, blk_scale, col_scale, gs, yp, N, K, O, (Kp + BK - 1) / BK);
  } else {
    constexpr int BK = 64;
    dim3 grid((O + PN - 1) / PN, (N + PM - 1) / PM);
    gemm_kernel<PM, PN, BK, PWM, PWN, BLOCK / BK, Dec><<<grid, PWM * PWN * 32, 0, st>>>(
        xp, dec, blk_scale, col_scale, gs, yp, N, K, O, (Kp + BK - 1) / BK);
  }
  return cudaGetLastError();
}

}  // namespace wo
