// Shared main loops of the weight-only GEMMs for Hopper (sm_90a):
//
//   y[n, o] = epilogue( sum_k x[n, k] * w[o, k] ),  x bf16 [N, K],  y bf16 [N, O]
//
// qmm_int4_wo.cu, qmm_fp4_wo.cu and qmm_byte_wo.cu include it and supply a
// decoder that turns 16 bytes of a packed weight row into bf16 values, as
// pairs of consecutive k. Every format decodes to bf16 exactly, so the
// products run on the tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32)
// and lose nothing before the f32 sum.
//
// What bounds these GEMMs on an H100: at decode (N = 8) the packed weight
// bytes, read once (gate_proj 14336 x 4096: 29.4 MB of 4-bit codes, >= 9 us
// at 3.35 TB/s; 58.7 MB for one byte a weight); at prefill (N = 16384) the
// 2 N O K operations (1.92 TFLOP for gate_proj, >= 1.95 ms at the 989
// TFLOP/s bf16 peak). Two routes, by N:
//
// Prefill (N > 16), `gemm_kernel`: weights are read once per N-tile with
// 16-byte loads and decoded once into shared memory, where all warps of the
// block reuse them; the next K tile's global loads are issued into registers
// before the current tile's math. mma.sync reaches a fraction of the wgmma
// rate, and there is no TMA or multi-stage ring yet: both are later work.
// Block = WARPS_M x WARPS_N warps; a warp owns a (BM / WARPS_M) x (BN /
// WARPS_N) tile as m16 x n8 fragments. Shared rows are padded by 8 bf16, so
// the 32-bit fragment reads of a warp (8 rows x 4 words) hit 32 distinct
// banks. Rows past N, columns past O and k past K are masked to zero; the
// packed rows themselves are padded to whole K tiles by the packers.
//
// Decode (N <= 16), `decode_kernel`: the weights are the MMA's M dimension
// (a warp owns 32 output rows, two m16 tiles) and the <= 8 or <= 16 tokens
// its n8 tiles, so no half of an MMA is padding at N = 8. The k order inside
// an MMA is free as long as A and B agree, so thread (g, t) of a warp feeds
// its fragments straight from registers: per 128-wide K block it loads 32
// consecutive k of its weight rows g, g + 8 (16 bytes of 4-bit codes) and
// the same 32 k of token g's x (four 16-byte loads; the block's warps read
// the same x, so L1 serves all but the first), with no shared memory and no
// barrier. K is split over the grid in whole 128-blocks (`n_split`, chosen
// by the wrapper from the shape: blocks enough to fill the card), and each
// warp keeps U K blocks in flight (loads issued U blocks ahead). Each split
// writes its f32 partial tile to a workspace, fences and bumps its tile's
// arrival counter; the warp that arrives last sums the partials in split
// order 0, 1, ... (deterministic: no float atomics), applies the epilogue,
// writes bf16 and sets the counter back to 0 for the next call. One launch.

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
//   struct Raw                    what a thread holds of a chunk between load and decode
//   Raw load(int o, int chunk)    chunk `chunk` of weight row o (o < O; past the row's end: zeros)
//   static uint4 octet(const Raw&, int q)   values 8q .. 8q + 7 of the chunk, decoded, as four
//                                 bf16 pairs: .x = k 8q (low half) | 8q + 1 (high half), .y = 8q + 2 | 8q + 3, ...

// EPC decoded values of a chunk to 16-byte aligned shared memory
template <class Dec>
__device__ __forceinline__ void store_chunk(const typename Dec::Raw& r, bf16* dst) {
#pragma unroll
  for (int q = 0; q < Dec::EPC / 8; ++q) *reinterpret_cast<uint4*>(dst + 8 * q) = Dec::octet(r, q);
}
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
      if (c < WCH) store_chunk<Dec>(wr[i], ws + (c / CPR) * LDS + (c % CPR) * Dec::EPC);
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

// ---- decode route ----

constexpr int KB = 128;                   // width of the K blocks a split is made of
constexpr int DW = 2;                     // warps of a decode block
constexpr int DMT = 2;                    // m16 tiles of output rows a warp owns
constexpr int DROWS = 16 * DMT;           // output rows of a warp (its tile of the fix-up)
constexpr int WS_TILE = DMT * 2 * 4 * 32;  // floats of one warp's partial tile (NT8 <= 2)
// blocks an SM holds at once, which the register budget is cut to (launch
// bounds): the wrapper's split count fills at most this one wave
constexpr int DEC_BLOCKS_N8 = 6, DEC_BLOCKS_N16 = 4;

// NT8: n8 tiles of tokens (1: N <= 8, 2: N <= 16); U: K blocks in flight per
// warp; SCALED: int4's block scales, blk_scale [nkb, O], applied to each
// 128-block's sum (blocks in order within a split).
template <int NT8, int U, bool SCALED, class Dec>
__global__ void __launch_bounds__(DW * 32, NT8 == 1 ? DEC_BLOCKS_N8 : DEC_BLOCKS_N16)
    decode_kernel(const bf16* __restrict__ x, const Dec dec, const float* __restrict__ blk_scale,
                  const float* __restrict__ col_scale, const float* __restrict__ gs, bf16* __restrict__ y,
                  float* __restrict__ ws, int* __restrict__ counters, int N, int K, int O, int nkb) {
  constexpr int CPT = 32 / Dec::EPC;  // chunks of a row a thread reads per K block
  using Raw = typename Dec::Raw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wt = blockIdx.x * DW + warp;  // the warp's tile: output rows [32 wt, 32 wt + 32)
  if (wt * DROWS >= O) return;            // the same for every split: no arrival expected
  const int sp = blockIdx.y, n_split = gridDim.y;
  const int kb0 = (int)((long long)sp * nkb / n_split), kb1 = (int)((long long)(sp + 1) * nkb / n_split);

  int row[DMT][2];  // rows g and g + 8 of each m16 tile
#pragma unroll
  for (int i = 0; i < DMT; ++i) {
    row[i][0] = wt * DROWS + 16 * i + g;
    row[i][1] = row[i][0] + 8;
  }

  Raw w[U][DMT][2][CPT];
  uint4 xv[U][NT8][4];
  float sc[U][DMT][2];
  auto load = [&](int u, int kb) {
    const bool live = kb < kb1;
#pragma unroll
    for (int i = 0; i < DMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = live && row[i][h] < O;
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          w[u][i][h][c] = ok ? dec.load(row[i][h], kb * (KB / Dec::EPC) + t * CPT + c) : Raw{};
        if constexpr (SCALED) sc[u][i][h] = ok ? blk_scale[(size_t)kb * O + row[i][h]] : 0.f;
      }
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const int n = g + 8 * j;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = kb * KB + 32 * t + 8 * c;
        xv[u][j][c] = live && n < N && k < K ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)n * K + k))
                                             : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  float acc[DMT][NT8][4];
#pragma unroll
  for (int i = 0; i < DMT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int u = 0; u < U; ++u) load(u, kb0 + u);
  for (int kb = kb0; kb < kb1; kb += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (kb + u < kb1) {
#pragma unroll
        for (int i = 0; i < DMT; ++i) {
          float part[NT8][4];
#pragma unroll
          for (int j = 0; j < NT8; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) part[j][r] = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // k 32t + 8q .. 32t + 8q + 7 of this block: two MMAs
            const int c = q / (Dec::EPC / 8), qc = q % (Dec::EPC / 8);
            const uint4 pa = Dec::octet(w[u][i][0][c], qc), pb = Dec::octet(w[u][i][1][c], qc);  // rows g, g + 8
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t a[4] = {h ? pa.z : pa.x, h ? pb.z : pb.x, h ? pa.w : pa.y, h ? pb.w : pb.y};
#pragma unroll
              for (int j = 0; j < NT8; ++j) {
                const uint4& xq = xv[u][j][q];
                const uint32_t b[2] = {h ? xq.z : xq.x, h ? xq.w : xq.y};
                if constexpr (SCALED)
                  mma_m16n8k16(part[j], a, b);
                else
                  mma_m16n8k16(acc[i][j], a, b);
              }
            }
          }
          if constexpr (SCALED) {
#pragma unroll
            for (int j = 0; j < NT8; ++j) {
              acc[i][j][0] = __fadd_rn(acc[i][j][0], __fmul_rn(part[j][0], sc[u][i][0]));
              acc[i][j][1] = __fadd_rn(acc[i][j][1], __fmul_rn(part[j][1], sc[u][i][0]));
              acc[i][j][2] = __fadd_rn(acc[i][j][2], __fmul_rn(part[j][2], sc[u][i][1]));
              acc[i][j][3] = __fadd_rn(acc[i][j][3], __fmul_rn(part[j][3], sc[u][i][1]));
            }
          }
        }
      }
      load(u, kb + u + U);
    }
  }

  if (n_split > 1) {  // the fix-up: the last split of the tile to arrive sums all of them, in order
    float* mine = ws + ((size_t)wt * n_split + sp) * WS_TILE;
#pragma unroll
    for (int i = 0; i < DMT; ++i)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) mine[((i * NT8 + j) * 4 + r) * 32 + lane] = acc[i][j][r];
    __threadfence();
    __syncwarp();
    int last = 0;
    if (lane == 0) last = atomicAdd(counters + wt, 1) == n_split - 1;
    if (!__shfl_sync(0xffffffffu, last, 0)) return;
    __threadfence();
    constexpr int E = DMT * NT8 * 4, SB = 8;  // partials a lane sums; splits whose loads fly together
    const float* tile = ws + (size_t)wt * n_split * WS_TILE + lane;
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = __ldcg(tile + e * 32);
    for (int s = 1; s < n_split; s += SB) {
      float nx[SB][E];
#pragma unroll
      for (int q = 0; q < SB; ++q)
#pragma unroll
        for (int e = 0; e < E; ++e)
          nx[q][e] = s + q < n_split ? __ldcg(tile + (size_t)(s + q) * WS_TILE + e * 32) : 0.f;
#pragma unroll
      for (int q = 0; q < SB; ++q)
        if (s + q < n_split)
#pragma unroll
          for (int e = 0; e < E; ++e) v[e] += nx[q][e];
    }
#pragma unroll
    for (int i = 0; i < DMT; ++i)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = v[(i * NT8 + j) * 4 + r];
    if (lane == 0) counters[wt] = 0;  // ready for the next call on this stream
  }

  // c[2h + q]: row g + 8h of the m16 tile, token 2t + q of the n8 tile
  const float g_all = (col_scale == nullptr && gs != nullptr) ? gs[0] : 1.f;
#pragma unroll
  for (int i = 0; i < DMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = row[i][h];
      if (o >= O) continue;
      const float c = col_scale ? col_scale[o] : g_all;
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = 8 * j + 2 * t + q;
          if (n < N) y[(size_t)n * O + o] = __float2bfloat16_rn(acc[i][j][2 * h + q] * c);
        }
    }
}

// Decode route (N <= 16): `n_split` splits of the ceil(Kp / 128) K blocks
// (1 <= n_split <= that; ws: n_tiles * n_split * WS_TILE floats and counters:
// n_tiles ints, 0 between calls, where n_tiles = ceil(O / DROWS), both unused
// at n_split 1). Prefill (N > 16): PM x PN tiles over 64-wide K tiles, 8 warps
// as PWM x PWN. BLOCK is the width of a scaled K block (128 for int4) or 0.
template <int PM, int PN, int PWM, int PWN, int BLOCK, class Dec>
cudaError_t launch(const void* x, const Dec& dec, const float* blk_scale, const float* col_scale,
                   const float* gs, void* y, int N, int K, int O, int Kp, float* ws, int* counters, int n_split,
                   cudaStream_t st) {
  static_assert(BLOCK == 0 || BLOCK == KB, "int4 blocks are the decode route's K blocks");
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* yp = static_cast<bf16*>(y);
  if (N <= 0 || O <= 0) return cudaSuccess;
  if (N <= 16) {
    const int nkb = (Kp + KB - 1) / KB;
    if (n_split < 1 || n_split > nkb || (n_split > 1 && (ws == nullptr || counters == nullptr)))
      return cudaErrorInvalidValue;
    // K blocks in flight a warp: 3 of int4 (6 KB), 2 of fp4 (its scales make a chunk 20 bytes) and bytes (8 KB)
    constexpr int U = sizeof(typename Dec::Raw) <= 16 && Dec::EPC == 32 ? 3 : 2;
    dim3 grid((O + DW * DROWS - 1) / (DW * DROWS), n_split);
    if (N <= 8)
      decode_kernel<1, U, (BLOCK > 0), Dec><<<grid, DW * 32, 0, st>>>(xp, dec, blk_scale, col_scale, gs, yp, ws,
                                                                     counters, N, K, O, nkb);
    else
      decode_kernel<2, U, (BLOCK > 0), Dec><<<grid, DW * 32, 0, st>>>(xp, dec, blk_scale, col_scale, gs, yp, ws,
                                                                     counters, N, K, O, nkb);
  } else {
    constexpr int BK = 64;
    dim3 grid((O + PN - 1) / PN, (N + PM - 1) / PM);
    gemm_kernel<PM, PN, BK, PWM, PWN, BLOCK / BK, Dec><<<grid, PWM * PWN * 32, 0, st>>>(
        xp, dec, blk_scale, col_scale, gs, yp, N, K, O, (Kp + BK - 1) / BK);
  }
  return cudaGetLastError();
}

}  // namespace wo
