// Tile primitives of the tensor-core flash-attention kernels for Hopper
// (sm_90a): csrc/flash_gqa.cu and the tensor-core route of
// csrc/skip_softmax_flash.cu. bf16 q / k / v, f32 accumulators, head_dim D
// in {32, 64, 128}.
//
// A block owns a tile of query rows; each warp owns MT m-tiles of 16 rows.
// Per k tile:
//   - tiles come from device memory by `cp.async.cg` (16 bytes a thread,
//     rows past the valid ones zero-filled) into shared rows whose 16-byte
//     chunks are XOR-swizzled, so the 8 rows an `ldmatrix` reads sit in 8
//     different bank groups;
//   - S = Q K^T by `mma.sync.m16n8k16` bf16 x bf16 -> f32: bf16 products are
//     exact in f32, so S differs from an f32 product only in summation
//     order. Q's and K's fragments come in through `ldmatrix`, one K
//     fragment serving the warp's MT m-tiles;
//   - the online softmax runs on the accumulator fragments: thread (g, t) of
//     a warp (g = lane / 4, t = lane % 4) holds rows g and g + 8 of an
//     m-tile, so a row's max is a shuffle over the quad (xor 1, 2). It works
//     in raw-score units, p = 2^(s c - m c) with c = scale log2(e): one FFMA
//     and one `ex2` a score, where expf(scale s - m) costs a range
//     reduction more; the softmax work per score is what competes with the
//     tensor cores at this head_dim. p is f32; l is summed from the f32 p
//     per thread and over the quad at the end;
//   - O += P V by the same mma: the C fragment of an m16n8 product is the A
//     fragment of the next m16k16, so P never goes through shared memory. P
//     is split exactly into three bf16 terms, p = p_hi + p_mid + p_lo (p's
//     24 significant bits, 8 a term, cut by masks, not rounded), three
//     products into one f32 accumulator: P V is then the f32 product in
//     another summation order. One bf16 P would add an error of ~2^-9 /
//     sqrt(3) of rms(out) per element, which over the 8B prefill's 67M
//     outputs breaks the per-element limit the kernels are held to (2^-8
//     |ref| + 1e-3 rms(ref)). Two terms (~16 bits of p) keep that limit, but
//     at a short prefill (the anchor's: 32 keys, d 32) they round 0.44% of
//     the bf16 outputs one ulp from the plain version's against 0.02% for
//     three (an H100), and an ulp in an attention output can become another
//     int8 activation code and another token; the kernels phase holds that
//     share to 1e-3 there. Over 2048 keys ~0.2% round apart either way (the
//     mma's own f32 accumulation, it seems). The third term costs ~20% of
//     the kernel's time. V comes in through `ldmatrix.trans`.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_tc {

constexpr float MASKED = -1e30f;  // a masked score, as the reference

// byte offset of 16-byte chunk `c` of row `r` in a [rows, D] bf16 tile
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int CH = D / 8;                       // chunks per row
  constexpr int W = CH < 8 ? CH : 8;              // chunks of a 128-byte bank line
  constexpr int SH = CH >= 8 ? 0 : (CH == 4 ? 1 : 2);  // log2 of rows per bank line
  return (uint32_t)((r * CH + (c ^ ((r >> SH) & (W - 1)))) * 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// rows [0, ROWS) of a tile, row r at src + r * stride (elements), into the
// swizzled tile at `dst`; rows >= valid are zero-filled (never read from src)
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src, long long stride,
                                          int valid) {
  constexpr int CH = D / 8, N = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int c = i * NT + threadIdx.x, r = c / CH, ch = c % CH;
    if (N % NT != 0 && c >= N) break;
    const bool ok = r < valid;
    cp_async16(dst + swz<D>(r, ch), src + (ok ? r * stride + ch * 8 : 0), ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&x)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&x)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(a));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the high halves of x and y as one bf16 pair (x in the low half)
__device__ __forceinline__ uint32_t high_halves(float x, float y) {
  return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}
// x with the low 16 bits of its pattern cleared: its top 8 significant bits
__device__ __forceinline__ float cut_bf16(float x) { return __uint_as_float(__float_as_uint(x) & 0xffff0000u); }

// (x, y) -> bf16 pairs hi + mid + lo == (x, y) exactly: hi holds each
// value's top 8 significant bits, mid the next 8, lo the last 8. Every
// difference is exact in f32 (x - cut(x) is x's low 16 significand bits),
// and what is left after two cuts has at most 8 significant bits, so lo
// takes it whole. (Below |x| = 2^-118 the differences go subnormal and lo
// loses bits: an error under 2^-141, where every p here sums to l >= 1.)
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const float rx = x - cut_bf16(x), ry = y - cut_bf16(y);
  hi = high_halves(x, y);
  mid = high_halves(rx, ry);
  lo = high_halves(rx - cut_bf16(rx), ry - cut_bf16(ry));
}

// s = Q K^T for this warp's MT m-tiles of 16 rows (rows row0 + 16 mt ..
// of the Q tile at q_s) and the BK keys of the tile at k_s. s[mt][n] holds
// keys 8n + 2t, 8n + 2t + 1 of rows g (s[mt][n][0..1]) and g + 8 (..[2..3]).
// Q's fragments come through `ldmatrix` per 16 columns of d; one K fragment
// serves all MT m-tiles.
template <int D, int BK, int MT>
__device__ __forceinline__ void qk(float (&s)[MT][BK / 8][4], uint32_t q_s, int row0, uint32_t k_s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], q_s + swz<D>(row0 + 16 * mt + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, k_s + swz<D>(16 * np + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(s[mt][2 * np], a[mt], b[0], b[1]);
        mma16816(s[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// 2^x on the special-function unit; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// The online-softmax update of one m-tile's rows by a tile of raw scores
// s = q.k (masked entries MASKED), replaced by p. Row state m is kept in
// the same raw units; with c = scale * log2(e), exp(scale (x - m)) is
// 2^(x c - m c): one FFMA and one ex2 a score. m_new = max(m, row max);
// p = 2^(s c - m_new c), 0 for a masked entry (its exponent is ~-1e29); l =
// l * corr + sum(p) (this thread's columns only); o *= corr, corr = 2^((m -
// m_new) c), skipped when no row of the warp moved its max.
template <int BK, int NO>
__device__ __forceinline__ void softmax_update(float (&s)[BK / 8][4], float (&m)[2], float (&l)[2],
                                               float (&o)[NO][4], float c) {
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = s[0][2 * r];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx), mc = m_new * c;
    corr[r] = exp2_ftz((m[r] - m_new) * c);
    m[r] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2_ftz(fmaf(s[n][2 * r + e], c, -mc));
        s[n][2 * r + e] = p;
        rs += p;
      }
    }
    l[r] = l[r] * corr[r] + rs;
  }
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
  }
}

// o += P V for this warp's MT m-tiles: P from the f32 probabilities p (the
// layout of `qk`'s s), split exactly into p_hi + p_mid + p_lo; V the BK x D
// tile at v_s. One V fragment serves all MT m-tiles.
template <int D, int BK, int MT>
__device__ __forceinline__ void pv(float (&o)[MT][D / 8][4], const float (&p)[MT][BK / 8][4], uint32_t v_s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t ahi[MT][4], amid[MT][4], alo[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // A register r: row g + 8 (r & 1), keys 8 (r >> 1) + 2t, + 1
        const float(&f)[4] = p[mt][2 * kk + (r >> 1)];
        split3_bf16(f[2 * (r & 1)], f[2 * (r & 1) + 1], ahi[mt][r], amid[mt][r], alo[mt][r]);
      }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, v_s + swz<D>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * dp + (lane >> 4)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(o[mt][2 * dp], ahi[mt], b[0], b[1]);
        mma16816(o[mt][2 * dp + 1], ahi[mt], b[2], b[3]);
        mma16816(o[mt][2 * dp], amid[mt], b[0], b[1]);
        mma16816(o[mt][2 * dp + 1], amid[mt], b[2], b[3]);
        mma16816(o[mt][2 * dp], alo[mt], b[0], b[1]);
        mma16816(o[mt][2 * dp + 1], alo[mt], b[2], b[3]);
      }
    }
  }
}

// one m-tile's output rows: o / max(l, 1e-30) in bf16; row r of its 16 at
// dst + r * stride (elements), written where r < valid
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst, long long stride, int valid,
                                           const float (&o)[D / 8][4], float (&l)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float L = l[r];
    L += __shfl_xor_sync(0xffffffffu, L, 1);
    L += __shfl_xor_sync(0xffffffffu, L, 2);
    const float inv = 1.f / fmaxf(L, 1e-30f);
    const int row = g + 8 * r;
    if (row >= valid) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * stride + 8 * n + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

}  // namespace attn_tc
