// Skip-softmax sparse flash attention for Hopper (sm_90a), two routes:
//   - tensor cores (`skip_softmax_flash_tc`): bf16, head_dim 32, 64 or 128,
//     tiles of 64 or 128 rows (bq, bk in {64, 128}): the 8B sparse prefill
//     (128-tiles) and the anchor einsum engine's (64-tiles);
//   - CUDA cores (`skip_softmax_flash`): f32 or bf16, head_dim 16, 32, 64 or
//     128, tiles of up to 128 x 128 rows whose sizes are read at run time:
//     f32 (the RULER anchor), d = 16 and the halving rule's odd tiles, which
//     have no tensor-core form that keeps their numbers.
// The wrapper (ops/cuda/sparse_attention.py `route`) picks the route from
// dtype, d, bq and bk alone.
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/sparse_attention.py
// skip_softmax_flash (_kernel).
//
//   q, k, v [BH, S, D]; bq | S, bk | S; nq = S / bq, nk = S / bk
//   s = (q . k^T in f32) * scale; under `causal` entries above the diagonal
//   are -1e30. For each (bh, q tile i) the k tiles j = 0 .. nk-1 are visited
//   IN ORDER; tile j is kept iff max(s_tile) >= run + log_thresh (f32 add),
//   where run is the largest tile max among the tiles of q tile i kept so far
//   (-1e30 before the first, so the first tile is always kept); under
//   `causal` a tile with j bk > i bq + bq - 1 is dropped as well. A kept tile
//   does the online-softmax update in f32: p = exp(s - m_new), zero where
//   s <= -1e29; out = acc / max(l, 1e-30). keep[bh, i, j] records each
//   decision (1 / 0).
//
// What bounds it on an H100: operations. At Llama-3.1-8B prefill (BH 256 =
// 8 x 32 heads, S 2048, d 128, bf16, causal 128-tiles) the causal scores of
// the kept tiles need up to 2.75e11 FLOP per layer (>= 0.28 ms at the 989
// TFLOP/s bf16 tensor-core peak) against 0.54 GB of q/k/v/out (0.16 ms at
// 3.35 TB/s).
//
// Both routes: the decisions depend on the visit order (run changes only on
// kept tiles), so one block owns one (bh, q tile) and walks its row of k
// tiles in order, stopping at the causal edge and writing 0 for the tiles
// beyond it. The tile max is a block-wide reduction (warp shuffles, one
// value per warp in shared memory, one barrier), and every thread takes the
// same decision from it, so the skip branch never diverges around a barrier.
//
// Tensor-core route (step A: `mma.sync`, the tile primitives of
// attn_tc.cuh, shared with flash_gqa.cu): bq / 16 warps of one 16-row m-tile
// each; K and V in a two-stage `cp.async` ring of swizzled shared tiles
// (160 KB at 128-tiles, d 128). K and V of tile j + 1 are prefetched while
// tile j computes and decides: V speculatively, since its bytes are not
// what binds (0.16 ms of bytes against 0.28 ms of operations) and a V
// loaded after the decision would stall every kept tile on a load. S by
// mma, the causal mask, the block-wide tile max of the raw scores times the
// scale (exactly the largest scaled score: scaling is monotone) and the
// decision; only a kept tile runs the softmax update and P V (P split
// exactly into three bf16 terms). A warp whose 16 rows all lie above the
// tile's first key contributes -1e30 to the max and skips the tile's work
// (exact: its update would be identity). The q tiles are launched heaviest
// first on the grid's fast axis. Measured (H100 80GB HBM3, 700 W,
// chip_smoke.py's kernels phase) at the 8B shape: 1.80-1.82 ms at threshold
// 1e-30 (kept 0.531), 15% of the bound, 3.7x SDPA causal (two bf16 terms of
// P: 1.56 ms); PERF.md's kernel table, row 17.
//
// CUDA-core route: q's tile and one k/v tile (k first; v
// only when the tile is kept, into the same buffer) sit in shared memory in
// the input type, the f32 scores / probabilities beside them (198 KB at f32,
// d 128). 256 threads as 16 x 16: a thread owns score rows ty + 16 i and
// columns tx + 16 j (i, j < 8), and the output columns tx + 16 c of the
// same rows, so each row's softmax state lives in the 16 lanes of a half
// warp. The dots run on the CUDA cores in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tc.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAXB = 128;             // largest bq and bk
constexpr int RI = MAXB / 16;          // score rows per thread
constexpr int SST = MAXB + 1;          // f32 row stride of the score tile

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int PAD = 1;  // row stride D + 1 words: conflict-free column reads
  __device__ static float get(const float* p) { return *p; }
  __device__ static float2 get2(const float* p) { return make_float2(p[0], p[1]); }
  __device__ static float put(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int PAD = 2;  // row stride D / 2 + 1 words
  __device__ static float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static float2 get2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static __nv_bfloat16 put(float x) { return __float2bfloat16_rn(x); }
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  return 2 * sizeof(T) * MAXB * (D + Elem<T>::PAD) + sizeof(float) * (MAXB * SST + NT / 32);
}

// rows [r0, r0 + n) of a [S, D] slab -> shared rows of stride D + PAD
template <typename T, int D>
__device__ void load_tile(T* dst, const T* __restrict__ src, int n) {
  constexpr int ST = D + Elem<T>::PAD;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  for (int c = threadIdx.x; c < n * D / V; c += NT) {
    const int r = c / (D / V), col = (c % (D / V)) * V;
    const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)r * D + col);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int t = 0; t < V; ++t) dst[r * ST + col + t] = e[t];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) skip_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                  const T* __restrict__ v, T* __restrict__ out,
                                                  int* __restrict__ keep, int S, int bq, int bk,
                                                  float scale, float log_thresh, int causal) {
  constexpr int ST = D + Elem<T>::PAD;
  constexpr int CJ = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* kv_s = q_s + MAXB * ST;
  float* p_s = reinterpret_cast<float*>(kv_s + MAXB * ST);
  float* red = p_s + MAXB * SST;

  const int bh = blockIdx.x, qi = blockIdx.y;
  const int nk = S / bk;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, warp = tid >> 5, lane = tid & 31;
  const int i0 = qi * bq;
  const size_t base = (size_t)bh * S * D;
  int* keep_row = keep + ((size_t)bh * (S / bq) + qi) * nk;

  load_tile<T, D>(q_s, q + base + (size_t)i0 * D, bq);

  float m[RI], l[RI], acc[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }
  float run = -1e30f;

  // tiles past the causal edge are structurally skipped: never visited
  const int last = causal ? min(nk - 1, (i0 + bq - 1) / bk) : nk - 1;
  for (int j = last + 1 + tid; j < nk; j += NT) keep_row[j] = 0;

  for (int jt = 0; jt <= last; ++jt) {
    const int j0 = jt * bk;
    load_tile<T, D>(kv_s, k + base + (size_t)j0 * D, bk);
    __syncthreads();

    float s[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < RI; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 2) {
      float2 qv[RI], kv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Elem<T>::get2(q_s + min(ty + 16 * i, bq - 1) * ST + d);
#pragma unroll
      for (int c = 0; c < RI; ++c) kv[c] = Elem<T>::get2(kv_s + min(tx + 16 * c, bk - 1) * ST + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < RI; ++c) s[i][c] += qv[i].x * kv[c].x + qv[i].y * kv[c].y;
    }
    // scale, causal mask; the tile max over this thread's valid entries
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int c = 0; c < RI; ++c) {
        const int col = tx + 16 * c;
        s[i][c] = (causal && j0 + col > i0 + r) ? -1e30f : s[i][c] * scale;
        if (r < bq && col < bk) tmax = fmaxf(tmax, s[i][c]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    if (lane == 0) red[warp] = tmax;
    __syncthreads();  // also: every thread is done reading k's tile
    float bm = red[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) bm = fmaxf(bm, red[w]);
    const bool kept = bm >= run + log_thresh;
    if (tid == 0) keep_row[jt] = kept ? 1 : 0;
    if (!kept) continue;  // uniform across the block
    run = fmaxf(run, bm);

    load_tile<T, D>(kv_s, v + base + (size_t)j0 * D, bk);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < RI; ++c)
        if (tx + 16 * c < bk) mx = fmaxf(mx, s[i][c]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < RI; ++c) {
        const int col = tx + 16 * c;
        const float p = s[i][c] > -1e29f ? expf(s[i][c] - m_new) : 0.f;
        if (col < bk) {
          rs += p;
          if (r < bq) p_s[r * SST + col] = p;
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // p and v's tile are in place

    for (int c = 0; c < bk; ++c) {
      float vv[CJ];
#pragma unroll
      for (int cc = 0; cc < CJ; ++cc) vv[cc] = Elem<T>::get(kv_s + c * ST + tx + 16 * cc);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = p_s[min(ty + 16 * i, bq - 1) * SST + c];
#pragma unroll
        for (int cc = 0; cc < CJ; ++cc) acc[i][cc] += p * vv[cc];
      }
    }
    __syncthreads();  // before the next tile overwrites k/v and p
  }

  T* ob = out + base + (size_t)i0 * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= bq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < CJ; ++cc) ob[(size_t)r * D + tx + 16 * cc] = Elem<T>::put(acc[i][cc] * inv_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int* keep, int BH, int S, int bq,
           int bk, float scale, float log_thresh, int causal, cudaStream_t st) {
  constexpr size_t SMEM = smem_bytes<T, D>();
  cudaError_t e = cudaFuncSetAttribute(skip_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, S / bq);
  skip_kernel<T, D><<<grid, NT, SMEM, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                            static_cast<const T*>(v), static_cast<T*>(out), keep, S, bq,
                                            bk, scale, log_thresh, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int* keep, int BH, int S, int D,
             int bq, int bk, float scale, float log_thresh, int causal, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, keep, BH, S, bq, bk, scale, log_thresh, causal, st);
    case 32:
      return launch<T, 32>(q, k, v, out, keep, BH, S, bq, bk, scale, log_thresh, causal, st);
    case 64:
      return launch<T, 64>(q, k, v, out, keep, BH, S, bq, bk, scale, log_thresh, causal, st);
    case 128:
      return launch<T, 128>(q, k, v, out, keep, BH, S, bq, bk, scale, log_thresh, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---- tensor-core route -----------------------------------------------------

// one 16-row m-tile a warp: S of a 128-key tile is 64 floats a thread, held
// whole until the block's decision; two m-tiles a warp spill (measured 2x
// slower on an H100 80GB HBM3)
constexpr int TC_MT = 1;

template <int D, int BQ, int BK>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * D * (BQ + 4 * BK) + sizeof(float) * 2 * (BQ / 16);
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(BQ * 2 / TC_MT)
    skip_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int* __restrict__ keep,
                   int S, float scale, float log_thresh, int causal) {
  using namespace attn_tc;
  constexpr int MT = TC_MT, NW = BQ / (16 * MT), NTC = NW * 32;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t q_s = smem_addr(tc_smem);
  const uint32_t kv_s = q_s + BQ * D * 2;  // stage st: K at kv_s + 2 st BK D 2, V BK D 2 bytes after
  float* red = reinterpret_cast<float*>(tc_smem + (BQ + 4 * BK) * D * 2);  // [2][NW] warp maxima

  const int nq = S / BQ, nk = S / BK;
  const int qi = nq - 1 - blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i0 = qi * BQ, r0 = 16 * MT * warp, w0 = i0 + r0;
  const size_t base = (size_t)bh * S * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  int* keep_row = keep + ((size_t)bh * nq + qi) * nk;

  // tiles past the causal edge are structurally skipped: never visited
  const int last = causal ? min(nk - 1, (i0 + BQ - 1) / BK) : nk - 1;
  for (int j = last + 1 + threadIdx.x; j < nk; j += NTC) keep_row[j] = 0;
  attn_tc::load_tile<BQ, D, NTC>(q_s, q + base + (size_t)i0 * D, D, BQ);
  attn_tc::load_tile<BK, D, NTC>(kv_s, kb, D, BK);
  attn_tc::load_tile<BK, D, NTC>(kv_s + BK * D * 2, vb, D, BK);
  cp_async_commit();

  float m[MT][2], l[MT][2], o[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = MASKED;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }
  float run = -1e30f;
  const float c = scale * LOG2E;

  for (int jt = 0; jt <= last; ++jt) {
    const int j0 = jt * BK, buf = jt & 1;
    const uint32_t k_s = kv_s + buf * 2 * BK * D * 2, v_s = k_s + BK * D * 2;
    cp_async_wait_all();
    __syncthreads();  // tile jt in place; every thread is done with tile jt - 1's buffers
    if (jt < last) {  // K and (speculatively) V of the next tile
      const uint32_t nk_s = kv_s + (buf ^ 1) * 2 * BK * D * 2;
      attn_tc::load_tile<BK, D, NTC>(nk_s, kb + (size_t)(j0 + BK) * D, D, BK);
      attn_tc::load_tile<BK, D, NTC>(nk_s + BK * D * 2, vb + (size_t)(j0 + BK) * D, D, BK);
      cp_async_commit();
    }
    // a warp whose rows all lie above the tile's first key sees only -1e30
    const bool live = !(causal && j0 > w0 + 16 * MT - 1);
    float s[MT][BK / 8][4];
    float tmax = MASKED;
    if (live) {
      qk<D, BK, MT>(s, q_s, r0, k_s);
      const bool edge = causal && j0 + BK - 1 > w0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = w0 + 16 * mt + g + 8 * (e >> 1), col = j0 + 8 * n + 2 * t + (e & 1);
            if (edge && col > row) s[mt][n][e] = MASKED;
            tmax = fmaxf(tmax, s[mt][n][e]);
          }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    if (lane == 0) red[buf * NW + warp] = tmax;
    __syncthreads();
    float bm = red[buf * NW];
#pragma unroll
    for (int w = 1; w < NW; ++w) bm = fmaxf(bm, red[buf * NW + w]);
    // the tile max of s = q.k * scale: scaling is monotone and every visited
    // tile has an unmasked score (key j0 <= its last row), so this is the
    // largest scaled score exactly
    bm *= scale;
    const bool kept = bm >= run + log_thresh;
    if (threadIdx.x == 0) keep_row[jt] = kept ? 1 : 0;
    if (!kept) continue;  // uniform across the block
    run = fmaxf(run, bm);
    if (!live) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) softmax_update<BK, D / 8>(s[mt], m[mt], l[mt], o[mt], c);
    pv<D, BK, MT>(o, s, v_s);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) store_rows<D>(out + base + (size_t)(w0 + 16 * mt) * D, D, 16, o[mt], l[mt]);
}

template <int D, int BQ, int BK>
int tc_launch(const void* q, const void* k, const void* v, void* out, int* keep, int BH, int S, float scale,
              float log_thresh, int causal, cudaStream_t st) {
  constexpr size_t SMEM = tc_smem_bytes<D, BQ, BK>();
  cudaError_t e = cudaFuncSetAttribute(skip_tc_kernel<D, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(S / BQ, BH);
  skip_tc_kernel<D, BQ, BK><<<grid, BQ * 2 / TC_MT, SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), keep, S, scale, log_thresh, causal);
  return (int)cudaGetLastError();
}

template <int D>
int tc_tiles(const void* q, const void* k, const void* v, void* out, int* keep, int BH, int S, int bq, int bk,
             float scale, float log_thresh, int causal, cudaStream_t st) {
  if (bq == 128 && bk == 128) return tc_launch<D, 128, 128>(q, k, v, out, keep, BH, S, scale, log_thresh, causal, st);
  if (bq == 128 && bk == 64) return tc_launch<D, 128, 64>(q, k, v, out, keep, BH, S, scale, log_thresh, causal, st);
  if (bq == 64 && bk == 128) return tc_launch<D, 64, 128>(q, k, v, out, keep, BH, S, scale, log_thresh, causal, st);
  if (bq == 64 && bk == 64) return tc_launch<D, 64, 64>(q, k, v, out, keep, BH, S, scale, log_thresh, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The CUDA-core route. q, k, v, out [BH, S, D] contiguous (dtype 0 = f32,
// 1 = bf16), keep [BH, S/bq, S/bk] int32; D in {16, 32, 64, 128};
// 1 <= bq, bk <= 128 dividing S.
extern "C" int skip_softmax_flash(const void* q, const void* k, const void* v, void* out, void* keep,
                                  int BH, int S, int D, int bq, int bk, int dtype, float scale,
                                  float log_thresh, int causal, void* stream) {
  if (bq < 1 || bk < 1 || bq > MAXB || bk > MAXB || S % bq || S % bk) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* kp = static_cast<int*>(keep);
  if (dtype == 0) return dispatch<float>(q, k, v, out, kp, BH, S, D, bq, bk, scale, log_thresh, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, kp, BH, S, D, bq, bk, scale, log_thresh, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route. q, k, v, out [BH, S, D] bf16 contiguous, 16-byte
// aligned, keep [BH, S/bq, S/bk] int32; D in {32, 64, 128}; bq, bk in
// {64, 128} dividing S.
extern "C" int skip_softmax_flash_tc(const void* q, const void* k, const void* v, void* out, void* keep, int BH,
                                     int S, int D, int bq, int bk, float scale, float log_thresh, int causal,
                                     void* stream) {
  if (S % bq || S % bk) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* kp = static_cast<int*>(keep);
  switch (D) {
    case 32:
      return tc_tiles<32>(q, k, v, out, kp, BH, S, bq, bk, scale, log_thresh, causal, st);
    case 64:
      return tc_tiles<64>(q, k, v, out, kp, BH, S, bq, bk, scale, log_thresh, causal, st);
    case 128:
      return tc_tiles<128>(q, k, v, out, kp, BH, S, bq, bk, scale, log_thresh, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
