// Causal GQA flash attention for Hopper (sm_90a) on the tensor cores: bf16
// in and out, f32 accumulators, head_dim 32, 64 or 128, any T (no padding
// needed), causal or not.
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/flash_gqa.py
// flash_attention_gqa (_kernel).
//
//   q [B, H, T, D] with any row / head / batch strides, k/v [B, Hkv, T, D]
//   contiguous (H % Hkv == 0, kv head h / rep), out strided like q:
//   out[b, h, t] = softmax_{s <= t}(q . k_s * sm_scale) @ v        (bf16)
//
// Online softmax as in the reference: s = (q . k) * scale as an f32
// multiply, masked scores are -1e30 and contribute p = 0, the running max
// starts at -1e30, the denominator clamps at 1e-30.
//
// What bounds it on an H100: operations. At Llama-3.1-8B prefill (8 x 32 x
// 2048 x 128, causal) 2.75e11 FLOP per layer, >= 0.28 ms at the 989 TFLOP/s
// bf16 tensor-core peak; q / k / v / out are 0.27 GB (0.08 ms at 3.35 TB/s).
// What this design does about it (step A of the redesign: `mma.sync`, not
// `wgmma`): one block of 4 warps per (b, h, 128-row q tile), each warp two
// 16-row m-tiles, so one K / V fragment from shared memory feeds two
// products. K / V come in 64-row tiles of kv head h / rep through a
// two-stage `cp.async` ring (tile j + 1 loads while tile j computes, one
// barrier per tile) into swizzled shared rows; tiles above the diagonal are
// never loaded, and a warp whose rows all lie above a tile's first key skips
// that tile (its update would be exact identity). S = Q K^T and O += P V run
// on the tensor cores (attn_tc.cuh), P split exactly into three bf16 terms,
// which costs 2x the bound's tensor-core work; the softmax takes one FFMA and
// one ex2 a score. The q tiles are launched heaviest first (reverse order on
// the grid's fast axis), so the causal triangle's light tiles make the tail.
// 96 KB of shared memory at D = 128. One block per (b, h): the query heads
// of a kv head read its K / V through L2 (1 MB a kv head at the 8B shape);
// a block over all `rep` heads of a kv head was not built. Measured (H100
// 80GB HBM3, 700 W, chip_smoke.py's kernels phase): 1.55-1.57 ms at the 8B
// shape, 18% of the bound, 3.2x SDPA (two bf16 terms of P: 1.30-1.32 ms);
// PERF.md's kernel table, row 3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tc.cuh"

namespace {

using namespace attn_tc;

// 128 q rows a block as 4 warps of two 16-row m-tiles, 64-key k tiles. On
// an H100 80GB HBM3 at the 8B shape this measured 1.31 ms against 1.40 (8
// warps of one m-tile), 1.56 (32-key tiles), 1.35-1.47 (registers capped for
// two to four blocks an SM) and 1.37-2.29 (a three-stage ring with the next
// tile's S issued before this tile's softmax).
constexpr int BQ = 128, BK = 64, MT = 2, NW = BQ / (16 * MT), NT = NW * 32;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * D * (BQ + 4 * BK);
}

template <int D>
__global__ void __launch_bounds__(NT)
    flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int H, int Hkv, int T,
                 float scale, int causal, long long sqb, long long sqh, long long sqt, long long sob,
                 long long soh, long long sot) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t q_s = smem_addr(smem);
  const uint32_t kv_s = q_s + BQ * D * 2;  // stage st: K at kv_s + 2 st BK D 2, V BK D 2 bytes after

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i0 = qt * BQ, r0 = 16 * MT * warp, w0 = i0 + r0;  // first row of the block, of this warp
  const __nv_bfloat16* kb = k + ((size_t)b * Hkv + hk) * T * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Hkv + hk) * T * D;

  const float c = scale * LOG2E;
  const int n_kt = (T + BK - 1) / BK;
  const int last = causal ? min(n_kt - 1, (i0 + BQ - 1) / BK) : n_kt - 1;
  load_tile<BQ, D, NT>(q_s, q + b * sqb + h * sqh + i0 * sqt, sqt, T - i0);
  load_tile<BK, D, NT>(kv_s, kb, D, T);
  load_tile<BK, D, NT>(kv_s + BK * D * 2, vb, D, T);
  cp_async_commit();

  float m[MT][2], l[MT][2], o[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = MASKED;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }

  for (int jt = 0; jt <= last; ++jt) {
    const int j0 = jt * BK;
    const uint32_t k_s = kv_s + (jt & 1) * 2 * BK * D * 2, v_s = k_s + BK * D * 2;
    cp_async_wait_all();
    __syncthreads();  // tile jt in place; every thread is done with tile jt - 1's buffers
    if (jt < last) {
      const uint32_t nk_s = kv_s + ((jt + 1) & 1) * 2 * BK * D * 2;
      load_tile<BK, D, NT>(nk_s, kb + (size_t)(j0 + BK) * D, D, T - j0 - BK);
      load_tile<BK, D, NT>(nk_s + BK * D * 2, vb + (size_t)(j0 + BK) * D, D, T - j0 - BK);
      cp_async_commit();
    }
    if (causal && j0 > w0 + 16 * MT - 1) continue;  // every score of this warp's rows is masked

    float s[MT][BK / 8][4];
    qk<D, BK, MT>(s, q_s, r0, k_s);
    if (j0 + BK > T || (causal && j0 + BK - 1 > w0)) {  // a tile on the diagonal or past T
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = w0 + 16 * mt + g + 8 * (e >> 1), col = j0 + 8 * n + 2 * t + (e & 1);
            const bool masked = col >= T || (causal && col > row);
            if (masked) s[mt][n][e] = MASKED;
          }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) softmax_update<BK, D / 8>(s[mt], m[mt], l[mt], o[mt], c);
    pv<D, BK, MT>(o, s, v_s);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows<D>(out + b * sob + h * soh + (w0 + 16 * mt) * sot, sot, T - w0 - 16 * mt, o[mt], l[mt]);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv, int T, float scale,
           int causal, const long long* sq, const long long* so, cudaStream_t st) {
  constexpr size_t SMEM = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_kernel<D><<<grid, NT, SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, Hkv, T, scale, causal, sq[0],
      sq[1], sq[2], so[0], so[1], so[2]);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, T, D] with element strides (sqb, sqh, sqt), k/v [B, Hkv, T, D]
// contiguous, out [B, H, T, D] with strides (sob, soh, sot); bf16, last
// dimension contiguous, rows 16-byte aligned; D in {32, 64, 128}.
extern "C" int flash_gqa(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv, int T,
                         int D, float scale, int causal, long long sqb, long long sqh, long long sqt,
                         long long sob, long long soh, long long sot, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long sq[3] = {sqb, sqh, sqt}, so[3] = {sob, soh, sot};
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, B, H, Hkv, T, scale, causal, sq, so, st);
    case 64:
      return launch<64>(q, k, v, out, B, H, Hkv, T, scale, causal, sq, so, st);
    case 128:
      return launch<128>(q, k, v, out, B, H, Hkv, T, scale, causal, sq, so, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
