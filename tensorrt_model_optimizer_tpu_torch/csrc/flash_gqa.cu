// Causal GQA flash attention for Hopper (sm_90a): bf16 in and out, f32
// accumulators, head_dim 32, 64 or 128, any T (no padding needed).
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/flash_gqa.py
// flash_attention_gqa (_kernel).
//
//   q [B, H, T, D], k/v [B, Hkv, T, D] bf16 (H % Hkv == 0, kv head h / rep)
//   out[b, h, t] = softmax_{s <= t}(q . k_s * sm_scale) @ v        (bf16)
//
// Online softmax as in the reference: running max starts at -1e30, masked
// scores are -1e30 and contribute p = 0, the denominator clamps at 1e-30.
//
// What bounds it on an H100: operations. At Llama-3.1-8B prefill (8 x 32 x
// 2048 x 128, causal) 2.75e11 FLOP per layer, >= 0.28 ms at the 989 TFLOP/s
// bf16 tensor-core peak. What this design does about it: one block per
// (b, h, 64-row q tile) keeps q (as f32), one 64-row k/v tile of kv head
// h / rep (as bf16, rows padded to 130 for conflict-free reads) and the
// 64 x 64 probabilities in shared memory (81 KB at D = 128); k/v tiles above the
// diagonal are never loaded. The dots run on the CUDA cores in f32 (each
// thread owns a 4 x 4 score tile and a 4 x D/16 output tile), far below the
// tensor-core peak: mma/wgmma bf16 with TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64;
constexpr int NT = 256;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * BQ * D + 2 * sizeof(__nv_bfloat16) * BK * (D + 2) + sizeof(float) * BQ * BK;
}

template <int D>
__global__ void __launch_bounds__(NT) flash_kernel(const __nv_bfloat16* __restrict__ q,
                                                   const __nv_bfloat16* __restrict__ k,
                                                   const __nv_bfloat16* __restrict__ v,
                                                   __nv_bfloat16* __restrict__ out, int H,
                                                   int Hkv, int T, float scale, int causal) {
  constexpr int KST = D + 2;  // bf16 row stride of the k/v tiles
  constexpr int JO = D / 32;   // output column pairs per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(q_s + BQ * D);
  __nv_bfloat16* v_s = k_s + BK * KST;
  float* p_s = reinterpret_cast<float*>(v_s + BK * KST);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = qt * BQ;
  const __nv_bfloat16* qb = q + ((size_t)b * H + h) * T * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Hkv + hk) * T * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Hkv + hk) * T * D;

  // q tile -> f32 (rows past T are zeros and never written out)
  for (int c = tid; c < BQ * D / 8; c += NT) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (i0 + r < T) {
      const uint4 u = *reinterpret_cast<const uint4*>(qb + (size_t)(i0 + r) * D + col);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        f[2 * j] = t.x;
        f[2 * j + 1] = t.y;
      }
    }
    float4* dst = reinterpret_cast<float4*>(q_s + r * D + col);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }

  float m[4], l[4], acc[4][2 * JO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * JO; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (T + BK - 1) / BK;
  const int last = causal ? min(n_kt - 1, (i0 + BQ - 1) / BK) : n_kt - 1;
  for (int jt = 0; jt <= last; ++jt) {
    const int j0 = jt * BK;
    for (int c = tid; c < BK * D / 8; c += NT) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      uint4 uk = make_uint4(0, 0, 0, 0), uv = make_uint4(0, 0, 0, 0);
      if (j0 + r < T) {
        uk = *reinterpret_cast<const uint4*>(kb + (size_t)(j0 + r) * D + col);
        uv = *reinterpret_cast<const uint4*>(vb + (size_t)(j0 + r) * D + col);
      }
      uint32_t* dk = reinterpret_cast<uint32_t*>(k_s + r * KST + col);
      uint32_t* dv = reinterpret_cast<uint32_t*>(v_s + r * KST + col);
      dk[0] = uk.x; dk[1] = uk.y; dk[2] = uk.z; dk[3] = uk.w;
      dv[0] = uv.x; dv[1] = uv.y; dv[2] = uv.z; dv[3] = uv.w;
    }
    __syncthreads();

    // scores: rows ty + 16 i, cols tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      float2 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float2*>(q_s + (ty + 16 * i) * D + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k_s + (tx + 16 * j) * KST + d));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + ty + 16 * i;
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + tx + 16 * j;
        const bool masked = col >= T || (causal && col > row);
        s[i][j] = masked ? -1e30f : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > -1e29f ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * BK + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 2 * JO; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc[i] over d columns 2 tx + 32 jj (+1)
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * BK + c];
#pragma unroll
      for (int jj = 0; jj < JO; ++jj) {
        const float2 vv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v_s + c * KST + 2 * tx + 32 * jj));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * jj] += p[i] * vv.x;
          acc[i][2 * jj + 1] += p[i] * vv.y;
        }
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = out + ((size_t)b * H + h) * T * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= T) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < JO; ++jj) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + 2 * tx + 32 * jj) =
          __floats2bfloat162_rn(acc[i][2 * jj] * inv_l, acc[i][2 * jj + 1] * inv_l);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv, int T,
           float scale, int causal, cudaStream_t st) {
  constexpr size_t SMEM = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_kernel<D><<<grid, NT, SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, Hkv, T, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, T, D], k/v [B, Hkv, T, D], out [B, H, T, D]; bf16, contiguous; D in {32, 64, 128}.
extern "C" int flash_gqa(const void* q, const void* k, const void* v, void* out, int B, int H,
                         int Hkv, int T, int D, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, B, H, Hkv, T, scale, causal, st);
    case 64:
      return launch<64>(q, k, v, out, B, H, Hkv, T, scale, causal, st);
    case 128:
      return launch<128>(q, k, v, out, B, H, Hkv, T, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
