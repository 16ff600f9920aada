// W4A8 GEMM for Hopper (sm_90a): int4 block-128 weights x per-token int8
// activations, exact int32 block sums, bf16 block scales applied in f32.
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/qmm.py qmm_int4_w48
// (_int4_w48_kernel / _int4_w48_kernel_noside).
//
//   y[n, o] = sum_b s[b, o] * (sum_{k in block b} x8[n, k] * q[o, k])   (f32)
//
// The caller multiplies by the per-token activation scale. Layout ("int4a8",
// quant/compress.py): packed [O, Kp/2] uint8, rows contiguous in K; inside
// each 8-group of k, byte i = nib(k_i) | nib(k_{i+4}) << 4, so one 32-bit
// word decodes (two masks, one byte-wise subtract) into two int8x4 words in
// the k order of four contiguous activation bytes. scales [Kp/128, O] bf16.
//
// What bounds it on an H100: decode (N = 8) is bound by the weight bytes
// (gate_proj 14336 x 4096: 29.4 MB of nibbles + 0.9 MB of scales, >= 9 us at
// 3.35 TB/s); prefill (N = 16384) by integer math (1.92 TOP for gate_proj,
// >= 0.97 ms at the 1979 TOP/s int8 tensor-core peak).
// What this design does about it: weights are read once per N-tile with
// 16-byte loads and decoded once into shared memory; a register-prefetch of
// the next K block overlaps the global loads with the current block's math.
// The math is __dp4a on the CUDA cores, exact in int32 per 128-block, so
// the kernel is bit-exact with its plain PyTorch version (__fmul_rn /
// __fadd_rn keep the f32 scale step from contracting into an FMA). dp4a
// runs well below the int8 tensor-core peak: mma/wgmma s8 is later work.
// Two tile shapes: 16 x 64 (N <= 32, decode: more blocks over O) and
// 64 x 128 (prefill). Rows and columns past N and O are masked; any N works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KB = 128;       // K block = one bf16 scale
constexpr int LDS = KB + 16;  // padded shared row stride (bytes): conflict-free 16-byte reads
constexpr int NT = 256;       // threads per block (16 x 16)

__device__ __forceinline__ uint32_t sext4(uint32_t u) {
  // four 4-bit two's complement values in the low nibbles of each byte -> int8x4
  return __vsub4(u ^ 0x08080808u, 0x08080808u);
}

template <int TN, int TO>
__global__ void __launch_bounds__(NT) w4a8_kernel(const int8_t* __restrict__ x,
                                                  const uint8_t* __restrict__ w,
                                                  const __nv_bfloat16* __restrict__ s,
                                                  float* __restrict__ y, int N, int K, int O,
                                                  int nblk) {
  constexpr int BN = 16 * TN, BO = 16 * TO;
  constexpr int XCH = BN * (KB / 16);       // 16-byte x chunks per tile
  constexpr int WCH = BO * (KB / 32);       // 16-byte packed-weight chunks per tile
  constexpr int XC = (XCH + NT - 1) / NT;
  constexpr int WC = (WCH + NT - 1) / NT;
  __shared__ __align__(16) int8_t xs[BN * LDS];
  __shared__ __align__(16) int8_t ws[BO * LDS];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.y * BN, o0 = blockIdx.x * BO;
  const size_t wrow = (size_t)nblk * (KB / 2);  // packed bytes per weight row

  int4 xr[XC], wr[WC];
  auto load = [&](int kb) {
#pragma unroll
    for (int i = 0; i < XC; ++i) {
      const int c = tid + i * NT;
      int4 v = make_int4(0, 0, 0, 0);
      if (c < XCH) {
        const int n = n0 + (c >> 3), k = kb * KB + (c & 7) * 16;
        if (n < N && k < K) v = *reinterpret_cast<const int4*>(x + (size_t)n * K + k);
      }
      xr[i] = v;
    }
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      const int c = tid + i * NT;
      int4 v = make_int4(0, 0, 0, 0);
      if (c < WCH) {
        const int o = o0 + (c >> 2);
        if (o < O) v = *reinterpret_cast<const int4*>(w + (size_t)o * wrow + kb * (KB / 2) + (c & 3) * 16);
      }
      wr[i] = v;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < XC; ++i) {
      const int c = tid + i * NT;
      if (c < XCH) *reinterpret_cast<int4*>(xs + (c >> 3) * LDS + (c & 7) * 16) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      const int c = tid + i * NT;
      if (c < WCH) {
        const uint32_t v[4] = {(uint32_t)wr[i].x, (uint32_t)wr[i].y, (uint32_t)wr[i].z,
                               (uint32_t)wr[i].w};
        uint32_t d[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[2 * j] = sext4(v[j] & 0x0F0F0F0Fu);             // k = 8g + 0..3
          d[2 * j + 1] = sext4((v[j] >> 4) & 0x0F0F0F0Fu);  // k = 8g + 4..7
        }
        int8_t* dst = ws + (c >> 2) * LDS + (c & 3) * 32;
        *reinterpret_cast<int4*>(dst) = make_int4(d[0], d[1], d[2], d[3]);
        *reinterpret_cast<int4*>(dst + 16) = make_int4(d[4], d[5], d[6], d[7]);
      }
    }
  };

  float acc[TN][TO];
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int j = 0; j < TO; ++j) acc[i][j] = 0.f;

  load(0);
  for (int kb = 0; kb < nblk; ++kb) {
    store();
    __syncthreads();
    if (kb + 1 < nblk) load(kb + 1);
    int isum[TN][TO];
#pragma unroll
    for (int i = 0; i < TN; ++i)
#pragma unroll
      for (int j = 0; j < TO; ++j) isum[i][j] = 0;
#pragma unroll 2
    for (int kk = 0; kk < KB; kk += 16) {
      int4 a[TN], b[TO];
#pragma unroll
      for (int i = 0; i < TN; ++i) a[i] = *reinterpret_cast<const int4*>(xs + (ty + 16 * i) * LDS + kk);
#pragma unroll
      for (int j = 0; j < TO; ++j) b[j] = *reinterpret_cast<const int4*>(ws + (tx + 16 * j) * LDS + kk);
#pragma unroll
      for (int i = 0; i < TN; ++i)
#pragma unroll
        for (int j = 0; j < TO; ++j) {
          int t = isum[i][j];
          t = __dp4a(a[i].x, b[j].x, t);
          t = __dp4a(a[i].y, b[j].y, t);
          t = __dp4a(a[i].z, b[j].z, t);
          t = __dp4a(a[i].w, b[j].w, t);
          isum[i][j] = t;
        }
    }
#pragma unroll
    for (int j = 0; j < TO; ++j) {
      const int o = o0 + tx + 16 * j;
      const float sj = o < O ? __bfloat162float(s[(size_t)kb * O + o]) : 0.f;
#pragma unroll
      for (int i = 0; i < TN; ++i) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn((float)isum[i][j], sj));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < TO; ++j) {
      const int o = o0 + tx + 16 * j;
      if (o < O) y[(size_t)n * O + o] = acc[i][j];
    }
  }
}

template <int TN, int TO>
void launch(const void* x, const void* w, const void* s, void* y, int N, int K, int O, int nblk,
            cudaStream_t st) {
  dim3 grid((O + 16 * TO - 1) / (16 * TO), (N + 16 * TN - 1) / (16 * TN));
  w4a8_kernel<TN, TO><<<grid, NT, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<float*>(y), N, K, O, nblk);
}

}  // namespace

// x [N, K] int8 (K % 16 == 0), w [O, nblk*64] uint8, s [nblk, O] bf16, y [N, O] f32.
extern "C" int w4a8_gemm(const void* x, const void* w, const void* s, void* y, int N, int K,
                         int O, int nblk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 32)
    launch<1, 4>(x, w, s, y, N, K, O, nblk, st);
  else
    launch<4, 8>(x, w, s, y, N, K, O, nblk, st);
  return (int)cudaGetLastError();
}
