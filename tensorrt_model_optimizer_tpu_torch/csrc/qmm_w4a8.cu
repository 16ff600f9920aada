// W4A8 GEMM for Hopper (sm_90a): int4 block-128 weights x per-token int8
// activations on the int8 tensor cores, exact int32 block sums, bf16 block
// scales applied in f32.
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/qmm.py qmm_int4_w48
// (_int4_w48_kernel / _int4_w48_kernel_noside).
//
//   y[n, o] = sum_b s[b, o] * (sum_{k in block b} x8[n, k] * q[o, k])   (f32)
//
// The caller multiplies by the per-token activation scale. Layout ("int4a8",
// ops/cuda/qmm.py): packed [O, Kp/2] uint8, rows contiguous in K; inside
// each 8-group of k, byte i = nib(k_i) | nib(k_{i+4}) << 4. scales [Kp/128,
// O] bf16. x [N, K] int8 with K % 16 == 0.
//
// Numerics, both routes. The weights are the MMA's A operand (M = output
// rows), x its B operand (N = tokens), int8 x int8 -> int32. A code enters
// as 16q, the nibble left in the high half of its byte (an exact int8 in
// [-128, 112]): one mask decodes a packed word's high nibbles (k 8g +
// 4..7), a shift and a mask its low ones (k 8g + 0..3). A 128-wide block's
// products sum exactly in int32, starting from the bits of M = 1.5 * 2^23,
// so the sum's bits read as f32 are M + 16v exactly (|16v| <= 16 * 128 *
// 127 * 8 < 2^22). The fold is
//   acc = __fadd_rn(acc, __fmaf_rn(M + 16v, s / 16, -M * s / 16)),
// blocks in order 0, 1, ...: M * s / 16 is exact for a bf16 s, so the FFMA's
// exact value is v * s and it rounds once, as __fmul_rn(v, s) would; a
// scale of 2^64 or more, or not finite, takes __fmul_rn(16v, s / 16)
// instead (warp-uniform branch). So each block adds RN(v s) to the f32
// result with one more rounding, exactly as the plain version does.
//
// Prefill (N > 16), `prefill_kernel`. Bound on an H100 by the int8 tensor
// cores (gate_proj at N = 16384: 1.92 TOP, >= 0.97 ms at 1979 TOP/s). A
// block takes 192 output rows x 128 tokens: 3 warpgroups, each a
// wgmma.m64n128k32 s8 (4 a 128-block) from shared memory, 64 int32 and 64
// f32 accumulators a thread. Per K block, one thread has the TMA bring x's
// 128 x 128-byte tile (swizzled 128B by the copy, zero past N and K) and
// the 192 x 64-byte packed weight tile (zero past O) into a ring of 5
// stages, completing on the stage's mbarrier; each warpgroup decodes its 64
// weight rows once into a 128B-swizzled int8 tile (16q), and both operands'
// descriptors are K-major with a 128-byte swizzle (a k32 step is +32 bytes
// on the start address). One block barrier a K block (a stage is free once
// every warpgroup is past it), one warpgroup barrier after the decode. Blocks
// walk the output in columns of 16 token tiles (a 1-D grid), so the blocks
// in flight share x's and the weights' tiles in the 50 MB L2. 165 KB of
// dynamic shared memory, one block an SM. The f32 output goes out with
// streaming stores. Tensor maps are encoded per call by
// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda).
//
// Decode (N <= 16), `decode_kernel`. Bound by the weight bytes (gate_proj:
// 29.4 MB of nibbles + 0.9 MB of scales, >= 9 us at 3.35 TB/s). mma.sync
// m16n8k32 s8: a warp owns 32 output rows (two m16 tiles) and the <= 8 or
// <= 16 tokens are its n8 tiles. The k order inside an MMA is free as long
// as A and B agree: in k32 step s, thread t of a lane quad takes k 32t + 8s
// .. 32t + 8s + 7 of the block for both, so thread (g, t) feeds its
// fragments from its own 16-byte loads of weight rows g and g + 8 and 32
// bytes of token g's x per K block: no shared memory, no barrier. K is
// split over the grid in whole 128-blocks (`n_split`, from
// `qmm.decode_splits`: one wave of blocks, launch bounds fix the blocks an
// SM holds), and each warp keeps U K blocks of loads in flight. Each split
// writes its f32 partial (its blocks folded in order from 0) to a
// workspace, fences and bumps its tile's arrival counter; the warp that
// arrives last sums the partials in split order 0, 1, ... (no float
// atomics, so repeated calls match bit for bit), writes y and sets the
// counter back to 0. One launch. The plain version (`w4a8_matmul_plain`)
// takes the same split, so the two agree bit for bit on both routes.
//
// What is left (H100, tools/torch_w4a8_probe.py, PERF.md): at prefill each
// warpgroup waits for its wgmmas before it folds, and the block barrier
// keeps the warpgroups in step, so the fold and the decode do not overlap
// the tensor cores; with two accumulator sets (a producer warpgroup and
// setmaxnreg to make room) they would. The TMA copies are bound by what the
// L2 delivers to a 192 x 128 tile; a 2-CTA cluster sharing x's tile by
// multicast was slower with its cluster barrier a K block.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KB = 128;              // K block = one bf16 scale
constexpr int MAGIC = 0x4B400000;    // bits of 1.5 * 2^23: + v stays exact for |v| < 2^22
constexpr float MAGIC_F = 12582912.f;

// 16 x the four 4-bit two's complement codes of a packed word's low (k 8g
// + 0..3) or high (k 8g + 4..7) nibbles, as int8x4: a code in the high
// half of a byte is an exact int8 (16q in [-128, 112]), so one mask (and a
// shift for the low nibbles) decodes it
__device__ __forceinline__ uint32_t lo16(uint32_t p) { return (p << 4) & 0xF0F0F0F0u; }
__device__ __forceinline__ uint32_t hi16(uint32_t p) { return p & 0xF0F0F0F0u; }

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// d = a . b + MAGIC (the first k32 step of a block)
__device__ __forceinline__ void mma_first(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(MAGIC));
}

// d += a . b
__device__ __forceinline__ void mma_acc(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A block's scale s as the fold takes it: s / 16 (the codes entered the
// MMA as 16q) and -MAGIC_F * s / 16, both exact for a bf16 s below 2^64.
struct Scale {
  float s16, nms;
};
__device__ __forceinline__ Scale scale_of(uint16_t bits) {
  const float s16 = __uint_as_float((uint32_t)bits << 16) * 0.0625f;
  return {s16, -MAGIC_F * s16};
}
__device__ __forceinline__ bool scale_fast(float s16) { return fabsf(s16) < 0x1p60f; }

// One block's sum, isum = MAGIC + 16 v with |16 v| < 2^22, into the f32
// result: acc + RN(v * s), one rounding each. FAST: the FFMA's exact
// (MAGIC + 16 v) s / 16 - MAGIC s / 16 = v s rounds once, as __fmul_rn(v, s)
// does; else (a scale of 2^64 or more, or not finite) the exact 16 v first.
template <bool FAST>
__device__ __forceinline__ float fold(float acc, int isum, Scale s) {
  const float f = __int_as_float(isum);
  if constexpr (FAST)
    return __fadd_rn(acc, __fmaf_rn(f, s.s16, s.nms));
  else
    return __fadd_rn(acc, __fmul_rn(__fadd_rn(f, -MAGIC_F), s.s16));
}

// ---- prefill route ----

constexpr int WGS = 3;                 // warpgroups, each 64 output rows x 128 tokens
constexpr int BO = 64 * WGS, BT = 128;  // output rows (weight rows) x tokens of a block
constexpr int PT = 128 * WGS;          // threads
constexpr int TILE = 128 * KB;       // x's 128 x 128-byte swizzled tile (16 KB)
constexpr int ATILE = BO * KB;       // the decoded weights' swizzled tile
constexpr int WLD = KB / 2;          // packed weight row of a K block (bytes)
constexpr int STAGE = TILE + BO * WLD;  // x's tile (swizzled) + the packed weight tile
constexpr int STAGES = 5;
constexpr int SMEM = 1024 + ATILE + STAGES * STAGE + 8 * STAGES;  // + alignment slack, decoded tile, barriers
constexpr int GROUP = 16;            // token tiles of a column of the walk

// byte offset of 16-byte chunk c of row r in a 128B-swizzled tile of 128-byte rows
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sdesc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 int32 a thread) += A (64 x 32, K-major) . B (128 x 32, K-major), both from shared memory
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t saddr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}
// one 2-D tile of `map` at (inner c0, outer c1) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(saddr(bar))
      : "memory");
}

__global__ void __launch_bounds__(PT, 1)
    prefill_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                   const uint16_t* __restrict__ s, float* __restrict__ y, int N, int O, int nblk) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* atile = smem;  // decoded weights (16q), BO rows x 128 bytes, swizzled
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + ATILE + STAGES * STAGE);  // one a stage: its tiles landed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq4 = warp & 3, g = lane >> 2, t = lane & 3;
  const int tiles_o = (O + BO - 1) / BO, tiles_n = (N + BT - 1) / BT;
  const int span = GROUP * tiles_o, first = blockIdx.x / span * GROUP, rest = blockIdx.x % span;
  const int rows = min(tiles_n - first, GROUP);
  const int n0 = (first + rest % rows) * BT, o0 = rest / rows * BO;

  auto stage_of = [&](int kb) { return smem + ATILE + (kb % STAGES) * STAGE; };
  auto load_stage = [&](int kb) {  // one thread: x's tile (swizzled by the copy) and the packed weights
    uint8_t* xs = stage_of(kb);
    uint64_t* b = bar + kb % STAGES;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(b, TILE + BO * WLD);
    tma_2d(xs, &xmap, kb * KB, n0, b);
    tma_2d(xs + TILE, &wmap, kb * WLD, o0, b);
  };
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(bar + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[64];
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    d[i] = MAGIC;
  }
  const uint64_t da0 = sdesc(saddr(atile + wg * 64 * 128));
  // the thread's weight rows: 16 wq4 + g and + 8 of its warpgroup's 64
  const int orow = o0 + wg * 64 + 16 * wq4 + g;

  if (tid == 0)
    for (int st = 0; st < STAGES - 1 && st < nblk; ++st) load_stage(st);

  for (int kb = 0; kb < nblk; ++kb) {
    Scale sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) sc[h] = scale_of(orow + 8 * h < O ? __ldg(s + (size_t)kb * O + orow + 8 * h) : (uint16_t)0);
    const bool fast = __all_sync(0xffffffffu, scale_fast(sc[0].s16) && scale_fast(sc[1].s16));
    mbar_wait(bar + kb % STAGES, (kb / STAGES) & 1);
    __syncthreads();  // stage kb has landed; every warpgroup is done with the previous block's tiles
    if (tid == 0 && kb + STAGES - 1 < nblk) load_stage(kb + STAGES - 1);
    const uint8_t* xs = stage_of(kb);
    {  // decode: thread tid takes packed words 8 (tid & 1) .. + 7 of weight row tid / 2 -> 4 chunks of 16q
      const int r = tid >> 1, hf = tid & 1;
      const uint4* pp = reinterpret_cast<const uint4*>(xs + TILE + r * WLD + 32 * hf);
      const uint4 p0 = pp[0], p1 = pp[1];
      const uint32_t pw[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint4*>(atile + swz(r, 4 * hf + c)) =
            make_uint4(lo16(pw[2 * c]), hi16(pw[2 * c]), lo16(pw[2 * c + 1]), hi16(pw[2 * c + 1]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's decoded rows are whole
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint64_t db0 = sdesc(saddr(xs));
#pragma unroll
    for (int step = 0; step < 4; ++step) wgmma_m64n128k32(d, da0 + 2 * step, db0 + 2 * step);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // d[4j + r]: weight row 16 wq4 + g (+ 8 for r >= 2), token 8j + 2t (+ 1 for odd r)
    if (fast) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[i] = fold<true>(acc[i], d[i], sc[(i >> 1) & 1]);
        d[i] = MAGIC;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[i] = fold<false>(acc[i], d[i], sc[(i >> 1) & 1]);
        d[i] = MAGIC;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = orow + 8 * h;
    if (o >= O) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + 8 * j + 2 * t + q;
        if (n < N) __stcs(y + (size_t)n * O + o, acc[4 * j + 2 * h + q]);
      }
  }
}

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda)
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a row-major [rows, cols] uint8 tensor, boxes of box_rows x box_cols bytes
bool tile_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows, int box_cols,
              CUtensorMapSwizzle swizzle) {
  auto fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, estrides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- decode route ----

constexpr int DW = 2;                      // warps of a decode block
constexpr int DMT = 2;                     // m16 tiles of output rows a warp owns
constexpr int DROWS = 16 * DMT;            // output rows of a warp (its tile of the fix-up)
constexpr int WS_TILE = DMT * 2 * 4 * 32;  // floats of one warp's partial tile (NT8 <= 2)
// blocks an SM holds at once, which the register budget is cut to (launch
// bounds): the wrapper's split count fills at most this one wave
constexpr int DEC_BLOCKS_N8 = 6, DEC_BLOCKS_N16 = 4;
constexpr int U = 3;                       // K blocks of loads in flight a warp

// NT8: n8 tiles of tokens (1: N <= 8, 2: N <= 16)
template <int NT8>
__global__ void __launch_bounds__(DW * 32, NT8 == 1 ? DEC_BLOCKS_N8 : DEC_BLOCKS_N16)
    decode_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w, const uint16_t* __restrict__ s,
                  float* __restrict__ y, float* __restrict__ ws, int* __restrict__ counters, int N, int K, int O,
                  int nkb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wt = blockIdx.x * DW + warp;  // the warp's tile: output rows [32 wt, 32 wt + 32)
  if (wt * DROWS >= O) return;            // the same for every split: no arrival expected
  const int sp = blockIdx.y, n_split = gridDim.y;
  const int kb0 = (int)((long long)sp * nkb / n_split), kb1 = (int)((long long)(sp + 1) * nkb / n_split);
  const size_t wrow = (size_t)nkb * (KB / 2);

  int row[DMT][2];  // rows g and g + 8 of each m16 tile
#pragma unroll
  for (int i = 0; i < DMT; ++i) {
    row[i][0] = wt * DROWS + 16 * i + g;
    row[i][1] = row[i][0] + 8;
  }

  uint4 wv[U][DMT][2];   // packed k 32t .. 32t + 31 of rows g, g + 8
  uint4 xv[U][NT8][2];   // x of token g + 8j at k 32t .. 32t + 31
  Scale sc[U][DMT][2];
  auto load = [&](int u, int kb) {
    const bool live = kb < kb1;
#pragma unroll
    for (int i = 0; i < DMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = live && row[i][h] < O;
        wv[u][i][h] = ok ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)row[i][h] * wrow + kb * (KB / 2) + 16 * t))
                         : make_uint4(0u, 0u, 0u, 0u);
        sc[u][i][h] = scale_of(ok ? __ldg(s + (size_t)kb * O + row[i][h]) : (uint16_t)0);
      }
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const int n = g + 8 * j;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = kb * KB + 32 * t + 16 * c;
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
          int isum[NT8][4];
#pragma unroll
          for (int step = 0; step < 4; ++step) {  // k 32t + 8 step .. + 7
            const uint32_t pa = word(wv[u][i][0], step), pb = word(wv[u][i][1], step);
            const uint32_t a[4] = {lo16(pa), lo16(pb), hi16(pa), hi16(pb)};
#pragma unroll
            for (int j = 0; j < NT8; ++j) {
              const uint4& xq = xv[u][j][step >> 1];
              const uint32_t b[2] = {step & 1 ? xq.z : xq.x, step & 1 ? xq.w : xq.y};
              if (step == 0)
                mma_first(isum[j], a, b);
              else
                mma_acc(isum[j], a, b);
            }
          }
          // c[0], c[1]: row g, tokens 2t, 2t + 1; c[2], c[3]: row g + 8
          if (scale_fast(sc[u][i][0].s16) && scale_fast(sc[u][i][1].s16)) {
#pragma unroll
            for (int j = 0; j < NT8; ++j)
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[i][j][r] = fold<true>(acc[i][j][r], isum[j][r], sc[u][i][r >> 1]);
          } else {
#pragma unroll
            for (int j = 0; j < NT8; ++j)
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[i][j][r] = fold<false>(acc[i][j][r], isum[j][r], sc[u][i][r >> 1]);
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
    for (int s0 = 1; s0 < n_split; s0 += SB) {
      float nx[SB][E];
#pragma unroll
      for (int q = 0; q < SB; ++q)
#pragma unroll
        for (int e = 0; e < E; ++e)
          nx[q][e] = s0 + q < n_split ? __ldcg(tile + (size_t)(s0 + q) * WS_TILE + e * 32) : 0.f;
#pragma unroll
      for (int q = 0; q < SB; ++q)
        if (s0 + q < n_split)
#pragma unroll
          for (int e = 0; e < E; ++e) v[e] = __fadd_rn(v[e], nx[q][e]);
    }
#pragma unroll
    for (int i = 0; i < DMT; ++i)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = v[(i * NT8 + j) * 4 + r];
    if (lane == 0) counters[wt] = 0;  // ready for the next call on this stream
  }

#pragma unroll
  for (int i = 0; i < DMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = row[i][h];
      if (o >= O) continue;
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = 8 * j + 2 * t + q;
          if (n < N) y[(size_t)n * O + o] = acc[i][j][2 * h + q];
        }
    }
}

}  // namespace

// x [N, K] int8 (K % 16 == 0), w [O, nblk*64] uint8, s [nblk, O] bf16, y [N, O] f32.
// N <= 16: the decode route, K split into n_split runs of whole 128-blocks
// (1 <= n_split <= nblk; ws: ceil(O / 32) * n_split * 512 floats and
// counters: ceil(O / 32) ints, 0 between calls; both unused at n_split 1).
// N > 16: the prefill route (ws, counters and n_split unused).
extern "C" int w4a8_gemm(const void* x, const void* w, const void* s, void* y, int N, int K, int O, int nblk,
                         void* ws, void* counters, int n_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const uint16_t* sp = static_cast<const uint16_t*>(s);
  float* yp = static_cast<float*>(y);
  if (N <= 0 || O <= 0) return (int)cudaSuccess;
  if (N <= 16) {
    if (n_split < 1 || n_split > nblk || (n_split > 1 && (ws == nullptr || counters == nullptr)))
      return (int)cudaErrorInvalidValue;
    dim3 grid((O + DW * DROWS - 1) / (DW * DROWS), n_split);
    float* wsp = static_cast<float*>(ws);
    int* cp = static_cast<int*>(counters);
    if (N <= 8)
      decode_kernel<1><<<grid, DW * 32, 0, st>>>(xp, wp, sp, yp, wsp, cp, N, K, O, nblk);
    else
      decode_kernel<2><<<grid, DW * 32, 0, st>>>(xp, wp, sp, yp, wsp, cp, N, K, O, nblk);
  } else {
    CUtensorMap xmap, wmap;
    if (!tile_map(&xmap, x, N, K, BT, KB, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tile_map(&wmap, w, O, nblk * WLD, BO, WLD, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    const int tiles = ((O + BO - 1) / BO) * ((N + BT - 1) / BT);
    prefill_kernel<<<tiles, PT, SMEM, st>>>(xmap, wmap, sp, yp, N, O, nblk);
  }
  return (int)cudaGetLastError();
}
