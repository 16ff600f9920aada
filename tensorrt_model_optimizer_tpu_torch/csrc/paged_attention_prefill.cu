// Chunked-prefill GQA attention over a paged KV pool: T query tokens of each
// sequence attend to the sequence's paged context and, causally, to the
// chunk's own k/v, all in stored form (bf16, int8 or fp8 e4m3 codes, or
// plane-packed NVFP4 with E4M3 block scales), for Hopper (sm_90a). Two
// routes (`paged_attention.prefill_route`): the tensor cores for bf16 q
// (`paged_attention_prefill_tc`, the served path) and the CUDA cores for f32
// q (`paged_attention_prefill`).
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/paged_attention.py
// paged_attention_prefill (_prefill_kernel), formats raw and nvfp4.
//
//   q        [B, T, n_kv*rep, hd] f32 (CUDA cores) or bf16 (tensor cores); k's
//            global scale folded in by the caller
//   kp, vp   [n_pages, n_kv, page, C] stored pages, kv-head-major; C = hd, or
//            hd/2 for NVFP4 with ksp, vsp [n_pages, n_kv, page, hd/16]
//   bt       [B, max_pages] int32 page ids; -1 (unused) reads as page 0
//   lens     [B] int32 context rows of each sequence BEFORE the chunk
//   ck, cv   [B, T, n_kv, C] the chunk's k/v in stored form (NVFP4: cks, cvs
//            [B, T, n_kv, hd/16]); token t sees chunk columns <= t
//   out      [B, T, n_kv*rep, hd] f32 (CUDA cores) or bf16 (tensor cores);
//            the caller applies v's global scale
// The page walk stops at lens[b]: the chunk's rows are read from ck / cv,
// never from the pages, so a sequence whose page writes went elsewhere still
// attends to its own chunk. Scores are divided by sqrt(hd) here; online
// softmax in f32 with the reference's constants (-1e30, 1e-30).
//
// What bounds it on an H100: at Llama-3.1-8B (T = 64, 8 sequences with ~1024
// context rows, 32 heads over 8 kv heads of 128) the 4 n_heads T (ctx + T) hd
// = 9.1 GFLOP a layer, >= 9 us at the bf16 tensor-core peak, against 17 MB of
// int8 context, >= 5 us: operations, on the tensor cores.
//
// The tensor-core route. A block owns one (sequence, kv head) and a tile of
// 64 query rows that pack GQA: row m is token m / rep, head m % rep, so the
// rep heads of a kv head share every K / V tile (16 tokens x 4 heads at the
// 8B shape; 4 warps of one 16-row m-tile each). It walks the context in
// tiles of 64 keys, looking up each row's page in the block table (rows past
// lens[b] are zero-filled, their pages never dereferenced), then the chunk's
// rows up to its last token. Each K / V tile is turned from stored form into
// bf16 in XOR-swizzled shared memory: bf16 rows by `cp.async`, the other
// forms through registers (16-byte loads issued before the current tile's
// products, converted and stored after them), two tiles in flight. The
// conversion is exact for every stored form: int8 codes (|c| <= 128), every
// finite e4m3 value, and an E2M1 code times an E4M3 scale (at most 6
// significant bits, exponents inside bf16's range) all fit bf16. So q . k
// differs from the plain f32 product only in summation order, and S = Q K^T,
// the online softmax and O += P V (P split exactly into three bf16 terms) are
// attn_tc.cuh's, as in flash_gqa.cu; 1/sqrt(hd) (2^-3.5 at hd 128, not a
// power of two) stays in the f32 softmax constant. Blocks of the sequences
// with the longest contexts launch first, the chunk's last q tile of each
// first. 80 KB of shared memory at hd 128: two blocks an SM. Measured (H100
// 80GB HBM3, 700 W, chip_smoke.py's kernels phase; PERF.md's kernel table,
// row 16) at the 8B chunk (T = 64, contexts of 1024 rows down to 0): int8
// 0.067 ms, bf16 0.070 ms (0.9x SDPA with an explicit mask; the CUDA-core
// route took 0.94 ms), 6-9% of the bound: the sequence with the longest
// context walks 17 tiles in one block, one 64-key tile at a time.
//
// The CUDA-core route (f32 q, which bf16 would round): every (sequence, kv
// head, token) is one warp with its own online-softmax state, 8 tokens a
// block; a warp walks the context's live pages and then the chunk rows <= t,
// four rows at a time, for all `rep` query heads at once, with a warp-wide
// sum per score.

#include <math.h>

#include "attn_tc.cuh"
#include "kv_common.cuh"

namespace {

using kvc::NW;
using kvc::UNROLL;

template <typename F, int HD, int REP>
__global__ void __launch_bounds__(NW * 32) paged_prefill_kernel(
    const float* __restrict__ q, const void* __restrict__ kp, const void* __restrict__ vp,
    const void* __restrict__ ksp, const void* __restrict__ vsp, const int* __restrict__ bt,
    const int* __restrict__ lens, const void* __restrict__ ck, const void* __restrict__ cv,
    const void* __restrict__ cks, const void* __restrict__ cvs, float* __restrict__ out, int n_kv,
    int page, int max_pages, int T, float scale) {
  constexpr int E = HD / 32;  // dims per lane
  const int g = blockIdx.x, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.y * NW + warp;
  if (t >= T) return;  // this kernel has no block-wide barrier
  const size_t qrow = ((size_t)b * T + t) * n_kv + g;  // also the chunk's row index
  const float* qb = q + qrow * REP * HD + lane * E;
  const int* table = bt + (size_t)b * max_pages;
  const int ctx = min(lens[b], max_pages * page);

  float qr[REP][E];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] = qb[r * HD + e];
  }
  kvc::Softmax<REP, E> st;
  st.init();

  {  // the paged context, rows [0, ctx)
    const kvc::Rows<F, HD> K(kp, ksp, lane), V(vp, vsp, lane);
    for (int base = 0; base < ctx; base += UNROLL) {
      float kr[UNROLL][E], vr[UNROLL][E];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int s = base + u;
        if (s < ctx) {
          const int pid = max(table[s / page], 0);
          const size_t row = ((size_t)pid * n_kv + g) * page + s % page;
          K.load(row, kr[u]);
          V.load(row, vr[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (base + u >= ctx) break;
        st.fold(qr, kr[u], vr[u], scale);
      }
    }
  }
  {  // the chunk itself, causal: columns j <= t
    const kvc::Rows<F, HD> K(ck, cks, lane), V(cv, cvs, lane);
    for (int base = 0; base <= t; base += UNROLL) {
      float kr[UNROLL][E], vr[UNROLL][E];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u;
        if (j <= t) {
          const size_t row = ((size_t)b * T + j) * n_kv + g;
          K.load(row, kr[u]);
          V.load(row, vr[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (base + u > t) break;
        st.fold(qr, kr[u], vr[u], scale);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float L = fmaxf(st.l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) out[(qrow * REP + r) * HD + lane * E + e] = st.acc[r][e] / L;
  }
}

struct Launch {
  const void *q, *kp, *vp, *ksp, *vsp, *bt, *lens, *ck, *cv, *cks, *cvs;
  void* out;
  int B, T, n_kv, page, max_pages;
  cudaStream_t st;

  template <typename F, int HD, int REP>
  int run() const {
    paged_prefill_kernel<F, HD, REP><<<dim3(n_kv, (T + NW - 1) / NW, B), NW * 32, 0, st>>>(
        static_cast<const float*>(q), kp, vp, ksp, vsp, static_cast<const int*>(bt),
        static_cast<const int*>(lens), ck, cv, cks, cvs, static_cast<float*>(out), n_kv, page,
        max_pages, T, 1.0f / sqrtf((float)HD));
    return (int)cudaGetLastError();
  }
};

}  // namespace

// fmt: 0 = bf16, 1 = int8, 2 = fp8 e4m3, 3 = NVFP4 (ksp, vsp, cks, cvs: the scale bytes; else unused).
extern "C" int paged_attention_prefill(int fmt, int hd, int rep, const void* q, const void* kp,
                                       const void* vp, const void* ksp, const void* vsp,
                                       const void* bt, const void* lens, const void* ck,
                                       const void* cv, const void* cks, const void* cvs, void* out,
                                       int B, int T, int n_kv, int page, int max_pages,
                                       void* stream) {
  return kvc::dispatch(fmt, hd, rep, Launch{q, kp, vp, ksp, vsp, bt, lens, ck, cv, cks, cvs, out, B,
                                            T, n_kv, page, max_pages,
                                            static_cast<cudaStream_t>(stream)});
}

// ---------------------------------------------------------------------------
// The tensor-core route.

namespace {

using attn_tc::LOG2E;
using attn_tc::MASKED;
using attn_tc::cp_async16;
using attn_tc::swz;

constexpr int TBM = 64;        // packed query rows (token, head) of a block
constexpr int TBK = 64;        // keys of a K / V tile
constexpr int TNW = TBM / 16;  // warps: one 16-row m-tile each
constexpr int TNT = TNW * 32;

template <int HD>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * HD * (TBM + 4 * TBK);  // Q, then two stages of K and V
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void st_shared4(uint32_t addr, const uint32_t* h) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(h[0]), "r"(h[1]), "r"(h[2]),
               "r"(h[3]));
}

// One K tile and one V tile of TBK rows each: stored form in device memory
// -> bf16 rows in the swizzled tiles. `fetch` issues the loads of row r =
// row_of(r) of the arrays (-1: past the valid rows, zero-filled and never
// read); `store` converts and writes what `fetch` brought into registers.
// Thread tid handles the 16-byte stored chunks tid, tid + TNT, ... of a row
// array, the same chunks of K and of V.
template <typename F, int HD>
struct Stage;

// bf16 rows go to shared memory as they are, by cp.async
template <int HD>
struct Stage<__nv_bfloat16, HD> {
  static constexpr int CPR = HD / 8;  // 16-byte chunks a row
  static constexpr int N = TBK * CPR;
  template <typename RowOf>
  __device__ __forceinline__ void fetch(const void* kb, const void*, const void* vb, const void*, RowOf row_of,
                                        uint32_t k_dst, uint32_t v_dst) {
    const __nv_bfloat16 *kp = static_cast<const __nv_bfloat16*>(kb), *vp = static_cast<const __nv_bfloat16*>(vb);
#pragma unroll
    for (int i = 0; i < N / TNT; ++i) {
      const int c = i * TNT + threadIdx.x, r = c / CPR, ch = c % CPR;
      const long long row = row_of(r);
      const long long off = row >= 0 ? row * HD + ch * 8 : 0;
      cp_async16(k_dst + swz<HD>(r, ch), kp + off, row >= 0);
      cp_async16(v_dst + swz<HD>(r, ch), vp + off, row >= 0);
    }
  }
  __device__ __forceinline__ void store() const {}
};

// int8 codes and fp8 e4m3 values: 16 a load, converted exactly to bf16
template <typename F, int HD>
struct Stage {
  static_assert(sizeof(F) == 1, "one-byte stored forms");
  static constexpr int CPR = HD / 16;
  static constexpr int N = TBK * CPR;
  static constexpr int PER = (N + TNT - 1) / TNT;
  uint4 kr[PER], vr[PER];
  uint32_t kd, vd;

  template <typename RowOf>
  __device__ __forceinline__ void fetch(const void* kb, const void*, const void* vb, const void*, RowOf row_of,
                                        uint32_t k_dst, uint32_t v_dst) {
    kd = k_dst;
    vd = v_dst;
    const uint8_t *kp = static_cast<const uint8_t*>(kb), *vp = static_cast<const uint8_t*>(vb);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = i * TNT + threadIdx.x, r = c / CPR, ch = c % CPR;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (N % TNT != 0 && c >= N) break;
      const long long row = row_of(r);
      if (row >= 0) {
        kr[i] = __ldg(reinterpret_cast<const uint4*>(kp + row * HD + ch * 16));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(vp + row * HD + ch * 16));
      }
    }
  }
  // 16 stored bytes -> dims 16 ch .. 16 ch + 15: bf16 chunks 2 ch, 2 ch + 1
  static __device__ __forceinline__ void put(uint32_t tile, int r, int ch, const uint4& raw) {
    float f[16];
    kvc::decode16<F>(raw, f);
    uint32_t h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) h[k] = bf16_pair(f[2 * k], f[2 * k + 1]);
    st_shared4(tile + swz<HD>(r, 2 * ch), h);
    st_shared4(tile + swz<HD>(r, 2 * ch + 1), h + 4);
  }
  __device__ __forceinline__ void store() const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = i * TNT + threadIdx.x, r = c / CPR, ch = c % CPR;
      if (N % TNT != 0 && c >= N) break;
      put(kd, r, ch, kr[i]);
      put(vd, r, ch, vr[i]);
    }
  }
};

// NVFP4: the 16 plane bytes of chunk ch hold dims 16 ch .. 16 ch + 15 (low
// nibbles, scale byte ch) and HD/2 + 16 ch .. (high nibbles, scale byte
// HD/32 + ch)
template <int HD>
struct Stage<kvc::Fp4, HD> {
  static constexpr int CPR = HD / 32;
  static constexpr int N = TBK * CPR;
  static constexpr int PER = (N + TNT - 1) / TNT;
  uint4 kr[PER], vr[PER];
  uint32_t ks[PER], vs[PER];  // the low block's scale byte | the high block's << 8
  uint32_t kd, vd;

  template <typename RowOf>
  __device__ __forceinline__ void fetch(const void* kb, const void* ksb, const void* vb, const void* vsb,
                                        RowOf row_of, uint32_t k_dst, uint32_t v_dst) {
    kd = k_dst;
    vd = v_dst;
    const uint8_t *kp = static_cast<const uint8_t*>(kb), *vp = static_cast<const uint8_t*>(vb);
    const uint8_t *kq = static_cast<const uint8_t*>(ksb), *vq = static_cast<const uint8_t*>(vsb);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = i * TNT + threadIdx.x, r = c / CPR, ch = c % CPR;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      ks[i] = vs[i] = 0u;
      if (N % TNT != 0 && c >= N) break;
      const long long row = row_of(r);
      if (row >= 0) {
        kr[i] = __ldg(reinterpret_cast<const uint4*>(kp + row * (HD / 2) + ch * 16));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(vp + row * (HD / 2) + ch * 16));
        const long long s0 = row * (HD / 16) + ch, s1 = s0 + HD / 32;
        ks[i] = (uint32_t)__ldg(kq + s0) | ((uint32_t)__ldg(kq + s1) << 8);
        vs[i] = (uint32_t)__ldg(vq + s0) | ((uint32_t)__ldg(vq + s1) << 8);
      }
    }
  }
  static __device__ __forceinline__ void put(uint32_t tile, int r, int ch, const uint4& raw, uint32_t sc) {
    float a[16], b[16];  // plane bytes 0-7, then 8-15: [e] low dims 16 ch + e (+ 8), [8 + e] high
    kvc::decode16_fp4(make_uint2(raw.x, raw.y), sc, a);
    kvc::decode16_fp4(make_uint2(raw.z, raw.w), sc, b);
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo[k] = bf16_pair(a[2 * k], a[2 * k + 1]);
      lo[4 + k] = bf16_pair(b[2 * k], b[2 * k + 1]);
      hi[k] = bf16_pair(a[8 + 2 * k], a[9 + 2 * k]);
      hi[4 + k] = bf16_pair(b[8 + 2 * k], b[9 + 2 * k]);
    }
    st_shared4(tile + swz<HD>(r, 2 * ch), lo);  // bf16 chunks of dims 16 ch .. and HD/2 + 16 ch ..
    st_shared4(tile + swz<HD>(r, 2 * ch + 1), lo + 4);
    st_shared4(tile + swz<HD>(r, HD / 16 + 2 * ch), hi);
    st_shared4(tile + swz<HD>(r, HD / 16 + 2 * ch + 1), hi + 4);
  }
  __device__ __forceinline__ void store() const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = i * TNT + threadIdx.x, r = c / CPR, ch = c % CPR;
      if (N % TNT != 0 && c >= N) break;
      put(kd, r, ch, kr[i], ks[i]);
      put(vd, r, ch, vr[i], vs[i]);
    }
  }
};

template <typename F, int HD, int REP>
__global__ void __launch_bounds__(TNT) paged_prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kp, const void* __restrict__ vp,
    const void* __restrict__ ksp, const void* __restrict__ vsp, const int* __restrict__ bt,
    const int* __restrict__ lens, const void* __restrict__ ck, const void* __restrict__ cv,
    const void* __restrict__ cks, const void* __restrict__ cvs, __nv_bfloat16* __restrict__ out, int B, int T,
    int n_kv, int page, int max_pages, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_b;
  const uint32_t q_s = attn_tc::smem_addr(smem);
  const uint32_t kv_s = q_s + TBM * HD * 2;  // stage st: K at kv_s + 2 st TBK HD 2, V TBK HD 2 bytes after

  // heaviest first: the block's sequence is the one of its rank by context
  // length (ties by index); within it, the kv head, then the q tile, the
  // chunk's last tile first
  const int n_mt = (T * REP + TBM - 1) / TBM;
  const int rank = blockIdx.x / (n_kv * n_mt), rest = blockIdx.x % (n_kv * n_mt);
  for (int i = threadIdx.x; i < B; i += TNT) {
    const int li = lens[i];
    int r = 0;
    for (int j = 0; j < B; ++j) {
      const int lj = lens[j];
      r += lj > li || (lj == li && j < i);
    }
    if (r == rank) s_b = i;
  }
  __syncthreads();
  const int b = s_b, g = rest / n_mt, M0 = (n_mt - 1 - rest % n_mt) * TBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int nH = n_kv * REP;
  const int ctx = min(lens[b], max_pages * page);
  const int t_hi = (min(M0 + TBM, T * REP) - 1) / REP;  // the tile's last token
  const int n_ctx = (ctx + TBK - 1) / TBK, n_tiles = n_ctx + t_hi / TBK + 1;
  const int* table = bt + (size_t)b * max_pages;

  {  // the Q tile: packed row m is token (M0 + m) / REP, head (M0 + m) % REP
    constexpr int CPR = HD / 8;
#pragma unroll
    for (int i = 0; i < TBM * CPR / TNT; ++i) {
      const int c = i * TNT + threadIdx.x, r = c / CPR, ch = c % CPR;
      const int M = M0 + r, t = M / REP;
      const bool ok = t < T;
      const __nv_bfloat16* src = q + (((size_t)b * T + t) * nH + g * REP + M % REP) * HD + ch * 8;
      cp_async16(q_s + swz<HD>(r, ch), ok ? src : q, ok);
    }
  }

  // tile jt: the context's tiles first, each row's page from the table, then
  // the chunk's own rows; -1 past the valid rows
  Stage<F, HD> stage;
  auto fetch = [&](int jt) {
    const uint32_t k_s = kv_s + (jt & 1) * 2 * TBK * HD * 2, v_s = k_s + TBK * HD * 2;
    if (jt < n_ctx) {
      stage.fetch(kp, ksp, vp, vsp, [&](int r) -> long long {
        const int s = jt * TBK + r;
        if (s >= ctx) return -1;
        const int pid = max(table[s / page], 0);
        return ((long long)pid * n_kv + g) * page + s % page;
      }, k_s, v_s);
    } else {
      stage.fetch(ck, cks, cv, cvs, [&](int r) -> long long {
        const int j = (jt - n_ctx) * TBK + r;
        return j < T ? ((long long)b * T + j) * n_kv + g : -1;
      }, k_s, v_s);
    }
  };
  fetch(0);
  attn_tc::cp_async_commit();
  stage.store();

  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f}, o[1][HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[0][n][0] = o[0][n][1] = o[0][n][2] = o[0][n][3] = 0.f;
  const float c = scale * LOG2E;
  const int w0 = M0 + 16 * warp;  // this warp's first packed row

  for (int jt = 0; jt < n_tiles; ++jt) {
    const uint32_t k_s = kv_s + (jt & 1) * 2 * TBK * HD * 2, v_s = k_s + TBK * HD * 2;
    attn_tc::cp_async_wait_all();
    __syncthreads();  // tile jt in place; every thread is done with tile jt - 1's buffers
    const bool more = jt + 1 < n_tiles;
    if (more) {
      fetch(jt + 1);
      attn_tc::cp_async_commit();
    }
    float s[1][TBK / 8][4];
    attn_tc::qk<HD, TBK, 1>(s, q_s, 16 * warp, k_s);
    const bool ctx_tile = jt < n_ctx;
    const int j0 = (ctx_tile ? jt : jt - n_ctx) * TBK, lim = ctx_tile ? ctx : T;
    if (!ctx_tile || j0 + TBK > ctx) {  // the context's last tile, or one of the chunk's (causal)
#pragma unroll
      for (int n = 0; n < TBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = (w0 + gq + 8 * (e >> 1)) / REP, col = j0 + 8 * n + 2 * tq + (e & 1);
          const bool masked = col >= lim || (!ctx_tile && col > t);
          if (masked) s[0][n][e] = MASKED;
        }
    }
    attn_tc::softmax_update<TBK, HD / 8>(s[0], m, l, o[0], c);
    attn_tc::pv<HD, TBK, 1>(o, s, v_s);
    if (more) stage.store();
  }

  // out[b, t, g REP + h] = o / max(l, 1e-30) in bf16, for tokens t < T
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float L = l[r];
    L += __shfl_xor_sync(0xffffffffu, L, 1);
    L += __shfl_xor_sync(0xffffffffu, L, 2);
    const float inv = 1.f / fmaxf(L, 1e-30f);
    const int M = w0 + gq + 8 * r, t = M / REP;
    if (t >= T) continue;
    __nv_bfloat16* dst = out + (((size_t)b * T + t) * nH + g * REP + M % REP) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n + 2 * tq) =
          __floats2bfloat162_rn(o[0][n][2 * r] * inv, o[0][n][2 * r + 1] * inv);
  }
}

struct LaunchTC {
  const void *q, *kp, *vp, *ksp, *vsp, *bt, *lens, *ck, *cv, *cks, *cvs;
  void* out;
  int B, T, n_kv, page, max_pages;
  cudaStream_t st;

  template <typename F, int HD, int REP>
  int run() const {
    constexpr size_t SMEM = tc_smem_bytes<HD>();
    cudaError_t e = cudaFuncSetAttribute(paged_prefill_tc_kernel<F, HD, REP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    const int n_mt = (T * REP + TBM - 1) / TBM;
    paged_prefill_tc_kernel<F, HD, REP><<<B * n_kv * n_mt, TNT, SMEM, st>>>(
        static_cast<const __nv_bfloat16*>(q), kp, vp, ksp, vsp, static_cast<const int*>(bt),
        static_cast<const int*>(lens), ck, cv, cks, cvs, static_cast<__nv_bfloat16*>(out), B, T, n_kv, page,
        max_pages, 1.0f / sqrtf((float)HD));
    return (int)cudaGetLastError();
  }
};

}  // namespace

// The tensor-core route: bf16 q and out, otherwise the arguments of
// `paged_attention_prefill`; any page size (each row's page is looked up).
extern "C" int paged_attention_prefill_tc(int fmt, int hd, int rep, const void* q, const void* kp,
                                          const void* vp, const void* ksp, const void* vsp,
                                          const void* bt, const void* lens, const void* ck,
                                          const void* cv, const void* cks, const void* cvs, void* out,
                                          int B, int T, int n_kv, int page, int max_pages,
                                          void* stream) {
  if (page <= 0) return (int)cudaErrorInvalidValue;
  return kvc::dispatch(fmt, hd, rep, LaunchTC{q, kp, vp, ksp, vsp, bt, lens, ck, cv, cks, cvs, out, B,
                                              T, n_kv, page, max_pages,
                                              static_cast<cudaStream_t>(stream)});
}
