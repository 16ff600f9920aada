// One-token GQA decode attention over a stored-form, kv-head-major KV cache
// (bf16, int8 or fp8 e4m3 codes, or plane-packed NVFP4), for Hopper (sm_90a).
//
// Replaces: tensorrt_model_optimizer_tpu/ops/pallas/kv_attention.py
// kv_decode_attention (_decode_kernel), formats bf16 / int8 / fp8 / nvfp4.
//
//   q    [B, n_kv*rep, hd] f32, pre-scaled (k's global scale / sqrt(hd))
//   k, v [B, n_kv, S, hd] stored codes; rows < pos are valid. NVFP4:
//        [B, n_kv, S, hd/2] plane-packed bytes with ks, vs [B, n_kv, S, hd/16]
//        E4M3 block-scale bytes (layout and decode: kv_common.cuh)
//   kn, vn [B, n_kv, hd] f32, the current token's code-domain k/v
//   out  [B, n_kv*rep, hd] f32 code-domain context (caller applies v's scale)
// with hd in {32, 64, 128} and rep in {1, 2, 4, 8}.
//
// f32 throughout, with the reference's constants: the max starts at -1e30,
// the denominator is clamped at 1e-30.
//
// What bounds it on an H100: the cache bytes. At Llama-3.1-8B, batch 8,
// pos 2048, int8: 8 x 8 x 2048 x 128 x 2 = 33.5 MB per layer, >= 10 us at
// 3.35 TB/s. What this design does about it, a flash-decoding split:
//   - kv_decode_split: the grid is (splits, n_kv, B); a block of 4 warps
//     owns `split_rows` (<= 256) rows < pos of one (sequence, kv head), so
//     at the 8B shape 8 splits make 512 blocks, ~4 an SM. A group of hd/16
//     lanes reads one row with 16-byte loads (Lane16, kv_common.cuh; 8 lanes
//     a row at hd 128), so a warp covers 2-16 rows at once and a score is a
//     3-step shuffle sum at hd 128; four rows a group are loaded before
//     any is used. The split's body, `kvc::split_attend`, is
//     shared with the paged decode (paged_attention_decode.cu): scores to
//     shared memory, each head's exact max and denominator, then p v. Each
//     split writes (max, denominator, accumulator) of its heads to a
//     scratch tensor the wrapper allocates. Rows >= pos are never read.
//   - kv_decode_merge: one block per (sequence, kv head) rescales the splits
//     to their common max (`kvc::merge_splits`), folds in the current token
//     and divides.
// Each K and V byte is read once; the q . k and p v work is a few FMAs a byte.
// Measured (H100 80GB HBM3, 700 W, chip_smoke.py's kernels phase; PERF.md's
// kernel table, row 2) at the 8B shape: int8 0.035 ms (29% of the bound;
// one block per (sequence, kv head) took 0.130), bf16 0.047 (1.08x SDPA).

#include "kv_common.cuh"

namespace {

using kvc::SNT;
using kvc::SPLIT_MAX;

template <typename T, int HD, int REP>
__global__ void __launch_bounds__(SNT) kv_decode_split(
    const float* __restrict__ q, const void* __restrict__ kc, const void* __restrict__ vc,
    const void* __restrict__ ks, const void* __restrict__ vs, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int n_kv, int S, int pos, int split_rows) {
  __shared__ kvc::SplitSmem<REP, HD> sm;
  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z, n_split = gridDim.x;
  const size_t head = (size_t)b * n_kv + g, row0 = head * S, part = head * n_split + sp;
  const int r0 = sp * split_rows, n = min(split_rows, pos - r0);  // this split's rows [r0, r0 + n)
  if (n <= 0) {  // pos 0: the current token alone
    kvc::split_empty<REP, HD>(part_ml + part * REP * 2, part_acc + part * REP * HD);
    return;
  }
  const int li = (threadIdx.x & 31) % (HD / 16);
  const kvc::Lane16<T, HD> K(kc, ks, li), V(vc, vs, li);
  float qr[REP][16];
#pragma unroll
  for (int h = 0; h < REP; ++h)
#pragma unroll
    for (int e = 0; e < 16; ++e) qr[h][e] = q[(head * REP + h) * HD + K.dim(e)];
  kvc::split_attend<T, HD, REP>(K, V, qr, n, [&](int i) { return row0 + r0 + i; }, part_ml + part * REP * 2,
                                part_acc + part * REP * HD, sm);
}

// out = (sum_sp acc_sp e^(m_sp - M) + e^(s_new - M) v_new) / max(sum_sp l_sp
// e^(m_sp - M) + e^(s_new - M), 1e-30), M the largest of the splits' maxima
// and the current token's score s_new = q . k_new (kvc::merge_splits)
template <int HD, int REP>
__global__ void __launch_bounds__(SNT) kv_decode_merge(const float* __restrict__ q, const float* __restrict__ kn,
                                                       const float* __restrict__ vn,
                                                       const float* __restrict__ part_ml,
                                                       const float* __restrict__ part_acc, float* __restrict__ out,
                                                       int n_kv, int n_split) {
  __shared__ float s_new[REP];
  const int g = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = (size_t)b * n_kv + g;
  for (int h = warp; h < REP; h += kvc::SNW) {
    float d = 0.f;
    for (int i = lane; i < HD; i += 32) d = fmaf(q[(head * REP + h) * HD + i], kn[head * HD + i], d);
    d = kvc::warp_sum(d);
    if (lane == 0) s_new[h] = d;
  }
  __syncthreads();
  const float* ml = part_ml + head * n_split * REP * 2;
  const float* acc = part_acc + head * n_split * REP * HD;
  for (int idx = threadIdx.x; idx < REP * HD; idx += SNT)
    out[head * REP * HD + idx] =
        kvc::merge_splits<HD, REP>(ml, acc, n_split, idx, s_new[idx / HD], 1.f, vn[head * HD + idx % HD]);
}

struct Launch {
  const void *q, *k, *v, *ks, *vs, *kn, *vn;
  void *part_ml, *part_acc, *out;
  int B, n_kv, S, pos, split_rows, n_split;
  cudaStream_t st;

  template <typename T, int HD, int REP>
  int run() const {
    kv_decode_split<T, HD, REP><<<dim3(n_split, n_kv, B), SNT, 0, st>>>(
        static_cast<const float*>(q), k, v, ks, vs, static_cast<float*>(part_ml), static_cast<float*>(part_acc),
        n_kv, S, pos, split_rows);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    kv_decode_merge<HD, REP><<<dim3(n_kv, B), SNT, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(kn), static_cast<const float*>(vn),
        static_cast<const float*>(part_ml), static_cast<const float*>(part_acc), static_cast<float*>(out), n_kv,
        n_split);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// fmt: 0 = bf16, 1 = int8, 2 = fp8 e4m3, 3 = NVFP4 (ks, vs: the block-scale bytes; else unused).
// part_ml [B, n_kv, n_split, rep, 2] and part_acc [B, n_kv, n_split, rep, hd]
// f32 scratch; n_split = max(1, ceil(pos / split_rows)), split_rows <= 256.
extern "C" int kv_decode_attention(int fmt, int hd, int rep, const void* q, const void* k,
                                   const void* v, const void* ks, const void* vs, const void* kn,
                                   const void* vn, void* part_ml, void* part_acc, void* out, int B,
                                   int n_kv, int S, int pos, int split_rows, int n_split, void* stream) {
  if (split_rows <= 0 || split_rows > SPLIT_MAX || n_split < 1 || (long long)n_split * split_rows < pos)
    return (int)cudaErrorInvalidValue;
  return kvc::dispatch(fmt, hd, rep, Launch{q, k, v, ks, vs, kn, vn, part_ml, part_acc, out, B, n_kv, S, pos,
                                            split_rows, n_split, static_cast<cudaStream_t>(stream)});
}
