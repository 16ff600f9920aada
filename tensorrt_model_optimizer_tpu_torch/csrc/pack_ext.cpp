// Host-side packing / quantization loops (C++), loaded through ctypes
// (the port's copy of the JAX package's `csrc/pack_ext.cpp`, the analog of
// the reference's `modelopt_round_and_pack_ext.cpp`): weight conversion for
// checkpoint export and import runs on the host, so the pack loops run in
// native code. Host code, not a kernel.
//
// Build: `csrc/__init__.py` runs the system C++ compiler at first use
// (-O3 -march=native -shared -fPIC) into build/pack_ext/. The loops keep
// the JAX package's `omp` pragmas; built without -fopenmp, they are ignored.
//
// All functions operate on contiguous row-major buffers.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Round-to-nearest-even helper on floats.
static inline float rne(float x) { return nearbyintf(x); }

// INT4 round + adjacent-nibble pack (reference export layout:
// out[j] = (q[2j+1] << 4) | q[2j]).
// w: [rows, cols] fp32, scale: [rows, cols/block] fp32, out: [rows, cols/2].
void int4_round_and_pack(const float* w, const float* scale, uint8_t* out,
                         int64_t rows, int64_t cols, int64_t block) {
  int64_t nblk = cols / block;
#pragma omp parallel for
  for (int64_t r = 0; r < rows; ++r) {
    const float* wr = w + r * cols;
    const float* sr = scale + r * nblk;
    uint8_t* po = out + r * (cols / 2);
    for (int64_t j = 0; j < cols / 2; ++j) {
      float s0 = sr[(2 * j) / block];
      float s1 = sr[(2 * j + 1) / block];
      int q0 = (int)rne(wr[2 * j] / (s0 != 0.f ? s0 : 1.f));
      int q1 = (int)rne(wr[2 * j + 1] / (s1 != 0.f ? s1 : 1.f));
      q0 = q0 < -8 ? -8 : (q0 > 7 ? 7 : q0);
      q1 = q1 < -8 ? -8 : (q1 > 7 ? 7 : q1);
      po[j] = (uint8_t)(((q1 & 0xF) << 4) | (q0 & 0xF));
    }
  }
}

// E2M1 rounding with the reference's decision boundaries
// (`nvfp4_quant.py:18-49`).
static inline float fp4_round_mag(float m) {
  if (m <= 0.25f) return 0.0f;
  if (m < 0.75f) return 0.5f;
  if (m <= 1.25f) return 1.0f;
  if (m < 1.75f) return 1.5f;
  if (m <= 2.5f) return 2.0f;
  if (m < 3.5f) return 3.0f;
  if (m <= 5.0f) return 4.0f;
  return 6.0f;
}

static inline uint8_t fp4_code(float v) {
  float m = fabsf(v);
  uint8_t idx;
  if (m <= 0.25f) idx = 0;
  else if (m < 0.75f) idx = 1;
  else if (m <= 1.25f) idx = 2;
  else if (m < 1.75f) idx = 3;
  else if (m <= 2.5f) idx = 4;
  else if (m < 3.5f) idx = 5;
  else if (m <= 5.0f) idx = 6;
  else idx = 7;
  // zero magnitude has no sign bit (reference maps -0 -> code 0,
  // `fp4_to_codes` uses q < 0 which is false for -0.0)
  if (idx == 0) return 0;
  return (uint8_t)(idx | (v < 0.f ? 8 : 0));
}

// Saturating E4M3 round-trip value (no native fp8 on host): clamp to 448,
// round mantissa to 3 bits at the value's exponent.
static inline float e4m3_roundtrip(float x) {
  if (x != x) return x;
  float ax = fabsf(x);
  if (ax > 448.f) return x > 0 ? 448.f : -448.f;
  if (ax == 0.f) return 0.f;
  int e;
  frexpf(ax, &e);          // ax = m * 2^e, m in [0.5, 1)
  e -= 1;                  // exponent of ax
  if (e < -6) e = -6;      // subnormal floor (bias 7)
  float q = ldexpf(1.0f, e - 3);  // ulp
  float r = rne(x / q) * q;
  if (fabsf(r) > 448.f) r = r > 0 ? 448.f : -448.f;
  return r;
}

// NVFP4 quantize + pack: w [rows, cols] fp32 -> codes packed adjacent
// (out [rows, cols/2]), per-block E4M3 scale values (scales [rows, cols/16]),
// given global_scale (amax/(6*448)).
void nvfp4_quantize_and_pack(const float* w, uint8_t* out, float* scales,
                             float global_scale, int64_t rows, int64_t cols,
                             int64_t block) {
  int64_t nblk = cols / block;
  float gs = global_scale != 0.f ? global_scale : 1.f;
#pragma omp parallel for
  for (int64_t r = 0; r < rows; ++r) {
    const float* wr = w + r * cols;
    uint8_t* po = out + r * (cols / 2);
    float* sr = scales + r * nblk;
    for (int64_t b = 0; b < nblk; ++b) {
      float amax = 0.f;
      for (int64_t k = 0; k < block; ++k) {
        float a = fabsf(wr[b * block + k]);
        if (a > amax) amax = a;
      }
      float s = e4m3_roundtrip(amax / (6.f * gs));
      if (s <= 0.f) s = 1.f;
      sr[b] = s;
      // Divide (not multiply-by-reciprocal): boundary values sit exactly on
      // the E2M1 decision points and a 1-ulp difference flips the code.
      float sb = s * gs;
      for (int64_t k = 0; k < block; k += 2) {
        int64_t i0 = b * block + k;
        uint8_t c0 = fp4_code(wr[i0] / sb);
        uint8_t c1 = fp4_code(wr[i0 + 1] / sb);
        po[i0 / 2] = (uint8_t)((c1 << 4) | c0);
      }
    }
  }
}

// NF4 codebook (QLoRA normal-float grid; matches ops/numerics.NF4_TABLE and
// the reference's NF4QTensor, `qtensor/nf4_tensor.py`).
static const float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

static inline uint8_t nf4_code(float xn) {
  // nearest codebook entry (grid is sorted; 16-way scan is branch-light)
  int best = 0;
  float bd = fabsf(xn - kNF4[0]);
  for (int i = 1; i < 16; ++i) {
    float d = fabsf(xn - kNF4[i]);
    if (d < bd) { bd = d; best = i; }
  }
  return (uint8_t)best;
}

// NF4 quantize + pack: per-block absmax scale, nibble-packed codes
// (reference `NF4_quantize`, kernels/quantization/gemm/tensor_quant.cpp:20).
// w: [n] fp32 viewed as n/block blocks; out: [n/2] bytes; absmax: [n/block].
void nf4_quantize_and_pack(const float* w, uint8_t* out, float* absmax,
                           int64_t n, int64_t block) {
  int64_t nblk = n / block;
#pragma omp parallel for
  for (int64_t b = 0; b < nblk; ++b) {
    const float* wb = w + b * block;
    float am = 0.f;
    for (int64_t k = 0; k < block; ++k) {
      float a = fabsf(wb[k]);
      if (a > am) am = a;
    }
    absmax[b] = am;
    float s = am != 0.f ? am : 1.f;
    uint8_t* po = out + (b * block) / 2;
    for (int64_t k = 0; k < block; k += 2) {
      uint8_t c0 = nf4_code(wb[k] / s);
      uint8_t c1 = nf4_code(wb[k + 1] / s);
      po[k / 2] = (uint8_t)((c1 << 4) | c0);
    }
  }
}

// NF4 dequantize (reference `NF4_dequantize`).
void nf4_dequantize(const uint8_t* packed, const float* absmax, float* out,
                    int64_t n, int64_t block) {
  int64_t nblk = n / block;
#pragma omp parallel for
  for (int64_t b = 0; b < nblk; ++b) {
    float s = absmax[b] != 0.f ? absmax[b] : 1.f;
    float* ob = out + b * block;
    const uint8_t* pb = packed + (b * block) / 2;
    for (int64_t k = 0; k < block; k += 2) {
      ob[k] = kNF4[pb[k / 2] & 0xF] * s;
      ob[k + 1] = kNF4[(pb[k / 2] >> 4) & 0xF] * s;
    }
  }
}

// INT4 unpack (adjacent layout) back to int8 — import path.
void int4_unpack(const uint8_t* packed, int8_t* out, int64_t n_bytes) {
#pragma omp parallel for
  for (int64_t i = 0; i < n_bytes; ++i) {
    int lo = packed[i] & 0xF;
    int hi = (packed[i] >> 4) & 0xF;
    out[2 * i] = (int8_t)(lo >= 8 ? lo - 16 : lo);
    out[2 * i + 1] = (int8_t)(hi >= 8 ? hi - 16 : hi);
  }
}

}  // extern "C"
