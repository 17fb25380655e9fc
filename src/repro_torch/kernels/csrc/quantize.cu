// Per-block quantize / dequantize for the compressed wire formats.
//
// Replaces: src/repro/kernels/quantize.py:73 quantize_blocks (its
//   pallas_call at :85) and :101 dequantize_blocks (:108), with the padding
//   of their wrappers in src/repro/kernels/ops.py:67-105.
// Semantics: each row is cut into 256-element blocks (a ragged tail counts
//   as zeros); per block scale = max(max|x|, 1e-30) * (1 / qmax), payload
//   = clip(x / scale, -qmax, qmax), rounded half to even for int8 (qmax 127)
//   or cast to float8 e4m3fn with saturation (qmax 448; the clip already
//   keeps it finite). Dequantize is float(v) * scale. NaN propagates as in
//   jnp.max / torch.amax: a block holding a NaN gets a NaN scale (fmaxf
//   would drop it), and the clip keeps NaN. The scale multiplies by the
//   f32 reciprocal of qmax, as the reference's XLA computes its `/ qmax`
//   (it folds a division by a constant); x / scale is IEEE division (no
//   fast math, no reciprocal), so int8 payloads match at rounding ties.
// Bound: bytes. Quantize reads 4 bytes and writes 1 + 4/256 per element;
//   dequantize the reverse. At 3.35 TB/s (H100 SXM data sheet) that is the
//   least time; the arithmetic is a few operations per element.
// Design: one warp per 256-element block, 8 elements per lane at a stride
//   of 32 (lane-contiguous, so loads coalesce at any row pitch: the
//   planner's chunk widths are often odd, so rows are not 16-byte aligned);
//   a warp-shuffle abs-max; lane 0 writes the scale. Rows are addressed
//   through an optional row-index table, so one launch quantizes the send
//   blocks of several ranks where they lie in the rank-stacked buffer, and
//   one launch dequantizes into the receivers' slots. Dequantize gives each
//   thread 4 payload bytes (one 32-bit load: payload rows are 256-aligned)
//   and stores them as one float4 where the output row is 16-byte aligned.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = 8;        // warps (scale blocks) per CTA in quantize
constexpr int kThreads = 256;    // dequantize CTA
constexpr int kPerThread = 4;    // dequantize elements per thread

// max that keeps a NaN from either side (fmaxf returns the other operand)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <int FMT>  // 0 = int8, 1 = float8 e4m3fn
__device__ __forceinline__ uint8_t encode(float x, float scale) {
  constexpr float qmax = FMT == 0 ? 127.f : 448.f;
  float q = x / scale;
  if (q == q) q = fminf(fmaxf(q, -qmax), qmax);
  if (FMT == 0) {
    return static_cast<uint8_t>(static_cast<int8_t>(rintf(q)));
  }
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3));
}

template <int FMT>
__device__ __forceinline__ float decode(uint8_t b) {
  if (FMT == 0) return static_cast<float>(static_cast<int8_t>(b));
  const __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b), __NV_E4M3);
  return __half2float(__half(h));
}

// a row index outside [0, limit) is a caller's bug: stop the launch
// rather than read or write another buffer
__device__ __forceinline__ long long checked_row(const long long* rows,
                                                 long long r,
                                                 long long limit) {
  if (rows == nullptr) return r;
  const long long i = rows[r];
  if (i < 0 || i >= limit) __trap();
  return i;
}

// warp w quantizes block (w / nb, w % nb); x row r starts at
// x + (rows ? rows[r] : r) * pitch and holds C valid elements
template <int FMT>
__global__ void quantize_rows(const float* __restrict__ x,
                              const long long* __restrict__ rows,
                              long long x_rows, long long pitch, long long C,
                              long long nb, long long total,
                              uint8_t* __restrict__ values,
                              float* __restrict__ scales) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (w >= total) return;
  const int lane = threadIdx.x & 31;
  const long long r = w / nb;
  const long long c0 = (w % nb) * kBlock;
  const float* xr = x + checked_row(rows, r, x_rows) * pitch;
  float v[kBlock / 32];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kBlock / 32; ++k) {
    const long long c = c0 + k * 32 + lane;
    v[k] = c < C ? xr[c] : 0.f;
    amax = nan_max(amax, fabsf(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  constexpr float inv_qmax = 1.f / (FMT == 0 ? 127.f : 448.f);
  const float scale = nan_max(amax, 1e-30f) * inv_qmax;
  uint8_t* out = values + r * nb * kBlock + c0;
#pragma unroll
  for (int k = 0; k < kBlock / 32; ++k) {
    out[k * 32 + lane] = encode<FMT>(v[k], scale);
  }
  if (lane == 0) scales[w] = scale;
}

// CTA b dequantizes columns [tile * 1024, +1024) of payload row b / tiles
// into out + (rows ? rows[r] : r) * pitch, C valid columns
template <int FMT>
__global__ void dequantize_rows(const uint8_t* __restrict__ values,
                                const float* __restrict__ scales, long long nb,
                                long long C, long long tiles,
                                float* __restrict__ out,
                                const long long* __restrict__ rows,
                                long long out_rows, long long pitch, int vec) {
  const long long r = blockIdx.x / tiles;
  const long long c = (blockIdx.x % tiles) * (kThreads * kPerThread) +
                      static_cast<long long>(threadIdx.x) * kPerThread;
  if (c >= C) return;
  const uint32_t word =
      *reinterpret_cast<const uint32_t*>(values + r * nb * kBlock + c);
  const float s = scales[r * nb + c / kBlock];  // 4 | 256: one block
  float f[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    f[k] = decode<FMT>(static_cast<uint8_t>(word >> (8 * k))) * s;
  }
  float* dst = out + checked_row(rows, r, out_rows) * pitch + c;
  if (vec && c + kPerThread <= C) {
    *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (c + k < C) dst[k] = f[k];
    }
  }
}

}  // namespace

// fmt: 0 = int8, 1 = fp8 e4m3fn. values: (B, nb * 256) bytes, scales:
// (B, nb) f32. rows: int64 (B,) row indices into x's x_rows rows, or null
// for x's rows 0..B-1. Returns cudaGetLastError().
extern "C" int repro_quantize_rows(const void* x, const void* rows,
                                   long long x_rows, long long pitch,
                                   long long B, long long C, void* values,
                                   void* scales, int fmt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const long long nb = (C + kBlock - 1) / kBlock > 0 ? (C + kBlock - 1) / kBlock : 1;
  const long long total = B * nb;
  const long long grid = (total + kWarps - 1) / kWarps;
  const float* xp = static_cast<const float*>(x);
  const long long* rp = static_cast<const long long*>(rows);
  uint8_t* vp = static_cast<uint8_t*>(values);
  float* sp = static_cast<float*>(scales);
  if (fmt == 0) {
    quantize_rows<0><<<(unsigned)grid, kWarps * 32, 0, s>>>(xp, rp, x_rows, pitch, C, nb,
                                                             total, vp, sp);
  } else {
    quantize_rows<1><<<(unsigned)grid, kWarps * 32, 0, s>>>(xp, rp, x_rows, pitch, C, nb,
                                                             total, vp, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

// values: (B, nb * 256), scales (B, nb); writes C columns of each row into
// out + (rows ? rows[r] : r) * pitch, rows indexing out's out_rows rows.
// Returns cudaGetLastError().
extern "C" int repro_dequantize_rows(const void* values, const void* scales,
                                     long long B, long long nb, long long C,
                                     void* out, const void* rows,
                                     long long out_rows, long long pitch,
                                     int fmt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0) return 0;
  const long long per_cta = kThreads * kPerThread;
  const long long tiles = (C + per_cta - 1) / per_cta;
  const long long grid = tiles * B;
  const int vec = pitch % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const uint8_t* vp = static_cast<const uint8_t*>(values);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  const long long* rp = static_cast<const long long*>(rows);
  if (fmt == 0) {
    dequantize_rows<0><<<(unsigned)grid, kThreads, 0, s>>>(vp, sp, nb, C, tiles, op, rp,
                                                            out_rows, pitch, vec);
  } else {
    dequantize_rows<1><<<(unsigned)grid, kThreads, 0, s>>>(vp, sp, nb, C, tiles, op, rp,
                                                            out_rows, pitch, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
