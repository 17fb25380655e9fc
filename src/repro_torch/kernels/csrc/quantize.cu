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
// Design: quantize gives one warp per 256-element block, 8 elements per
//   lane at a stride of 32 (lane-contiguous, so loads coalesce at any row
//   pitch: the planner's chunk widths are often odd, so rows are not
//   16-byte aligned); a warp-shuffle abs-max; lane 0 writes the scale. Rows
//   are addressed through an optional row-index table, so one launch
//   quantizes the send blocks of several ranks where they lie in the
//   rank-stacked buffer, and one launch dequantizes into the receivers'
//   slots.
// Dequantize stores aligned float4s on every row, whatever the row's
//   offset mod 16 bytes (odd pitches, a receive view, `out_cols` < Cp).
//   A row's first h = (its 16-byte boundary - its start) / 4 columns are
//   its head; the body is cut into quads of 4 columns, each one aligned
//   float4 store. Row column c is payload byte c (payload rows are
//   256-byte aligned), so quad j's 4 bytes start at byte 4 j + h: the two
//   aligned payload words j and j + 1, funnelled with __byte_perm (the
//   right word from the next lane by shuffle, the warp's last lane's from
//   lane 0's next word, or its own load). A warp takes 128 quads: lane l
//   loads words 32 k + l and stores quad 32 k + l (k < 4), so every load
//   reads 128 contiguous bytes and every store writes 512; giving each
//   thread 16 contiguous columns (one 16-byte load, four float4 stores 64
//   bytes apart) was 1.6x slower on the card (tools/staging_sweep.cu).
//   Stores stream past the caches (st.cs). One block of 8 warps per
//   4096 columns of a row; the head (block 0 of the row, lane 0) and the
//   ragged last quad go column by column.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = 8;        // warps (scale blocks) per CTA in quantize
constexpr int kThreads = 256;    // dequantize CTA
constexpr int kQuads = 4;        // dequantize float4 stores per thread
constexpr long long kTileQuads = kThreads * kQuads;  // dequantize quads per CTA

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

template <int FMT>
__device__ __forceinline__ float byte_times(unsigned word, int k, float s) {
  return decode<FMT>(static_cast<uint8_t>(word >> (8 * k))) * s;
}

// CTA b dequantizes quads [tile * kTileQuads, +kTileQuads) of payload row
// b / tiles (Cp = nb * 256 bytes) into out + (rows ? rows[r] : r) * pitch,
// C valid columns
template <int FMT>
__global__ void __launch_bounds__(kThreads)
    dequantize_rows(const uint8_t* __restrict__ values, const float* __restrict__ scales,
                    long long nb, long long C, long long tiles, float* __restrict__ out,
                    const long long* __restrict__ rows, long long out_rows, long long pitch) {
  const long long r = blockIdx.x / tiles;
  const int lane = threadIdx.x & 31;
  const long long q0 = (blockIdx.x - r * tiles) * kTileQuads + (threadIdx.x >> 5) * (32 * kQuads);
  const unsigned* pay = reinterpret_cast<const unsigned*>(values + r * nb * kBlock);
  const long long words = nb * (kBlock / 4);
  const float* sc = scales + r * nb;
  float* dst = out + checked_row(rows, r, out_rows) * pitch;
  long long h = ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
  if (h > C) h = C;
  const long long quads = (C - h) / 4;  // aligned float4 stores of the row
  const int rem = static_cast<int>(C - h - quads * 4);
  const unsigned sel = 0x3210u + 0x1111u * static_cast<unsigned>(h);
  unsigned w[kQuads];
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const long long j = q0 + 32 * k + lane;
    w[k] = j < words ? __ldcs(pay + j) : 0u;
  }
  const long long after = q0 + 32 * kQuads;  // the word after the warp's last
  const unsigned last = lane == 31 && after < words ? __ldcs(pay + after) : 0u;
  if (q0 == 0 && lane == 0) {
    for (int k = 0; k < h; ++k) dst[k] = byte_times<FMT>(w[0], k, sc[0]);
  }
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const unsigned down = __shfl_down_sync(~0u, w[k], 1);
    // lane 31 needs word q0 + 32 (k + 1): lane 0's next one, or its own load
    const unsigned wrap = __shfl_sync(~0u, w[k + 1 < kQuads ? k + 1 : k], 0);
    const unsigned next = lane < 31 ? down : k + 1 < kQuads ? wrap : last;
    const long long j = q0 + 32 * k + lane;
    if (j > quads || (j == quads && rem == 0)) continue;
    // row columns c0 + e are payload bytes 4 j + h + e
    const unsigned v = __byte_perm(w[k], next, sel);
    const long long c0 = h + 4 * j;
    if (j < quads) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = byte_times<FMT>(v, e, sc[(c0 + e) / kBlock]);
      __stcs(reinterpret_cast<float4*>(dst + c0), make_float4(f[0], f[1], f[2], f[3]));
    } else {
      for (int e = 0; e < rem; ++e) dst[c0 + e] = byte_times<FMT>(v, e, sc[(c0 + e) / kBlock]);
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

// values: (B, nb * 256) at a 4-byte aligned address, scales (B, nb);
// writes C columns of each row into out + (rows ? rows[r] : r) * pitch
// (any 4-byte aligned address), rows indexing out's out_rows rows.
// Returns cudaGetLastError().
extern "C" int repro_dequantize_rows(const void* values, const void* scales,
                                     long long B, long long nb, long long C,
                                     void* out, const void* rows,
                                     long long out_rows, long long pitch,
                                     int fmt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0) return 0;
  const long long tiles = ((C + 3) / 4 + kTileQuads - 1) / kTileQuads;
  const long long grid = tiles * B;
  const uint8_t* vp = static_cast<const uint8_t*>(values);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  const long long* rp = static_cast<const long long*>(rows);
  if (fmt == 0) {
    dequantize_rows<0><<<(unsigned)grid, kThreads, 0, s>>>(vp, sp, nb, C, tiles, op, rp,
                                                            out_rows, pitch);
  } else {
    dequantize_rows<1><<<(unsigned)grid, kThreads, 0, s>>>(vp, sp, nb, C, tiles, op, rp,
                                                            out_rows, pitch);
  }
  return static_cast<int>(cudaGetLastError());
}
