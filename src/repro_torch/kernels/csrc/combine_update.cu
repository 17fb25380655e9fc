// Fused combine-update: the merge of every round of the compiled schedule
// executor, in place on the rank-stacked buffer.
//
// Replaces: src/repro/kernels/combine_update.py:52 fused_combine (its
//   pallas_call at :67) and the slice/merge/update of its wrapper
//   fused_combine_update (:82).
// Semantics: per row, mode 2 (ACCUMULATE) writes cur + recv, mode 1
//   (OVERWRITE) writes recv, mode 0 (KEEP) leaves cur untouched. bf16 sums
//   are taken in f32 and rounded to nearest even, as the plain version
//   does. KEEP rows are never read or written, so a -0.0 or a NaN payload
//   there survives bit for bit (the reference's where-form contract).
// Bound: bytes. An OVERWRITE row reads recv and writes the row; an
//   ACCUMULATE row also reads cur; KEEP rows move nothing. The least time
//   is those bytes / 3.35 TB/s on an H100 SXM (NVIDIA data sheet).
// Design: one thread block per (row, column tile). The block computes its
//   row's destination from the per-rank round tables (start, lo, hi), which
//   stay on the device, so the buffer is updated where it lies: no slice,
//   no merged copy, no update-slice pass. A KEEP row's blocks return before
//   touching memory. Columns move as 16-byte vectors when every row starts
//   16-byte aligned, else element by element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;  // vectors (or elements) per thread per tile

__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b, float) {
  float4 x = *reinterpret_cast<float4*>(&a);
  float4 y = *reinterpret_cast<float4*>(&b);
  float4 z = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  return *reinterpret_cast<uint4*>(&z);
}

__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b, __nv_bfloat16) {
  uint4 out;
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 u = __bfloat1622float2(x[k]);
    const float2 v = __bfloat1622float2(y[k]);
    z[k] = __floats2bfloat162_rn(u.x + v.x, u.y + v.y);
  }
  return out;
}

__device__ __forceinline__ float add_one(float a, float b) { return a + b; }

__device__ __forceinline__ __nv_bfloat16 add_one(__nv_bfloat16 a,
                                                 __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

// rows = n * B; row q is rank q / B, block row q % B. recv is (n, B, C),
// buf is (n, K, C). start/lo/hi are per-rank int32 (n,) on the device;
// row_mode, when given, is a per-row int32 (rows,) mode that replaces the
// lo/hi/combine rule (the plain fused_combine entry point).
template <typename T>
__global__ void merge_rows(T* __restrict__ buf, const T* __restrict__ recv,
                           const int* __restrict__ start,
                           const int* __restrict__ lo,
                           const int* __restrict__ hi,
                           const int* __restrict__ row_mode, int B,
                           long long K, long long C, long long tiles,
                           int combine, int vec) {
  const long long bid = blockIdx.x;
  const long long q = bid / tiles;
  const long long tile = bid % tiles;
  const int r = static_cast<int>(q / B);
  const int i = static_cast<int>(q % B);
  int mode;
  if (row_mode != nullptr) {
    mode = row_mode[q];
  } else {
    mode = (i >= lo[r] && i < hi[r]) ? 1 + combine : 0;
  }
  if (mode == 0) return;
  const long long row0 = start != nullptr ? start[r] : 0;
  T* d = buf + ((long long)r * K + row0 + i) * C;
  const T* s = recv + q * C;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const long long per_tile = (long long)kThreads * kVecPerThread;
    const long long v0 = tile * per_tile;
    const long long v1 = min(v0 + per_tile, C / V);
    uint4* dv = reinterpret_cast<uint4*>(d);
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
      const uint4 x = sv[v];
      dv[v] = mode == 2 ? add_vec(dv[v], x, T()) : x;
    }
  } else {
    const long long per_tile = (long long)kThreads * kVecPerThread;
    const long long c0 = tile * per_tile;
    const long long c1 = min(c0 + per_tile, C);
    for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) {
      d[c] = mode == 2 ? add_one(d[c], s[c]) : s[c];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int repro_merge_rows(void* buf, const void* recv, const void* start,
                                const void* lo, const void* hi,
                                const void* row_mode, int rows, int B,
                                long long K, long long C, int combine,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0) return 0;
  const int elem = dtype == 1 ? 2 : 4;
  const bool vec = (C * elem) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(buf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(recv) % 16 == 0;
  const long long cols = vec ? C / (16 / elem) : C;
  const long long per_tile = (long long)kThreads * kVecPerThread;
  const long long tiles = (cols + per_tile - 1) / per_tile;
  const long long grid = tiles * rows;
  const int* st = static_cast<const int*>(start);
  const int* l = static_cast<const int*>(lo);
  const int* h = static_cast<const int*>(hi);
  const int* m = static_cast<const int*>(row_mode);
  if (dtype == 1) {
    merge_rows<__nv_bfloat16><<<(unsigned)grid, kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(buf),
        static_cast<const __nv_bfloat16*>(recv), st, l, h, m, B, K, C, tiles,
        combine, vec ? 1 : 0);
  } else {
    merge_rows<float><<<(unsigned)grid, kThreads, 0, s>>>(
        static_cast<float*>(buf), static_cast<const float*>(recv), st, l, h, m,
        B, K, C, tiles, combine, vec ? 1 : 0);
  }
  return static_cast<int>(cudaGetLastError());
}
