// Fused combine-update: the merge of every round of the compiled schedule
// executor, in place on the rank-stacked buffer.
//
// Replaces: src/repro/kernels/combine_update.py:52 fused_combine (its
//   pallas_call at :67) and the slice/merge/update of its wrapper
//   fused_combine_update (:82).
// Semantics: per row, mode 2 (ACCUMULATE) writes cur + recv, mode 1
//   (OVERWRITE) writes recv, mode 0 (KEEP) leaves cur untouched. bf16 sums
//   are taken in f32 and rounded to nearest even, as the plain version
//   does; f32 sums are one add. KEEP rows are never read or written, so a
//   -0.0 or a NaN payload there survives bit for bit (the reference's
//   where-form contract).
// Bound: bytes. An OVERWRITE row reads recv and writes the row; an
//   ACCUMULATE row also reads cur; KEEP rows move nothing. The least time
//   is those bytes / 3.35 TB/s on an H100 SXM (NVIDIA data sheet).
// Design: ONE kernel and one launch at any row width and alignment.
//   - Rows: the block computes its row's place from the per-rank round
//     tables (start, lo, hi), which stay on the device, so the buffer is
//     updated where it lies. The moving rows are numbered rank by rank
//     (rank r's rows lo[r]..hi[r]-1; locate walks the ranks). The launch
//     has one block a tile of every row of the round, n * B rows, and
//     block b takes tile b / (n * B) of moving row b % (n * B): a round
//     that moves fewer rows leaves blocks that exit after the walk, spread
//     between the live ones, where they cost less than after them
//     (tools/combine_sweep.cu). (The plain
//     fused_combine entry point's per-row modes take row b % rows under
//     its own mode; its KEEP rows' blocks do nothing.)
//   - Cut: each moving row is cut at its destination's 16-byte
//     boundaries: a head of < 16 bytes, aligned 16-byte units in tiles of
//     kTile units (32 KiB), a tail of < 16 bytes. Tile 0 of a row also
//     merges the head and the row's last tile the tail, an element a lane
//     of the first warp.
//   - Body: each thread keeps kUnroll 16-byte loads of recv (and, when
//     accumulating, of cur at the store's own aligned address) in flight
//     before its stores, neighbouring lanes on neighbouring vectors, each
//     warp's stores contiguous. recv is read once and streamed past the
//     caches (ld.cs); each recv vector is funnelled (vec16.cuh) from the
//     two aligned source vectors around it, the vector itself when the row
//     and its recv row agree mod 16, the right neighbour coming from the
//     next lane by shuffle, so a warp issues 257 aligned loads for 256
//     stores. Stores stream (st.cs) where kStreamStores: the sweep
//     measures the choice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;                       // 16-byte loads in flight per thread
constexpr long long kTile = kThreads * kUnroll;  // 16-byte units per tile (32 KiB)

__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b, float) {
  float4 x = *reinterpret_cast<float4*>(&a);
  float4 y = *reinterpret_cast<float4*>(&b);
  float4 z = make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y), __fadd_rn(x.z, y.z),
                         __fadd_rn(x.w, y.w));
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
    z[k] = __floats2bfloat162_rn(__fadd_rn(u.x, v.x), __fadd_rn(u.y, v.y));
  }
  return out;
}

__device__ __forceinline__ float add_one(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ __nv_bfloat16 add_one(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// Moving row m of a round: rank r's rows lo[r]..hi[r]-1 (clipped to the
// block), numbered rank by rank. Returns false past the last moving row;
// else sets row (of buf, (n * K, C)) and q (of recv, (n * B, C)).
__device__ __forceinline__ bool locate(long long m, const int* start, const int* lo,
                                       const int* hi, int n, int B, long long K, long long& row,
                                       long long& q) {
  for (int r = 0; r < n; ++r) {
    const int a = max(lo[r], 0);
    const long long cnt = max(min(hi[r], B) - a, 0);
    if (m < cnt) {
      row = (long long)r * K + start[r] + a + m;
      q = (long long)r * B + a + m;
      return true;
    }
    m -= cnt;
  }
  return false;
}

// Tile `tile` of one row of C elements: dst d, source s, tiles a row.
template <typename T, bool kAcc, bool kStreamStores>
__device__ __forceinline__ void merge_tile(T* __restrict__ d, const T* __restrict__ s,
                                           long long C, long long tile, long long tiles) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const long long head = min((long long)((16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15) /
                                 (long long)sizeof(T), C);
  const long long units = (C - head) / V;
  const long long tail = C - head - units * V;
  if (tile == 0 && tid < head) d[tid] = kAcc ? add_one(d[tid], s[tid]) : s[tid];
  if (tile == tiles - 1 && tid < tail) {
    const long long c = head + units * V + tid;
    d[c] = kAcc ? add_one(d[c], s[c]) : s[c];
  }
  const long long base = tile * kTile;
  if (base >= units) return;  // whole block: the shuffles below see all 32 lanes
  uint4* out = reinterpret_cast<uint4*>(d + head);
  const uint8_t* from = reinterpret_cast<const uint8_t*>(s + head);
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(from) & 15);
  const uint4* in = reinterpret_cast<const uint4*>(from - off);
  // aligned source vectors: the one after the last unit holds its final
  // `off` bytes
  const long long avail = units + (off != 0);
  const int q = off >> 2;
  const unsigned sel = 0x3210u + 0x1111u * static_cast<unsigned>(off & 3);
  const int lane = tid & 31;
  const long long j0 = base + (tid >> 5) * (32 * kUnroll) + lane;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 a[kUnroll], c[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    a[u] = j0 + 32 * u < avail ? __ldcs(in + j0 + 32 * u) : zero;
    if (kAcc) c[u] = j0 + 32 * u < units ? out[j0 + 32 * u] : zero;
  }
  // a warp's kUnroll spans of 32 vectors follow each other, so lane 31's
  // right neighbour is lane 0's vector of the next span; only after the
  // last span does it load its own
  const long long after = j0 + 32 * kUnroll - lane;
  const uint4 last = lane == 31 && after < avail ? __ldcs(in + after) : zero;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const uint4 down = shfl_down(a[u]);
    const uint4 nx = a[u + 1 < kUnroll ? u + 1 : u];
    const uint4 wrap = make_uint4(__shfl_sync(~0u, nx.x, 0), __shfl_sync(~0u, nx.y, 0),
                                  __shfl_sync(~0u, nx.z, 0), __shfl_sync(~0u, nx.w, 0));
    const uint4 next = lane < 31 ? down : u + 1 < kUnroll ? wrap : last;
    if (j0 + 32 * u < units) {
      uint4 v = funnel(a[u], next, q, sel);
      if (kAcc) v = add_vec(c[u], v, T());
      if (kStreamStores) {
        __stcs(out + j0 + 32 * u, v);
      } else {
        out[j0 + 32 * u] = v;
      }
    }
  }
}

// n ranks of B block rows: recv is (n, B, C), buf is (n, K, C). start/lo/hi
// are per-rank int32 (n,) on the device; row_mode, when given, is a per-row
// int32 (n * B,) mode that replaces the lo/hi/combine rule (the plain
// fused_combine entry point: n = 1, K = B, row m is row m of both). One
// block a tile: block b takes tile b / (n * B) of moving row b % (n * B).
template <typename T, bool kStreamStores>
__global__ void __launch_bounds__(kThreads)
    merge_rows(T* __restrict__ buf, const T* __restrict__ recv, const int* __restrict__ start,
               const int* __restrict__ lo, const int* __restrict__ hi,
               const int* __restrict__ row_mode, int n, int B, long long K, long long C,
               long long tiles, int combine) {
  const long long rows = (long long)n * B;
  const long long m = blockIdx.x % rows, tile = blockIdx.x / rows;
  long long row = m, q = m;
  int mode;
  if (row_mode != nullptr) {
    mode = row_mode[m];
  } else {
    if (!locate(m, start, lo, hi, n, B, K, row, q)) return;  // past the moving rows
    mode = 1 + combine;
  }
  if (mode == 2) {
    merge_tile<T, true, kStreamStores>(buf + row * C, recv + q * C, C, tile, tiles);
  } else if (mode == 1) {
    merge_tile<T, false, kStreamStores>(buf + row * C, recv + q * C, C, tile, tiles);
  }
}

}  // namespace

// One launch over n ranks of B rows of C elements, each row cut into
// max(1, ceil(C * elem / 16 / kTile)) tiles, one block a tile of every row.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for rows that need more blocks than a grid holds.
extern "C" int repro_merge_rows(void* buf, const void* recv, const void* start,
                                const void* lo, const void* hi, const void* row_mode, int n,
                                int B, long long K, long long C, int combine, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || B <= 0 || C <= 0) return 0;
  const long long units = C * (dtype == 1 ? 2 : 4) / 16;
  const long long tiles = units > kTile ? (units + kTile - 1) / kTile : 1;
  const long long grid = tiles * n * B;
  if (grid >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int* st = static_cast<const int*>(start);
  const int* l = static_cast<const int*>(lo);
  const int* h = static_cast<const int*>(hi);
  const int* m = static_cast<const int*>(row_mode);
  if (dtype == 1) {
    merge_rows<__nv_bfloat16, true><<<(unsigned)grid, kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(buf), static_cast<const __nv_bfloat16*>(recv), st, l, h, m,
        n, B, K, C, tiles, combine);
  } else {
    merge_rows<float, true><<<(unsigned)grid, kThreads, 0, s>>>(
        static_cast<float*>(buf), static_cast<const float*>(recv), st, l, h, m, n, B, K, C,
        tiles, combine);
  }
  return static_cast<int>(cudaGetLastError());
}
