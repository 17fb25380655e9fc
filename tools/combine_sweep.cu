// Design sweep of the merge kernel (fused_combine_update) on one card: the
// kept kernel, compiled from its own source
// (src/repro_torch/kernels/csrc/combine_update.cu, included below and
// called through its C entry point or its kernel template; the other
// designs reuse its tile and row search), beside the parent's design and
// the designs it was chosen over (plain stores, a warp's prefix sum in
// place of the walk over the ranks, the moving rows' tiles first, on a
// block a tile or a resident grid), each timed with CUDA
// events at the main path's round shapes, twice, in one process.
// chip_smoke.py compiles it with the port's kernels, so it builds from the
// same sources.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/combine_sweep tools/combine_sweep.cu && build/combine_sweep
//
// Shapes (buf (n, K, C), recv (n, 1, C), n = 4 ranks): the int8 plan's f32
// rounds (4, 45, 23,301,689), the tuned bf16 rounds (4, 32, 32,768,000)
// and the serving chain's bf16 rounds (4, 2, 49,932,191), each as a round
// that moves 1 row (rank 1's) and one that moves 3 (ranks 1-3's), each
// accumulating and overwriting. Rank r's row lands at buf row r * K +
// min(1 + r, K - 1), so rows sit at different offsets mod 16 when C is
// odd. Bounds: the moved rows' bytes (recv read, row written, and read
// when accumulating) / 3.35 TB/s. Data are zero bytes: the kernels move bits and add zeros,
// so the times do not depend on them. Prints one line per variant; exits
// 1 on a CUDA error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "../src/repro_torch/kernels/csrc/vec16.cuh"

namespace comb {
#include "../src/repro_torch/kernels/csrc/combine_update.cu"
}

namespace {

constexpr int T = 256;

// --- the parent's merge: a block per (row, tile of 1024 columns or
// vectors) of every row, KEEP rows' blocks exiting; 16-byte vectors when
// the row width and both base pointers are 16-byte aligned, else an
// element a thread ---

template <typename E>
__global__ void parent_rows(E* __restrict__ buf, const E* __restrict__ recv,
                            const int* __restrict__ start, const int* __restrict__ lo,
                            const int* __restrict__ hi, int B, long long K, long long C,
                            long long tiles, int combine, int vec) {
  const long long bid = blockIdx.x;
  const long long q = bid / tiles;
  const long long tile = bid % tiles;
  const int r = static_cast<int>(q / B);
  const int i = static_cast<int>(q % B);
  const int mode = (i >= lo[r] && i < hi[r]) ? 1 + combine : 0;
  if (mode == 0) return;
  E* d = buf + ((long long)r * K + start[r] + i) * C;
  const E* s = recv + q * C;
  if (vec) {
    constexpr int V = 16 / sizeof(E);
    const long long v0 = tile * T * 4;
    const long long v1 = min(v0 + T * 4, C / V);
    uint4* dv = reinterpret_cast<uint4*>(d);
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    for (long long v = v0 + threadIdx.x; v < v1; v += T) {
      const uint4 x = sv[v];
      dv[v] = mode == 2 ? comb::add_vec(dv[v], x, E()) : x;
    }
  } else {
    const long long c0 = tile * T * 4;
    const long long c1 = min(c0 + T * 4, C);
    for (long long c = c0 + threadIdx.x; c < c1; c += T) {
      d[c] = mode == 2 ? comb::add_one(d[c], s[c]) : s[c];
    }
  }
}

// --- the kept tile, its moving rows' tiles first (block t: tile t % tiles
// of moving row t / tiles), so the blocks past them come after the live
// ones; looping over t by the grid, so it also runs on a resident grid ---

template <typename E>
__global__ void __launch_bounds__(T)
    rows_first(E* __restrict__ buf, const E* __restrict__ recv, const int* __restrict__ start,
               const int* __restrict__ lo, const int* __restrict__ hi, int n, int B, long long K,
               long long C, long long tiles, int combine) {
  for (long long t = blockIdx.x;; t += gridDim.x) {
    const long long m = t / tiles;
    long long row = 0, q = 0;
    if (!comb::locate(m, start, lo, hi, n, B, K, row, q)) return;
    if (combine) {
      comb::merge_tile<E, true, true>(buf + row * C, recv + q * C, C, t % tiles, tiles);
    } else {
      comb::merge_tile<E, false, true>(buf + row * C, recv + q * C, C, t % tiles, tiles);
    }
  }
}

// --- the kept map and tile, but each warp finds its moving row at once
// from the tables in place of locate's walk over the ranks:
// lane k of each chunk of 32 ranks loads rank r0 + k's start and row range
// lo..hi-1 (clipped to the block), an inclusive prefix sum of the counts
// by shuffles numbers the moving rows rank by rank, and a ballot finds the
// rank that holds row m. Returns the round's count of moving rows; when m
// is below it, sets row (of buf, (n * K, C)) and q (of recv, (n * B, C)).
// The whole warp calls it. ---
__device__ __forceinline__ long long find_row(long long m, const int* start, const int* lo,
                                              const int* hi, int n, int B, long long K,
                                              long long& row, long long& q) {
  const int lane = threadIdx.x & 31;
  long long total = 0;
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int r = r0 + lane;
    int a = 0, cnt = 0, s = 0;
    if (r < n) {
      a = max(lo[r], 0);
      cnt = max(min(hi[r], B) - a, 0);
      s = start[r];
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += v;
    }
    const int chunk = __shfl_sync(~0u, incl, 31);
    const long long rel = m - total;  // m's place among this chunk's rows
    if (rel >= 0 && rel < chunk) {
      const int k = __ffs(__ballot_sync(~0u, incl > rel)) - 1;
      const long long i = a + rel - (incl - cnt);  // block row, in lane k
      row = __shfl_sync(~0u, (long long)r * K + s + i, k);
      q = __shfl_sync(~0u, (long long)r * B + i, k);
    }
    total += chunk;
  }
  return total;
}

template <typename E>
__global__ void __launch_bounds__(T)
    warp_search(E* __restrict__ buf, const E* __restrict__ recv, const int* __restrict__ start,
                const int* __restrict__ lo, const int* __restrict__ hi, int n, int B,
                long long K, long long C, long long tiles, int combine) {
  const long long m = blockIdx.x % (n * B), tile = blockIdx.x / (n * B);
  long long row = 0, q = 0;
  if (m >= find_row(m, start, lo, hi, n, B, K, row, q)) return;
  if (combine) {
    comb::merge_tile<E, true, true>(buf + row * C, recv + q * C, C, tile, tiles);
  } else {
    comb::merge_tile<E, false, true>(buf + row * C, recv + q * C, C, tile, tiles);
  }
}

// --- the kept map and tile under a register cap: at least kMinBlocks
// blocks a multiprocessor (the kept kernel holds two), so a block that
// exits at once takes a smaller share of the slots ---

template <typename E, int kMinBlocks>
__global__ void __launch_bounds__(T, kMinBlocks)
    capped(E* __restrict__ buf, const E* __restrict__ recv, const int* __restrict__ start,
           const int* __restrict__ lo, const int* __restrict__ hi, int n, int B, long long K,
           long long C, long long tiles, int combine) {
  const long long m = blockIdx.x % (n * B), tile = blockIdx.x / (n * B);
  long long row = 0, q = 0;
  if (!comb::locate(m, start, lo, hi, n, B, K, row, q)) return;
  if (combine) {
    comb::merge_tile<E, true, true>(buf + row * C, recv + q * C, C, tile, tiles);
  } else {
    comb::merge_tile<E, false, true>(buf + row * C, recv + q * C, C, tile, tiles);
  }
}

// --- the kept tile, but one block a tile column: block b merges tile b of
// every moving row in turn, so no block is launched for a row that stays ---

template <typename E>
__global__ void __launch_bounds__(T)
    column(E* __restrict__ buf, const E* __restrict__ recv, const int* __restrict__ start,
           const int* __restrict__ lo, const int* __restrict__ hi, int n, int B, long long K,
           long long C, long long tiles, int combine) {
  long long row = 0, q = 0;
  for (long long m = 0; comb::locate(m, start, lo, hi, n, B, K, row, q); ++m) {
    if (combine) {
      comb::merge_tile<E, true, true>(buf + row * C, recv + q * C, C, blockIdx.x, tiles);
    } else {
      comb::merge_tile<E, false, true>(buf + row * C, recv + q * C, C, blockIdx.x, tiles);
    }
  }
}

template <typename K>
float time_ms(K launch, int reps) {
  for (int i = 0; i < 3; ++i) launch();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < reps; ++i) launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms / reps;
}

template <typename F>
int resident(F f) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, T, 0);
  return per_sm * sms;
}

template <typename E>
void sweep(const char* label, long long K, long long C, int dtype) {
  const int n = 4, B = 1;
  // start r = min(1 + r, K - 1); lo 0; hi: rank 1 only, or ranks 1-3
  int host[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1};
  for (int r = 0; r < n; ++r) host[r] = (int)(1 + r < K - 1 ? 1 + r : K - 1);
  int* tab = nullptr;
  cudaMalloc(&tab, sizeof(host));
  cudaMemcpy(tab, host, sizeof(host), cudaMemcpyHostToDevice);
  E *buf = nullptr, *recv = nullptr;
  cudaMalloc(&buf, n * K * C * sizeof(E));
  cudaMalloc(&recv, n * B * C * sizeof(E));
  cudaMemset(buf, 0, n * K * C * sizeof(E));
  cudaMemset(recv, 0, n * B * C * sizeof(E));
  const long long units = C * (long long)sizeof(E) / 16;
  const long long tiles = units > comb::kTile ? (units + comb::kTile - 1) / comb::kTile : 1;
  const int grid = (int)(tiles * n * B);
  const bool vec = (C * sizeof(E)) % 16 == 0;
  const long long ptiles = ((vec ? C / (16 / sizeof(E)) : C) + T * 4 - 1) / (T * 4);
  const int g_res = resident(rows_first<E>);
  const int *start = tab, *lo = tab + 4;
  for (int moved = 1; moved <= 3; moved += 2) {
    const int* hi = tab + (moved == 1 ? 8 : 12);
    for (int combine = 1; combine >= 0; --combine) {
      const double bytes = (double)moved * C * sizeof(E) * (combine ? 3 : 2);
      printf("%s (%d, %lld, %lld) %s, %d row%s: bound %.4f ms\n", label, n, K, C,
             combine ? "accumulate" : "overwrite", moved, moved == 1 ? "" : "s",
             bytes / 3.35e12 * 1e3);
      for (int rep = 0; rep < 2; ++rep) {
        printf("  parent, a block per 1024 %s of every row (%lld): %.4f ms\n",
               vec ? "vectors" : "elements", ptiles * n * B, time_ms([&] {
                 parent_rows<E><<<(unsigned)(ptiles * n * B), T>>>(buf, recv, start, lo, hi, B,
                                                                   K, C, ptiles, combine,
                                                                   vec ? 1 : 0); }, 10));
        printf("  kept, a block a 32 KiB tile of every row, moving rows spread (%d): %.4f ms\n",
               grid, time_ms([&] {
                 comb::repro_merge_rows(buf, recv, start, lo, hi, nullptr, n, B, K, C, combine,
                                        dtype, nullptr); }, 10));
        printf("  kept kernel, plain stores in place of st.cs (%d): %.4f ms\n", grid,
               time_ms([&] {
                 comb::merge_rows<E, false><<<grid, T>>>(buf, recv, start, lo, hi, nullptr, n,
                                                         B, K, C, tiles, combine); }, 10));
        printf("  kept map, each warp finding its row by a prefix sum (%d): %.4f ms\n", grid,
               time_ms([&] {
                 warp_search<E><<<grid, T>>>(buf, recv, start, lo, hi, n, B, K, C, tiles,
                                             combine); }, 10));
        printf("  moving rows' tiles first, a block a tile (%d): %.4f ms\n", grid, time_ms([&] {
                 rows_first<E><<<grid, T>>>(buf, recv, start, lo, hi, n, B, K, C, tiles,
                                            combine); }, 10));
        printf("  kept map, registers capped for 3 blocks a multiprocessor (%d): %.4f ms\n", grid,
               time_ms([&] {
                 capped<E, 3><<<grid, T>>>(buf, recv, start, lo, hi, n, B, K, C, tiles,
                                           combine); }, 10));
        printf("  kept map, registers capped for 4 blocks a multiprocessor (%d): %.4f ms\n", grid,
               time_ms([&] {
                 capped<E, 4><<<grid, T>>>(buf, recv, start, lo, hi, n, B, K, C, tiles,
                                           combine); }, 10));
        printf("  a block a tile column, merging it in every moving row (%d): %.4f ms\n",
               (int)tiles, time_ms([&] {
                 column<E><<<(int)tiles, T>>>(buf, recv, start, lo, hi, n, B, K, C, tiles,
                                              combine); }, 10));
        printf("  moving rows' tiles first on the resident grid (%d), looping: %.4f ms\n",
               g_res, time_ms([&] {
                 rows_first<E><<<g_res, T>>>(buf, recv, start, lo, hi, n, B, K, C, tiles,
                                             combine); }, 10));
      }
    }
  }
  cudaFree(buf);
  cudaFree(recv);
  cudaFree(tab);
}

}  // namespace

int main() {
  sweep<float>("int8 plan f32", 45, 23301689, 0);
  sweep<__nv_bfloat16>("tuned bf16", 32, 32768000, 1);
  sweep<__nv_bfloat16>("serving chain bf16", 2, 49932191, 1);
  const cudaError_t err = cudaDeviceSynchronize();
  printf("status: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
