// Design sweep of the staging copy and the compressed hop's dequantize on
// one card: each kept kernel, compiled from its own source
// (src/repro_torch/kernels/csrc/chunked_copy.cu, quantize.cu, included
// below and called through their C entry points), beside the parent's
// design and the design it was chosen over, each timed with CUDA events at
// the main path's shapes, twice, in one process. chip_smoke.py compiles
// it with the port's kernels, so it builds from the same sources.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/staging_sweep tools/staging_sweep.cu && build/staging_sweep
//
// Copy: 1,048,576,037 bf16 (2,097,152,074 bytes) to a 16-byte aligned
// destination, from an aligned source and from one 2 bytes off (one
// element less). Dequantize: int8 payload (3, 23,301,888) and its scales
// to f32 rows (3, 23,301,689) of odd pitch. Bounds: bytes / 3.35 TB/s.
// Data are constant bytes: the kernels move bits, so the times do not
// depend on them. Prints one line per variant; exits 1 on a CUDA error.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "../src/repro_torch/kernels/csrc/vec16.cuh"

namespace copy {
#include "../src/repro_torch/kernels/csrc/chunked_copy.cu"
}
namespace deq {
#include "../src/repro_torch/kernels/csrc/quantize.cu"
}

namespace {

constexpr int T = 256;

// --- the parent's copy: one block per 64 Ki-element chunk when both
// pointers are aligned, else the whole copy a byte per thread ---

__global__ void copy_chunks(uint4* __restrict__ dst, const uint4* __restrict__ src, long long nvec,
                            long long chunk_vec) {
  const long long begin = (long long)blockIdx.x * chunk_vec;
  const long long end = min(begin + chunk_vec, nvec);
#pragma unroll 4
  for (long long i = begin + threadIdx.x; i < end; i += T) dst[i] = src[i];
}

__global__ void copy_bytes(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src, long long n) {
  const long long step = (long long)gridDim.x * T;
  for (long long i = (long long)blockIdx.x * T + threadIdx.x; i < n; i += step) dst[i] = src[i];
}

// --- the Hopper alternative for the aligned copy: one thread a block
// drives S stages of CH bytes through TMA bulk copies (global -> shared
// on an mbarrier, shared -> global as a bulk group), interleaved tiles ---

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int S, int CH>
__global__ void copy_bulk(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src, long long bytes) {
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ __align__(8) uint64_t full[S];
  if (threadIdx.x != 0) return;
  const long long tiles = (bytes + CH - 1) / CH;
  const long long mine = tiles > blockIdx.x ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  for (int s = 0; s < S; ++s) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(&full[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  auto load = [&](long long k) {
    const long long off = ((long long)blockIdx.x + k * gridDim.x) * CH;
    const uint32_t len = (uint32_t)min((long long)CH, bytes - off);
    const uint32_t bar = smem(&full[k % S]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(len) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(smem(stage + (k % S) * CH)), "l"(src + off), "r"(len), "r"(bar) : "memory");
  };
  for (long long k = 0; k < mine && k < S - 1; ++k) load(k);
  for (long long k = 0; k < mine; ++k) {
    if (k + S - 1 < mine) {
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      load(k + S - 1);
    }
    uint32_t done = 0;
    while (!done) {
      asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                   : "=r"(done) : "r"(smem(&full[k % S])), "r"((uint32_t)((k / S) & 1)) : "memory");
    }
    const long long off = ((long long)blockIdx.x + k * gridDim.x) * CH;
    const uint32_t len = (uint32_t)min((long long)CH, bytes - off);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(dst + off), "r"(smem(stage + (k % S) * CH)), "r"(len) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// --- dequantize (int8) ---

__device__ __forceinline__ float bt(unsigned w, int k, float s) { return (float)(int8_t)(w >> (8 * k)) * s; }

// the parent's: four columns a thread, scalar stores at an odd pitch
__global__ void deq_scalar(const uint8_t* __restrict__ values, const float* __restrict__ scales, long long nb,
                           long long C, long long tiles, float* __restrict__ out, long long pitch) {
  const long long r = blockIdx.x / tiles;
  const long long c = (blockIdx.x % tiles) * (T * 4) + (long long)threadIdx.x * 4;
  if (c >= C) return;
  const uint32_t word = *reinterpret_cast<const uint32_t*>(values + r * nb * 256 + c);
  const float s = scales[r * nb + c / 256];
  float* dst = out + r * pitch + c;
#pragma unroll
  for (int k = 0; k < 4; ++k) if (c + k < C) dst[k] = bt(word, k, s);
}

// the design the kept one was chosen over: sixteen contiguous columns a
// thread, one 16-byte payload load, four float4 stores 64 bytes apart
// across the warp (the body only)
__global__ void __launch_bounds__(T) deq_groups(const uint8_t* __restrict__ values, const float* __restrict__ scales,
    long long nb, long long C, long long tiles, float* __restrict__ out, long long pitch) {
  const long long r = blockIdx.x / tiles;
  const long long g = (blockIdx.x - r * tiles) * T + threadIdx.x;
  const uint4* pay = reinterpret_cast<const uint4*>(values + r * nb * 256);
  float* dst = out + r * pitch;
  const long long h = ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
  const unsigned sel = 0x3210u + 0x1111u * (unsigned)h;
  const uint4 a = g < nb * 16 ? __ldcs(pay + g) : make_uint4(0, 0, 0, 0);
  unsigned next = (threadIdx.x & 31) == 31 && g + 1 < nb * 16 ? *reinterpret_cast<const unsigned*>(pay + g + 1) : 0u;
  const unsigned nx = __shfl_down_sync(~0u, a.x, 1);
  if ((threadIdx.x & 31) != 31) next = nx;
  const long long c0 = h + 16 * g;
  if (c0 + 16 > C) return;
  const unsigned w[5] = {a.x, a.y, a.z, a.w, next};
  const float* sc = scales + r * nb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned v = __byte_perm(w[i], w[i + 1], sel);
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = bt(v, e, sc[(c0 + 4 * i + e) >> 8]);
    *reinterpret_cast<float4*>(dst + c0 + 4 * i) = make_float4(f[0], f[1], f[2], f[3]);
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
  return ms / reps;
}

template <typename F>
int resident(F f, int threads, int dyn_smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, threads, dyn_smem);
  return per_sm * sms;
}

}  // namespace

int main() {
  const long long N = 2LL * 1048576037;
  uint8_t *src = nullptr, *dst = nullptr;
  cudaMalloc(&src, N + 16);
  cudaMalloc(&dst, N);
  cudaMemset(src, 1, N + 16);
  // the kept kernel's cut (copy_plan): aligned destination, so no head
  const long long tile = 8 * 256, units = N / 16, units2 = (N - 2) / 16;
  const int tiles = (int)((units + tile - 1) / tile), tiles2 = (int)((units2 + tile - 1) / tile);
  const int g_kept = resident(copy::copy_tiles, 256, 0);
  cudaFuncSetAttribute(copy_bulk<4, 32768>, cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * 32768);
  const int g_bulk = resident(copy_bulk<4, 32768>, 32, 4 * 32768);
  printf("copy (1048576037,) bf16, bound %.4f ms\n", 2.0 * N / 3.35e12 * 1e3);
  for (int rep = 0; rep < 2; ++rep) {
    printf("  cudaMemcpyAsync D2D (clone): %.4f ms\n",
           time_ms([&] { cudaMemcpyAsync(dst, src, N, cudaMemcpyDeviceToDevice); }, 10));
    printf("  parent, a block per 64 Ki-element chunk: %.4f ms\n", time_ms([&] {
      copy_chunks<<<(units + 8191) / 8192, T>>>((uint4*)dst, (const uint4*)src, units, 8192); }, 10));
    printf("  kept, a block a 32 KiB tile (%d): %.4f ms\n", tiles, time_ms([&] {
      copy::repro_chunked_copy(dst, src, 0, units, N - 16 * units, tiles, nullptr); }, 10));
    printf("  kept kernel on a resident grid (%d), looping: %.4f ms\n", g_kept, time_ms([&] {
      copy::repro_chunked_copy(dst, src, 0, units, N - 16 * units, g_kept, nullptr); }, 10));
    printf("  TMA bulk, 4 stages of 32 KiB, grid %d (body only): %.4f ms\n", g_bulk, time_ms([&] {
      copy_bulk<4, 32768><<<g_bulk, 32, 4 * 32768>>>(dst, src, units * 16); }, 10));
    printf("  source 2 bytes off: cudaMemcpyAsync D2D (clone): %.4f ms\n",
           time_ms([&] { cudaMemcpyAsync(dst, src + 2, N - 2, cudaMemcpyDeviceToDevice); }, 10));
    printf("  source 2 bytes off: parent, a byte a thread: %.4f ms\n", time_ms([&] {
      copy_bytes<<<65536, T>>>(dst, src + 2, N - 2); }, 10));
    printf("  source 2 bytes off: kept, a block a 32 KiB tile (%d): %.4f ms\n", tiles2, time_ms([&] {
      copy::repro_chunked_copy(dst, src + 2, 0, units2, N - 2 - 16 * units2, tiles2, nullptr); }, 10));
    printf("  source 2 bytes off: kept kernel on a resident grid (%d), looping: %.4f ms\n", g_kept,
           time_ms([&] { copy::repro_chunked_copy(dst, src + 2, 0, units2, N - 2 - 16 * units2, g_kept,
                                                  nullptr); }, 10));
  }
  cudaFree(src);
  cudaFree(dst);

  const long long B = 3, C = 23301689, nb = (C + 255) / 256, Cp = nb * 256;
  uint8_t* vals = nullptr;
  float *sc = nullptr, *out = nullptr;
  cudaMalloc(&vals, B * Cp);
  cudaMalloc(&sc, B * nb * 4);
  cudaMalloc(&out, B * C * 4);
  cudaMemset(vals, 3, B * Cp);
  cudaMemset(sc, 0, B * nb * 4);
  printf("dequantize (3, 23301689) int8, bound %.4f ms\n", B * C * (4 + 1 + 4.0 / 256) / 3.35e12 * 1e3);
  const long long t4 = (C + 1023) / 1024, t16 = ((C + 15) / 16 + T - 1) / T;
  for (int rep = 0; rep < 2; ++rep) {
    printf("  cudaMemsetAsync of the output alone: %.4f ms\n",
           time_ms([&] { cudaMemsetAsync(out, 0, B * C * 4); }, 20));
    printf("  parent, 4 columns a thread, scalar stores: %.4f ms\n",
           time_ms([&] { deq_scalar<<<t4 * B, T>>>(vals, sc, nb, C, t4, out, C); }, 20));
    printf("  16 contiguous columns a thread, float4 stores 64 bytes apart: %.4f ms\n",
           time_ms([&] { deq_groups<<<t16 * B, T>>>(vals, sc, nb, C, t16, out, C); }, 20));
    printf("  kept, coalesced quads, streaming stores: %.4f ms\n", time_ms([&] {
      deq::repro_dequantize_rows(vals, sc, B, nb, C, out, nullptr, B, C, 0, nullptr); }, 20));
  }
  const cudaError_t err = cudaDeviceSynchronize();
  printf("status: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
