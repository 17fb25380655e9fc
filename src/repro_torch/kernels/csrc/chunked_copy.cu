// Pipelined chunked copy of a flat buffer: the bucket-staging primitive of
// weight distribution (the paper's CUDA-kernel copy, Sec. IV-C).
//
// Replaces: src/repro/kernels/chunked_copy.py:37 chunked_copy (its
//   pallas_call at :51), a grid over chunk_elems chunks with a masked
//   ragged tail.
// Bound: bytes. Every byte is read once and written once, so the least time
//   is 2 * nbytes / 3.35 TB/s on an H100 SXM (NVIDIA data sheet HBM3 rate).
// Design: dtype-agnostic byte copy. One thread block per chunk; its threads
//   stride over the chunk in 16-byte vectors (neighbouring threads on
//   neighbouring addresses, so every warp issues full 512-byte
//   transactions). Thousands of independent chunks keep enough loads in
//   flight on all 132 SMs to stream at the memory rate; no shared memory is
//   needed because nothing is reused. When either pointer is not 16-byte
//   aligned the whole copy takes the byte path; otherwise only the ragged
//   tail (< 16 bytes) does. Nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void copy_chunks_vec(uint4* __restrict__ dst,
                                const uint4* __restrict__ src,
                                long long nvec, long long chunk_vec) {
  const long long begin = (long long)blockIdx.x * chunk_vec;
  const long long end = min(begin + chunk_vec, nvec);
#pragma unroll 4
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    dst[i] = src[i];
  }
}

__global__ void copy_bytes(uint8_t* __restrict__ dst,
                           const uint8_t* __restrict__ src, long long n) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    dst[i] = src[i];
  }
}

}  // namespace

extern "C" int repro_chunked_copy(void* dst, const void* src, long long nbytes,
                                  long long chunk_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbytes <= 0) return 0;
  uint8_t* d = static_cast<uint8_t*>(dst);
  const uint8_t* x = static_cast<const uint8_t*>(src);
  long long done = 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(d) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (aligned) {
    const long long nvec = nbytes / 16;
    const long long chunk_vec = chunk_bytes / 16 > 0 ? chunk_bytes / 16 : 1;
    if (nvec > 0) {
      const long long grid = (nvec + chunk_vec - 1) / chunk_vec;
      copy_chunks_vec<<<(unsigned)grid, kThreads, 0, s>>>(
          reinterpret_cast<uint4*>(d), reinterpret_cast<const uint4*>(x), nvec,
          chunk_vec);
    }
    done = nvec * 16;
  }
  const long long rest = nbytes - done;
  if (rest > 0) {
    long long blocks = (rest + kThreads - 1) / kThreads;
    if (blocks > 65536) blocks = 65536;
    copy_bytes<<<(unsigned)blocks, kThreads, 0, s>>>(d + done, x + done, rest);
  }
  return static_cast<int>(cudaGetLastError());
}
