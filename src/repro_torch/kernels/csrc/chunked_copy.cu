// Pipelined chunked copy of a flat buffer: the bucket-staging primitive of
// weight distribution (the paper's CUDA-kernel copy, Sec. IV-C).
//
// Replaces: src/repro/kernels/chunked_copy.py:37 chunked_copy (its
//   pallas_call at :51), a grid over chunk_elems chunks with a masked
//   ragged tail.
// Bound: bytes. Every byte is read once and written once, so the least time
//   is 2 * nbytes / 3.35 TB/s on an H100 SXM (NVIDIA data sheet HBM3 rate).
// Design: a dtype-agnostic byte copy in ONE launch at any alignment.
//   - Cut (by the host: copy_plan in the wrapper): the destination's head
//     of < 16 bytes up to its first 16-byte boundary, `units` aligned
//     16-byte units in tiles of kTile units (32 KiB), and a tail of < 16
//     bytes. Block b copies tiles b, b + grid, ...; block 0 also the head
//     and the last block the tail, a byte per thread. So any grid copies
//     every byte once; the host launches one block a tile, which on the
//     card copied the 2 GB staging bucket within 0.1% of cudaMemcpyAsync's
//     time, where a grid of the blocks the card holds at once, looping,
//     was 6% slower (tools/staging_sweep.cu).
//   - Each thread keeps kUnroll independent 16-byte loads in flight before
//     their stores, neighbouring threads on neighbouring vectors, streaming
//     past the caches (ld/st .cs: nothing is read again). Each aligned
//     store is built from the two aligned source vectors around it with
//     funnel (vec16.cuh), which is the vector itself when source and
//     destination agree mod 16; the right neighbour comes from the next
//     lane by shuffle (shfl_down), and a warp's kUnroll spans of 32 vectors
//     are contiguous, so lane 31 takes lane 0's next vector and loads its
//     own only after the last span: 257 loads for 256 stores.
//   Nothing is padded, and no byte outside [dst, dst + nbytes) is written.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;                          // 16-byte loads in flight per thread
constexpr long long kTile = kThreads * kUnroll;     // 16-byte units per tile (32 KiB)

__global__ void __launch_bounds__(kThreads)
    copy_tiles(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src, long long head,
               long long units, long long tail) {
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid < head) dst[tid] = src[tid];
  if (blockIdx.x == gridDim.x - 1 && tid < tail) {
    const long long i = head + units * 16 + tid;
    dst[i] = src[i];
  }
  uint4* out = reinterpret_cast<uint4*>(dst + head);
  const uint8_t* from = src + head;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(from) & 15);
  const uint4* in = reinterpret_cast<const uint4*>(from - off);
  // aligned source vectors: the one after the last unit holds its final
  // `off` bytes
  const long long avail = units + (off != 0);
  const int q = off >> 2;
  const unsigned sel = 0x3210u + 0x1111u * static_cast<unsigned>(off & 3);
  const int lane = tid & 31;
  const long long first = (tid >> 5) * (32 * kUnroll) + lane;  // within a tile
  const uint4 zero = make_uint4(0, 0, 0, 0);
  // `base` is the same in every thread of the block, so whole warps run
  // each tile and the shuffles see all 32 lanes. A warp's kUnroll loads
  // cover kUnroll spans of 32 vectors that follow each other, so lane 31's
  // right neighbour is lane 0's vector of the next span; only after the
  // last span does it load its own.
  for (long long base = blockIdx.x * kTile; base < units; base += gridDim.x * kTile) {
    const long long j0 = base + first;
    uint4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = j0 + 32 * u < avail ? __ldcs(in + j0 + 32 * u) : zero;
    }
    const long long after = j0 + 32 * kUnroll - lane;  // the vector after the warp's last
    const uint4 last = lane == 31 && after < avail ? __ldcs(in + after) : zero;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint4 down = shfl_down(a[u]);
      const uint4 nx = a[u + 1 < kUnroll ? u + 1 : u];
      const uint4 wrap = make_uint4(__shfl_sync(~0u, nx.x, 0), __shfl_sync(~0u, nx.y, 0),
                                    __shfl_sync(~0u, nx.z, 0), __shfl_sync(~0u, nx.w, 0));
      const uint4 next = lane < 31 ? down : u + 1 < kUnroll ? wrap : last;
      if (j0 + 32 * u < units) __stcs(out + j0 + 32 * u, funnel(a[u], next, q, sel));
    }
  }
}

}  // namespace

// Copies head + 16 * units + tail bytes from src to dst (copy_plan in the
// wrapper cuts them: head, tail < 16, dst + head 16-byte aligned when
// units > 0) in one launch of `grid` >= 1 blocks. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a cut or grid that
// breaks those rules.
extern "C" int repro_chunked_copy(void* dst, const void* src, long long head,
                                  long long units, long long tail, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* d = static_cast<uint8_t*>(dst);
  const bool bad_cut = head < 0 || head > 15 || tail < 0 || tail > 15 || units < 0 ||
                       (units > 0 && (reinterpret_cast<uintptr_t>(d + head) & 15));
  if (grid <= 0 || bad_cut) return static_cast<int>(cudaErrorInvalidValue);
  if (head + units + tail == 0) return 0;
  copy_tiles<<<grid, kThreads, 0, s>>>(d, static_cast<const uint8_t*>(src), head, units,
                                       tail);
  return static_cast<int>(cudaGetLastError());
}
