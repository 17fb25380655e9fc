// Device-initiated schedule replay: a whole lowered schedule in ONE launch,
// one group of thread blocks per rank, the ranks synchronized only by
// point-to-point flags.
//
// Replaces: src/repro/kernels/inkernel_collective.py:246 _rdma_replay (its
//   pallas_call at :269, kernel body _rdma_kernel :175), reached through
//   inkernel_replay (:285).
// Semantics: for each round, lane classes in order; in a class-round every
//   pair (src, dst) that moves rows merges rows [lo, hi) of src's send
//   window (at send_start) into dst's window (at recv_start): dst + src on
//   combine rounds (bf16 summed in f32 and rounded once to nearest even, as
//   combine_update.cu does), src otherwise. Every read sees the class's
//   snapshot. Rows outside [lo, hi) are never read or written, and a copy
//   moves bits, never a float conversion, so -0.0 and NaN payloads in kept
//   rows survive bit for bit.
// Two kinds of class-round (the host's round_modes, field kMode):
//   DIRECT: no row the class-round reads is a row it writes, across the
//     whole stacked buffer. The source's blocks write straight into the
//     destination's window, merging on the fly on combine rounds: 2 units a
//     row (3 on combine rounds), one pass, and the destination only waits.
//   STAGED (two ranks swapping a chunk): the source puts its rows into the
//     destination's landing slot and the destination merges the slot into
//     its window afterwards, so every read sees the snapshot.
// Protocol, per class-round in which the rank puts or receives (the host
//   table says which; every block of a group reads the same entry):
//   1. rank-local barrier: all blocks of the group have finished the
//      previous class-round, its reads included;
//   2. the group's leader signals the barrier words of its put partner and
//      of its receive partner (release);
//   3. every block waits for its own barrier words to reach their targets
//      (acquire): the partners have finished their previous class-rounds,
//      so a direct write lands on no row its owner still reads, and a
//      landing slot is free;
//   4. the blocks put rows [lo, hi): into the partner's window (DIRECT) or
//      its landing slot (STAGED);
//   5. rank-local barrier (each block fences first): every put is done;
//   6. the leader signals the partner's receive word (release);
//   7. every block waits for its own receive word's target, then (STAGED
//      only) merges its slot.
//   Each rank keeps one barrier word and one receive word PER SENDER, and a
//   word counts that sender's signals since the launch; the targets are
//   cumulative counts computed on the host (rdma_wait_targets in the
//   wrapper): no wait arithmetic happens here. One counter for all senders
//   would let a partner that runs ahead stand in for one that has not
//   arrived. One landing slot per rank (the largest block of a class with a
//   STAGED class-round) serves every class; plans with no STAGED
//   class-round pass null slots, which are never touched.
// Addresses: the kernel takes a pointer table (each rank's buffer row,
//   landing slot and flag words, and the groups' first blocks) and never
//   computes another rank's address from its own. On one card the pointers
//   are rows of one allocation; on many cards they become symmetric-memory
//   peer pointers, and the flags' scope (.gpu below) becomes .sys. The
//   protocol stays.
// Groups: a block that spins on a flag while its partner's blocks are not
//   resident deadlocks the card, so the launch is cooperative and at most
//   the occupancy query's resident count. The host sizes each rank's group
//   by the bytes it moves (rdma_groups in the wrapper: at least one block,
//   the rest in proportion); a block finds its rank by searching the
//   groups' starts. On one card this lets the ranks that move rows use the
//   SMs that a chain's tail leaves idle; on many cards each group is its
//   own card and the sizing is moot. Every spin is bounded by
//   %globaltimer: a wait unmet for kTimeoutNs ends in __trap(), and the
//   error reaches the caller at its next synchronize. Nothing falls back.
// Bound: bytes, as the shared kernel's: over every merged row, the source
//   row read, the destination read on combine rounds, the destination
//   written; / 3.35 TB/s (H100 SXM data sheet). DIRECT class-rounds move
//   exactly that; STAGED ones add a write and a read of the slot.
// Spans: a pair's window is one contiguous span in both buffers; only the
//   two start addresses differ mod 16 (odd chunk widths). The head is moved
//   element by element until the destination is 16-byte aligned; the body
//   reads aligned 16-byte source vectors and builds each output vector from
//   two neighbours shifted by the byte offset (prmt on the 32-bit words; the
//   neighbour comes from the next lane by shuffle, so a warp issues 33 loads
//   for 32 aligned 16-byte stores), kUnroll vectors in flight per thread;
//   the tail goes element by element. The aligned case is the same code
//   with shift 0. Loads of data that other blocks wrote in this launch go
//   through L2 (__ldcg). Flags are monotonic within a launch and zeroed by a
//   cudaMemsetAsync on the same stream before it. 64-bit indices
//   throughout: the training plan's buffer holds 4.19e9 elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // 16-byte vectors in flight per thread
constexpr int kMaxRanks = 64;  // MAX_RANKS in the wrapper
constexpr int kFields = 13;    // RDMA_FIELDS in the wrapper
constexpr unsigned long long kTimeoutNs = 10ull * 1000 * 1000 * 1000;

// entry fields (rdma_table in the wrapper)
constexpr int kDst = 0, kSrc = 1, kPutLo = 2, kPutHi = 3, kSend = 4, kLo = 5,
              kHi = 6, kRecv = 7, kWaitBarDst = 8, kWaitBarSrc = 9,
              kWaitRecv = 10, kComb = 11, kMode = 12;
constexpr int kDirect = 1;  // round_modes: SKIP 0, DIRECT 1, STAGED 2

// The pointer table. Flag words of a rank: [0] its blocks' arrival counter,
// [1 + q] barrier signals from rank q, [1 + n + q] receive signals from q.
// Rank r's group is blocks [start[r], start[r + 1]).
struct Peers {
  void* buf[kMaxRanks];
  void* land[kMaxRanks];
  unsigned* flags[kMaxRanks];
  int start[kMaxRanks + 1];
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void signal(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(1u)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p >= target; trap after kTimeoutNs.
__device__ __forceinline__ void wait_geq(const unsigned* p, unsigned target) {
  if (ld_acquire(p) >= target) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(p) < target) {
    if (global_ns() - t0 > kTimeoutNs) __trap();
    __nanosleep(64);
  }
}

// All blocks of this rank's group reach this point (target = B_me * epoch).
__device__ __forceinline__ void local_barrier(unsigned* arrive, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrive, 1u);
    wait_geq(arrive, target);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float add_unit(float a, float b) { return a + b; }

__device__ __forceinline__ __nv_bfloat16 add_unit(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

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

// One element: *to = comb ? *to + *from : *from (bits only when copying).
template <typename T>
__device__ __forceinline__ void move_elem(T* to, const T* from, int comb) {
  const T v = __ldcg(from);
  *to = comb ? add_unit(__ldcg(to), v) : v;
}

// to[i] = comb ? to[i] + from[i] : from[i] over [0, len), spread over the
// group's nthreads threads (tid is this thread's place among them; every
// thread of the group calls with the same arguments). The two spans may
// start at any element offsets mod 16 bytes; no store falls outside.
template <typename T>
__device__ __forceinline__ void span(T* to, const T* from, long long len, int comb,
                                     long long tid, long long nthreads) {
  constexpr long long V = 16 / sizeof(T);
  long long head = ((16 - (reinterpret_cast<uintptr_t>(to) & 15)) & 15) / sizeof(T);
  if (head > len) head = len;
  if (tid < head) move_elem(to + tid, from + tid, comb);
  to += head;
  from += head;
  len -= head;
  const long long nv = len / V;  // aligned 16-byte stores
  const long long tail = len - nv * V;
  if (tid < tail) move_elem(to + nv * V + tid, from + nv * V + tid, comb);
  if (nv == 0) return;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(from) & 15);
  const uint4* src =
      reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(from) - off);
  uint4* dst = reinterpret_cast<uint4*>(to);
  const long long avail = nv + (off != 0);  // aligned source vectors the body reads
  const int q = off >> 2;
  const unsigned sel = 0x3210u + 0x1111u * static_cast<unsigned>(off & 3);
  const bool last_lane = (threadIdx.x & 31) == 31;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  // `it` is the same in every thread of the group, so whole warps run each
  // iteration and the shuffles see all 32 lanes
  for (long long it = 0; it < nv; it += kUnroll * nthreads) {
    uint4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = it + u * nthreads + tid;
      a[u] = j < avail ? __ldcg(src + j) : zero;
      b[u] = off && last_lane && j + 1 < avail ? __ldcg(src + j + 1) : zero;
    }
    if (off) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint4 nx = shfl_down(a[u]);
        if (!last_lane) b[u] = nx;
      }
    }
    if (comb) {
      uint4 d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = it + u * nthreads + tid;
        d[u] = j < nv ? __ldcg(dst + j) : zero;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = it + u * nthreads + tid;
        if (j < nv) dst[j] = add_vec(d[u], funnel(a[u], b[u], q, sel), T());
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = it + u * nthreads + tid;
        if (j < nv) dst[j] = funnel(a[u], b[u], q, sel);
      }
    }
  }
}

// at most 80 registers a thread: three blocks of 256 on every SM
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    replay(Peers p, const int* tab, int C, int rounds, int n, long long cols) {
  int me = 0;
  while (static_cast<int>(blockIdx.x) >= p.start[me + 1]) ++me;
  const int B = p.start[me + 1] - p.start[me];
  const int lb = blockIdx.x - p.start[me];
  const bool leader = lb == 0 && threadIdx.x == 0;
  const long long tid = (long long)lb * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)B * blockDim.x;
  T* mine = static_cast<T*>(p.buf[me]);
  const T* slot = static_cast<const T*>(p.land[me]);
  unsigned* flags = p.flags[me];
  unsigned epoch = 0;
  for (int s = 0; s < rounds; ++s) {
    for (int c = 0; c < C; ++c) {
      const int* row = tab + ((long long)s * C + c) * n * kFields;
      const int* e = row + me * kFields;
      const int dst = e[kDst], src = e[kSrc];
      if (dst < 0 && src < 0) continue;
      const bool direct = e[kMode] == kDirect;
      local_barrier(flags, ++epoch * B);
      if (leader) {
        if (dst >= 0) signal(p.flags[dst] + 1 + me);
        if (src >= 0) signal(p.flags[src] + 1 + me);
      }
      if (threadIdx.x == 0) {
        if (dst >= 0) wait_geq(flags + 1 + dst, e[kWaitBarDst]);
        if (src >= 0) wait_geq(flags + 1 + src, e[kWaitBarSrc]);
        __threadfence();
      }
      __syncthreads();
      if (dst >= 0) {
        const long long lo = e[kPutLo], hi = e[kPutHi];
        const T* from = mine + (e[kSend] + lo) * cols;
        if (direct) {
          T* to = static_cast<T*>(p.buf[dst]) + (row[dst * kFields + kRecv] + lo) * cols;
          span<T>(to, from, (hi - lo) * cols, e[kComb], tid, nthreads);
        } else {
          span<T>(static_cast<T*>(p.land[dst]) + lo * cols, from, (hi - lo) * cols, 0,
                  tid, nthreads);
        }
        local_barrier(flags, ++epoch * B);
        if (leader) signal(p.flags[dst] + 1 + n + me);
      }
      if (src >= 0) {
        if (threadIdx.x == 0) {
          wait_geq(flags + 1 + n + src, e[kWaitRecv]);
          __threadfence();
        }
        __syncthreads();
        if (!direct) {
          const long long lo = e[kLo], hi = e[kHi];
          span<T>(mine + (e[kRecv] + lo) * cols, slot + lo * cols, (hi - lo) * cols,
                  e[kComb], tid, nthreads);
        }
      }
    }
  }
}

// Blocks the device holds resident at once for this instantiation, into
// *out; returns the occupancy query's cudaError_t.
template <typename T>
cudaError_t resident_blocks(int* out) {
  static int blocks = 0;  // per instantiation, one device
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, replay<T>, kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    blocks = per_sm * sms;
  }
  *out = blocks;
  return cudaSuccess;
}

template <typename T>
int launch(const Peers& peers, const int* tab, int C, int rounds, int n,
           long long cols, cudaStream_t stream) {
  const int grid = peers.start[n];
  int resident = 0;
  const cudaError_t query = resident_blocks<T>(&resident);
  if (query != cudaSuccess) return static_cast<int>(query);
  if (grid > resident) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Peers p = peers;
  void* args[] = {&p, &tab, &C, &rounds, &n, &cols};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(replay<T>), dim3(grid), dim3(kThreads), args, 0,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: host array of 3n device pointers, each rank's buffer row (K, cols),
// landing slot (null when the plan stages nothing) and flag words, in that
// order; starts: host array of n + 1 ints, rank r's group is blocks
// [starts[r], starts[r + 1]), each at least one block, starts[n] at most
// repro_inkernel_rdma_resident; tables: the device int32 table (rounds, C, n,
// kFields); flags: the n ranks' flag words, flag_words int32 in all, zeroed
// here on the stream before the launch. dtype 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 on success).
extern "C" int repro_inkernel_rdma(const unsigned long long* ptrs, const int* starts,
                                   const void* tables, int C, int rounds, int n,
                                   long long cols, void* flags, long long flag_words,
                                   int dtype, void* stream) {
  if (C <= 0 || rounds <= 0 || cols <= 0) return 0;
  if (n < 1 || n > kMaxRanks || starts[0] != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Peers peers;
  peers.start[0] = 0;
  for (int r = 0; r < n; ++r) {
    if (starts[r + 1] <= starts[r]) return static_cast<int>(cudaErrorInvalidValue);
    peers.buf[r] = reinterpret_cast<void*>(ptrs[r]);
    peers.land[r] = reinterpret_cast<void*>(ptrs[n + r]);
    peers.flags[r] = reinterpret_cast<unsigned*>(ptrs[2 * n + r]);
    peers.start[r + 1] = starts[r + 1];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(flags, 0, static_cast<size_t>(flag_words) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* tab = static_cast<const int*>(tables);
  return dtype == 1 ? launch<__nv_bfloat16>(peers, tab, C, rounds, n, cols, s)
                    : launch<float>(peers, tab, C, rounds, n, cols, s);
}

// Blocks of 256 threads the device holds resident at once for the dtype's
// instantiation, into *blocks: the most the groups may hold together.
// Returns a cudaError_t (0 on success).
extern "C" int repro_inkernel_rdma_resident(int dtype, int* blocks) {
  return static_cast<int>(dtype == 1 ? resident_blocks<__nv_bfloat16>(blocks)
                                     : resident_blocks<float>(blocks));
}
