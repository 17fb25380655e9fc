// Device-initiated schedule replay: a whole lowered collective schedule in
// ONE launch, one group of thread blocks per rank, the ranks synchronized
// only by point-to-point flags.
//
// Replaces: src/repro/kernels/inkernel_collective.py:246 _rdma_replay (its
//   pallas_call at :269, kernel body _rdma_kernel :175), reached through
//   inkernel_replay (:285).
// Semantics: for each round, lane classes in order; in a class-round every
//   pair (src, dst) that moves rows puts rows [lo, hi) of src's send window
//   (at send_start) into dst's landing slot, then dst merges its slot into
//   its window (at recv_start): dst + slot on combine rounds (bf16 summed in
//   f32 and rounded once to nearest even, as combine_update.cu does), slot
//   otherwise. Rows outside [lo, hi) are never read or written, so -0.0 and
//   NaN payloads in kept rows survive bit for bit. The reference puts the
//   whole block; only [lo, hi) is ever merged, so the result is the same.
// Protocol, per class-round in which the rank puts or receives (the host
//   table says which; every block of a group reads the same entry):
//   1. rank-local barrier: all B blocks have finished the previous merge;
//   2. the group's leader signals the barrier words of its put partner and
//      of its receive partner (release);
//   3. every block waits for its own barrier words to reach their targets
//      (acquire);
//   4. the blocks put rows [lo, hi) into the partner's landing slot;
//   5. rank-local barrier (each block fences first): every put is done, and
//      no block merges into a row another block is still reading for its
//      put (the class snapshot);
//   6. the leader signals the partner's receive word (release);
//   7. every block waits for its own receive word's target, then merges.
//   Each rank keeps one barrier word and one receive word PER SENDER, and a
//   word counts that sender's signals since the launch; the targets are
//   cumulative counts computed on the host (rdma_wait_targets in the
//   wrapper): no wait arithmetic happens here. One counter for all senders
//   would let a partner that runs ahead stand in for one that has not
//   arrived. One landing slot per rank (the largest block) serves every
//   class: a source puts only after its destination signalled the barrier,
//   which it does only after its last merge.
// Addresses: the kernel takes a pointer table (each rank's buffer row,
//   landing slot and flag words) and never computes another rank's address
//   from its own. On one card the pointers are rows of one allocation; on
//   many cards they become symmetric-memory peer pointers, and the flags'
//   scope (.gpu below) becomes .sys. The protocol stays.
// Liveness: a block that spins on a flag while its partner's blocks are not
//   resident deadlocks the card, so the launch is cooperative, sized from
//   the occupancy query, and split into n groups of B = floor(resident / n)
//   blocks. Every spin is bounded by %globaltimer: a wait unmet for
//   kTimeoutNs ends in __trap(), and the error reaches the caller at its
//   next synchronize. Nothing falls back.
// Bound: bytes, as the shared kernel's: over every merged row, the source
//   row read, the destination read on combine rounds, the destination
//   written; / 3.35 TB/s (H100 SXM data sheet). The landing slot adds a
//   write and a read of every merged row (4 units a row, 5 on combine
//   rounds, against 2 and 3), and a class-round's put and merge run one
//   after the other on one group each.
// Memory: flags are monotonic within a launch and zeroed by a
//   cudaMemsetAsync on the same stream before it. Loads of data that other
//   blocks wrote in this launch go through L2 (__ldcg). 16-byte vectors when
//   every row starts 16-byte aligned, else element by element. 64-bit
//   indices throughout: the training plan's buffer holds 4.19e9 elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 64;  // MAX_RANKS in the wrapper
constexpr int kFields = 12;    // RDMA_FIELDS in the wrapper
constexpr unsigned long long kTimeoutNs = 10ull * 1000 * 1000 * 1000;

// entry fields (rdma_table in the wrapper)
constexpr int kDst = 0, kSrc = 1, kPutLo = 2, kPutHi = 3, kSend = 4, kLo = 5,
              kHi = 6, kRecv = 7, kWaitBarDst = 8, kWaitBarSrc = 9,
              kWaitRecv = 10, kComb = 11;

// The pointer table. Flag words of a rank: [0] its blocks' arrival counter,
// [1 + q] barrier signals from rank q, [1 + n + q] receive signals from q.
struct Peers {
  void* buf[kMaxRanks];
  void* land[kMaxRanks];
  unsigned* flags[kMaxRanks];
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

// All B blocks of this rank's group reach this point (target = B * epoch).
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

__device__ __forceinline__ float add_unit(float a, float b, float) {
  return a + b;
}

__device__ __forceinline__ __nv_bfloat16 add_unit(__nv_bfloat16 a,
                                                  __nv_bfloat16 b,
                                                  __nv_bfloat16) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

__device__ __forceinline__ uint4 add_unit(uint4 a, uint4 b, float) {
  float4 x = *reinterpret_cast<float4*>(&a);
  float4 y = *reinterpret_cast<float4*>(&b);
  float4 z = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  return *reinterpret_cast<uint4*>(&z);
}

__device__ __forceinline__ uint4 add_unit(uint4 a, uint4 b, __nv_bfloat16) {
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

// to[i] = comb ? to[i] + from[i] : from[i] over [0, len), strided over the
// group's threads.
template <typename T, typename U>
__device__ __forceinline__ void span(U* to, const U* from, long long len,
                                     int comb, long long tid, long long stride) {
  if (comb) {
    for (long long i = tid; i < len; i += stride) {
      to[i] = add_unit(__ldcg(to + i), __ldcg(from + i), T());
    }
  } else {
    for (long long i = tid; i < len; i += stride) to[i] = __ldcg(from + i);
  }
}

// U is the unit a thread moves: uint4 (16 bytes) or T itself.
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads)
    replay(Peers p, const int* tab, int C, int rounds, int n, int B,
           long long cols) {
  constexpr long long V = sizeof(U) / sizeof(T);
  const long long units = cols / V;  // units per row
  const int me = blockIdx.x / B;
  const int lb = blockIdx.x % B;
  const bool leader = lb == 0 && threadIdx.x == 0;
  const long long tid = (long long)lb * blockDim.x + threadIdx.x;
  const long long stride = (long long)B * blockDim.x;
  U* mine = static_cast<U*>(p.buf[me]);
  const U* slot = static_cast<const U*>(p.land[me]);
  unsigned* flags = p.flags[me];
  unsigned epoch = 0;
  for (int s = 0; s < rounds; ++s) {
    for (int c = 0; c < C; ++c) {
      const int* e = tab + (((long long)s * C + c) * n + me) * kFields;
      const int dst = e[kDst], src = e[kSrc];
      if (dst < 0 && src < 0) continue;
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
        span<T>(static_cast<U*>(p.land[dst]) + lo * units,
                mine + (e[kSend] + lo) * units, (hi - lo) * units, 0, tid,
                stride);
        local_barrier(flags, ++epoch * B);
        if (leader) signal(p.flags[dst] + 1 + n + me);
      }
      if (src >= 0) {
        if (threadIdx.x == 0) {
          wait_geq(flags + 1 + n + src, e[kWaitRecv]);
          __threadfence();
        }
        __syncthreads();
        const long long lo = e[kLo], hi = e[kHi];
        span<T>(mine + (e[kRecv] + lo) * units, slot + lo * units,
                (hi - lo) * units, e[kComb], tid, stride);
      }
    }
  }
}

// Blocks the device holds resident at once for this instantiation.
template <typename T, typename U>
int resident_blocks() {
  static int blocks = 0;  // per instantiation, one device
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, replay<T, U>,
                                                      kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    blocks = per_sm * sms;
  }
  return blocks;
}

template <typename T, typename U>
int launch(const Peers& peers, const int* tab, int C, int rounds, int n,
           long long cols, cudaStream_t stream) {
  int B = resident_blocks<T, U>() / n;
  if (B < 1) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err
                                               : cudaErrorCooperativeLaunchTooLarge);
  }
  Peers p = peers;
  void* args[] = {&p, &tab, &C, &rounds, &n, &B, &cols};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(replay<T, U>), dim3(n * B), dim3(kThreads),
      args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

}  // namespace

// ptrs: host array of 3n device pointers, each rank's buffer row (K, cols),
// landing slot and flag words, in that order; tables: the device int32 table
// (rounds, C, n, kFields); flags: the n ranks' flag words, flag_words int32
// in all, zeroed here on the stream before the launch. dtype 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int repro_inkernel_rdma(const unsigned long long* ptrs,
                                   const void* tables, int C, int rounds, int n,
                                   long long cols, void* flags,
                                   long long flag_words, int dtype,
                                   void* stream) {
  if (C <= 0 || rounds <= 0 || cols <= 0) return 0;
  if (n < 1 || n > kMaxRanks) return static_cast<int>(cudaErrorInvalidValue);
  Peers peers;
  const int elem = dtype == 1 ? 2 : 4;
  bool vec = (cols * elem) % 16 == 0;
  for (int r = 0; r < n; ++r) {
    peers.buf[r] = reinterpret_cast<void*>(ptrs[r]);
    peers.land[r] = reinterpret_cast<void*>(ptrs[n + r]);
    peers.flags[r] = reinterpret_cast<unsigned*>(ptrs[2 * n + r]);
    vec = vec && aligned(peers.buf[r]) && aligned(peers.land[r]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(flags, 0, static_cast<size_t>(flag_words) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* tab = static_cast<const int*>(tables);
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, uint4>(peers, tab, C, rounds, n, cols, s)
               : launch<__nv_bfloat16, __nv_bfloat16>(peers, tab, C, rounds, n,
                                                      cols, s);
  }
  return vec ? launch<float, uint4>(peers, tab, C, rounds, n, cols, s)
             : launch<float, float>(peers, tab, C, rounds, n, cols, s);
}

// Blocks in each rank's group of the cooperative grid (blocks of 256
// threads); 0 when the device holds fewer than n blocks at once.
extern "C" int repro_inkernel_rdma_group(int dtype, int vec, int n) {
  if (n < 1) return 0;
  if (dtype == 1) {
    return (vec ? resident_blocks<__nv_bfloat16, uint4>()
                : resident_blocks<__nv_bfloat16, __nv_bfloat16>()) / n;
  }
  return (vec ? resident_blocks<float, uint4>() : resident_blocks<float, float>()) /
         n;
}
