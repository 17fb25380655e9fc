// In-kernel schedule replay: a whole lowered collective schedule replayed in
// ONE launch over the rank-stacked (n, K, cols) buffer, in place.
//
// Replaces: src/repro/kernels/inkernel_collective.py:136
//   inkernel_replay_shared (its pallas_call at :149), kernel body
//   _shared_kernel (:101) over the planes of _packed_planes (:53).
// Semantics: for each round, lane classes in order; within a class-round,
//   every active pair (src, dst) merges rows [lo, hi) of src's block at
//   send_start into dst's block at recv_start: dst + src on combine rounds
//   (bf16 summed in f32 and rounded once to nearest even, as
//   combine_update.cu and the plain version do), src otherwise. A row
//   outside [lo, hi) is never read or written, so -0.0 and NaN payloads in
//   kept rows survive bit for bit. Every source row is read from the class's
//   snapshot: the host marks a class-round STAGED when a row it reads is a
//   row it writes; then the incoming rows land in a scratch first, the grid
//   synchronizes, and the merge reads the scratch. Otherwise (DIRECT) each
//   thread reads its source element and writes its destination element.
// Bound: bytes. Over every merged row: the source row read, the destination
//   read on combine rounds, the destination written; those bytes / 3.35 TB/s
//   on an H100 SXM (NVIDIA data sheet). The compiled executor moves about
//   twice that (gather into a receive slot, then merge) in 2 launches per
//   class-round.
// Design: a cooperative launch sized to the occupancy limit (every block
//   resident), a grid-stride loop over each pair's window (one contiguous
//   span: a rank's consecutive rows are adjacent), and a grid-wide barrier
//   (cooperative_groups grid sync) between class-rounds, so rounds run in
//   order inside the one launch. The tables stay in device memory, uploaded
//   once per lowering by the wrapper. Spans move as 16-byte vectors when
//   every row starts 16-byte aligned, else element by element. 64-bit
//   indices throughout: the training plan's buffer holds 4.19e9 elements.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSkip = 0, kStaged = 2;

// Device tables, one int32 block (see _device_tables in the wrapper):
// npairs (C), pairs (C, n, 2), block (C), send_start, recv_start, lo, hi
// (C, T, n), combine (C, T), mode (C, T).
struct Tables {
  const int* npairs;
  const int* pairs;
  const int* block;
  const int* send;
  const int* recv;
  const int* lo;
  const int* hi;
  const int* comb;
  const int* mode;
  int C, T, n;
};

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

// to[i] = comb ? to[i] + from[i] : from[i] over [0, len), grid-strided.
// Plain (coherent) loads: the buffer changes between class-rounds.
template <typename T, typename U>
__device__ __forceinline__ void merge_span(U* to, const U* from, long long len,
                                           int comb, long long tid,
                                           long long stride) {
  if (comb) {
    for (long long i = tid; i < len; i += stride) {
      to[i] = add_unit(to[i], from[i], T());
    }
  } else {
    for (long long i = tid; i < len; i += stride) to[i] = from[i];
  }
}

// U is the unit a thread moves: uint4 (16 bytes) or T itself.
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads)
    replay(T* buf, T* land, Tables tb, long long K, long long cols,
           long long land_rows) {
  constexpr long long V = sizeof(U) / sizeof(T);
  const long long units = cols / V;  // units per row
  U* b = reinterpret_cast<U*>(buf);
  U* l = reinterpret_cast<U*>(land);
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int n = tb.n;
  bool pending = false;  // a class-round ran since the last barrier
  for (int s = 0; s < tb.T; ++s) {
    for (int c = 0; c < tb.C; ++c) {
      // uniform across the grid: every thread reads the same table words,
      // so every thread reaches the same barriers
      const int mode = tb.mode[c * tb.T + s];
      if (mode == kSkip) continue;
      if (pending) grid.sync();
      pending = true;
      const int comb = tb.comb[c * tb.T + s];
      const int np = tb.npairs[c];
      const int* pr = tb.pairs + (long long)c * n * 2;
      const long long at = ((long long)c * tb.T + s) * n;
      if (mode == kStaged) {
        for (int p = 0; p < np; ++p) {
          const int src = pr[2 * p], dst = pr[2 * p + 1];
          const int lo = tb.lo[at + dst], hi = tb.hi[at + dst];
          if (hi <= lo) continue;
          const U* from = b + ((long long)src * K + tb.send[at + src] + lo) * units;
          U* to = l + ((long long)dst * land_rows + lo) * units;
          merge_span<T>(to, from, (long long)(hi - lo) * units, 0, tid, stride);
        }
        grid.sync();
      }
      for (int p = 0; p < np; ++p) {
        const int src = pr[2 * p], dst = pr[2 * p + 1];
        const int lo = tb.lo[at + dst], hi = tb.hi[at + dst];
        if (hi <= lo) continue;
        const U* from =
            mode == kStaged
                ? l + ((long long)dst * land_rows + lo) * units
                : b + ((long long)src * K + tb.send[at + src] + lo) * units;
        U* to = b + ((long long)dst * K + tb.recv[at + dst] + lo) * units;
        merge_span<T>(to, from, (long long)(hi - lo) * units, comb, tid, stride);
      }
    }
  }
}

// Blocks of the cooperative grid: every block must be resident at once.
template <typename T, typename U>
int grid_blocks() {
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
int launch(void* buf, void* land, Tables tb, long long K, long long cols,
           long long land_rows, cudaStream_t stream) {
  const int blocks = grid_blocks<T, U>();
  if (blocks <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err
                                               : cudaErrorCooperativeLaunchTooLarge);
  }
  T* b = static_cast<T*>(buf);
  T* l = static_cast<T*>(land);
  void* args[] = {&b, &l, &tb, &K, &cols, &land_rows};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(replay<T, U>), dim3(blocks), dim3(kThreads),
      args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buf: (n, K, cols) of dtype (0 = float32, 1 = bfloat16); land: (n *
// land_rows, cols) scratch or null when no class-round stages; tables: the
// device int32 block above. Returns a cudaError_t (0 on success).
extern "C" int repro_inkernel_replay(void* buf, void* land, const void* tables,
                                     int C, int T, int n, long long K,
                                     long long cols, long long land_rows,
                                     int dtype, void* stream) {
  if (C <= 0 || T <= 0 || cols <= 0) return 0;
  const int* t = static_cast<const int*>(tables);
  const long long ctn = (long long)C * T * n;
  Tables tb;
  tb.npairs = t;
  tb.pairs = tb.npairs + C;
  tb.block = tb.pairs + (long long)C * n * 2;
  tb.send = tb.block + C;
  tb.recv = tb.send + ctn;
  tb.lo = tb.recv + ctn;
  tb.hi = tb.lo + ctn;
  tb.comb = tb.hi + ctn;
  tb.mode = tb.comb + (long long)C * T;
  tb.C = C;
  tb.T = T;
  tb.n = n;
  const int elem = dtype == 1 ? 2 : 4;
  const bool vec = (cols * elem) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(buf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(land) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, uint4>(buf, land, tb, K, cols, land_rows, s)
               : launch<__nv_bfloat16, __nv_bfloat16>(buf, land, tb, K, cols,
                                                      land_rows, s);
  }
  return vec ? launch<float, uint4>(buf, land, tb, K, cols, land_rows, s)
             : launch<float, float>(buf, land, tb, K, cols, land_rows, s);
}

// The cooperative grid the replay launches with (blocks of 256 threads).
extern "C" int repro_inkernel_grid(int dtype, int vec) {
  if (dtype == 1) {
    return vec ? grid_blocks<__nv_bfloat16, uint4>()
               : grid_blocks<__nv_bfloat16, __nv_bfloat16>();
  }
  return vec ? grid_blocks<float, uint4>() : grid_blocks<float, float>();
}
