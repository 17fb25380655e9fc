// Fused parameter updates over flat buffers: model averaging
// out = (1 - a) * w + a * u and the gradient step out = w - a * u, each
// computed in f32 and rounded once to w's dtype.
//
// Replaces: src/repro/kernels/param_update.py:67 mix and :73 scaled_add
//   (their kernels _mix_kernel / _scaled_add_kernel, pallas_call at :50 in
//   _run), a 1-D grid over 65,536-element tiles with a zero-padded tail.
// Bound: bytes. w and u are read once and the output written once, so the
//   least time is 3 * n * elem_size / 3.35 TB/s on an H100 SXM.
// Design: a grid-stride loop over 16-byte vectors (8 bf16 or 4 f32 values a
//   thread) when all three pointers are 16-byte aligned, and an element loop
//   over the ragged tail (or over everything when a pointer is not aligned);
//   nothing is padded. The arithmetic is spelled with __fmul_rn / __fadd_rn /
//   __fsub_rn so that nvcc cannot contract it into an FMA: each product and
//   sum is rounded as the plain PyTorch version rounds it, and the results
//   are bit-equal. `a` and `1 - a` arrive as f32, computed as the reference
//   computes them (a rounded to f32, then 1 - a in f32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void cast_to(float* p, float x) { *p = x; }
__device__ __forceinline__ void cast_to(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// op 0: mix, (1 - a) * w + a * u; op 1: scaled_add, w - a * u
template <int OP>
__device__ __forceinline__ float update(float w, float u, float a, float one_minus_a) {
  if (OP == 0) return __fadd_rn(__fmul_rn(one_minus_a, w), __fmul_rn(a, u));
  return __fsub_rn(w, __fmul_rn(a, u));
}

template <typename T, int OP>
__global__ void update_vec(T* __restrict__ out, const T* __restrict__ w,
                           const T* __restrict__ u, long long nvec, float a, float one_minus_a) {
  constexpr int kPer = 16 / sizeof(T);
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nvec; i += step) {
    const uint4 wv = reinterpret_cast<const uint4*>(w)[i];
    const uint4 uv = reinterpret_cast<const uint4*>(u)[i];
    uint4 ov;
    const T* wp = reinterpret_cast<const T*>(&wv);
    const T* up = reinterpret_cast<const T*>(&uv);
    T* op = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      cast_to(&op[e], update<OP>(to_f32(wp[e]), to_f32(up[e]), a, one_minus_a));
    reinterpret_cast<uint4*>(out)[i] = ov;
  }
}

template <typename T, int OP>
__global__ void update_elem(T* __restrict__ out, const T* __restrict__ w,
                            const T* __restrict__ u, long long n, float a, float one_minus_a) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += step)
    cast_to(&out[i], update<OP>(to_f32(w[i]), to_f32(u[i]), a, one_minus_a));
}

unsigned grid_for(long long items) {
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, grid-stride beyond
  return (unsigned)(blocks > 0 ? blocks : 1);
}

template <typename T, int OP>
int run(void* out, const void* w, const void* u, long long n, float a, float one_minus_a,
        cudaStream_t s) {
  T* o = static_cast<T*>(out);
  const T* wp = static_cast<const T*>(w);
  const T* up = static_cast<const T*>(u);
  constexpr int kPer = 16 / sizeof(T);
  long long done = 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(wp) |
                         reinterpret_cast<uintptr_t>(up)) % 16) == 0;
  if (aligned && n >= kPer) {
    const long long nvec = n / kPer;
    update_vec<T, OP><<<grid_for(nvec), kThreads, 0, s>>>(o, wp, up, nvec, a, one_minus_a);
    done = nvec * kPer;
  }
  if (n > done)
    update_elem<T, OP><<<grid_for(n - done), kThreads, 0, s>>>(o + done, wp + done, up + done,
                                                                n - done, a, one_minus_a);
  return (int)cudaGetLastError();
}

}  // namespace

// op: 0 mix, 1 scaled_add; dtype: 0 float32, 1 bfloat16. Flat contiguous
// buffers of n elements; out is a buffer of its own (the wrapper allocates it).
extern "C" int repro_param_update(void* out, const void* w, const void* u, long long n,
                                  int op, int dtype, float a, float one_minus_a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (dtype == 0 && op == 0) return run<float, 0>(out, w, u, n, a, one_minus_a, s);
  if (dtype == 0 && op == 1) return run<float, 1>(out, w, u, n, a, one_minus_a, s);
  if (dtype == 1 && op == 0) return run<__nv_bfloat16, 0>(out, w, u, n, a, one_minus_a, s);
  if (dtype == 1 && op == 1) return run<__nv_bfloat16, 1>(out, w, u, n, a, one_minus_a, s);
  return (int)cudaErrorInvalidValue;
}
