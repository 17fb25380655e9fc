// Blocked online-softmax attention, forward, on CUDA cores: the route of
// every call that flash_attention_sm90.cu (bf16, head widths 64, 128 and
// 256) does not take, that is f32 at every width (phase 5's smoke models,
// the f32 smoke configs' prefill) and bf16 at head widths 16 and 32. It
// takes 16, 32, 64, 128 and 256 in either dtype.
//
// Replaces: src/repro/kernels/flash_attention.py:102 flash_attention (its
//   pallas_call at :141; the body is _kernel, :38-95). q (B, T, H, hd),
//   k/v (B, S, KV, hd), GQA (kv head = h / (H / KV)), causal / sliding
//   window / prefix-LM masks, f32 or bf16 in, the input dtype out.
// Bound: operations. 4 * hd flops per (query, key) pair the caller's tiles
//   keep, on bf16 tensor cores at 989 TFLOP/s (H100 SXM data sheet), against
//   the bytes of q, k, v read once and the output written once at 3.35 TB/s;
//   at the serving path's shapes the flops bound it.
// Design: simple first. One block of 256 threads per (64 query rows, query
//   head, batch). It stages its q rows once and then walks the keys in
//   tiles of 32, each staged in shared memory in f32, and keeps the running
//   (max, sum, acc) of its rows in registers: a thread owns 4 rows (ty +
//   16a) and, for the scores, 2 keys (tx + 16c); for the output, 4-column
//   groups (4tx + 64n). The products are f32 FMAs on CUDA cores, float4
//   reads of shared memory, no tensor cores (f32 has none at full
//   precision), so the kernel runs far from its bound.
//   What head width 256 costs: the f32 tiles take (64*260 + 32*260 +
//   32*256 + 64*36) * 4 = 141,824 bytes of shared memory a block (76,800
//   at 128), above the 48 KB default, so every launch opts in with
//   cudaFuncSetAttribute; one block fits an SM (two at 128), 8 warps to
//   hide latency. Each thread keeps acc[4][4][4], 64 f32, for its output.
//   The arithmetic is the Pallas kernel's: scale after the q.k dot, masked
//   scores set to -1e30 (not -inf), the running max starting at -1e30, the
//   sum clamped at 1e-30 before the division. The caller's (bq, bk) tiles
//   decide, with the Pallas kernel's `relevant` test (:51-57), which
//   (query, key) pairs are processed at all: a key of a skipped caller tile
//   enters as -inf, which leaves the row's (max, sum, acc) exactly as they
//   were, so this kernel processes the same pairs as the Pallas kernel even
//   though its own tiles are smaller; a 32-key tile that no caller tile
//   keeps is not loaded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per staged tile
constexpr int kThreads = 256;  // tx = tid % 16, ty = tid / 16
constexpr float kMasked = -1e30f;  // NEG_INF of the Pallas kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int T, S, H, KV;
  float scale;
  int causal, has_window, window, prefix, bq, bk;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The Pallas kernel's `relevant`: does caller tile (qi, ki) run at all?
__device__ __forceinline__ bool tile_relevant(const Params& p, int qi, int ki) {
  const int q0 = qi * p.bq, k0 = ki * p.bk;
  bool rel = true;
  if (p.causal) rel = k0 <= q0 + p.bq - 1;
  if (p.has_window) {
    bool in_win = k0 + p.bk - 1 > q0 - p.window;
    if (p.prefix) in_win = in_win || (k0 < p.prefix);
    rel = rel && in_win;
  }
  return rel;
}

// The Pallas kernel's element mask for query i, key j.
__device__ __forceinline__ bool allowed(const Params& p, int i, int j) {
  bool m = true;
  if (p.causal) {
    m = j <= i;
    if (p.prefix) m = m || (j < p.prefix);
  }
  if (p.has_window) {
    bool w = j > i - p.window;
    if (p.prefix) w = w || ((j < p.prefix) && (i < p.prefix));
    m = m && w;
  }
  return m;
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + kBQ * (kBK + 4));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  constexpr int QS = HD + 4;                // padded row stride of q and k tiles
  constexpr int PS = kBK + 4;               // row stride of the probability tile
  constexpr int NC = HD >= 64 ? HD / 64 : 1;  // 4-column output groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * HD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const long long q_row = (long long)p.H * HD, kv_row = (long long)p.KV * HD;
  const T* qb = static_cast<const T*>(p.q) + ((long long)b * p.T * p.H + h) * HD;
  const T* kb = static_cast<const T*>(p.k) + ((long long)b * p.S * p.KV + kvh) * HD;
  const T* vb = static_cast<const T*>(p.v) + ((long long)b * p.S * p.KV + kvh) * HD;
  T* ob = static_cast<T*>(p.o) + ((long long)b * p.T * p.H + h) * HD;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, t = r0 + r;
    Qs[r * QS + d] = t < p.T ? to_f32(qb[(long long)t * q_row + d]) : 0.f;
  }

  int row[4], row_tile[4];
  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    row[a] = r0 + ty + 16 * a;
    row_tile[a] = row[a] / p.bq;
    m[a] = kMasked;
    l[a] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
  }
  const bool col_ok = HD >= 64 || 4 * tx < HD;
  const int qi_lo = r0 / p.bq, qi_hi = (min(r0 + kBQ, p.T) - 1) / p.bq;

  for (int c0 = 0; c0 < p.S; c0 += kBK) {
    const int c1 = min(c0 + kBK, p.S) - 1;
    bool any = false;  // the same for every thread of the block
    for (int qi = qi_lo; qi <= qi_hi && !any; ++qi)
      for (int ki = c0 / p.bk; ki <= c1 / p.bk && !any; ++ki) any = tile_relevant(p, qi, ki);
    if (!any) continue;

    __syncthreads();  // the q tile is in; the last tile's readers are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD, j = c0 + r;
      float kx = 0.f, vx = 0.f;
      if (j < p.S) {
        kx = to_f32(kb[(long long)j * kv_row + d]);
        vx = to_f32(vb[(long long)j * kv_row + d]);
      }
      Ks[r * QS + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) s[a][0] = s[a][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qv[a] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * a) * QS + d]);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * c) * QS + d]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[a][c];
          x = fmaf(qv[a].x, kv[c].x, x);
          x = fmaf(qv[a].y, kv[c].y, x);
          x = fmaf(qv[a].z, kv[c].z, x);
          x = fmaf(qv[a].w, kv[c].w, x);
          s[a][c] = x;
        }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = row[a], j = c0 + tx + 16 * c;
        if (i >= p.T || j >= p.S || !tile_relevant(p, row_tile[a], j / p.bk))
          s[a][c] = -INFINITY;  // not processed: leaves (max, sum, acc) as they are
        else
          s[a][c] = allowed(p, i, j) ? s[a][c] * p.scale : kMasked;
      }
      const float m_new = fmaxf(m[a], row_max16(fmaxf(s[a][0], s[a][1])));
      const float p0 = expf(s[a][0] - m_new), p1 = expf(s[a][1] - m_new);
      const float corr = expf(m[a] - m_new);
      l[a] = l[a] * corr + row_sum16(p0 + p1);
      m[a] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] *= corr;
      Ps[(ty + 16 * a) * PS + tx] = p0;
      Ps[(ty + 16 * a) * PS + tx + 16] = p1;
    }
    __syncthreads();

    if (col_ok) {
#pragma unroll 2
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 pv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          pv[a] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * a) * PS + kk]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            const float4 vv =
                *reinterpret_cast<const float4*>(&Vs[(kk + e) * HD + 4 * tx + 64 * n]);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const float w = e == 0 ? pv[a].x : e == 1 ? pv[a].y : e == 2 ? pv[a].z : pv[a].w;
              acc[a][n][0] = fmaf(w, vv.x, acc[a][n][0]);
              acc[a][n][1] = fmaf(w, vv.y, acc[a][n][1]);
              acc[a][n][2] = fmaf(w, vv.z, acc[a][n][2]);
              acc[a][n][3] = fmaf(w, vv.w, acc[a][n][3]);
            }
          }
        }
      }
    }
  }

  if (!col_ok) return;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (row[a] >= p.T) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    T* orow = ob + (long long)row[a] * q_row;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(&orow[4 * tx + 64 * n + e], acc[a][n][e] / denom);
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.T + kBQ - 1) / kBQ, p.H, B);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. window < 0 means no window. All tensors
// contiguous in the reference's layout; the wrapper checks shapes, dtypes
// and the tile contract (T % bq == 0, S % bk == 0) before the call.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int dtype, int B, int T, int S, int H, int KV, int hd,
                                     float scale, int causal, int window, int prefix, int bq,
                                     int bk, void* stream) {
  Params p{q, k, v, o, T, S, H, KV, scale, causal, window >= 0 ? 1 : 0, window, prefix, bq, bk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || bq <= 0 || bk <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_hd<float>(p, B, hd, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(p, B, hd, s);
  return (int)cudaErrorInvalidValue;
}
