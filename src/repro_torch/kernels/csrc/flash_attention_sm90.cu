// Blocked online-softmax attention, forward, on Hopper's tensor cores: the
// route of every bf16 call with head width 128 or 256, which is every
// layer's prefill of gemma3-27b (width 128) and of paligemma-3b (width 256)
// from S = CHUNKED_ATTN_MIN_S (4096) keys on.
//
// Replaces: src/repro/kernels/flash_attention.py:102 flash_attention (its
//   pallas_call at :141; the body is _kernel, :38-95), as flash_attention.cu
//   does for f32 and the other head widths. q (B, T, H, hd), k/v
//   (B, S, KV, hd) bf16 with hd 128 or 256, GQA (kv head = h / (H / KV)),
//   causal / sliding window / prefix-LM masks, bf16 out.
// Bound: operations. 4 * hd flops per (query, key) pair that the caller's
//   tiles keep and the masks allow, on bf16 tensor cores at 989 TFLOP/s
//   (H100 SXM data sheet), against q, k, v read once and the output
//   written once at 3.35 TB/s; at the serving path's shapes the flops bound
//   it by more than 10x.
// Design (FlashAttention-3's shape, simplified), one instantiation of
//   flash_fwd_sm90 per head width (Cfg<hd>): one block of 384 threads
//   per (128 query rows, query head, batch), the grid walking the query
//   tiles last to first so that the heaviest causal tiles start first.
//   Warpgroup 0 is the producer: it gives up registers (setmaxnreg 40 at
//   width 128, 24 at 256) and one thread issues TMA loads, the q tile once
//   and then each kept tile of k and v (128 keys at width 128, 64 at 256)
//   into a ring of 2 stages, each stage with a full and an empty mbarrier.
//   Warpgroups 1 and 2 (setmaxnreg 232 at width 128, 240 at 256) are the
//   consumers, 64 query rows each, wgmma's M. Tiles are bf16 in shared
//   memory with the 128-byte swizzle, each as hd/64 pieces of 64 columns
//   (a swizzled row is 128 bytes); the tensor maps cover the (B, S, KV, hd)
//   layout with the head as a coordinate and are encoded on the host per
//   call with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no link against libcuda). Shared memory: 96
//   KiB a block at width 128 (q 32, two stages of k and v 64), 192 KiB at
//   256 (q 64, two stages 128).
//   S = q k^T is hd/16 wgmma m64nBKk16 from shared memory (both K-major),
//   in f32; the scale multiplies after the dot, as in the Pallas kernel
//   (:67-69). The online softmax runs in registers on the accumulator
//   fragment: a row lives in the 4 threads of a quad (2 rows a thread),
//   the running max starts at -1e30 and the row sum comes from the f32
//   probabilities. O += P V is wgmma m64n128k16 with P from registers (the
//   S fragment's layout is the A fragment's) and V from shared memory,
//   MN-major (the transpose bit), once per 128-column half of O; P enters
//   as two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi), two
//   products into one accumulator, so that p keeps about 16 bits: one bf16
//   rounding of p would cost as much as the output's own rounding, and the
//   bf16 output is held within one rounding of the plain version's f32
//   result. The epilogue divides by max(l, 1e-30) and stores bf16, rows
//   past T left out.
//   Width 256's register budget: O is 64 x 256 f32 a warpgroup, 128
//   registers a thread, beside S (32: 64-key tiles) and p_hi/p_lo (32,
//   formed as S dies); 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536.
//   ptxas still spills a few registers a tile around S (PERF.md §6).
//   Which pairs are processed is the Pallas kernel's rule, on the caller's
//   (bq, bk) tiles: the wrapper hands over an int8 table of this kernel's
//   (128 x BK) tiles (kernels/flash_attention.py tile_classes): 0, no
//   caller tile kept, not loaded; 1, every pair kept and allowed, no mask
//   test (at width 256: the element rule with every key let through, one
//   softmax for both classes); 2, the per-element path, where a key of a
//   caller tile that the Pallas kernel skips enters as -inf (it leaves
//   max, sum and acc as they were), a masked key as -1e30 and a key past S
//   as -inf.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;         // query rows per block: two consumer warpgroups of 64
constexpr int kStages = 2;       // k/v ring depth
constexpr int kThreads = 384;    // producer warpgroup, then two consumer warpgroups
constexpr int kPiece = 64;       // bf16 columns of one 128-byte swizzled row

// Each head width's tiles, shared memory and register split.
template <int HD>
struct Cfg {
  static_assert(HD == 128 || HD == 256, "head width 128 or 256");
  static constexpr int kBK = HD == 128 ? 128 : 64;             // keys per staged tile
  static constexpr int kRegsProducer = HD == 128 ? 40 : 24;    // setmaxnreg
  static constexpr int kRegsConsumer = HD == 128 ? 232 : 240;
  static constexpr int kPieces = HD / kPiece;   // 64-column pieces of a row
  static constexpr int kHalves = HD / 128;      // 128-column halves of O (wgmma's N)
  static constexpr int kSRegs = kBK / 2;        // the 64 x kBK S fragment, a thread
  static constexpr uint32_t kQPiece = kBQ * 128;   // bytes of one piece of the q tile
  static constexpr uint32_t kKVPiece = kBK * 128;  // ... of a k or v tile
  static constexpr uint32_t kQBytes = kQPiece * kPieces;
  static constexpr uint32_t kKVBytes = kKVPiece * kPieces;
  static constexpr uint32_t kBarOffset = kQBytes + kStages * 2 * kKVBytes;
  // the barriers, and 1 KiB of slack for the swizzle's alignment
  static constexpr size_t kSmemBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};
constexpr float kMasked = -1e30f;  // NEG_INF of the Pallas kernel
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* o;
  const int8_t* classes;  // (nqt, nkt) classes of this kernel's tiles
  int T, S, H, KV, nqt, nkt;
  float scale;
  int causal, has_window, window, prefix, bq, bk;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of the given parity has completed. A wait of more
// than 2^32 cycles (about 2 s) is a lost arrival: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// One box of (64 columns, 1 head, rows, 1 sequence) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; byte offsets.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_REGS32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_REGS64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "      \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define FA_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_D32 FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
#define FA_D64 FA_D32, FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)

// d (64 x 128, f32) (+)= a (64 x 16, shared, K-major) . b (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_D64
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, f32) (+)= a (64 x 16, shared, K-major) . b (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D32
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128, f32) += a (64 x 16, bf16 registers) . b (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_D64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// The Pallas kernel's `relevant` for a caller tile starting at (q0, k0).
__device__ __forceinline__ bool kept(const Params& p, int q0, int k0) {
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<HD>;
  constexpr int kBK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t sQ = base, bar_q = base + C::kBarOffset;
  const int qt = p.nqt - 1 - (int)blockIdx.y;  // heaviest causal tiles first
  const int h = blockIdx.x, b = blockIdx.z;
  const int8_t* cls = p.classes + (size_t)qt * p.nkt;
  const int wg = threadIdx.x / 128;
  auto sK = [&](int s) { return base + C::kQBytes + s * 2 * C::kKVBytes; };
  auto sV = [&](int s) { return base + C::kQBytes + s * 2 * C::kKVBytes + C::kKVBytes; };
  auto full = [&](int s) { return bar_q + 8 + 8 * s; };
  auto empty = [&](int s) { return bar_q + 8 + 8 * kStages + 8 * s; };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::kRegsProducer));
    if (threadIdx.x == 0) {
      const int kvh = h / (p.H / p.KV);
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kPieces; ++c)
        tma_load(sQ + c * C::kQPiece, &tq, bar_q, c * kPiece, h, qt * kBQ, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < p.nkt; ++kt) {
        if (cls[kt] == 0) continue;
        mbar_wait(empty(stage), phase ^ 1);  // the first pass finds the ring empty
        mbar_expect_tx(full(stage), 2 * C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kPieces; ++c)
          tma_load(sK(stage) + c * C::kKVPiece, &tk, full(stage), c * kPiece, kvh, kt * kBK, b);
#pragma unroll
        for (int c = 0; c < C::kPieces; ++c)
          tma_load(sV(stage) + c * C::kKVPiece, &tv, full(stage), c * kPiece, kvh, kt * kBK, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kRegsConsumer));
    const int cw = wg - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // this thread's two rows of the accumulator fragment
    const int row_a = qt * kBQ + 64 * cw + 16 * warp + g, row_b = row_a + 8;
    const int qc_a = row_a / p.bq * p.bq, qc_b = row_b / p.bq * p.bq;  // their caller tiles
    const float scale_log2 = p.scale * kLog2e;
    float o[C::kHalves][64];  // O's 128-column halves, each one wgmma accumulator
#pragma unroll
    for (int oh = 0; oh < C::kHalves; ++oh)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[oh][i] = 0.f;
    float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;  // l: this thread's share
    const uint32_t q_rows = sQ + cw * 64 * 128;  // this warpgroup's 64 rows of each piece

    mbar_wait(bar_q, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < p.nkt; ++kt) {
      const int c = cls[kt];
      if (c == 0) continue;
      // The element rule's masks: bit 2 jj + e is this thread's column
      // 8 jj + 2 t + e, set in kept_* when the key is below S in a caller
      // tile that the Pallas kernel keeps and in ok_* when the mask allows
      // it (rows a and b); all set on a class-1 tile. Built in a rolled loop
      // before S is in registers, so that they cost few registers beside O.
      uint32_t kept_a = ~0u, kept_b = ~0u, ok_a = ~0u, ok_b = ~0u;
      if (c == 2) {
        kept_a = kept_b = ok_a = ok_b = 0;
#pragma unroll 1
        for (int i = 0; i < kBK / 4; ++i) {
          const int j = kt * kBK + 8 * (i / 2) + 2 * t + (i % 2);
          const int kc = j / p.bk * p.bk;
          const bool in = j < p.S;
          kept_a |= (uint32_t)(in && kept(p, qc_a, kc)) << i;
          kept_b |= (uint32_t)(in && kept(p, qc_b, kc)) << i;
          ok_a |= (uint32_t)allowed(p, row_a, j) << i;
          ok_b |= (uint32_t)allowed(p, row_b, j) << i;
        }
      }
      mbar_wait(full(stage), phase);

      float s[C::kSRegs];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the swizzled row
        const uint64_t da = desc_sw128(q_rows + (kk / 4) * C::kQPiece + off, 16, 1024);
        const uint64_t db = desc_sw128(sK(stage) + (kk / 4) * C::kKVPiece + off, 16, 1024);
        wgmma_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      float corr_a, corr_b;
      // Class 1 at width 128: every pair kept and allowed, no mask test. At
      // width 256 every tile takes the element rule, class 1 with its masks
      // all set: with a second softmax beside it, ptxas spilled half of O
      // around every S (the 64 x 256 O leaves it little room).
      if (HD == 128 && c == 1) {
        float mx_a = s[0], mx_b = s[2];
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj) {
          mx_a = fmaxf(mx_a, fmaxf(s[4 * jj], s[4 * jj + 1]));
          mx_b = fmaxf(mx_b, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
        }
        const float mn_a = fmaxf(m_a, quad_max(mx_a) * p.scale);
        const float mn_b = fmaxf(m_b, quad_max(mx_b) * p.scale);
        corr_a = exp2f((m_a - mn_a) * kLog2e);
        corr_b = exp2f((m_b - mn_b) * kLog2e);
        m_a = mn_a;
        m_b = mn_b;
        const float ma2 = mn_a * kLog2e, mb2 = mn_b * kLog2e;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj) {
          s[4 * jj] = exp2f(fmaf(s[4 * jj], scale_log2, -ma2));
          s[4 * jj + 1] = exp2f(fmaf(s[4 * jj + 1], scale_log2, -ma2));
          s[4 * jj + 2] = exp2f(fmaf(s[4 * jj + 2], scale_log2, -mb2));
          s[4 * jj + 3] = exp2f(fmaf(s[4 * jj + 3], scale_log2, -mb2));
          sum_a += s[4 * jj] + s[4 * jj + 1];
          sum_b += s[4 * jj + 2] + s[4 * jj + 3];
        }
        l_a = l_a * corr_a + sum_a;
        l_b = l_b * corr_b + sum_b;
      } else {  // the Pallas kernel's element rule
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t bit = 1u << (2 * jj + e);
            float& xa = s[4 * jj + e];
            float& xb = s[4 * jj + 2 + e];
            xa = kept_a & bit ? (ok_a & bit ? xa * p.scale : kMasked) : -INFINITY;
            xb = kept_b & bit ? (ok_b & bit ? xb * p.scale : kMasked) : -INFINITY;
            mx_a = fmaxf(mx_a, xa);
            mx_b = fmaxf(mx_b, xb);
          }
        }
        const float mn_a = fmaxf(m_a, quad_max(mx_a));
        const float mn_b = fmaxf(m_b, quad_max(mx_b));
        corr_a = exp2f((m_a - mn_a) * kLog2e);
        corr_b = exp2f((m_b - mn_b) * kLog2e);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj) {
          s[4 * jj] = exp2f((s[4 * jj] - mn_a) * kLog2e);
          s[4 * jj + 1] = exp2f((s[4 * jj + 1] - mn_a) * kLog2e);
          s[4 * jj + 2] = exp2f((s[4 * jj + 2] - mn_b) * kLog2e);
          s[4 * jj + 3] = exp2f((s[4 * jj + 3] - mn_b) * kLog2e);
          sum_a += s[4 * jj] + s[4 * jj + 1];
          sum_b += s[4 * jj + 2] + s[4 * jj + 3];
        }
        l_a = l_a * corr_a + sum_a;
        l_b = l_b * corr_b + sum_b;
      }

      // p as two bf16 terms, in the A fragment's order (pairs of columns);
      // s dies as they are formed
      uint32_t ph[C::kSRegs / 2], pl[C::kSRegs / 2];
#pragma unroll
      for (int i = 0; i < C::kSRegs / 2; ++i) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
        const float2 hf = __bfloat1622float2(hi);
        ph[i] = bf16x2_bits(hi);
        pl[i] = bf16x2_bits(__floats2bfloat162_rn(s[2 * i] - hf.x, s[2 * i + 1] - hf.y));
      }
#pragma unroll
      for (int oh = 0; oh < C::kHalves; ++oh)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          o[oh][4 * jj] *= corr_a;
          o[oh][4 * jj + 1] *= corr_a;
          o[oh][4 * jj + 2] *= corr_b;
          o[oh][4 * jj + 3] *= corr_b;
        }

      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
#pragma unroll
        for (int oh = 0; oh < C::kHalves; ++oh) {
          // MN-major: 16 keys are two 8-row groups 1024 bytes apart (SBO), the
          // two 64-column pieces of this half of hd kKVPiece apart (LBO)
          const uint64_t dv = desc_sw128(sV(stage) + 2 * oh * C::kKVPiece + kc * 2048,
                                         C::kKVPiece, 1024);
          wgmma_rs(o[oh], ph[4 * kc], ph[4 * kc + 1], ph[4 * kc + 2], ph[4 * kc + 3], dv);
          wgmma_rs(o[oh], pl[4 * kc], pl[4 * kc + 1], pl[4 * kc + 2], pl[4 * kc + 3], dv);
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int oh = 0; oh < C::kHalves; ++oh) fence_regs(o[oh]);
      mbar_arrive(empty(stage));
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    const float den_a = fmaxf(quad_sum(l_a), 1e-30f), den_b = fmaxf(quad_sum(l_b), 1e-30f);
    const long long q_row = (long long)p.H * HD;
    __nv_bfloat16* ob = p.o + ((long long)b * p.T * p.H + h) * HD + 2 * t;
#pragma unroll
    for (int oh = 0; oh < C::kHalves; ++oh)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int col = 128 * oh + 8 * jj;
        if (row_a < p.T)
          *reinterpret_cast<__nv_bfloat162*>(ob + row_a * q_row + col) =
              __floats2bfloat162_rn(o[oh][4 * jj] / den_a, o[oh][4 * jj + 1] / den_a);
        if (row_b < p.T)
          *reinterpret_cast<__nv_bfloat162*>(ob + row_b * q_row + col) =
              __floats2bfloat162_rn(o[oh][4 * jj + 2] / den_b, o[oh][4 * jj + 3] / den_b);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (B, rows, heads, hd) bf16, boxes of (64 columns, 1 head, box_rows rows, 1).
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch, int rows, int heads,
            int hd, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPiece, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, const void* classes, int B,
           int T, int S, int H, int KV, float scale, int causal, int window, int prefix, int bq,
           int bk, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int nqt = (T + kBQ - 1) / kBQ, nkt = (S + C::kBK - 1) / C::kBK;
  if (nqt > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, B, T, H, HD, kBQ) || !encode(fn, &tk, k, B, S, KV, HD, C::kBK) ||
      !encode(fn, &tv, v, B, S, KV, HD, C::kBK))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  Params p{static_cast<__nv_bfloat16*>(o), static_cast<const int8_t*>(classes), T, S, H, KV,
           nqt, nkt, scale, causal, window >= 0 ? 1 : 0, window, prefix, bq, bk};
  const dim3 grid(H, nqt, B);
  flash_fwd_sm90<HD><<<grid, kThreads, C::kSmemBytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q (B, T, H, hd), k/v (B, S, KV, hd) with hd 128 or 256, o like q,
// all contiguous and 16-byte aligned; classes: int8 (ceil(T/128),
// ceil(S/BK)) on the device, from tile_classes(kq=128, kk=BK), BK = 128 at
// width 128 and 64 at 256. window < 0 means no window. The wrapper checks
// shapes, dtypes and the tile contract before the call.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                          const void* classes, int B, int T, int S, int H,
                                          int KV, int hd, float scale, int causal, int window,
                                          int prefix, int bq, int bk, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || bq <= 0 || bk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 128:
      return launch<128>(q, k, v, o, classes, B, T, S, H, KV, scale, causal, window, prefix, bq,
                         bk, st);
    case 256:
      return launch<256>(q, k, v, o, classes, B, T, S, H, KV, scale, causal, window, prefix, bq,
                         bk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
