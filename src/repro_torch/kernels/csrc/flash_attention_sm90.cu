// Blocked online-softmax attention, forward, on Hopper's tensor cores: the
// route of every bf16 call with head width 64, 128 or 256, which is every
// layer's prefill of hymba-1.5b (width 64), gemma3-27b (width 128) and
// paligemma-3b (width 256) from S = CHUNKED_ATTN_MIN_S (4096) keys on.
//
// Replaces: src/repro/kernels/flash_attention.py:102 flash_attention (its
//   pallas_call at :141; the body is _kernel, :38-95), as flash_attention.cu
//   does for f32 and bf16 at widths 16 and 32. q (B, T, H, hd), k/v
//   (B, S, KV, hd) bf16 with hd 64, 128 or 256, GQA (kv head = h / (H /
//   KV), any group), causal / sliding window / prefix-LM masks, bf16 out.
// Bound: operations. 4 * hd flops per (query, key) pair that the caller's
//   tiles keep and the masks allow, on bf16 tensor cores at 989 TFLOP/s
//   (H100 SXM data sheet), against q, k, v read once and the output
//   written once at 3.35 TB/s; at the serving path's shapes the flops bound
//   it by 2.5x (width 64) to more than 10x (256). At width 64 the
//   exponentials weigh as much: one exp2 a pair against 256 tensor flops,
//   at the SFU's 16 a clock an SM.
// Design at widths 128 and 256 (FlashAttention-3's shape, simplified), one
//   instantiation of flash_fwd_sm90 per head width (Cfg<hd>): one block of
//   384 threads per (128 query rows, query head, batch), the grid walking
//   the query tiles last to first so that the heaviest causal tiles start
//   first. Warpgroup 0 is the producer: it gives up registers (setmaxnreg
//   40 at width 128, 24 at 256) and one thread issues TMA loads, the q tile
//   once and then each kept tile of k and v (128 keys at width 128, 64 at
//   256) into a ring of 2 stages, each stage with a full and an empty
//   mbarrier. Warpgroups 1 and 2 (setmaxnreg 232 at width 128, 240 at 256)
//   are the consumers, 64 query rows each, wgmma's M. Tiles are bf16 in
//   shared memory with the 128-byte swizzle, each as hd/64 pieces of 64
//   columns (a swizzled row is 128 bytes); the tensor maps cover the (B, S,
//   KV, hd) layout with the head as a coordinate and are encoded on the host
//   per call with cuTensorMapEncodeTiled, reached through
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
// Design at width 64 (flash_fwd_sm90_d64, Cfg64; the numerics above, the
//   tiles 128 x 128): O is 64 x 64 f32, 32 registers a thread, P V sixteen
//   wgmma m64n64k16 with P from registers and V's one 64-column piece. One
//   block of 288 threads: the two consumer warpgroups and one producer warp
//   (no setmaxnreg: 167 of the 168 registers a thread, no spill), a ring of
//   2 stages, S, softmax and P V in turn in each warpgroup, the two
//   warpgroups left to interleave on their own. FlashAttention-3's answers
//   (the next tile's S issued before this tile's softmax, the warpgroups
//   taking turns), a deeper ring and two blocks an SM were each no faster
//   on the card (PERF.md §6). Per block: the list of its kept tiles is
//   built once (a ballot over the class row) and walked; each row's rule for
//   class-2 tiles (the Pallas kernel's kept and allowed tests as key bounds)
//   is made once into shared memory and turned into bits of the thread's 32
//   columns per tile; the output goes through the q tile's shared memory
//   and one TMA store a warpgroup.
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

// d (64 x 64, f32) += a (64 x 16, bf16 registers) . b (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(x) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(x) : "r"(addr) : "memory");
  return x;
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

// Head width 64's tiles and shared memory: 128 x 128 tiles, two consumer
// warpgroups of 64 query rows and a producer warp. A ninth warp puts three
// warps on one of the SM's four register files, so ptxas caps every thread
// at 168 registers, which the kernel fits without a spill.
struct Cfg64 {
  static constexpr int kBK = 128;
  static constexpr int kBlockThreads = 288;
  static constexpr uint32_t kQBytes = kBQ * 128;  // one 64-column piece a row
  static constexpr uint32_t kKVBytes = kBK * 128;
  static constexpr uint32_t kBarOffset = kQBytes + kStages * 2 * kKVBytes;
  // then each of the tile's rows' RowRule (32 bytes a row), then the count
  // of this q tile's kept tiles and their list, 16 bits each: 4 kt + class
  static constexpr uint32_t kRuleOffset = (kBarOffset + 8 * (1 + 2 * kStages) + 15) / 16 * 16;
  static constexpr uint32_t kListOffset = kRuleOffset + kBQ * 32;
  static constexpr size_t smem_bytes(int nkt) {
    return kListOffset + 16 + (2 * nkt + 15) / 16 * 16 + 1024;
  }
  static constexpr size_t kSmemMax = 232448;  // a block's most on the H100
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One row's element rule as key bounds: key j lies in a caller tile that
// the Pallas kernel keeps (and below S) when j < khi && (j >= klo || j <
// kpre), and the mask allows it when j < ahi && (j >= alo || j < apre).
struct RowRule {
  int khi, klo, kpre, ahi, alo, apre;
};

// The bounds of row i, whose caller tile starts at qc; the keys' caller
// tiles start at multiples of bk, so kept()'s tests on a tile's start
// become bounds on the key (see kept and allowed).
__device__ __forceinline__ RowRule row_rule(const Params& p, int i, int qc) {
  const int big = 1 << 30;  // past any key, with room below INT_MAX
  RowRule r;
  r.khi = p.causal ? min(((qc + p.bq - 1) / p.bk + 1) * p.bk, p.S) : p.S;
  const int x = qc - p.window - p.bk + 2;  // the window's first kept tile start, rounded up
  r.klo = p.has_window && x > 0 ? (x + p.bk - 1) / p.bk * p.bk : 0;
  r.kpre = p.has_window && p.prefix ? (p.prefix + p.bk - 1) / p.bk * p.bk : 0;
  r.ahi = p.causal ? max(i + 1, p.prefix) : big;
  r.alo = p.has_window ? i - p.window + 1 : 0;
  r.apre = p.has_window && p.prefix && i < p.prefix ? p.prefix : 0;
  return r;
}

// A row's rule in shared memory: two 16-byte words at addr.
__device__ __forceinline__ void st_rule(uint32_t addr, const RowRule& r) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(r.khi), "r"(r.klo),
               "r"(r.kpre), "r"(r.ahi)
               : "memory");
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};" ::"r"(addr + 16), "r"(r.alo), "r"(r.apre)
               : "memory");
}

__device__ __forceinline__ RowRule ld_rule(uint32_t addr) {
  RowRule r;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.khi), "=r"(r.klo), "=r"(r.kpre), "=r"(r.ahi)
               : "r"(addr)
               : "memory");
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];" : "=r"(r.alo), "=r"(r.apre) : "r"(addr + 16)
               : "memory");
  return r;
}

// The bits of this thread's 32 columns of a 128-key tile (bit 2 jj + e for
// column 8 jj + 2 t + e) whose column lies below L, counted from the tile's
// first key: the columns rise with the bit, so these are the lowest
// f(L - 2 t) + f(L - 2 t - 1) bits, f(x) the jj with 8 jj < x.
__device__ __forceinline__ uint32_t cols_below(int L, int t) {
  const int n = min(max((L - 2 * t + 7) >> 3, 0), 16) + min(max((L - 2 * t + 6) >> 3, 0), 16);
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

// One row's kept and allowed bits in the tile whose first key is k0.
__device__ __forceinline__ void row_masks(const RowRule& r, int k0, int t, uint32_t& kept,
                                          uint32_t& ok) {
  kept = cols_below(r.khi - k0, t) & (~cols_below(r.klo - k0, t) | cols_below(r.kpre - k0, t));
  ok = cols_below(r.ahi - k0, t) & (~cols_below(r.alo - k0, t) | cols_below(r.apre - k0, t));
}

// One tile's online softmax on this thread's share of the 64 x 128 S
// fragment, in place: s becomes the f32 p, the row maxima and sums move on,
// and corr is the factor by which the rows of O are to be scaled. Class 1
// takes no mask; class 2 the Pallas kernel's element rule on rows a and b,
// whose rules lie in shared memory at rule_a and rule_b, as bits of this
// thread's columns of the tile that starts at key k0 (see row_masks).
__device__ __forceinline__ void online_softmax(float (&s)[64], int c, uint32_t rule_a,
                                               uint32_t rule_b, int k0, int t, float scale,
                                               float& m_a, float& m_b, float& l_a, float& l_b,
                                               float& corr_a, float& corr_b) {
  float mn_a, mn_b;
  if (c == 1) {
    float mx_a = s[0], mx_b = s[2];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * jj], s[4 * jj + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
    }
    mn_a = fmaxf(m_a, quad_max(mx_a) * scale);
    mn_b = fmaxf(m_b, quad_max(mx_b) * scale);
    const float scale_log2 = scale * kLog2e, ma2 = mn_a * kLog2e, mb2 = mn_b * kLog2e;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      s[4 * jj] = ex2(fmaf(s[4 * jj], scale_log2, -ma2));
      s[4 * jj + 1] = ex2(fmaf(s[4 * jj + 1], scale_log2, -ma2));
      s[4 * jj + 2] = ex2(fmaf(s[4 * jj + 2], scale_log2, -mb2));
      s[4 * jj + 3] = ex2(fmaf(s[4 * jj + 3], scale_log2, -mb2));
    }
  } else {
    uint32_t kept_a, ok_a, kept_b, ok_b;
    row_masks(ld_rule(rule_a), k0, t, kept_a, ok_a);
    row_masks(ld_rule(rule_b), k0, t, kept_b, ok_b);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t bit = 1u << (2 * jj + e);
        float& xa = s[4 * jj + e];
        float& xb = s[4 * jj + 2 + e];
        xa = kept_a & bit ? (ok_a & bit ? xa * scale : kMasked) : -INFINITY;
        xb = kept_b & bit ? (ok_b & bit ? xb * scale : kMasked) : -INFINITY;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    }
    mn_a = fmaxf(m_a, quad_max(mx_a));
    mn_b = fmaxf(m_b, quad_max(mx_b));
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      s[4 * jj] = ex2((s[4 * jj] - mn_a) * kLog2e);
      s[4 * jj + 1] = ex2((s[4 * jj + 1] - mn_a) * kLog2e);
      s[4 * jj + 2] = ex2((s[4 * jj + 2] - mn_b) * kLog2e);
      s[4 * jj + 3] = ex2((s[4 * jj + 3] - mn_b) * kLog2e);
    }
  }
  corr_a = ex2((m_a - mn_a) * kLog2e);
  corr_b = ex2((m_b - mn_b) * kLog2e);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    sum_a += s[4 * jj] + s[4 * jj + 1];
    sum_b += s[4 * jj + 2] + s[4 * jj + 3];
  }
  l_a = l_a * corr_a + sum_a;
  l_b = l_b * corr_b + sum_b;
}

// O (64 x 64) += P (64 x 128, two bf16 terms in registers) . V (128 x 64,
// MN-major: 16 keys are two 8-row groups 1024 bytes apart; the one
// 64-column piece needs no LBO but gets the tile's).
__device__ __forceinline__ void pv64(float (&o)[32], const uint32_t (&ph)[32],
                                     const uint32_t (&pl)[32], uint32_t v_tile) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    const uint64_t dv = desc_sw128(v_tile + kc * 2048, 128 * 128, 1024);
    wgmma_rs(o, ph[4 * kc], ph[4 * kc + 1], ph[4 * kc + 2], ph[4 * kc + 3], dv);
    wgmma_rs(o, pl[4 * kc], pl[4 * kc + 1], pl[4 * kc + 2], pl[4 * kc + 3], dv);
  }
}

__global__ void __launch_bounds__(Cfg64::kBlockThreads, 1)
    flash_fwd_sm90_d64(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, const Params p) {
  using C = Cfg64;
  constexpr int kBK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t sQ = base, bar_q = base + C::kBarOffset;
  const int qt = p.nqt - 1 - (int)blockIdx.y;  // heaviest causal tiles first
  const int h = blockIdx.x, b = blockIdx.z;
  // this q tile's kept tiles, listed once: the loops walk the list, not
  // the whole row of the class table (a window keeps 9 of 32 at hymba's)
  const uint32_t list = base + C::kListOffset + 16;  // after its count
  const int wg = threadIdx.x / 128;  // 0, 1: the consumers; 2: the producer warp
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
  if (threadIdx.x < 32) {  // warp 0: the list, in the order of kt
    const int8_t* row = p.classes + (size_t)qt * p.nkt;
    int n = 0;
    for (int i0 = 0; i0 < p.nkt; i0 += 32) {
      const int i = i0 + (int)threadIdx.x;
      const int c = i < p.nkt ? row[i] : 0;
      const uint32_t kept_lanes = __ballot_sync(0xffffffffu, c != 0);
      if (c != 0) {
        const int at = n + __popc(kept_lanes & ((1u << threadIdx.x) - 1));
        asm volatile("st.shared.u16 [%0], %1;" ::"r"(list + 2 * at), "h"((uint16_t)(4 * i + c))
                     : "memory");
      }
      n += __popc(kept_lanes);
    }
    if (threadIdx.x == 0) st_shared(list - 16, (uint32_t)n);
  }
  if (threadIdx.x < 256 && threadIdx.x % 4 == 0) {  // each row's rule, once
    for (int r = threadIdx.x / 4; r < kBQ; r += 64) {
      const int i = qt * kBQ + r;
      st_rule(base + C::kRuleOffset + r * 32, row_rule(p, i, i / p.bq * p.bq));
    }
  }
  __syncthreads();
  const int kept_tiles = (int)ld_shared_u32(list - 16);
  auto listed = [&](int i) {  // 4 kt + class of the i-th kept tile
    uint16_t x;
    asm volatile("ld.shared.u16 %0, [%1];" : "=h"(x) : "r"(list + 2 * i) : "memory");
    return (int)x;
  };

  // the producer warp's first thread: q once, then each kept k/v tile into
  // the next stage of the ring once both warpgroups have let go of it (the
  // first pass finds the ring empty)
  if (threadIdx.x == 256) {
    mbar_expect_tx(bar_q, C::kQBytes);
    tma_load(sQ, &tq, bar_q, 0, h, qt * kBQ, b);
    const int kvh = h / (p.H / p.KV);
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < kept_tiles; ++i) {
      const int kt = listed(i) >> 2;
      mbar_wait(empty(stage), phase ^ 1);
      mbar_expect_tx(full(stage), 2 * C::kKVBytes);
      tma_load(sK(stage), &tk, full(stage), 0, kvh, kt * kBK, b);
      tma_load(sV(stage), &tv, full(stage), 0, kvh, kt * kBK, b);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  if (wg == 2) return;
  __syncwarp();

  const int cw = wg, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the rule of the first of this thread's two rows of the accumulator
  // fragment (the second is 8 rows on)
  const uint32_t rule_a = base + C::kRuleOffset + (64 * cw + 16 * warp + g) * 32;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;  // l: this thread's share
  const uint32_t q_rows = sQ + cw * 64 * 128;  // this warpgroup's 64 rows

  mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  // One kept tile: S, its softmax, P V. ptxas (CUDA 12.9) fits the kernel
  // in 167 registers without a spill in this form, a lambda for the tile
  // after a __syncwarp; as the loop's own body it spilled 16 bytes and
  // serialized the wgmma (C7512).
  auto step = [&](int i) {
    const int e = listed(i), kt = e >> 2, c = e & 3;
    mbar_wait(full(stage), phase);
    float s[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 columns = 32 bytes into the swizzled row
      wgmma_ss(s, desc_sw128(q_rows + kk * 32, 16, 1024),
               desc_sw128(sK(stage) + kk * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    float corr_a, corr_b;
    online_softmax(s, c, rule_a, rule_a + 8 * 32, kt * kBK, t, p.scale, m_a, m_b, l_a, l_b,
                   corr_a, corr_b);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      o[4 * jj] *= corr_a;
      o[4 * jj + 1] *= corr_a;
      o[4 * jj + 2] *= corr_b;
      o[4 * jj + 3] *= corr_b;
    }
    // p as two bf16 terms, in the A fragment's order; s dies as they are formed
    uint32_t ph[32], pl[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2 * j], s[2 * j + 1]);
      const float2 hf = __bfloat1622float2(hi);
      ph[j] = bf16x2_bits(hi);
      pl[j] = bf16x2_bits(__floats2bfloat162_rn(s[2 * j] - hf.x, s[2 * j + 1] - hf.y));
    }
    wgmma_fence();
    pv64(o, ph, pl, sV(stage));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    mbar_arrive(empty(stage));
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  };
#pragma unroll 1
  for (int i = 0; i < kept_tiles; ++i) step(i);

  // The epilogue: O / l in bf16 into this warpgroup's 64 rows of the q tile
  // (read by its last S = q k^T, which has completed), in the 128-byte
  // swizzle of the tensor maps (16-byte chunk jj of row r at jj ^ (r % 8)),
  // then one TMA store of the 64 rows; rows past T are not written.
  const float inv_a = 1.f / fmaxf(quad_sum(l_a), 1e-30f);
  const float inv_b = 1.f / fmaxf(quad_sum(l_b), 1e-30f);
  const uint32_t r_a = q_rows + (16 * warp + g) * 128 + 4 * t, r_b = r_a + 8 * 128;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const uint32_t chunk = (uint32_t)((jj ^ g) * 16);
    st_shared(r_a + chunk,
              bf16x2_bits(__floats2bfloat162_rn(o[4 * jj] * inv_a, o[4 * jj + 1] * inv_a)));
    st_shared(r_b + chunk,
              bf16x2_bits(__floats2bfloat162_rn(o[4 * jj + 2] * inv_b, o[4 * jj + 3] * inv_b)));
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");  // this warpgroup alone
  if (tid == 0) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::
            "l"(reinterpret_cast<uint64_t>(&to)), "r"(q_rows), "r"(0), "r"(h),
        "r"(qt * kBQ + 64 * cw), "r"(b)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // before the block ends
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

// Head width 64's launch: the output is stored through a fourth tensor map
// (boxes of 64 rows, one consumer warpgroup's).
int launch64(const void* q, const void* k, const void* v, void* o, const void* classes, int B,
             int T, int S, int H, int KV, float scale, int causal, int window, int prefix, int bq,
             int bk, cudaStream_t stream) {
  using C = Cfg64;
  const int nqt = (T + kBQ - 1) / kBQ, nkt = (S + C::kBK - 1) / C::kBK;
  if (nqt > 65535 || B > 65535 || nkt >= 16384) return (int)cudaErrorInvalidValue;
  const size_t smem = C::smem_bytes(nkt);
  if (smem > C::kSmemMax) return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  if (!encode(fn, &tq, q, B, T, H, 64, kBQ) || !encode(fn, &tk, k, B, S, KV, 64, C::kBK) ||
      !encode(fn, &tv, v, B, S, KV, 64, C::kBK) || !encode(fn, &to, o, B, T, H, 64, 64))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90_d64, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  Params p{static_cast<__nv_bfloat16*>(o), static_cast<const int8_t*>(classes), T, S, H, KV,
           nqt, nkt, scale, causal, window >= 0 ? 1 : 0, window, prefix, bq, bk};
  const dim3 grid(H, nqt, B);
  flash_fwd_sm90_d64<<<grid, C::kBlockThreads, smem, stream>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q (B, T, H, hd), k/v (B, S, KV, hd) with hd 64, 128 or 256, o like
// q, all contiguous and 16-byte aligned; classes: int8 (ceil(T/128),
// ceil(S/BK)) on the device, from tile_classes(kq=128, kk=BK), BK = 128 at
// widths 64 and 128 and 64 at 256. window < 0 means no window. The wrapper
// checks shapes, dtypes and the tile contract before the call.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                          const void* classes, int B, int T, int S, int H,
                                          int KV, int hd, float scale, int causal, int window,
                                          int prefix, int bq, int bk, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || bq <= 0 || bk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch64(q, k, v, o, classes, B, T, S, H, KV, scale, causal, window, prefix, bq, bk,
                      st);
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
