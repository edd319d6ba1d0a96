// Flash attention forward for Hopper (sm_90a): bf16 in and out, f32 softmax state.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _fa_kernel): online-softmax attention with f32 running max m, sum l and
// accumulator acc; causal masking with q_offset = Lkv - Lq, a sliding window and
// the tanh score softcap. It computes the same function, not the same blocks.
//
// What bounds it on the card: 4 * H * Lq * Lkv * D tensor-core operations per
// batch row. At the DiT's lengths (L ~ 1e3..1e4, D = 64) that is far above the
// H100's ~295 operations per byte, so the bound is the bf16 tensor-core rate,
// which only wgmma reaches. At D = 64 the softmax's exponentials (one per score,
// 16 per clock on an SM's special-function units) take as many cycles as the two
// products, so the one has to run while the other does.
//
// What the design does about it:
//   * one block per (batch*head, tile of 64 * NC queries) with one producer
//     warpgroup, whose one thread starts the TMA copies (its registers lowered
//     with setmaxnreg), and NC consumer warpgroups of 64 query rows (wgmma's M).
//     One warpgroup's wgmma stream alone fills about 60% of the tensor cores, so
//     the consumers' products and softmaxes interleave. NC is 2, or 3 at D = 64
//     for non-causal calls whose grid of 192-row blocks fills the card's waves;
//   * Q is copied once; K and V tiles of BN keys go through a ring of STAGES
//     shared-memory stages, each with "full" mbarriers for K and for V (TMA bytes
//     arrived) and an "empty" one (every consumer done with the stage), so the
//     next tiles load while this one is multiplied. The TMA maps are 4-D (D, H,
//     L, B) over the caller's strides, 128-byte swizzled, one 64-column box per
//     128 bytes of a row; keys and queries past the end are zero-filled;
//   * BN is 128 keys at D = 64 and 128. At D = 256 (gemma2) a 128-key K or V tile
//     is 64 KB, so two stages would not fit the block's 227 KB: there BN is 64
//     and the ring has two stages. Two stages leave no slack if a stage waits
//     for both its products, so at D = 256 K and V have "empty" mbarriers of
//     their own and a K tile is released as soon as its Q K^T is done: the next
//     K tile then loads during the step that multiplies this one's P V. The
//     output accumulator (64 x 256 f32) takes 128 of a consumer thread's 240
//     registers, S (64 x 64) 32 and P 16 more: two consumers fit without
//     spills (one alone was 1.2x slower at gemma2's prefill shapes:
//     launch/flash_attention_ab.py on an NVIDIA H100 80GB HBM3 at 700 W);
//   * S = Q K^T is wgmma m64nBNk16 with both operands in shared memory (K-major);
//     P V is wgmma with P taken from registers: the f32 fragment of S, rounded to
//     bf16 pairs, is already wgmma's A-operand layout; V is the B operand read
//     MN-major (the descriptor's transpose bit). Each step starts the next tile's
//     Q K^T and this tile's P V together and runs the next softmax while P V is
//     on the tensor cores;
//   * S, P, the running max and sum and the output accumulator stay in registers;
//     scores are scaled by log2(e) to use exp2; the row max is reduced over the
//     row's quad of threads by shuffles, the row sum once at the end;
//   * only tiles that touch the diagonal, the window's edge or Lkv are masked:
//     keys at or past Lkv are -inf (a zero-filled key would score 0), masked keys
//     are -1e30 as in the reference, so a row whose keys are all masked averages
//     V; causal and window tiles that hold no unmasked key are skipped when every
//     row keeps its own position (q_offset >= 0); causal grids run each head's
//     longest rows first;
//   * the output is divided by l, rounded to bf16, staged through the consumer's
//     Q tile and written with 16-byte stores; rows at or past Lq are not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WG_ROWS = 64;            // query rows per consumer warpgroup (wgmma M)
constexpr int BOX_BYTES = 128;         // one swizzled row of a box: 64 bf16 columns
constexpr int TURN = 4;                // named barriers TURN.. pass the product turn
                                       // (1..3 sync a consumer's epilogue)
constexpr float MASKED = -1e30f;       // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;

// NC consumer warpgroups of 64 query rows, after one producer warpgroup.
template <int D, int NC>
struct Smem {
  static constexpr int BN = D == 256 ? 64 : 128;             // keys per KV tile
  static constexpr int STAGES = D == 64 ? 4 : D == 128 ? 3 : 2;   // as many as fit
  // K and V released apart (K once its Q K^T is done): where two stages must do
  static constexpr bool SPLIT = STAGES == 2;
  static constexpr int BOXES = D / 64;                       // 64-column boxes per row
  static constexpr int Q_WG = WG_ROWS * D * 2;                // one consumer's Q tile
  static constexpr int KV = BN * D * 2;                       // one K or one V tile
  static constexpr int q = 0;
  static constexpr int k = q + NC * Q_WG;
  static constexpr int v = k + STAGES * KV;
  // full_k, full_v, empty_k [STAGES]; empty_v [STAGES] if SPLIT (else empty_k
  // serves both); q
  static constexpr int bars = v + STAGES * KV;
  static constexpr int EMPTIES = SPLIT ? 2 : 1;
  static constexpr int bytes = bars + 8 * ((2 + EMPTIES) * STAGES + 1) + 1024;  // + slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------------------
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
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA ----------------------------------------------------------------------------
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row),
        "r"(batch)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------------------
// Shared-memory matrix descriptors for 128-byte-swizzled tiles, whose 8-row groups
// lie 1024 bytes apart (SBO). K-major (Q, K): the leading offset is unused.
// MN-major (V): the leading offset is the distance between 64-column boxes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Tie registers to this point, so that the compiler neither reads an accumulator
// before the wgmma that writes it has been waited on nor moves writes past it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define FA_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) (+)= A (64 x 16, shared) * B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 16, shared) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16, registers) * B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56),
        FA_D8(64), FA_D8(72), FA_D8(80), FA_D8(88), FA_D8(96), FA_D8(104), FA_D8(112),
        FA_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef FA_D8

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2], const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&acc)[32], const uint32_t* a, uint64_t db) {
  wgmma_m64n64k16_rs(acc, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&acc)[64], const uint32_t* a, uint64_t db) {
  wgmma_m64n128k16_rs(acc, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&acc)[128], const uint32_t* a, uint64_t db) {
  wgmma_m64n256k16_rs(acc, a, db);
}

// S (+)= Q K^T over one 16-column slice, for a tile of BN keys.
__device__ __forceinline__ void wgmma_qk(float (&s)[64], uint64_t da, uint64_t db, int acc) {
  wgmma_m64n128k16_ss(s, da, db, acc);
}
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t da, uint64_t db, int acc) {
  wgmma_m64n64k16_ss(s, da, db, acc);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T for one consumer's 64 rows and one tile of BN keys, started and
// committed as one wgmma group. Both tiles are BOXES boxes of 64 columns; a
// 16-column slice is 32 bytes into a box's row.
template <int D, int BN>
__device__ __forceinline__ void qk_async(float (&s)[BN / 2], uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_qk(s, desc_sw128(q_tile + (kk / 4) * WG_ROWS * BOX_BYTES + col, 0),
             desc_sw128(k_tile + (kk / 4) * BN * BOX_BYTES + col, 0), kk > 0);
  }
  wgmma_commit();
}

// acc += P V as one wgmma group: P's 16-key slice kk is the accumulator
// fragment's values 8kk..8kk+7, packed in pairs; V's is 16 rows (2048 bytes)
// down the tile.
template <int D, int BN>
__device__ __forceinline__ void pv_async(float (&acc)[D / 2], const uint32_t (&p)[BN / 4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_pv<D>(acc, &p[4 * kk], desc_sw128(v_tile + kk * 16 * BOX_BYTES, BN * BOX_BYTES));
  wgmma_commit();
}

// Accumulator fragment of wgmma m64nN: value i of a thread sits at row
// 16 * warp + lane / 4 + 8 * ((i / 2) % 2) and column 8 * (i / 4) + 2 * (lane % 4) + i % 2.

// What the online softmax of one consumer needs to know about its tile.
struct Rows {
  int qpos;            // key position of the thread's first row's own query
  int Lkv, causal, window;
  float softcap, scale;
};

// Max and sum over the N / 2 values a thread holds of row r (values 4q + 2r
// and 4q + 2r + 1), as trees: few warps share an SM sub-partition, so the
// latency of one long chain would not be hidden.
// (Every index is a constant once unrolled: t must stay in registers.)
template <int N>
__device__ __forceinline__ float row_max(const float (&s)[N], int r) {
  static_assert(N == 32 || N == 64, "16 or 32 values a row");
  float t[N / 4];
#pragma unroll
  for (int q = 0; q < N / 4; ++q) t[q] = fmaxf(s[4 * q + 2 * r], s[4 * q + 2 * r + 1]);
  if constexpr (N == 64) {
#pragma unroll
    for (int q = 0; q < 8; ++q) t[q] = fmaxf(t[q], t[q + 8]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) t[q] = fmaxf(t[q], t[q + 4]);
  return fmaxf(fmaxf(t[0], t[2]), fmaxf(t[1], t[3]));
}
template <int N>
__device__ __forceinline__ float row_sum(const float (&s)[N], int r) {
  float t[N / 4];
#pragma unroll
  for (int q = 0; q < N / 4; ++q) t[q] = s[4 * q + 2 * r] + s[4 * q + 2 * r + 1];
  if constexpr (N == 64) {
#pragma unroll
    for (int q = 0; q < 8; ++q) t[q] += t[q + 8];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) t[q] += t[q + 4];
  return (t[0] + t[2]) + (t[1] + t[3]);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// One tile of the online softmax, in place: the scores s become the
// unnormalised probabilities exp2(s * scale * log2(e) - m) of the new running
// max m (log2 units); l (this thread's share of each row's sum) and alpha (the
// factor acc must be scaled by) follow. `masked`: the tile touches the
// diagonal, the window's edge or Lkv, or the scores are softcapped.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, bool masked,
                                             const Rows& rw, int lane) {
  const float sl2 = rw.scale * LOG2E;
  float mx[2];
  if (masked) {
    if (rw.softcap > 0.f) {
      // cap * tanh(x / cap) = cap - 2 cap / (exp(2 x / cap) + 1), in log2 units
      const float two_x = 2.f * rw.scale / rw.softcap * LOG2E, cap = rw.softcap * LOG2E;
#pragma unroll
      for (int j = 0; j < N; ++j) s[j] = cap - 2.f * cap * fast_rcp(fast_exp2(s[j] * two_x) + 1.f);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) s[j] *= sl2;
    }
    // value j sits at key kb + 8 * (j / 4) + j % 2 of row qpos + 8 * ((j / 2) % 2)
    const int kb = k0 + 2 * (lane % 4);
    const int end = rw.Lkv - kb;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = rw.qpos + 8 * r - kb;           // keys past it are masked (causal)
      const int hi = rw.causal ? qp : INT_MAX;
      const int lo = rw.causal && rw.window > 0 ? qp - rw.window + 1 : INT_MIN;
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * q + e, j = 4 * q + 2 * r + e;
          if (c >= end)
            s[j] = -INFINITY;          // ragged edge: not a key at all
          else if (c > hi || c < lo)
            s[j] = MASKED;
        }
      mx[r] = fmaxf(m[r], quad_max(row_max(s, r)));
    }
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = fast_exp2(s[j] - mx[(j / 2) % 2]);
  } else {
    // every score finite and unmasked: the max on raw scores, one FFMA each
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(m[r], quad_max(row_max(s, r)) * sl2);
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = fast_exp2(fmaf(s[j], sl2, -mx[(j / 2) % 2]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    alpha[r] = fast_exp2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] = l[r] * alpha[r] + row_sum(s, r);
  }
}

// P rounded to bf16, as the reference rounds the probabilities to v's type.
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&p)[N / 2], const float (&s)[N]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
}

template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
fa_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int H, int Lq,
              int Lkv, long long osb, long long osl, long long osh, int causal, int window,
              float softcap, float scale) {
  using SM = Smem<D, NC>;
  constexpr int STAGES = SM::STAGES, BN = SM::BN;
  constexpr int BM = NC * WG_ROWS;     // query rows per block
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // per stage: K arrived, V arrived, every consumer done with the stage's K (and,
  // if SPLIT, apart from it its V); then Q arrived
  const uint32_t full_k = base + SM::bars, full_v = full_k + 8 * STAGES,
                 empty_k = full_v + 8 * STAGES,
                 empty_v = SM::SPLIT ? empty_k + 8 * STAGES : empty_k,
                 q_bar = empty_v + 8 * STAGES;

  const int n_qt = gridDim.x;
  // causal: the longest rows of each head first
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x) * BM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q_offset = Lkv - Lq;       // extend/decode queries sit at the end of kv

  // KV tiles that hold an unmasked key for some row of this block. Skipping the
  // others is exact when every row keeps its own position (q_offset >= 0): the
  // reference's exp(-1e30 - m) is then 0 for every skipped key.
  const int n_tiles = (Lkv + BN - 1) / BN;
  int t_begin = 0, t_end = n_tiles;
  if (causal && q_offset >= 0) {
    const int first_q = q0 + q_offset, last_q = q0 + BM - 1 + q_offset;
    t_end = min(n_tiles, last_q / BN + 1);
    if (window > 0) t_begin = max(0, first_q - window + 1) / BN;
  }
  const int n = t_end - t_begin;       // >= 1

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 128 * NC);
      if (SM::SPLIT) mbar_init(empty_v + 8 * s, 128 * NC);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(24));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, NC * SM::Q_WG);
      for (int c = 0; c < NC; ++c)
        for (int j = 0; j < SM::BOXES; ++j)
          tma_load(base + SM::q + c * SM::Q_WG + j * WG_ROWS * BOX_BYTES, &tq, q_bar, j * 64, h,
                   q0 + c * WG_ROWS, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES, row = (t_begin + i) * BN;
        const uint32_t free_parity = ((i / STAGES) & 1) ^ 1;
        mbar_wait(empty_k + 8 * s, free_parity);
        mbar_expect_tx(full_k + 8 * s, SM::KV);
        for (int j = 0; j < SM::BOXES; ++j)
          tma_load(base + SM::k + s * SM::KV + j * BN * BOX_BYTES, &tk, full_k + 8 * s, j * 64,
                   h, row, b);
        if constexpr (SM::SPLIT) mbar_wait(empty_v + 8 * s, free_parity);
        mbar_expect_tx(full_v + 8 * s, SM::KV);
        for (int j = 0; j < SM::BOXES; ++j)
          tma_load(base + SM::v + s * SM::KV + j * BN * BOX_BYTES, &tv, full_v + 8 * s, j * 64,
                   h, row, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    // the register file split: 24 for the producer, the rest to the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(NC == 2 ? 240 : 160));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row = warp * 16 + lane / 4;          // this thread's rows: row and row + 8
    const int wg_q0 = q0 + c * WG_ROWS;
    const uint32_t q_tile = base + SM::q + c * SM::Q_WG;
    const Rows rw{wg_q0 + row + q_offset, Lkv, causal, window, softcap, scale};
    // whether tile t needs masks for some row of this consumer
    auto masked = [&](int t) {
      const int k0 = t * BN;
      return softcap > 0.f || k0 + BN > Lkv ||
             (causal && (k0 + BN - 1 > wg_q0 + q_offset ||
                         (window > 0 && k0 <= wg_q0 + WG_ROWS - 1 + q_offset - window)));
    };

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    float sc[BN / 2];
    uint32_t p[BN / 4];

    // The first tile's scores and probabilities; then each step starts the
    // next tile's Q K^T and this tile's P V together and runs the next tile's
    // softmax while P V is on the tensor cores. The consumers take turns to
    // start their products: c waits on named barrier TURN + c and passes the
    // turn on once its Q K^T is done, so one's softmax runs while the next
    // one's products do (left alone they fall into step, all multiplying, then
    // all exponentiating). The last consumer opens the first turn and, at the
    // end, passes none.
    auto turn_wait = [&] { asm volatile("bar.sync %0, 256;" ::"r"(TURN + c) : "memory"); };
    auto turn_pass = [&] {
      asm volatile("bar.arrive %0, 256;" ::"r"(TURN + (c + 1) % NC) : "memory");
    };
    if (c == NC - 1) turn_pass();
    mbar_wait(q_bar, 0);
    mbar_wait(full_k, 0);
    fence_regs(sc);
    turn_wait();
    wgmma_fence();
    qk_async<D, BN>(sc, q_tile, base + SM::k);
    wgmma_wait<0>();
    turn_pass();
    fence_regs(sc);
    if constexpr (SM::SPLIT) mbar_arrive(empty_k);
    softmax_tile(sc, m, l, alpha, t_begin * BN, masked(t_begin), rw, lane);
    pack_p(p, sc);
    for (int i = 1; i < n; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES, t = t_begin + i;
      mbar_wait(full_k + 8 * s, (i / STAGES) & 1);
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(p);
      mbar_wait(full_v + 8 * sp, ((i - 1) / STAGES) & 1);
      turn_wait();
      wgmma_fence();
      qk_async<D, BN>(sc, q_tile, base + SM::k + s * SM::KV);
      pv_async<D, BN>(acc, p, base + SM::v + sp * SM::KV);
      wgmma_wait<1>();                 // Q K^T done; P V may still run
      turn_pass();
      fence_regs(sc);
      if constexpr (SM::SPLIT) mbar_arrive(empty_k + 8 * s);
      softmax_tile(sc, m, l, alpha, t * BN, masked(t), rw, lane);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      mbar_arrive(empty_v + 8 * sp);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j / 2) % 2];
      pack_p(p, sc);
    }
    const int sl = (n - 1) % STAGES;
    mbar_wait(full_v + 8 * sl, ((n - 1) / STAGES) & 1);
    fence_regs(acc);
    fence_regs(p);
    turn_wait();
    wgmma_fence();
    pv_async<D, BN>(acc, p, base + SM::v + sl * SM::KV);
    if (c != NC - 1) turn_pass();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty_v + 8 * sl);

    // ---- epilogue: divide by l, round, stage through this consumer's Q tile ----
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
    }
    // every warp of this consumer is done reading its Q tile
    asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
    unsigned char* stage = smem + SM::q + c * SM::Q_WG;
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int r = row + 8 * ((j / 2) % 2);
      const int col = 8 * (j / 4) + 2 * (lane % 4);
      const int box = col / 64, chunk = (col % 64) / 8;
      *reinterpret_cast<uint32_t*>(stage + box * WG_ROWS * BOX_BYTES + r * BOX_BYTES +
                                   ((chunk ^ (r % 8)) * 16) + (col % 8) * 2) =
          pack_bf16(acc[j] * inv[(j / 2) % 2], acc[j + 1] * inv[(j / 2) % 2]);
    }
    __syncwarp();
    // each warp copies out its own 16 rows, 16 bytes a lane
    constexpr int CHUNKS = D / 8;
    bf16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int x = lane; x < 16 * CHUNKS; x += 32) {
      const int r = warp * 16 + x / CHUNKS, cc = x % CHUNKS;
      const int qrow = wg_q0 + r;
      if (qrow < Lq) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            stage + (cc / 8) * WG_ROWS * BOX_BYTES + r * BOX_BYTES + (((cc % 8) ^ (r % 8)) * 16));
        *reinterpret_cast<uint4*>(ob + (long long)qrow * osl + cc * 8) = val;
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime: no -lcuda needed.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, H, L, B) map of a (B, L, H, D) bf16 tensor with element strides st =
// (batch, row, head), boxes of 64 columns x box_rows rows, 128-byte swizzled,
// zero-filled out of bounds. A dimension of size 1 gets a stride that cannot
// matter, so that broadcast (stride-0) size-1 dimensions encode.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int D, int H, int L, int B,
                     const long long* st, int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  cuuint64_t natural = (cuuint64_t)D * 2;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = natural;
    natural = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int NC>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Lq,
                   int Lkv, const long long* st, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  const int bytes = Smem<D, NC>::bytes;
  // above 48 KB of shared memory needs an opt-in, once per device (never while a
  // CUDA graph is being captured: the first call of a run is eager)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fa_fwd_kernel<D, NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  if ((long long)B * H > 65535) return cudaErrorInvalidConfiguration;
  // the maps travel as kernel parameters, so a captured launch keeps its own
  CUtensorMap tq, tk, tv;
  if ((err = make_map(&tq, q, D, H, Lq, B, st, WG_ROWS)) != cudaSuccess) return err;
  constexpr int BN = Smem<D, NC>::BN;
  if ((err = make_map(&tk, k, D, H, Lkv, B, st + 3, BN)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, D, H, Lkv, B, st + 6, BN)) != cudaSuccess) return err;
  dim3 grid((Lq + NC * WG_ROWS - 1) / (NC * WG_ROWS), B * H);
  fa_fwd_kernel<D, NC><<<grid, 128 * (NC + 1), bytes, stream>>>(
      tq, tk, tv, o, H, Lq, Lkv, st[9], st[10], st[11], causal, window, softcap, scale);
  return cudaGetLastError();
}

// At D = 64, three consumers (192 query rows a block) keep the tensor cores
// busier than two; two leave a smaller last wave of blocks. Take three for
// non-causal calls when the waves of blocks they need, at their rate per row
// (about 1.22x two's on an H100, tuned at L = 4173 and 9293), cost less. Causal
// calls take two: their blocks are short, and the 192-row diagonal wastes more.
bool three_consumers(int bh, int Lq, int causal) {
  static int sms[64] = {};
  int dev = 0;
  if (causal || cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return false;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return false;
  auto waves = [&](int rows) {
    return (double)(((long long)(Lq + rows - 1) / rows * bh + sms[dev] - 1) / sms[dev]);
  };
  return waves(3 * WG_ROWS) * 3 * WG_ROWS / 1.22 < waves(2 * WG_ROWS) * 2 * WG_ROWS;
}

}  // namespace

// q: (B, Lq, H, D), k/v: (B, Lkv, H, D), o: (B, Lq, H, D), all bf16 with unit
// stride on D, other strides multiples of 8 and 16-byte aligned bases.
// strides: 12 element strides, (batch, row, head) for q, k, v, o.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                          int B, int H, int Lq, int Lkv, int D,
                                          const long long* strides, int causal, int window,
                                          float softcap, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lkv <= 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaError_t err;
  if (D == 64 && three_consumers(B * H, Lq, causal))
    err = launch<64, 3>(qp, kp, vp, op, B, H, Lq, Lkv, strides, causal, window, softcap, scale,
                        s);
  else if (D == 64)
    err = launch<64, 2>(qp, kp, vp, op, B, H, Lq, Lkv, strides, causal, window, softcap, scale,
                        s);
  else if (D == 128)
    err = launch<128, 2>(qp, kp, vp, op, B, H, Lq, Lkv, strides, causal, window, softcap, scale,
                         s);
  else if (D == 256)
    err = launch<256, 2>(qp, kp, vp, op, B, H, Lq, Lkv, strides, causal, window, softcap, scale,
                         s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Dynamic shared memory a launch of the (D, NC) instantiation asks for; 0 for
// one that does not exist.
extern "C" int repro_flash_attention_smem_bytes(int D, int NC) {
  if (D == 64) return NC == 2 ? Smem<64, 2>::bytes : NC == 3 ? Smem<64, 3>::bytes : 0;
  if (NC != 2) return 0;
  return D == 128 ? Smem<128, 2>::bytes : D == 256 ? Smem<256, 2>::bytes : 0;
}
