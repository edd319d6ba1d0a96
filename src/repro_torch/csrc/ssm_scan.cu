// Gated linear-attention scan (Mamba2 / RWKV6) for Hopper (sm_90a).
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T              (S is K x V, f32)
//   o_t = q_t . S_t                                   inclusive read (Mamba2)
//   o_t = q_t . S_{t-1} + (q_t . (u * k_t)) v_t       strict read + bonus u (RWKV6)
//
// with the per-step decay clamped as the TPU kernel clamps it,
// w = expf(fmaxf(logf(fmaxf(w, 1e-30f)), -5.4f)). q/k/v in f32 or bf16, the
// decay in f32, the state and all arithmetic in f32; o is stored in v's dtype.
// K and V up to 64, any L.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan (body
// _scan_kernel). That kernel walks the chunks on a sequential grid axis with S
// in VMEM, and computes each chunk through the factorisation q*exp(cum) /
// k*exp(-cum), which underflows or overflows at the decay floor (NaN at chunk
// 32, errors up to 1.73 at chunk 16). This kernel computes the same function
// token by token: every factor is a decay <= 1 or an input, so nothing leaves
// f32 range at the floor, and no token's arithmetic depends on where a chunk
// starts, so a sequence cut anywhere and carried on from its state gives the
// same bits.
//
// What bounds it on the card: the recurrence takes 5 f32 operations per
// (token, k, v): ~89 us at B=4, H=40, L=1810, K=V=64 at the CUDA cores'
// 67 TFLOP/s, above the ~67 us that its bytes take (q/k/v bf16 and the decay f32
// read once, o written once: ~225 MB at 3.35 TB/s). Tensor cores are not used:
// a chunked form would take the intra-chunk products in bf16 or TF32 and sum
// them in a chunk-aligned order, which neither meets the f32 limits the
// kernel is held to nor gives the same bits when a sequence is cut; and it
// could gain at most the 1.3x between the two bounds above.
//
// What the design does about it:
//   * one block of 128 threads per (batch, head, slice of V); each thread holds
//     R rows x 4 columns of S in registers, so SUBS = 64 / R threads share a
//     group of 4 columns and the slice is 4 * 128 / SUBS columns: 64 (R = 8),
//     32 (R = 4) or 16 (R = 2). Per token a thread loads its R values of q, k
//     and the decay (16-byte shared loads; one broadcast value for a scalar
//     decay) and 4 of v, for 4 columns;
//   * the read q . S is not reduced in the token loop, where a chain of
//     shuffles would stall it: two transposing shuffles leave each thread one
//     column's sum over 4 threads, stored to shared memory; the SUBS / 4 such
//     sums of each output are added in order a chunk later;
//   * the host chooses R by the wave arithmetic: the busiest SM holds
//     ceil(blocks / SMs) blocks, each costing a measured time per token
//     (TILE_COST); R never depends on L;
//   * chunks of CHUNK tokens are staged once per block by TMA: thread 0 loads
//     one box (CHUNK tokens x 64 elements, or x the slice for v) of q, k, the
//     decay and v through 4-D tensor maps (elements, tokens, heads, batch;
//     a broadcast head or batch is a dimension of size 1) into a ring of
//     STAGES raw stages, completing the stage's mbarrier; a scalar decay
//     lands by 4-byte cp.async. Chunk c + 3 is staged after chunk c's token
//     loop, into the stage chunk c held, and converted by chunk c + 2's loop:
//     a whole loop hides its latency. A layout TMA cannot take (a last stride
//     other than 1, a misaligned base or stride) is copied element by element
//     into the same ring, per tensor;
//   * the token loop of a chunk also converts the next chunk, one piece a
//     token, into the second set of f32 tiles (bf16 widened; past L, K or V
//     q = k = v = 0 and w = 1, which leave S unchanged and add nothing to o;
//     the clamp once per element, or once per token for a scalar decay, read
//     by its head stride), and sums and stores the last chunk's outputs, so
//     that work fills the FMAs' issue gaps; one barrier per chunk;
//   * the token loop is unrolled over the chunk and loads the next token's
//     rows before this token's FMAs; each state element's arithmetic per
//     token is kv = k * v; strict: part += q * (u * kv + S), S = w * S + kv;
//     inclusive: S = w * S + kv, part += q * S. No step spans two tokens.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int KMAX = 64;                // largest K and V the kernel takes
constexpr int THREADS = 128;
constexpr int COLS = 4;                 // columns of S per thread
constexpr int CHUNK = 16;               // tokens per staged chunk
constexpr int STAGES = 3;               // chunks in the shared-memory ring
constexpr float MAX_NEG_LOGW = 5.4f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(CHUNK * KMAX == 8 * THREADS, "the convert pass gives each thread 8 elements");

// which tensors the 16-byte path cannot take, copied element by element
enum { ELEM_Q = 1, ELEM_K = 2, ELEM_V = 4, ELEM_W = 8 };

struct Strides {
  long long b, h, l, k;                 // in elements; 0 for a broadcast dimension
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float clamp_decay(float w) {
  return expf(fmaxf(logf(fmaxf(w, 1e-30f)), -MAX_NEG_LOGW));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers and TMA: a stage's tiles land through cp.async.bulk.tensor and
// complete its mbarrier's transaction count
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
// One box of a 4-D tensor map (elements, tokens, heads, batch) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The tile of one instantiation: R rows x COLS columns of S per thread.
template <int R> struct Tile {
  static_assert(R == 2 || R == 4 || R == 8, "R is 2, 4 or 8");
  static constexpr int SUBS = KMAX / R;          // threads that share one group of columns
  static constexpr int VT = THREADS / SUBS * COLS;  // columns of S per block
  static constexpr int NP = SUBS / 4;            // partial sums of the read per column
};

// Shared memory of one instantiation, in bytes: the ring of raw stages (q, k,
// the decay, v), two sets of f32 tiles q, k, w, v (the chunk the token loop
// reads, the next one being converted) and two of the read's partial sums
// (this chunk's, the last one's being summed and stored).
template <typename T, bool SCALAR_W, int R> struct Smem {
  static constexpr int VT = Tile<R>::VT;
  static constexpr int Q_RAW = CHUNK * KMAX * (int)sizeof(T);
  static constexpr int W_RAW = SCALAR_W ? 128 : CHUNK * KMAX * 4;   // 128-byte TMA boxes
  static constexpr int V_RAW = CHUNK * VT * (int)sizeof(T);
  static constexpr int STAGE = 2 * Q_RAW + W_RAW + V_RAW;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int QF = CHUNK * KMAX;        // f32 elements of the q, k (and w) tiles
  static constexpr int WF = SCALAR_W ? CHUNK : QF;
  static constexpr int VF = CHUNK * VT;
  static constexpr int TILES = 2 * QF + WF + VF; // f32 elements of one set of tiles
  static constexpr int PF = CHUNK * VT * Tile<R>::NP;
  static constexpr int BARS = RING + 4 * (2 * TILES + 2 * PF);   // STAGES mbarriers
  static constexpr int BYTES = BARS + 8 * STAGES;
  static_assert(Q_RAW % 128 == 0 && W_RAW % 128 == 0 && V_RAW % 128 == 0,
                "TMA writes shared memory at 128-byte boundaries");
};

// Row of S held in slot j by thread `sub`: R / 4 runs of 4 rows (one 16-byte
// shared load each), 4 * SUBS rows apart; at R = 2 one run of 2 (8 bytes). The
// SUBS threads of a group read contiguous bytes, so no load conflicts.
template <int R> __device__ __forceinline__ int row_of(int sub, int j) {
  return R >= 4 ? 4 * sub + 4 * (KMAX / R) * (j / 4) + j % 4 : R * sub + j;
}

template <int R>
__device__ __forceinline__ void load_rows(const float* row, int sub, float (&r)[R]) {
  if constexpr (R >= 4) {
#pragma unroll
    for (int p = 0; p < R / 4; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(row + 4 * sub + 4 * (KMAX / R) * p);
      r[4 * p] = a.x, r[4 * p + 1] = a.y, r[4 * p + 2] = a.z, r[4 * p + 3] = a.w;
    }
  } else {
    const float2 a = *reinterpret_cast<const float2*>(row + R * sub);
    r[0] = a.x, r[1] = a.y;
  }
}

// 8 consecutive raw elements as f32: one 16-byte shared load for bf16, two for f32
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y), b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Tokens t0 .. t0 + tn - 1, columns 0 .. width - 1 of one tensor into a raw
// tile of PITCH elements a row, element by element, by warp 0: the path of a
// tensor that TMA cannot take.
template <typename E, int PITCH>
__device__ __forceinline__ void copy_elements(E* dst, const E* src, const Strides& s, int t0,
                                              int tn, int width) {
  for (int i = threadIdx.x; i < tn * width; i += 32) {
    const int t = i / width, c = i - t * width;
    dst[t * PITCH + c] = src[(long long)(t0 + t) * s.l + (long long)c * s.k];
  }
}

// The four strided inputs of one block, each at its (b, h) and the slice's v0
// (for the element path), and their tensor maps with this block's head and
// batch coordinates in them (0 along a broadcast dimension).
template <typename T> struct Inputs {
  const T *q, *k, *v;
  const float* w;
  Strides sq, sk, sv, sw;
  const CUtensorMap *mq, *mk, *mv, *mw;
  int hq, bq, hk, bk, hv, bv, hw, bw, v0;
};

// Stage the chunk of tokens t0.. into raw stage st, by warp 0: thread 0
// arrives on `bar` with the bytes its TMA boxes (CHUNK tokens x 64 elements,
// or x the slice for v; zero-filled past L, K and V) will bring, 0 past L,
// so the barrier's phase always completes; a scalar decay lands through
// 4-byte cp.async (one group a chunk); element-wise tensors are stored here.
template <typename T, bool SCALAR_W, int R>
__device__ __forceinline__ void stage_chunk(unsigned char* st, uint64_t* bar,
                                            const Inputs<T>& in, int t0, int L, int K, int vn,
                                            int elem) {
  using M = Smem<T, SCALAR_W, R>;
  const int tn = max(0, min(CHUNK, L - t0));
  const bool tq = !(elem & ELEM_Q), tk = !(elem & ELEM_K), tv = !(elem & ELEM_V);
  const bool tw = !SCALAR_W && !(elem & ELEM_W);
  T* qr = reinterpret_cast<T*>(st);
  T* kr = reinterpret_cast<T*>(st + M::Q_RAW);
  float* wr = reinterpret_cast<float*>(st + 2 * M::Q_RAW);
  T* vr = reinterpret_cast<T*>(st + 2 * M::Q_RAW + M::W_RAW);
  if (threadIdx.x == 0) {
    if (tn == 0) {
      mbar_expect_tx(bar, 0);
    } else {
      mbar_expect_tx(bar, (tq + tk) * M::Q_RAW + tw * M::W_RAW + tv * M::V_RAW);
      if (tq) tma_load(qr, in.mq, bar, 0, t0, in.hq, in.bq);
      if (tk) tma_load(kr, in.mk, bar, 0, t0, in.hk, in.bk);
      if (tw) tma_load(wr, in.mw, bar, 0, t0, in.hw, in.bw);
      if (tv) tma_load(vr, in.mv, bar, in.v0, t0, in.hv, in.bv);
    }
  }
  if (!tq) copy_elements<T, KMAX>(qr, in.q, in.sq, t0, tn, K);
  if (!tk) copy_elements<T, KMAX>(kr, in.k, in.sk, t0, tn, K);
  if constexpr (SCALAR_W) {
    if (threadIdx.x < tn) cp_async4(wr + threadIdx.x, in.w + (long long)(t0 + threadIdx.x) * in.sw.l);
  } else {
    if (!tw) copy_elements<float, KMAX>(wr, in.w, in.sw, t0, tn, K);
  }
  if (!tv) copy_elements<T, M::VT>(vr, in.v, in.sv, t0, tn, vn);
  cp_async_commit();
}

// One of the NPIECES pieces of converting a landed raw stage (tn tokens)
// into a set of f32 tiles; the token loop runs piece t at token t, so the
// next chunk's conversion interleaves with this chunk's FMAs (straight-line
// code: every thread computes, stores are predicated). Past L, K or V:
// q = k = v = 0, w = 1. Pieces 0, 1: q, k (8 elements a thread); 2..9: the
// decay, one clamp a thread per piece (per token at the scalar path, in
// piece 2); 10: v.
constexpr int NPIECES = 11;

template <typename T, bool SCALAR_W, int R>
__device__ __forceinline__ void convert_piece(int piece, const unsigned char* st, float* tiles,
                                              int tn, int K, int vn) {
  using M = Smem<T, SCALAR_W, R>;
  constexpr int VT = M::VT;
  const int tid = threadIdx.x;
  const T* qr = reinterpret_cast<const T*>(st);
  const T* kr = reinterpret_cast<const T*>(st + M::Q_RAW);
  const float* wr = reinterpret_cast<const float*>(st + 2 * M::Q_RAW);
  const T* vr = reinterpret_cast<const T*>(st + 2 * M::Q_RAW + M::W_RAW);
  float* qf = tiles;
  float* kf = qf + M::QF;
  float* wf = kf + M::QF;
  float* vf = wf + M::WF;
  if (piece <= 1) {
    const int t = tid / 8, c0 = tid % 8 * 8;
    float x[8];
    load8((piece == 0 ? qr : kr) + t * KMAX + c0, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = (t < tn && c0 + e < K) ? x[e] : 0.f;
    store8((piece == 0 ? qf : kf) + t * KMAX + c0, x);
  } else if (piece < 10) {
    if constexpr (SCALAR_W) {
      if (piece == 2) {
        const float x = clamp_decay(wr[tid % CHUNK]);
        if (tid < CHUNK) wf[tid] = tid < tn ? x : 1.f;
      }
    } else {
      const int i = (piece - 2) * THREADS + tid, t = i / KMAX, c = i % KMAX;
      const float x = clamp_decay(wr[i]);
      wf[i] = (t < tn && c < K) ? x : 1.f;
    }
  } else {
    constexpr int GROUPS8 = CHUNK * VT / 8;      // 8-column groups of the v tile
    const int g = min(tid, GROUPS8 - 1), t = g / (VT / 8), c8 = g % (VT / 8) * 8;
    float x[8];
    load8(vr + t * VT + c8, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = (t < tn && c8 + e < vn) ? x[e] : 0.f;
    if (tid < GROUPS8) store8(vf + t * VT + c8, x);
  }
}

template <typename T, bool STRICT, bool SCALAR_W, int R>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ bonus,
                const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ sf,
                int H, int L, int K, int V, Strides sq, Strides sk, Strides sv, Strides sw,
                int elem, const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mw) {
  using M = Smem<T, SCALAR_W, R>;
  constexpr int SUBS = Tile<R>::SUBS, VT = Tile<R>::VT, NP = Tile<R>::NP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem + M::RING);    // 2 sets of M::TILES
  float* parts = tiles + 2 * M::TILES;           // 2 sets of [CHUNK][VT][NP] partial sums
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + M::BARS);   // one a stage

  const int nvs = (V + VT - 1) / VT;
  const int bh = blockIdx.x / nvs;
  const int v0 = (blockIdx.x % nvs) * VT;
  const int vn = min(VT, V - v0);                // columns of this slice
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int sub = tid % SUBS;
  const int col = (tid / SUBS) * COLS;           // the thread's first column in the slice

  Inputs<T> in{q + b * sq.b + h * sq.h, k + b * sk.b + h * sk.h,
               v + b * sv.b + h * sv.h + v0 * sv.k, w + b * sw.b + h * sw.h, sq, sk, sv, sw,
               &mq, &mk, &mv, &mw,
               sq.h ? h : 0, sq.b ? b : 0, sk.h ? h : 0, sk.b ? b : 0,
               sv.h ? h : 0, sv.b ? b : 0, sw.h ? h : 0, sw.b ? b : 0, v0};

  float S[R][COLS], u[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = row_of<R>(sub, j);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int vcol = v0 + col + c;
      S[j][c] = (s0 != nullptr && r < K && vcol < V) ? s0[((long long)bh * K + r) * V + vcol]
                                                      : 0.f;
    }
    u[j] = (STRICT && r < K) ? bonus[(long long)h * K + r] : 0.f;
  }

  // One of the SPIECES pieces of storing a chunk's o (starting at t0, tn
  // tokens) from its partial sums: a thread takes 4 columns of one token and
  // sums each column's NP partial sums in order; one 8- or 16-byte store
  // where V % 4 == 0 keeps it aligned.
  constexpr int QUADS = CHUNK * VT / 4, SPIECES = (QUADS + THREADS - 1) / THREADS;
  static_assert(NPIECES + SPIECES <= CHUNK, "the pieces run at the chunk's tokens");
  const bool vec_out = V % 4 == 0;
  auto store_piece = [&](int piece, const float* pp, int t0, int tn) {
    const int i = min(piece * THREADS + tid, QUADS - 1);
    const int t = i / (VT / 4), c4 = i % (VT / 4) * 4;
    float a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x[NP];
      const float* src = pp + (t * VT + c4 + e) * NP;
      if constexpr (NP % 4 == 0) {
#pragma unroll
        for (int p = 0; p < NP; p += 4) {
          const float4 y = *reinterpret_cast<const float4*>(src + p);
          x[p] = y.x, x[p + 1] = y.y, x[p + 2] = y.z, x[p + 3] = y.w;
        }
      } else {
        const float2 y = *reinterpret_cast<const float2*>(src);
        x[0] = y.x, x[1] = y.y;
      }
      a[e] = x[0];
#pragma unroll
      for (int p = 1; p < NP; ++p) a[e] += x[p];
    }
    if (piece * THREADS + tid >= QUADS || t >= tn) return;
    T* o = out + ((long long)bh * L + t0 + t) * V + v0 + c4;
    if (vec_out && c4 + 4 <= vn) {
      store4(o, make_float4(a[0], a[1], a[2], a[3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c4 + e < vn) o[e] = from_f32<T>(a[e]);
    }
  };

  // where this thread's partial sum goes after the two shuffles: column
  // col + 2 * (sub & 1) + (sub >> 1 & 1), slot sub >> 2
  const bool b0 = sub & 1, b1 = sub & 2;
  const int pme = (col + 2 * b0 + b1) * NP + (sub >> 2);
  auto stage = [&](int c) { return smem + (c % STAGES) * M::STAGE; };
  auto chunk_len = [&](int c) { return max(0, min(CHUNK, L - c * CHUNK)); };

  // The ring: chunks 0..2 are staged up front; after chunk c's token loop
  // (which converted chunk c + 1) chunk c + 3 is staged into the stage chunk
  // c held, and it is waited for (its mbarrier's phase, and wait_group 0 for
  // a scalar decay) after chunk c + 1's loop, before its barrier. One
  // barrier per chunk.
  const int nchunks = (L + CHUNK - 1) / CHUNK;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < 32) {
#pragma unroll 1
    for (int c = 0; c < STAGES; ++c)
      stage_chunk<T, SCALAR_W, R>(stage(c), bars + c, in, c * CHUNK, L, K, vn, elem);
  }
  cp_async_wait<STAGES - 2>();                   // chunks 0 and 1 landed
  mbar_wait(bars, 0);
  mbar_wait(bars + 1, 0);
  __syncthreads();
#pragma unroll
  for (int piece = 0; piece < NPIECES; ++piece)
    convert_piece<T, SCALAR_W, R>(piece, stage(0), tiles, chunk_len(0), K, vn);
  __syncthreads();

#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    const float* qf = tiles + (c & 1) * M::TILES;
    const float* kf = qf + M::QF;
    const float* wf = kf + M::QF;
    const float* vf = wf + M::WF;
    float* next_tiles = tiles + ((c + 1) & 1) * M::TILES;
    const unsigned char* next_stage = stage(c + 1);
    const int next_len = chunk_len(c + 1), prev_len = c > 0 ? CHUNK : 0;
    float* pw = parts + (c & 1) * M::PF;
    const float* pr = parts + ((c + 1) & 1) * M::PF;

    // one token's q, k, w rows and v columns from the f32 tiles
    auto load_token = [&](int t, float (&qr)[R], float (&kr)[R], float (&wr)[R],
                          float (&vv)[COLS]) {
      load_rows<R>(qf + t * KMAX, sub, qr);
      load_rows<R>(kf + t * KMAX, sub, kr);
      if constexpr (SCALAR_W) {
        const float ws = wf[t];
#pragma unroll
        for (int j = 0; j < R; ++j) wr[j] = ws;
      } else {
        load_rows<R>(wf + t * KMAX, sub, wr);
      }
      const float4 v4 = *reinterpret_cast<const float4*>(vf + t * VT + col);
      vv[0] = v4.x, vv[1] = v4.y, vv[2] = v4.z, vv[3] = v4.w;
    };

    float qr[R], kr[R], wr[R], vv[COLS];
    load_token(0, qr, kr, wr, vv);
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      float qn[R], kn[R], wn[R], vn4[COLS], part[COLS];
      if (t + 1 < CHUNK) load_token(t + 1, qn, kn, wn, vn4);   // ahead of this token's FMAs
      // the next chunk's conversion and the last chunk's outputs, a piece a token
      if (t < NPIECES) convert_piece<T, SCALAR_W, R>(t, next_stage, next_tiles, next_len, K, vn);
      if (t >= NPIECES && t < NPIECES + SPIECES)
        store_piece(t - NPIECES, pr, (c - 1) * CHUNK, prev_len);
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) part[cc] = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) {
          const float kv = kr[j] * vv[cc];
          if (STRICT) {
            part[cc] = fmaf(qr[j], fmaf(u[j], kv, S[j][cc]), part[cc]);   // reads S_{t-1}
            S[j][cc] = fmaf(wr[j], S[j][cc], kv);
          } else {
            S[j][cc] = fmaf(wr[j], S[j][cc], kv);
            part[cc] = fmaf(qr[j], S[j][cc], part[cc]);                   // reads S_t
          }
        }
      }
      // neighbours (sub, sub ^ 1) swap halves of their 4 column sums, then
      // (sub, sub ^ 2) halves of the 2 left: each thread stores 1 column's
      // sum over 4 threads; the NP such sums are added in store_piece
      const float a0 = b0 ? part[2] : part[0], a1 = b0 ? part[3] : part[1];
      const float s0 = b0 ? part[0] : part[2], s1 = b0 ? part[1] : part[3];
      const float x0 = a0 + __shfl_xor_sync(FULL, s0, 1);
      const float x1 = a1 + __shfl_xor_sync(FULL, s1, 1);
      const float y = b1 ? x0 : x1;
      pw[t * VT * NP + pme] = (b1 ? x1 : x0) + __shfl_xor_sync(FULL, y, 2);
      if (t + 1 < CHUNK) {
#pragma unroll
        for (int j = 0; j < R; ++j) qr[j] = qn[j], kr[j] = kn[j], wr[j] = wn[j];
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) vv[cc] = vn4[cc];
      }
    }
    cp_async_wait<0>();                          // chunk c + 2 landed
    mbar_wait(bars + (c + 2) % STAGES, (c + 2) / STAGES & 1);
    __syncthreads();                             // next tiles, partial sums and copies visible
    if (tid < 32) {
      fence_proxy_async();                       // the stage's reads before its refill
      stage_chunk<T, SCALAR_W, R>(stage(c + STAGES), bars + c % STAGES, in,
                                  (c + STAGES) * CHUNK, L, K, vn, elem);
    }
  }
  cp_async_wait<0>();
  if (nchunks > 0) {
#pragma unroll
    for (int piece = 0; piece < SPIECES; ++piece)
      store_piece(piece, parts + ((nchunks - 1) & 1) * M::PF, (nchunks - 1) * CHUNK,
                  chunk_len(nchunks - 1));
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = row_of<R>(sub, j);
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (r < K && v0 + col + c < V) sf[((long long)bh * K + r) * V + v0 + col + c] = S[j][c];
  }
}

// Device ns of one block per token, by R (2, 4, 8), at rwkv6's 4 x 1810 on an
// H100 (NVIDIA H100 80GB HBM3, 700 W): the tile sweep of
// repro_torch/launch/ssm_scan_tiles.py, recorded in PERF.md
constexpr float TILE_COST[3] = {79.0f, 88.1f, 151.7f};

int sm_count() {
  static int cache[64];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < 64 && cache[dev]) return cache[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < 64) cache[dev] = n;
  return n;
}

// The R whose busiest SM (ceil(blocks / SMs) blocks) finishes first; 0 on error.
int choose_rows(int B, int H, int V) {
  const int sms = sm_count();
  if (sms <= 0) return 0;
  int best = 8;
  float best_cost = 0.f;
  for (int i = 2; i >= 0; --i) {
    const int r = 2 << i, vt = 4 * THREADS * r / KMAX;
    const long long blocks = (long long)B * H * ((V + vt - 1) / vt);
    const float cost = (float)((blocks + sms - 1) / sms) * TILE_COST[i];
    if (i == 2 || cost < best_cost) best = r, best_cost = cost;
  }
  return best;
}

bool vec_ok(const void* p, const long long* s, int width, int es) {
  return s[3] == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s[0] * es) % 16 == 0 &&
         (s[1] * es) % 16 == 0 && (s[2] * es) % 16 == 0 && (width * es) % 16 == 0;
}

int elem_flags(const void* q, const void* k, const void* v, const void* w, int K, int V,
               const long long* strides, int es) {
  int f = 0;
  if (!vec_ok(q, strides, K, es)) f |= ELEM_Q;
  if (!vec_ok(k, strides + 4, K, es)) f |= ELEM_K;
  if (!vec_ok(v, strides + 8, V, es)) f |= ELEM_V;
  if (strides[15] != 0 && !vec_ok(w, strides + 12, K, 4)) f |= ELEM_W;
  return f;
}

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

// A 4-D map (width, L, H, B) of one input with element strides s = (b, h, l,
// 1), in boxes of box0 elements x CHUNK tokens, zero-filled out of bounds. A
// broadcast (stride-0) head or batch dimension becomes a dimension of size 1
// (the kernel's coordinate there is 0), with a stride that cannot matter.
bool make_map(CUtensorMap* map, const void* ptr, int es, int width, int L, int H, int B,
              const long long* s, int box0) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)(L > 0 ? L : 1),
                              (cuuint64_t)(s[1] ? H : 1), (cuuint64_t)(s[0] ? B : 1)};
  cuuint64_t strides[3] = {(cuuint64_t)(s[2] * es), (cuuint64_t)(s[1] * es),
                           (cuuint64_t)(s[0] * es)};
  cuuint64_t natural = (cuuint64_t)width * es;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = (natural + 15) / 16 * 16;
    natural = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)CHUNK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The ELEM_* flags of the inputs staged element by element, and the tensor
// maps (q, k, v, decay) of the others: those TMA can take whose maps encode.
int staging(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, const void* w,
            int B, int H, int L, int K, int V, const long long* strides, int es, int R) {
  int elem = elem_flags(q, k, v, w, K, V, strides, es);
  const void* ptrs[4] = {q, k, v, w};
  const int bits[4] = {ELEM_Q, ELEM_K, ELEM_V, ELEM_W};
  for (int i = 0; i < 4; ++i) {
    if ((elem & bits[i]) || (i == 3 && strides[15] == 0)) continue;
    if (!make_map(&maps[i], ptrs[i], i == 3 ? 4 : es, i == 2 ? V : K, L, H, B, strides + 4 * i,
                  i == 2 ? 8 * R : KMAX))
      elem |= bits[i];
  }
  return elem;
}

// One instantiation of the kernel, as a type the dispatch below passes on.
template <typename T, bool STRICT, bool SCALAR_W, int R> struct Inst {
  using type = T;
  static constexpr auto kernel = ssm_scan_kernel<T, STRICT, SCALAR_W, R>;
  static constexpr int smem = Smem<T, SCALAR_W, R>::BYTES, vt = Tile<R>::VT;

  // the kernel's shared-memory attributes, set once per device
  static cudaError_t prepare() {
    static unsigned long long done;              // one bit per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < 64 && (done >> dev & 1))) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
    return err;
  }
};

template <typename T, bool STRICT, bool SCALAR_W, typename F>
cudaError_t by_rows(int R, F& f) {
  switch (R) {
    case 2: return f(Inst<T, STRICT, SCALAR_W, 2>{});
    case 4: return f(Inst<T, STRICT, SCALAR_W, 4>{});
    case 8: return f(Inst<T, STRICT, SCALAR_W, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(Inst<...>{}) for the instantiation of dtype (0 = f32, 1 = bf16), read,
// decay kind and R
template <typename F>
cudaError_t dispatch(int dtype, bool strict, bool scalar_w, int R, F&& f) {
  if (dtype == 0) {
    if (strict) return scalar_w ? by_rows<float, true, true>(R, f) : by_rows<float, true, false>(R, f);
    return scalar_w ? by_rows<float, false, true>(R, f) : by_rows<float, false, false>(R, f);
  }
  if (strict) return scalar_w ? by_rows<bf16, true, true>(R, f) : by_rows<bf16, true, false>(R, f);
  return scalar_w ? by_rows<bf16, false, true>(R, f) : by_rows<bf16, false, false>(R, f);
}

int scan(int R, const void* q, const void* k, const void* v, const void* w, const void* bonus,
         const void* s0, void* out, void* sf, int B, int H, int L, int K, int V,
         const long long* strides, int dtype, void* stream) {
  if (K < 1 || K > KMAX || V < 1 || V > KMAX || L < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  if (R == 0) R = choose_rows(B, H, V);
  if (R == 0) return (int)cudaErrorInvalidDevice;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
  const int es = dtype == 0 ? 4 : 2;
  CUtensorMap maps[4] = {};
  const int elem = staging(maps, q, k, v, w, B, H, L, K, V, strides, es, R);
  cudaStream_t stream_ = reinterpret_cast<cudaStream_t>(stream);
  return (int)dispatch(dtype, bonus != nullptr, strides[15] == 0, R, [&](auto inst) {
    using I = decltype(inst);
    using T = typename I::type;
    cudaError_t err = I::prepare();
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)B * H * ((V + I::vt - 1) / I::vt);
    I::kernel<<<(unsigned)blocks, THREADS, I::smem, stream_>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(w), static_cast<const float*>(bonus),
        static_cast<const float*>(s0), static_cast<T*>(out), static_cast<float*>(sf), H, L, K,
        V, st[0], st[1], st[2], st[3], elem, maps[0], maps[1], maps[2], maps[3]);
    return cudaGetLastError();
  });
}

}  // namespace

// q/k/w: (B, H, L, K); v: (B, H, L, V); each read through the 4 strides (in
// elements, order b, h, l, last) that `strides` holds for q, k, v, w in turn.
// bonus: (H, K) f32 contiguous, or null for the inclusive read; s0: (B, H, K, V)
// f32 contiguous, or null for a zero state. out: (B, H, L, V) contiguous in the
// dtype of q/k/v; sf: (B, H, K, V) f32 contiguous. dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and out alike). Returns the launch's cudaError_t.
extern "C" int repro_ssm_scan(const void* q, const void* k, const void* v, const void* w,
                              const void* bonus, const void* s0, void* out, void* sf, int B,
                              int H, int L, int K, int V, const long long* strides, int dtype,
                              void* stream) {
  return scan(0, q, k, v, w, bonus, s0, out, sf, B, H, L, K, V, strides, dtype, stream);
}

// repro_ssm_scan with the rows of S per thread forced to R (2, 4 or 8), for
// the tile sweep (repro_torch/launch/ssm_scan_tiles.py).
extern "C" int repro_ssm_scan_rows(int R, const void* q, const void* k, const void* v,
                                   const void* w, const void* bonus, const void* s0, void* out,
                                   void* sf, int B, int H, int L, int K, int V,
                                   const long long* strides, int dtype, void* stream) {
  if (R != 2 && R != 4 && R != 8) return (int)cudaErrorInvalidValue;
  return scan(R, q, k, v, w, bonus, s0, out, sf, B, H, L, K, V, strides, dtype, stream);
}

// What repro_ssm_scan does with these inputs (strict: a bonus is given):
// plan[0] = R (rows of S per thread), plan[1] = the slice's columns, plan[2] =
// the ELEM_* flags of the tensors copied element by element (q 1, k 2, v 4,
// decay 8; the others land by TMA), plan[3] = 1 for the scalar-decay path
// (its decay lands by 4-byte cp.async), plan[4] = dynamic shared memory per
// block in bytes, plan[5] = blocks resident per SM.
extern "C" int repro_ssm_scan_plan(const void* q, const void* k, const void* v, const void* w,
                                   int strict, int B, int H, int L, int K, int V,
                                   const long long* strides, int dtype, int* plan) {
  if (K < 1 || K > KMAX || V < 1 || V > KMAX || L < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int R = choose_rows(B, H, V);
  if (R == 0) return (int)cudaErrorInvalidDevice;
  const bool scalar_w = strides[15] == 0;
  CUtensorMap maps[4];
  plan[0] = R;
  plan[2] = staging(maps, q, k, v, w, B, H, L, K, V, strides, dtype == 0 ? 4 : 2, R);
  plan[3] = scalar_w;
  return (int)dispatch(dtype, strict != 0, scalar_w, R, [&](auto inst) {
    using I = decltype(inst);
    plan[1] = I::vt;
    plan[4] = I::smem;
    cudaError_t err = I::prepare();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan[5], I::kernel, THREADS, I::smem);
  });
}
