// Flash attention forward for Hopper (sm_90a): bf16 in and out, f32 softmax state.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _fa_kernel): online-softmax attention with f32 running max m, sum l and
// accumulator acc; causal masking with q_offset = Lkv - Lq, a sliding window and
// the tanh score softcap. It computes the same function, not the same blocks.
//
// What bounds it on the card: 4 * H * Lq * Lkv * D tensor-core operations per
// batch row. At the DiT's lengths (L ~ 1e3..1e4, D = 64) that is far above the
// H100's ~295 operations per byte, so the bound is the bf16 tensor-core rate.
//
// What the design does about it (the simple version; wgmma, TMA and warp
// specialisation are later work):
//   * one block per (batch*head, 64-query tile); the TPU's sequential KV grid
//     axis becomes a loop over 64-key tiles inside the block;
//   * Q, K and V tiles sit in shared memory; Q K^T and P V run on the tensor
//     cores through nvcuda::wmma (bf16 16x16x16, f32 accumulate);
//   * the f32 score tile goes through shared memory for the online softmax;
//     P is rounded to bf16 for the P V product, as the reference rounds the
//     probabilities to v's dtype; acc stays in f32 in shared memory;
//   * q/k/v are read in their (B, L, H, D) layout through strides and o is
//     written the same way: no transposes and no padded copies;
//   * key columns at or past Lkv are -inf before the row max and query rows at
//     or past Lq are neither loaded nor stored, so every length works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;                 // query rows per block, 16 per warp
constexpr int BK = 64;                 // keys per KV tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASKED = -1e30f;       // the reference's mask value

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;    // bf16 row stride of the Q, K, V tiles
  static constexpr int LDS = BK + 4;   // f32 row stride of the score tile
  static constexpr int LDP = BK + 8;   // bf16 row stride of the probability tile
  static constexpr int LDO = D + 4;    // f32 row stride of the accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = q + size_t(BQ) * LDH * 2;
  static constexpr size_t v = k + size_t(BK) * LDH * 2;
  static constexpr size_t s = v + size_t(BK) * LDH * 2;
  static constexpr size_t p = s + size_t(BQ) * LDS * 4;
  static constexpr size_t o = p + size_t(BQ) * LDP * 2;
  static constexpr size_t bytes = o + size_t(BQ) * LDO * 4;
};

// Copy rows [row0, row0 + 64) of one head into a shared tile, 16 bytes a thread;
// rows at or past `rows` are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int row0, int rows) {
  constexpr int VPR = D / 8;
  constexpr int LDH = Layout<D>::LDH;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Lq, int Lkv,
              long long qsb, long long qsl, long long qsh,
              long long ksb, long long ksl, long long ksh,
              long long vsb, long long vsl, long long vsh,
              long long osb, long long osl, long long osh,
              int causal, int window, float softcap, float scale) {
  using LY = Layout<D>;
  constexpr int LDH = LY::LDH, LDS = LY::LDS, LDP = LY::LDP, LDO = LY::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem + LY::q);
  bf16* sk = reinterpret_cast<bf16*>(smem + LY::k);
  bf16* sv = reinterpret_cast<bf16*>(smem + LY::v);
  float* ss = reinterpret_cast<float*>(smem + LY::s);
  bf16* sp = reinterpret_cast<bf16*>(smem + LY::p);
  float* so = reinterpret_cast<float*>(smem + LY::o);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_offset = Lkv - Lq;       // extend/decode queries sit at the end of kv

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;
  bf16* ob = o + b * osb + h * osh;

  load_tile<D>(sq, qb, qsl, q0, Lq);
  for (int i = threadIdx.x; i < BQ * LDO; i += THREADS) so[i] = 0.f;

  // Each pair of lanes owns one query row of the warp's 16; each lane half of it.
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qpos = q0 + row + q_offset;
  float m = -INFINITY, l = 0.f;

  // KV tiles that hold an unmasked key for some row of this block. Skipping the
  // others is exact when every row keeps its own position (q_offset >= 0): the
  // reference's exp(-1e30 - m) is then 0 for every skipped key.
  const int n_tiles = (Lkv + BK - 1) / BK;
  int t_begin = 0, t_end = n_tiles;
  if (causal && q_offset >= 0) {
    const int first_q = q0 + q_offset, last_q = q0 + BQ - 1 + q_offset;
    t_end = min(n_tiles, last_q / BK + 1);
    if (window > 0) t_begin = max(0, first_q - window + 1) / BK;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();                   // every warp is done with the last K/V tile
    load_tile<D>(sk, kb, ksl, k0, Lkv);
    load_tile<D>(sv, vb, vsl, k0, Lkv);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(c[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::load_matrix_sync(a, sq + warp * 16 * LDH + kk, LDH);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::load_matrix_sync(kt, sk + j * 16 * LDH + kk, LDH);
          wmma::mma_sync(c[j], a, kt, c[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(ss + warp * 16 * LDS + j * 16, c[j], LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this lane's 32 columns of its row.
    const float* srow = ss + row * LDS + half * 32;
    float vals[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kpos = k0 + half * 32 + c;
      float s = srow[c] * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      if (kpos >= Lkv) {
        s = -INFINITY;                 // ragged edge: not a key at all
      } else if (causal) {
        bool keep = kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        if (!keep) s = MASKED;
      }
      vals[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    float sum = 0.f;
    bf16* prow = sp + row * LDP + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float pc = __expf(vals[c] - m_new);
      prow[c] = __float2bfloat16(pc);
      sum += pc;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = alpha * l + sum;
    m = m_new;
    float* orow = so + row * LDO + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    __syncwarp();

    // acc += P V for this warp's 16 rows.
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[BK / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], sp + warp * 16 * LDP + kk * 16, LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        float* tile = so + warp * 16 * LDO + j * 16;
        wmma::load_matrix_sync(acc, tile, LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::load_matrix_sync(vf, sv + kk * 16 * LDH + j * 16, LDH);
          wmma::mma_sync(acc, pa[kk], vf, acc);
        }
        wmma::store_matrix_sync(tile, acc, LDO, wmma::mem_row_major);
      }
    }
    __syncwarp();
  }
  __syncthreads();

  const int qrow = q0 + row;
  if (qrow < Lq) {
    const float inv = (l == 0.f) ? 1.f : 1.f / l;   // a row that saw no key gives 0
    const float* orow = so + row * LDO + half * (D / 2);
    bf16* dst = ob + (long long)qrow * osl + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      __align__(16) bf16 pack[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) pack[e] = __float2bfloat16(orow[c + e] * inv);
      *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(pack);
    }
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Lq,
                   int Lkv, const long long* st, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  // above 48 KB of shared memory needs an opt-in, once per device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  fa_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, o, H, Lq, Lkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Lq, H, D), k/v: (B, Lkv, H, D), o: (B, Lq, H, D), all bf16 with unit
// stride on D. strides: 12 element strides, (batch, row, head) for q, k, v, o.
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
  if (D == 64)
    err = launch<64>(qp, kp, vp, op, B, H, Lq, Lkv, strides, causal, window, softcap, scale, s);
  else if (D == 128)
    err = launch<128>(qp, kp, vp, op, B, H, Lq, Lkv, strides, causal, window, softcap, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
