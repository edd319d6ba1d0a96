// Gated linear-attention scan (Mamba2 / RWKV6) for Hopper (sm_90a).
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T              (S is K x V, f32)
//   o_t = q_t . S_t                                   inclusive read (Mamba2)
//   o_t = q_t . S_{t-1} + (q_t . (u * k_t)) v_t       strict read + bonus u (RWKV6)
//
// with the per-step log-decay clamped at -5.4, as the TPU kernel clamps it.
// q/k/v in f32 or bf16, the decay in f32, the state and all arithmetic in f32;
// o is stored in v's dtype. K and V up to 64, any L.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan (body
// _scan_kernel). That kernel walks the chunks on a sequential grid axis with S
// in VMEM, and computes each chunk through the factorisation q*exp(cum) /
// k*exp(-cum), which underflows or overflows at the decay floor (NaN at chunk
// 32, errors up to 1.73 at chunk 16). This kernel computes the same function,
// not the same blocks:
//   * one block per (batch, head, slice of V), so B*H*ceil(V/slice) blocks
//     fill the 132 SMs at the serving shapes (B*H is 40..256); each block
//     walks the whole sequence itself, holding its K x slice of S in
//     registers: 128 threads, 8 per group of COLS columns, 8 rows each. The
//     slice is 16 columns (COLS = 1) when that grid fits in one wave of
//     resident blocks, else 32 (COLS = 2): at B*H = 256 (zamba2) the
//     narrow grid needs a second wave, at 160 (rwkv6) the wide one leaves
//     too few warps per SM;
//   * the recurrence runs token by token, as written above: every factor is a
//     decay <= 1 or an input, so nothing leaves f32 range at the floor and the
//     result does not depend on the chunk length (CHUNK below only sets how
//     many tokens are staged in shared memory at a time);
//   * the read o_t[v] = sum_k q_t[k] S[k, v] is a partial sum over each
//     thread's 8 rows and three warp shuffles across the 8 threads of a
//     column group; each column's arithmetic is the same for either slice;
//   * q/k/v/decay are read through their strides, so the head-shared B/C and
//     the per-head decay of Mamba2 (stride-0 broadcasts) are never copied, and
//     the bonus is read as (H, K) by head.
//
// What bounds it on the card: as written, its arithmetic. The recurrence
// takes 5 f32 operations per (token, k, v), ~89 us at B=4, H=40, L=1810,
// K=V=64 at the CUDA cores' 67 TFLOP/s, above the ~67 us that its bytes
// take (q/k/v bf16 and the decay f32 read once, o written once: ~225 MB at
// 3.35 TB/s). Moving the chunk products to the tensor cores (a chunked form
// whose intra-chunk weights are exp(cum_t - cum_s) <= 1 per pair), with
// cp.async or TMA double buffering, is the later work that makes it
// bytes-bound. This is the simple version: synchronous loads, CUDA cores, f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int KMAX = 64;                // largest K and V the kernel takes
constexpr int SUBS = 8;                 // threads that share one column of S
constexpr int ROWS = KMAX / SUBS;       // rows of S per thread
constexpr int GROUPS = 16;              // column groups of a block
constexpr int THREADS = GROUPS * SUBS;  // 128
constexpr int CHUNK = 32;               // tokens staged in shared memory per pass
constexpr float MAX_NEG_LOGW = 5.4f;

struct Strides {
  long long b, h, l, k;                 // in elements; 0 for a broadcast dimension
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// Row of S held in slot j by thread `sub`: 4*sub + j, then 32 + 4*sub + (j - 4).
// Each half is one 16-byte shared load; the 8 threads of a column read 128
// contiguous bytes, so a warp's loads hit every bank once.
__device__ __forceinline__ int row_of(int sub, int j) {
  return (j < 4 ? 4 * sub + j : 32 + 4 * sub + (j - 4));
}

// The thread's 8 values of one staged row, in row_of order: two 16-byte loads.
__device__ __forceinline__ void load_rows(const float* row, int sub, float (&r)[ROWS]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * sub);
  const float4 b = *reinterpret_cast<const float4*>(row + 32 + 4 * sub);
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

template <typename T, bool STRICT, int COLS>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ bonus,
                const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ sf,
                int H, int L, int K, int V, Strides sq, Strides sk, Strides sv, Strides sw) {
  __shared__ __align__(16) float q_s[CHUNK][KMAX];
  __shared__ __align__(16) float k_s[CHUNK][KMAX];
  __shared__ __align__(16) float w_s[CHUNK][KMAX];
  constexpr int VT = GROUPS * COLS;     // columns of S per block
  __shared__ float v_s[CHUNK][VT];
  __shared__ float o_s[CHUNK][VT];

  const int nvs = (V + VT - 1) / VT;
  const int bh = blockIdx.x / nvs;
  const int v0 = (blockIdx.x % nvs) * VT;
  const int b = bh / H, h = bh % H;
  const int col = (threadIdx.x / SUBS) * COLS;   // the thread's first column in the slice
  const int sub = threadIdx.x % SUBS;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = w + b * sw.b + h * sw.h;

  float S[ROWS][COLS], u[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = row_of(sub, j);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int vcol = v0 + col + c;
      S[j][c] = (s0 != nullptr && r < K && vcol < V) ? s0[((long long)bh * K + r) * V + vcol]
                                                      : 0.f;
    }
    u[j] = (STRICT && r < K) ? bonus[(long long)h * K + r] : 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += CHUNK) {
    const int tn = min(CHUNK, L - t0);
    // stage the chunk; rows past L and columns past K read as q = k = 0,
    // w = 1, which leave S unchanged and add nothing to o
    for (int i = threadIdx.x; i < CHUNK * KMAX; i += THREADS) {
      const int t = i / KMAX, kk = i % KMAX;
      float qv = 0.f, kv = 0.f, wv = 1.f;
      if (t < tn && kk < K) {
        const long long l = t0 + t;
        qv = to_f32(qb[l * sq.l + kk * sq.k]);
        kv = to_f32(kb[l * sk.l + kk * sk.k]);
        wv = expf(fmaxf(logf(fmaxf(wb[l * sw.l + kk * sw.k], 1e-30f)), -MAX_NEG_LOGW));
      }
      q_s[t][kk] = qv;
      k_s[t][kk] = kv;
      w_s[t][kk] = wv;
    }
    for (int i = threadIdx.x; i < CHUNK * VT; i += THREADS) {
      const int t = i / VT, c = i % VT;
      v_s[t][c] = (t < tn && v0 + c < V) ? to_f32(vb[(long long)(t0 + t) * sv.l + (v0 + c) * sv.k])
                                         : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < tn; ++t) {
      float qr[ROWS], kr[ROWS], wr[ROWS];
      load_rows(q_s[t], sub, qr);
      load_rows(k_s[t], sub, kr);
      load_rows(w_s[t], sub, wr);
      float vv[COLS], part[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) vv[c] = v_s[t][col + c], part[c] = 0.f;
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const float kv = kr[j] * vv[c];
          if (STRICT) {
            part[c] = fmaf(qr[j], fmaf(u[j], kv, S[j][c]), part[c]);   // reads S_{t-1}
            S[j][c] = fmaf(wr[j], S[j][c], kv);
          } else {
            S[j][c] = fmaf(wr[j], S[j][c], kv);
            part[c] = fmaf(qr[j], S[j][c], part[c]);                   // reads S_t
          }
        }
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        part[c] += __shfl_xor_sync(0xffffffffu, part[c], 1);
        part[c] += __shfl_xor_sync(0xffffffffu, part[c], 2);
        part[c] += __shfl_xor_sync(0xffffffffu, part[c], 4);
        if (sub == 0) o_s[t][col + c] = part[c];
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < tn * VT; i += THREADS) {
      const int t = i / VT, c = i % VT;
      if (v0 + c < V)
        out[((long long)bh * L + t0 + t) * V + v0 + c] = from_f32<T>(o_s[t][c]);
    }
    // the next pass writes only the staging tiles, which every thread has
    // finished reading (the barrier above); o_s is rewritten after its barrier
  }

#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = row_of(sub, j);
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (r < K && v0 + col + c < V) sf[((long long)bh * K + r) * V + v0 + col + c] = S[j][c];
  }
}

template <typename T, bool STRICT, int COLS>
cudaError_t launch_cols(const void* q, const void* k, const void* v, const void* w,
                        const void* bonus, const void* s0, void* out, void* sf, int B, int H,
                        int L, int K, int V, const Strides* st, cudaStream_t stream) {
  const long long blocks = (long long)B * H * ((V + GROUPS * COLS - 1) / (GROUPS * COLS));
  ssm_scan_kernel<T, STRICT, COLS><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(bonus),
      static_cast<const float*>(s0), static_cast<T*>(out), static_cast<float*>(sf), H, L, K,
      V, st[0], st[1], st[2], st[3]);
  return cudaGetLastError();
}

// The 16-column slice when its grid fits in one wave of resident blocks on
// this card, else the 32-column slice (half the blocks).
template <typename T, bool STRICT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* w,
                   const void* bonus, const void* s0, void* out, void* sf, int B, int H,
                   int L, int K, int V, const Strides* st, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ssm_scan_kernel<T, STRICT, 1>, THREADS, 0);
  if (err != cudaSuccess) return err;
  const long long narrow = (long long)B * H * ((V + GROUPS - 1) / GROUPS);
  if (narrow <= (long long)per_sm * sms)
    return launch_cols<T, STRICT, 1>(q, k, v, w, bonus, s0, out, sf, B, H, L, K, V, st, stream);
  return launch_cols<T, STRICT, 2>(q, k, v, w, bonus, s0, out, sf, B, H, L, K, V, st, stream);
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
  if (K < 1 || K > KMAX || V < 1 || V > KMAX || L < 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool strict = bonus != nullptr;
  cudaError_t err;
  if (dtype == 0)
    err = strict ? launch<float, true>(q, k, v, w, bonus, s0, out, sf, B, H, L, K, V, st, s)
                 : launch<float, false>(q, k, v, w, bonus, s0, out, sf, B, H, L, K, V, st, s);
  else if (dtype == 1)
    err = strict ? launch<bf16, true>(q, k, v, w, bonus, s0, out, sf, B, H, L, K, V, st, s)
                 : launch<bf16, false>(q, k, v, w, bonus, s0, out, sf, B, H, L, K, V, st, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
