// AdaLN-modulated RMSNorm for Hopper (sm_90a), f32 or bf16.
//
//   out[b, l, :] = x * rsqrt(mean(x^2) + eps) * (1 + scale[b]) + shift[b]
//
// math in f32, stored in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/adaln_rmsnorm.py::adaln_rmsnorm
// (body _kernel). The TPU version broadcasts scale and shift to (B*L, D)
// before the call and streams three row tiles; here a block reads the (B, D)
// modulation row of its batch row once, so no broadcast copy is ever written.
//
// What bounds it on the card: bytes. It does ~6 operations per element, far
// below the H100's ~295 per byte, and must move x in and out once: 2 * B*L*D
// * sizeof(T) bytes (plus the modulation once per batch row). At 3.35 TB/s
// and ~1 us of DRAM latency an SM needs ~25 KB in flight to keep its share
// of the bandwidth, and a served call is short (2-27 us of bytes), so a
// fixed cost per row, per block or per wave of blocks shows.
//
// What the design does about it:
//   * a row is loaded in one burst: each of its lanes holds V 16-byte
//     vectors of x in registers (V a template parameter, so the loops unroll
//     and all V loads are in flight at once: one DRAM round trip a row, not
//     one a vector). Neighbouring lanes take neighbouring vectors; lane j
//     takes vectors j, j + lanes, ..., masked past the row's end. A row of up
//     to 32 vectors takes the next power of two of lanes (D = 32..128), so a
//     warp holds 32 / lanes rows; a wider row takes all 32 lanes;
//   * x is read once: the sum of squares (per lane in order, then a
//     butterfly of shuffles over the row's lanes) and the epilogue both use
//     the registers. The packed row is passed through an empty asm after the
//     sum, so the compiler converts it again in the epilogue instead of
//     keeping an f32 copy of the row live, which for bf16 would take twice
//     the row's registers and cut the warps an SM holds;
//   * the modulation is read once per block: every block's rows lie in one
//     batch row (grid (blocks along L, B)), and the block stages scale[b] and
//     shift[b] into shared memory by 16-byte cp.async while its first x loads
//     are in flight; the epilogue reads them from there (lane j reads vectors
//     j + i * lanes: no bank conflicts);
//   * bytes in flight: every row of the call has its own warp (or group of
//     lanes), a block per group of rows, and a row's loads are all issued at
//     once. At L = 1101 every row is resident at once (~8 warps and ~25 KB of
//     x an SM at D = 1536 bf16); at the long shapes the registers bound
//     residency (58 a thread at V = 6, 79 at V = 12: 32 and 24 warps an SM),
//     far above 25 KB an SM. The body is a loop over groups with the grid's
//     stride, so any grid is right; the launch gives a block per group. Two
//     variants timed on an H100 while this kernel was designed were not
//     faster at every served shape, so neither is kept: the same pass
//     without the loop (fewer registers, more warps an SM), and persistent
//     blocks (as many as reside, each warp loading its next row while it
//     stores the current one). The host (kernels/adaln_rmsnorm.py::plan)
//     picks V, the lanes and the warps per block from the shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_WARPS = 8;           // warps per block, at most
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Where one thread's row is: its vectors, whether the row exists, and this
// lane's place in it.
struct RowAt {
  const uint4* x;
  uint4* out;
  bool live;
};

template <int V>
__device__ __forceinline__ void load_row(uint4 (&v)[V], const RowAt& r, int j, int lanes,
                                         int nvec) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = j + i * lanes;
    v[i] = (r.live && c < nvec) ? __ldg(r.x + c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The row's sum of squares over its lanes, r = rsqrt(sum / D + eps), and the
// modulated row stored. Every lane of the warp calls it (the shuffles).
template <typename T, int V>
__device__ __forceinline__ void norm_row(uint4 (&v)[V], const uint4* mod, const RowAt& r, int j,
                                         int lanes, int nvec, int D, float eps) {
  constexpr int N = 16 / sizeof(T);    // elements per 16-byte vector
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const T* e = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float f = to_f32(e[k]);
      ss += f * f;
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) ss += __shfl_xor_sync(FULL, ss, off);
#pragma unroll
  for (int i = 0; i < V; ++i)          // convert again below: no f32 copy stays live
    asm volatile("" : "+r"(v[i].x), "+r"(v[i].y), "+r"(v[i].z), "+r"(v[i].w));
  const float rs = rsqrtf(ss / (float)D + eps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = j + i * lanes;
    if (!r.live || c >= nvec) continue;
    const uint4 ms = mod[c];
    const uint4 mt = mod[nvec + c];
    const T* ex = reinterpret_cast<const T*>(&v[i]);
    const T* es = reinterpret_cast<const T*>(&ms);
    const T* et = reinterpret_cast<const T*>(&mt);
    uint4 res;
    T* er = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float xn = to_f32(ex[k]) * rs;
      er[k] = from_f32<T>(xn * (1.f + to_f32(es[k])) + to_f32(et[k]));
    }
    r.out[c] = res;
  }
}

// Block (blockIdx.x, b) takes the groups blockIdx.x, + gridDim.x, ... of
// batch row b (the launch gives a block per group); a group is blockDim.x /
// 32 warps x (32 >> lanes_log2) rows. Dynamic shared memory: the batch row's
// scale then shift, nvec 16-byte vectors each.
template <typename T, int V>
__global__ void __launch_bounds__(MAX_WARPS * 32)
adaln_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                     const T* __restrict__ shift, T* __restrict__ out, int L, int D,
                     long long scale_stride, long long shift_stride, float eps, int lanes_log2) {
  extern __shared__ uint4 mod[];
  const int nvec = D / (16 / (int)sizeof(T));
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x % 32;
  const int j = lane & (lanes - 1);
  const int rows_per_block = (blockDim.x / 32) << (5 - lanes_log2);
  const int in_block = (threadIdx.x / 32 << (5 - lanes_log2)) + (lane >> lanes_log2);
  const int groups = (L + rows_per_block - 1) / rows_per_block;
  const int step = gridDim.x;
  const int b = blockIdx.y;
  const long long row0 = (long long)b * L;
  auto at = [&](int g) {
    const int l = g * rows_per_block + in_block;
    const long long off = (row0 + l) * D;
    return RowAt{reinterpret_cast<const uint4*>(x + off), reinterpret_cast<uint4*>(out + off),
                 g < groups && l < L};
  };

  uint4 va[V];
  int g = blockIdx.x;
  load_row<V>(va, at(g), j, lanes, nvec);
  const uint4* sr = reinterpret_cast<const uint4*>(scale + b * scale_stride);
  const uint4* tr = reinterpret_cast<const uint4*>(shift + b * shift_stride);
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    cp_async16(mod + c, sr + c);
    cp_async16(mod + nvec + c, tr + c);
  }
  cp_async_wait_all();
  __syncthreads();
  for (;;) {
    norm_row<T, V>(va, mod, at(g), j, lanes, nvec, D, eps);
    g += step;
    if (g >= groups) break;
    load_row<V>(va, at(g), j, lanes, nvec);
  }
}

}  // namespace

// One signature's launch, filled once per signature by
// kernels/adaln_rmsnorm.py (_Launch, from its plan): B, L, D of x; vectors
// per lane (V), log2 of the lanes per row, warps per block; the modulation
// rows' strides in elements; eps; dtype 0 = float32, 1 = bfloat16.
struct AdalnLaunch {
  int B, L, D, vectors, lanes_log2, warps;
  long long scale_stride, shift_stride;
  float eps;
  int dtype;
};

namespace {

template <typename T, int V>
cudaError_t launch(const void* x, const void* scale, const void* shift, void* out,
                   const AdalnLaunch& p, cudaStream_t stream) {
  const int rows_per_block = p.warps << (5 - p.lanes_log2);
  const dim3 grid((p.L + rows_per_block - 1) / rows_per_block, p.B);
  const size_t smem = 2 * (size_t)p.D * sizeof(T);
  adaln_rmsnorm_kernel<T, V><<<grid, p.warps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(shift),
      static_cast<T*>(out), p.L, p.D, p.scale_stride, p.shift_stride, p.eps, p.lanes_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_v(const void* x, const void* scale, const void* shift, void* out,
                     const AdalnLaunch& p, cudaStream_t s) {
  switch (p.vectors) {        // VECTORS in kernels/adaln_rmsnorm.py
    case 1: return launch<T, 1>(x, scale, shift, out, p, s);
    case 2: return launch<T, 2>(x, scale, shift, out, p, s);
    case 4: return launch<T, 4>(x, scale, shift, out, p, s);
    case 6: return launch<T, 6>(x, scale, shift, out, p, s);
    case 8: return launch<T, 8>(x, scale, shift, out, p, s);
    case 12: return launch<T, 12>(x, scale, shift, out, p, s);
    case 16: return launch<T, 16>(x, scale, shift, out, p, s);
    case 24: return launch<T, 24>(x, scale, shift, out, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x/out: (B*L, D) contiguous; scale/shift: B rows of D contiguous elements,
// `*_stride` elements apart; every pointer 16-byte aligned and D a multiple of
// 16 bytes' worth of elements (the wrapper checks). Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_adaln_rmsnorm(const void* x, const void* scale, const void* shift,
                                   void* out, const AdalnLaunch* p, void* stream) {
  if (p->B <= 0 || p->L <= 0) return (int)cudaSuccess;
  if (p->warps < 1 || p->warps > MAX_WARPS || p->lanes_log2 < 0 || p->lanes_log2 > 5)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return (int)launch_v<float>(x, scale, shift, out, *p, s);
  if (p->dtype == 1) return (int)launch_v<bf16>(x, scale, shift, out, *p, s);
  return (int)cudaErrorInvalidValue;
}
