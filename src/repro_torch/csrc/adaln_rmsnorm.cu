// AdaLN-modulated RMSNorm for Hopper (sm_90a), f32 or bf16.
//
//   out[b, l, :] = x * rsqrt(mean(x^2) + eps) * (1 + scale[b]) + shift[b]
//
// math in f32, stored in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/adaln_rmsnorm.py::adaln_rmsnorm
// (body _kernel). The TPU version broadcasts scale and shift to (B*L, D)
// before the call and streams three row tiles; here each row reads its (B, D)
// modulation row by index row // L, so no broadcast copy is ever written.
//
// What bounds it on the card: bytes. It does ~5 operations per element and
// moves x in, out, and scale/shift once per batch row: about 2 * B*L*D *
// sizeof(T), i.e. it sits far below the H100's ~295 operations per byte.
//
// What the design does about it: one warp per row, 16-byte vector loads and
// stores with neighbouring lanes on neighbouring addresses, a warp-shuffle
// sum of squares, and no shared memory. The second pass re-reads the row,
// which the warp has just brought into L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;           // 8 rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
adaln_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                     const T* __restrict__ shift, T* __restrict__ out, int rows, int L, int D,
                     long long scale_stride, long long shift_stride, float eps) {
  constexpr int N = 16 / sizeof(T);    // elements per 16-byte vector
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int nvec = D / N;
  const T* xr = x + (long long)row * D;

  float ss = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + i * N);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float f = to_f32(e[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)D + eps);

  const int b = row / L;
  const T* sr = scale + b * scale_stride;
  const T* tr = shift + b * shift_stride;
  T* orow = out + (long long)row * D;
  for (int i = lane; i < nvec; i += 32) {
    const uint4 rx = *reinterpret_cast<const uint4*>(xr + i * N);
    const uint4 rs = *reinterpret_cast<const uint4*>(sr + i * N);
    const uint4 rt = *reinterpret_cast<const uint4*>(tr + i * N);
    const T* ex = reinterpret_cast<const T*>(&rx);
    const T* es = reinterpret_cast<const T*>(&rs);
    const T* et = reinterpret_cast<const T*>(&rt);
    __align__(16) T res[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xn = to_f32(ex[j]) * r;
      res[j] = from_f32<T>(xn * (1.f + to_f32(es[j])) + to_f32(et[j]));
    }
    *reinterpret_cast<uint4*>(orow + i * N) = *reinterpret_cast<const uint4*>(res);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* shift, void* out, int rows,
                   int L, int D, long long scale_stride, long long shift_stride, float eps,
                   cudaStream_t stream) {
  const int rows_per_block = THREADS / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  adaln_rmsnorm_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(shift),
      static_cast<T*>(out), rows, L, D, scale_stride, shift_stride, eps);
  return cudaGetLastError();
}

}  // namespace

// x/out: (rows = B*L, D) contiguous; scale/shift: B rows of D contiguous
// elements, `*_stride` elements apart. dtype: 0 = float32, 1 = bfloat16.
// D must be a multiple of 16 bytes' worth of elements.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_adaln_rmsnorm(const void* x, const void* scale, const void* shift,
                                   void* out, int rows, int L, int D, long long scale_stride,
                                   long long shift_stride, float eps, int dtype, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, scale, shift, out, rows, L, D, scale_stride, shift_stride, eps, s);
  else if (dtype == 1)
    err = launch<bf16>(x, scale, shift, out, rows, L, D, scale_stride, shift_stride, eps, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
