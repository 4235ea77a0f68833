// RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (rmsnorm_kernel, pallas_call at :29), which reduces the mean square of a
// [block_rows, D] VMEM tile in fp32 and scales it in the same pass.
//
// Bound on this card: bytes.  Each element of x is read once and each
// output written once (2*N*D*sizeof(x) + 4*D bytes over 3.35 TB/s); the
// arithmetic is a few operations per element.  In decode N is the number of
// slots (4 rows of 896), so the work is nanoseconds and the launch is the
// cost.
//
// Design: one block of 128 threads per row.  Each thread loads its
// elements (d = tid, tid + 128, ...) once into registers (at most ITEMS of
// them; the wrapper picks ITEMS from D), sums their squares in fp32 in that
// order, and the block reduces the 128 partial sums by a fixed xor-shuffle
// tree inside each warp and then the four warp sums in a fixed order, so
// every run gives the same bits.  The scale pass uses the registers, so x
// is read from device memory once.  Everything is fp32; the result is cast
// once to x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int ITEMS>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[kWarps];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;

  float v[ITEMS];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = i * kThreads + tid;
    v[i] = j < d ? to_f(xr[j]) : 0.f;
    ss = fmaf(v[i], v[i], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = i * kThreads + tid;
    if (j < d) outr[j] = from_f<T>(v[i] * inv * scale[j]);
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* scale, void* out,
                         int64_t n, int d, float eps, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int items = (d + kThreads - 1) / kThreads;
  if (items <= 8)
    rmsnorm_kernel<T, 8><<<grid, kThreads, 0, stream>>>(xt, scale, ot, d, eps);
  else if (items <= 16)
    rmsnorm_kernel<T, 16><<<grid, kThreads, 0, stream>>>(xt, scale, ot, d, eps);
  else if (items <= 32)
    rmsnorm_kernel<T, 32><<<grid, kThreads, 0, stream>>>(xt, scale, ot, d, eps);
  else if (items <= 64)
    rmsnorm_kernel<T, 64><<<grid, kThreads, 0, stream>>>(xt, scale, ot, d, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  x and out are contiguous [n, d]; scale is
// float32 [d].  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(int dtype, const void* x, const void* scale,
                              void* out, int64_t n, int d, float eps,
                              void* stream) {
  if (n <= 0 || n > 2147483647LL || d <= 0) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(x, s, out, n, d, eps, st);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(x, s, out, n, d, eps, st);
  return cudaErrorInvalidValue;
}
