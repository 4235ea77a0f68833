// The backward of RMSNorm for Hopper (sm_90a): with y = x r s, r =
// rsqrt(mean(x^2) + eps) and g = dL/dy over rows of D elements,
//
//   dx = r (g s - x r^2 mean(g s x))      per row
//   dscale = sum over rows of g x r       per column
//
// Replaces no TPU kernel: the JAX package never differentiates its Pallas
// rmsnorm_kernel (src/repro/kernels/rmsnorm/kernel.py:29); its training
// differentiates the XLA norm (src/repro/models/layers.py, apply_norm).  The
// port's forward is a hand-written kernel whose output carries no autograd
// graph, so its gradient is written here.
//
// Bound on this card: bytes.  x and g are read once and dx written once
// (3 N D sizeof(x) bytes, plus the scale and dscale), a few operations an
// element; at qwen2-0.5b's train shape ([4,096, 896] bf16) 22 MB, 0.0066 ms
// at 3.35 TB/s.
//
// Design, simple first: every element in fp32, one element an access
// (columns c, c + 32, ... of a row to lane c of a warp, or c, c + threads,
// ... to thread c of a block), so any D and alignment take the same code.
//
//   warp   D <= 1,024: rmsnorm_bwd_warp_kernel, 8 warps a block, a warp a
//          row; the row's two sums by xor shuffles.  Block i takes rows i 8
//          + w, i 8 + w + 8 blocks, ...: a fixed set for the grid the
//          wrapper picks from N alone.
//   block  1,024 < D <= 8,192: rmsnorm_bwd_block_kernel, a block a row of
//          ceil(D / 1,024) warps (as the forward's block route); block i
//          takes rows i, i + blocks, ...; warp sums meet in shared memory in
//          warp order.
//
// dscale without atomics: each thread keeps its columns' sums over its rows
// in registers; a block writes one row of partial sums [blocks, D] (the
// warp route adds its 8 warps' in warp order first), and
// rmsnorm_bwd_dscale_kernel adds the partials of each column in block order.
// Every sum runs in a fixed order for a given (N, D, dtype), so a second
// call gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kElems = 32;                 // elements of a row a thread holds at most
constexpr int kWarpMaxD = 32 * kElems;     // the warp route's widest row
constexpr int kMaxThreads = 256;           // the block route's most threads
constexpr int kMaxD = kMaxThreads * kElems;
constexpr int kWarpRows = 8;               // warps (rows at a time) a warp-route block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One row: this thread's elements of x, g (columns first, first + stride,
// ...) and the scale, and its partial sums of x^2 and g s x in column order.
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ x, const T* __restrict__ g,
                                         const float (&s)[kElems], int d, int first,
                                         int stride, float (&xf)[kElems],
                                         float (&gf)[kElems], float& ss, float& gsx) {
  ss = 0.f;
  gsx = 0.f;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int c = first + e * stride;
    xf[e] = c < d ? to_f(x[c]) : 0.f;
    gf[e] = c < d ? to_f(g[c]) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    ss = fmaf(xf[e], xf[e], ss);
    gsx = fmaf(gf[e] * s[e], xf[e], gsx);
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ dx, const float (&s)[kElems],
                                          const float (&xf)[kElems],
                                          const float (&gf)[kElems],
                                          float (&acc)[kElems], int d, int first,
                                          int stride, float r, float mean_gsx) {
  const float k = r * r * mean_gsx;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int c = first + e * stride;
    if (c < d) {
      dx[c] = from_f<T>(r * (gf[e] * s[e] - xf[e] * k));
      acc[e] = fmaf(gf[e] * xf[e], r, acc[e]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpRows)
rmsnorm_bwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const T* __restrict__ g, T* __restrict__ dx,
                        float* __restrict__ partial, int64_t n, int d, float eps) {
  __shared__ float red[kWarpRows][kWarpMaxD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s[kElems], acc[kElems], xf[kElems], gf[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int c = lane + 32 * e;
    s[e] = c < d ? scale[c] : 0.f;
    acc[e] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(d);
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpRows + warp; row < n;
       row += static_cast<int64_t>(gridDim.x) * kWarpRows) {
    float ss, gsx;
    load_row<T>(x + row * d, g + row * d, s, d, lane, 32, xf, gf, ss, gsx);
    ss = warp_sum(ss);
    gsx = warp_sum(gsx);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    store_row<T>(dx + row * d, s, xf, gf, acc, d, lane, 32, r, gsx * inv_d);
  }
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int c = lane + 32 * e;
    if (c < d) red[warp][c] = acc[e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += 32 * kWarpRows) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpRows; ++w) sum += red[w][c];
    partial[static_cast<int64_t>(blockIdx.x) * d + c] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_block_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const T* __restrict__ g, T* __restrict__ dx,
                         float* __restrict__ partial, int64_t n, int d, float eps) {
  __shared__ float sums[2][kMaxThreads / 32];
  const int tid = threadIdx.x, threads = blockDim.x, warps = threads >> 5;
  float s[kElems], acc[kElems], xf[kElems], gf[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int c = tid + threads * e;
    s[e] = c < d ? scale[c] : 0.f;
    acc[e] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(d);
  for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
    float ss, gsx;
    load_row<T>(x + row * d, g + row * d, s, d, tid, threads, xf, gf, ss, gsx);
    ss = warp_sum(ss);
    gsx = warp_sum(gsx);
    __syncthreads();   // the previous row's sums are read
    if ((tid & 31) == 0) {
      sums[0][tid >> 5] = ss;
      sums[1][tid >> 5] = gsx;
    }
    __syncthreads();
    float tss = 0.f, tgsx = 0.f;
    for (int w = 0; w < warps; ++w) {
      tss += sums[0][w];
      tgsx += sums[1][w];
    }
    const float r = rsqrtf(tss / static_cast<float>(d) + eps);
    store_row<T>(dx + row * d, s, xf, gf, acc, d, tid, threads, r, tgsx * inv_d);
  }
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int c = tid + threads * e;
    if (c < d) partial[static_cast<int64_t>(blockIdx.x) * d + c] = acc[e];
  }
}

// dscale[c] = sum over blocks of partial[block][c], in block order.
__global__ void __launch_bounds__(256)
rmsnorm_bwd_dscale_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                          int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float sum = 0.f;
  for (int i = 0; i < blocks; ++i) sum += partial[static_cast<int64_t>(i) * d + c];
  dscale[c] = sum;
}

// What ops._BWD_LAUNCH packs: addresses of x, scale (f32 [D]), g, dx, the
// partial sums [blocks, D] (f32 workspace) and dscale (f32 [D]), the stream
// and the row count; dtype (0 float32, 1 bfloat16), route (0 warp, 1 block),
// threads a block, blocks, D; eps.
struct BwdLaunch {
  int64_t x, scale, g, dx, partial, dscale, stream, n;
  int32_t dtype, route, threads, blocks, d;
  float eps;
};
static_assert(sizeof(BwdLaunch) == 88, "ops._BWD_LAUNCH packs 88 bytes");

template <typename T>
cudaError_t launch_typed(const BwdLaunch& p) {
  const T* x = reinterpret_cast<const T*>(p.x);
  const float* s = reinterpret_cast<const float*>(p.scale);
  const T* g = reinterpret_cast<const T*>(p.g);
  T* dx = reinterpret_cast<T*>(p.dx);
  float* part = reinterpret_cast<float*>(p.partial);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p.stream);
  if (p.route == 0)
    rmsnorm_bwd_warp_kernel<T><<<p.blocks, 32 * kWarpRows, 0, st>>>(x, s, g, dx, part,
                                                                     p.n, p.d, p.eps);
  else
    rmsnorm_bwd_block_kernel<T><<<p.blocks, p.threads, 0, st>>>(x, s, g, dx, part, p.n,
                                                                p.d, p.eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dscale_kernel<<<(p.d + 255) / 256, 256, 0, st>>>(
      part, reinterpret_cast<float*>(p.dscale), p.blocks, p.d);
  return cudaGetLastError();
}

bool plan_ok(const BwdLaunch& p) {
  if (p.dtype != 0 && p.dtype != 1) return false;
  if (p.n <= 0 || p.d <= 0 || p.d > kMaxD || p.blocks <= 0) return false;
  if (p.route == 0) return p.d <= kWarpMaxD && p.threads == 32 * kWarpRows;
  if (p.route == 1)
    return p.threads % 32 == 0 && p.threads >= 32 && p.threads <= kMaxThreads &&
           static_cast<int64_t>(p.threads) * kElems >= p.d;
  return false;
}

}  // namespace

// Launch the backward on a BwdLaunch packed at `packed` → cudaGetLastError()
// after the last launch; cudaErrorInvalidValue for a plan it does not take.
extern "C" int rmsnorm_bwd_launch(const void* packed) {
  BwdLaunch p;
  memcpy(&p, packed, sizeof(p));
  if (!plan_ok(p)) return cudaErrorInvalidValue;
  if (p.dtype == 0) return launch_typed<float>(p);
  return launch_typed<__nv_bfloat16>(p);
}

// out: {sizeof(BwdLaunch), elements a thread holds, widest D, warps a
// warp-route block, most threads a block of the block route}.
extern "C" int rmsnorm_bwd_constants(int* out) {
  out[0] = static_cast<int>(sizeof(BwdLaunch));
  out[1] = kElems;
  out[2] = kMaxD;
  out[3] = kWarpRows;
  out[4] = kMaxThreads;
  return 0;
}
