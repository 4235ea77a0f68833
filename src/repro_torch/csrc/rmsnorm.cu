// RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (rmsnorm_kernel, pallas_call at :29), which reduces the mean square of a
// [block_rows, D] VMEM tile in fp32 and scales it in the same pass.
//
// Bound on this card: bytes.  Each element of x is read once and each
// output written once (2*N*D*sizeof(x) + 4*D bytes over 3.35 TB/s); the
// arithmetic is a few operations per element.  At decode N is the number
// of slots (4 rows), so the work is nanoseconds and the launch and the
// wrapper's host time are the cost.
//
// Design.  A thread holds up to 32 elements of its row in registers, as
// they were loaded (raw bf16 or f32), so x is read from device memory once,
// and their scale values in fp32, loaded with x before the reduction so
// that the scale's round trip to L2 overlaps x's instead of following the
// sum (at decode, a few rows, that round trip is most of the kernel).
// x, out and scale move in 16-byte vectors (8 bf16 or 4 f32; the f32 scale
// as float4) when D is a multiple of the vector width and x, out and scale
// are 16-byte aligned; otherwise the same kernels run at a width of one
// element.  Two routes, chosen by the wrapper's ops._plan from (dtype, D,
// alignment) alone and passed in the launch:
//
//   warp   D <= 1024 (32 lanes x 32 elements): a warp a row, 4 rows a
//          block; the row's sum is reduced by xor shuffles inside its
//          warp, with no shared memory and no barrier.  qwen2-0.5b's
//          D 896 (112 bf16 vectors, 3-4 a lane).
//   block  1024 < D <= 8192: a block a row of ceil(D / 1024) warps
//          (32-256 threads), so a thread holds at most 4 bf16 vectors, 8
//          f32 vectors or 32 elements; the warp sums meet in shared memory.
//          mamba2-2.7b's D 2560 (3 warps) and 5120 (5 warps).
//
// Vector j of a row (j counts vectors) sits with lane or thread j % T,
// T the threads of the row.  Reduction order, fixed by (D, dtype, route):
// each thread sums the squares of its vectors in order of j and of the
// elements within each, in fp32 with fma; a xor-shuffle tree over offsets
// 16, 8, 4, 2, 1 leaves the warp's sum in every lane (a + b = b + a, so
// every lane has the same bits); the block route then adds the warp sums
// in warp order, from 0.  N, the grid and timing never enter it, so a
// second call gives the same bits.  Everything is fp32; the result is
// (x * inv) * scale, cast once to x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kElems = 32;       // elements of a row a thread holds at most
constexpr int kWarpMaxD = 32 * kElems;
constexpr int kMaxThreads = 256;  // block route: 8192 / kElems
constexpr int kMaxRows = 4;       // warp route: rows (warps) a block
constexpr int kMaxD = kMaxThreads * kElems;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// V elements of T moved by one access (16 bytes when V > 1).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// The V scale values of vector j, as float4 loads where V is a multiple of 4.
template <int V>
__device__ __forceinline__ void load_scale(const float* __restrict__ scale,
                                           int j, float (&s)[V]) {
  if constexpr (V % 4 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(scale) + j * (V / 4);
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 f = s4[k];
      s[4 * k] = f.x;
      s[4 * k + 1] = f.y;
      s[4 * k + 2] = f.z;
      s[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = scale[j * V + k];
  }
}

// Load vectors first, first + stride, ... (< nv) of a row into p and their
// scale values into s, all before the reduction, so that the scale's trip
// to L2 overlaps x's instead of following the sum; return the thread's sum
// of squares, in order of vector and element.
template <typename T, int V, int ITEMS>
__device__ __forceinline__ float load_row(const Vec<T, V>* __restrict__ xr,
                                          const float* __restrict__ scale,
                                          int nv, int first, int stride,
                                          Vec<T, V> (&p)[ITEMS],
                                          float (&s)[ITEMS][V]) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = first + i * stride;
    if (j < nv) {
      p[i] = xr[j];
      load_scale<V>(scale, j, s[i]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (first + i * stride < nv) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f(p[i].v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  return ss;
}

template <typename T, int V, int ITEMS>
__device__ __forceinline__ void store_row(Vec<T, V>* __restrict__ outr,
                                          int nv, int first, int stride,
                                          const Vec<T, V> (&p)[ITEMS],
                                          const float (&s)[ITEMS][V],
                                          float inv) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = first + i * stride;
    if (j < nv) {
      Vec<T, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e)
        o.v[e] = from_f<T>(to_f(p[i].v[e]) * inv * s[i][e]);
      outr[j] = o;
    }
  }
}

__device__ __forceinline__ float warp_sum(float ss) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  return ss;
}

// Warp route: blockDim.x / 32 rows a block, one warp each.
template <typename T, int V>
__global__ void __launch_bounds__(32 * kMaxRows)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ out, int64_t n, int d, float eps) {
  constexpr int ITEMS = kElems / V;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp: this route has no block barrier
  const int nv = d / V;
  Vec<T, V> p[ITEMS];
  float s[ITEMS][V];
  const float ss = warp_sum(load_row<T, V, ITEMS>(
      reinterpret_cast<const Vec<T, V>*>(x + row * d), scale, nv, lane, 32, p,
      s));
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  store_row<T, V, ITEMS>(reinterpret_cast<Vec<T, V>*>(out + row * d), nv,
                         lane, 32, p, s, inv);
}

// Block route: one row a block of blockDim.x threads (a multiple of 32).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     T* __restrict__ out, int d, float eps) {
  constexpr int ITEMS = kElems / V;
  __shared__ float warp_sums[kMaxThreads / 32];
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int64_t row = blockIdx.x;
  const int nv = d / V;
  Vec<T, V> p[ITEMS];
  float s[ITEMS][V];
  const float ss = warp_sum(load_row<T, V, ITEMS>(
      reinterpret_cast<const Vec<T, V>*>(x + row * d), scale, nv, tid,
      threads, p, s));
  if ((tid & 31) == 0) warp_sums[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (threads >> 5); ++w) total += warp_sums[w];
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);
  store_row<T, V, ITEMS>(reinterpret_cast<Vec<T, V>*>(out + row * d), nv,
                         tid, threads, p, s, inv);
}

// What ops._LAUNCH packs: addresses, the stream and the row count, then
// dtype (0 float32, 1 bfloat16), vector width, route (0 warp, 1 block),
// threads a block, rows a block, D, eps (and 4 bytes of padding).
struct Launch {
  int64_t x, scale, out, stream, n;
  int32_t dtype, vec, route, threads, rows, d;
  float eps;
};
static_assert(sizeof(Launch) == 72, "ops._LAUNCH packs 72 bytes");

template <typename T, int V>
cudaError_t launch_typed(const Launch& p) {
  const T* x = reinterpret_cast<const T*>(p.x);
  const float* s = reinterpret_cast<const float*>(p.scale);
  T* o = reinterpret_cast<T*>(p.out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p.stream);
  if (p.route == 0) {
    const int64_t blocks = (p.n + p.rows - 1) / p.rows;
    rmsnorm_warp_kernel<T, V><<<static_cast<unsigned>(blocks), p.threads, 0, st>>>(
        x, s, o, p.n, p.d, p.eps);
  } else {
    rmsnorm_block_kernel<T, V><<<static_cast<unsigned>(p.n), p.threads, 0, st>>>(
        x, s, o, p.d, p.eps);
  }
  return cudaGetLastError();
}

// The plan is the wrapper's; here it is only checked against what the
// kernels need.
bool plan_ok(const Launch& p) {
  const int width = p.dtype == 0 ? 4 : 8;
  if (p.dtype != 0 && p.dtype != 1) return false;
  if (p.n <= 0 || p.d <= 0 || p.d > kMaxD) return false;
  if (p.vec != 1 && p.vec != width) return false;
  if (p.d % p.vec != 0) return false;
  if (p.route == 0)
    return p.d <= kWarpMaxD && p.rows >= 1 && p.rows <= kMaxRows &&
           p.threads == 32 * p.rows &&
           (p.n + p.rows - 1) / p.rows <= 2147483647LL;
  if (p.route == 1)
    return p.rows == 1 && p.threads % 32 == 0 && p.threads >= 32 &&
           p.threads <= kMaxThreads &&
           static_cast<int64_t>(p.threads) * kElems >= p.d &&
           p.n <= 2147483647LL;
  return false;
}

}  // namespace

// Launch the kernel on a Launch packed at `packed` → cudaGetLastError()
// after the launch; cudaErrorInvalidValue for a plan the kernels do not
// take, cudaErrorMisalignedAddress for a vector width on an unaligned
// pointer.
extern "C" int rmsnorm_launch(const void* packed) {
  Launch p;
  memcpy(&p, packed, sizeof(p));
  if (!plan_ok(p)) return cudaErrorInvalidValue;
  if (p.vec > 1 && ((p.x | p.scale | p.out) & 15)) return cudaErrorMisalignedAddress;
  if (p.dtype == 0)
    return p.vec == 1 ? launch_typed<float, 1>(p) : launch_typed<float, 4>(p);
  return p.vec == 1 ? launch_typed<__nv_bfloat16, 1>(p)
                    : launch_typed<__nv_bfloat16, 8>(p);
}

// out: {sizeof(Launch), elements a thread holds, widest D, most rows a
// block of the warp route, most threads a block of the block route}.
extern "C" int rmsnorm_constants(int* out) {
  out[0] = static_cast<int>(sizeof(Launch));
  out[1] = kElems;
  out[2] = kMaxD;
  out[3] = kMaxRows;
  out[4] = kMaxThreads;
  return 0;
}

namespace {

template <typename T, int V>
cudaError_t resources(int route, int threads, int* out) {
  cudaFuncAttributes a;
  cudaError_t rc = route == 0
                       ? cudaFuncGetAttributes(&a, rmsnorm_warp_kernel<T, V>)
                       : cudaFuncGetAttributes(&a, rmsnorm_block_kernel<T, V>);
  if (rc != cudaSuccess) return rc;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return route == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &out[2], rmsnorm_warp_kernel<T, V>, threads, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &out[2], rmsnorm_block_kernel<T, V>, threads, 0);
}

}  // namespace

// out: {registers a thread, local memory bytes a thread, blocks an SM holds
// at `threads` a block} of the instance for dtype (0 float32, 1 bfloat16),
// vector width vec and route (0 warp, 1 block).
extern "C" int rmsnorm_resources(int dtype, int vec, int route, int threads,
                                 int* out) {
  if (route != 0 && route != 1) return cudaErrorInvalidValue;
  if (dtype == 0 && vec == 1) return resources<float, 1>(route, threads, out);
  if (dtype == 0 && vec == 4) return resources<float, 4>(route, threads, out);
  if (dtype == 1 && vec == 1) return resources<__nv_bfloat16, 1>(route, threads, out);
  if (dtype == 1 && vec == 8) return resources<__nv_bfloat16, 8>(route, threads, out);
  return cudaErrorInvalidValue;
}
