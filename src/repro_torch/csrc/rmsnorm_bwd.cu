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
// Bound and design.  Bytes: x and g are read once and dx written once
// (3 N D sizeof(x) bytes, plus the scale and dscale), about ten operations
// an element; at qwen2-0.5b's train shape ([4,096, 896] bf16) 22 MB, 0.00658
// ms at 3.35 TB/s; at mamba2-2.7b's widths ([8,192, 2,560] and [8,192,
// 5,120] bf16) 126 and 252 MB.  So the kernel has to keep enough bytes in
// flight and spend few instructions an element:
//
// - 16-byte vectors.  x, g and dx move 8 bf16 or 4 f32 an access (the
//   forward's Vec<T, V> layout, and its float4 scale loads) where D is a
//   multiple of the width and x, g, dx and the scale are 16-byte aligned;
//   otherwise the same kernels run at one element an access (D 1,001, an
//   offset view).  Vector j of a row sits with lane (thread) j % T of the
//   row's T lanes (threads).
// - Rows in flight.  A thread keeps its x and g as the packed vectors it
//   loaded (16 registers each for 32 bf16) and converts at use; the scale
//   is read again from L1 at each use instead of being held; only the
//   thread's dscale sums over its rows stay in fp32 registers.  The block's
//   column sums meet in a [4, D] buffer (16 KB at most), not one row a warp.
// - dscale in parallel, in a fixed order, with no atomics.  A block writes
//   one row of partial sums (partial [blocks, D] f32), and
//   rmsnorm_bwd_dscale_kernel sums them: a block of 16 warps for each 32
//   columns, warp w adding partial rows w, w + 16, ... in order and the
//   warps' sums meeting in warp order.
//
// Routes, chosen by ops.bwd_plan from (dtype, N, D, alignment) alone:
//
//   warp   D <= 1,024: rmsnorm_bwd_warp_kernel, 8 warps a block, a warp a
//          row: block i takes rows i 8 + w, i 8 + w + 8 blocks, ...; the
//          row's two sums by xor shuffles.  The 8 warps' column sums meet
//          as ((w0 + w4) + (w2 + w6)) + ((w1 + w5) + (w3 + w7)), and warp 0
//          writes the block's partial row.  At most 264 blocks: two an SM
//          at the bf16 vector instance's 127 registers fill 132 SMs in
//          one wave.
//   block  1,024 < D <= 8,192: rmsnorm_bwd_block_kernel, a block a row of
//          ceil(D / 1,024) warps (as the forward's block route): block i
//          takes rows i, i + blocks, ...; a row's warp sums meet in shared
//          memory in warp order (two buffers by row parity, one barrier a
//          row); each column is one thread's, which writes it to the
//          block's partial row.  At most 1,980 warps: 15 an SM at 128
//          registers, one wave at D 2,560 (660 blocks of 3 warps) and
//          D 5,120 (396 of 5).
//
// The grid is min(the rows' blocks, the route's cap), a constant, so
// every sum (a thread's in order of vector and element, the shuffle tree,
// the warp and block orders) is fixed by (N, D, dtype, alignment): a second
// call gives the same bits.  Both means are a sum times 1/D, as the plain
// version's mean on the card.

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
constexpr int kWarpBlocks = 264;           // most blocks of a warp-route launch
constexpr int kBlockWarps = 1980;          // most warps of a block-route launch
constexpr int kReduceWarps = 16;           // warps of a dscale block (32 columns)

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

// The V scale values (or V column sums) of vector j, as float4 accesses
// where V is a multiple of 4.
template <int V>
__device__ __forceinline__ void load_f(const float* __restrict__ p, int j, float (&s)[V]) {
  if constexpr (V % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p) + j * (V / 4);
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 f = p4[k];
      s[4 * k] = f.x;
      s[4 * k + 1] = f.y;
      s[4 * k + 2] = f.z;
      s[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = p[j * V + k];
  }
}

template <int V>
__device__ __forceinline__ void store_f(float* __restrict__ p, int j, const float (&s)[V]) {
  if constexpr (V % 4 == 0) {
    float4* p4 = reinterpret_cast<float4*>(p) + j * (V / 4);
#pragma unroll
    for (int k = 0; k < V / 4; ++k)
      p4[k] = make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[j * V + k] = s[k];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// This thread's vectors first, first + stride, ... (< nv) of a row of x and
// of g, all loads issued before any is used.
template <typename T, int V, int ITEMS>
__device__ __forceinline__ void load_row(const Vec<T, V>* __restrict__ xr,
                                         const Vec<T, V>* __restrict__ gr, int nv,
                                         int first, int stride, Vec<T, V> (&xv)[ITEMS],
                                         Vec<T, V> (&gv)[ITEMS]) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = first + i * stride;
    if (j < nv) {
      xv[i] = xr[j];
      gv[i] = gr[j];
    }
  }
}

// This thread's sums of x^2 and of g s x over its vectors of the row, in
// order of vector and element.
template <typename T, int V, int ITEMS>
__device__ __forceinline__ void row_sums(const float* __restrict__ scale, int nv,
                                         int first, int stride,
                                         const Vec<T, V> (&xv)[ITEMS],
                                         const Vec<T, V> (&gv)[ITEMS], float& ss,
                                         float& gsx) {
  ss = 0.f;
  gsx = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = first + i * stride;
    if (j < nv) {
      float s[V];
      load_f<V>(scale, j, s);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xf = to_f(xv[i].v[e]);
        ss = fmaf(xf, xf, ss);
        gsx = fmaf(to_f(gv[i].v[e]) * s[e], xf, gsx);
      }
    }
  }
}

// dx = r (g s - x k) of this thread's vectors of the row, k = r^2 mean(g s
// x); g x r added to the thread's column sums.
template <typename T, int V, int ITEMS>
__device__ __forceinline__ void store_row(Vec<T, V>* __restrict__ dxr,
                                          const float* __restrict__ scale, int nv,
                                          int first, int stride,
                                          const Vec<T, V> (&xv)[ITEMS],
                                          const Vec<T, V> (&gv)[ITEMS], float r,
                                          float k, float (&acc)[ITEMS][V]) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = first + i * stride;
    if (j < nv) {
      float s[V];
      load_f<V>(scale, j, s);
      Vec<T, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xf = to_f(xv[i].v[e]), gf = to_f(gv[i].v[e]);
        o.v[e] = from_f<T>(r * (gf * s[e] - xf * k));
        acc[i][e] = fmaf(gf * xf, r, acc[i][e]);
      }
      dxr[j] = o;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(32 * kWarpRows, 2)
rmsnorm_bwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const T* __restrict__ g, T* __restrict__ dx,
                        float* __restrict__ partial, int64_t n, int d, float eps) {
  constexpr int ITEMS = kElems / V;
  __shared__ __align__(16) float buf[kWarpRows / 2][kWarpMaxD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = d / V;
  const float inv_d = 1.f / static_cast<float>(d);
  float acc[ITEMS][V];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpRows + warp; row < n;
       row += static_cast<int64_t>(gridDim.x) * kWarpRows) {
    Vec<T, V> xv[ITEMS], gv[ITEMS];
    load_row<T, V, ITEMS>(reinterpret_cast<const Vec<T, V>*>(x + row * d),
                          reinterpret_cast<const Vec<T, V>*>(g + row * d), nv, lane, 32,
                          xv, gv);
    float ss, gsx;
    row_sums<T, V, ITEMS>(scale, nv, lane, 32, xv, gv, ss, gsx);
    ss = warp_sum(ss);
    gsx = warp_sum(gsx);
    const float r = rsqrtf(ss * inv_d + eps);
    store_row<T, V, ITEMS>(reinterpret_cast<Vec<T, V>*>(dx + row * d), scale, nv, lane,
                           32, xv, gv, r, r * r * (gsx * inv_d), acc);
  }
  // The block's column sums, a tree over its warps: warps half..2 half - 1
  // hand theirs to warps 0..half - 1 through buf.
#pragma unroll
  for (int half = kWarpRows / 2; half > 0; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        if (lane + 32 * i < nv) store_f<V>(buf[warp - half], lane + 32 * i, acc[i]);
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if (lane + 32 * i < nv) {
          float o[V];
          load_f<V>(buf[warp], lane + 32 * i, o);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[i][e] += o[e];
        }
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
    float* out = partial + static_cast<int64_t>(blockIdx.x) * d;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (lane + 32 * i < nv) store_f<V>(out, lane + 32 * i, acc[i]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, 2)
rmsnorm_bwd_block_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const T* __restrict__ g, T* __restrict__ dx,
                         float* __restrict__ partial, int64_t n, int d, float eps) {
  constexpr int ITEMS = kElems / V;
  __shared__ float sums[2][2][kMaxThreads / 32];   // [row parity][x^2, g s x][warp]
  const int tid = threadIdx.x, threads = blockDim.x, warps = threads >> 5;
  const int nv = d / V;
  const float inv_d = 1.f / static_cast<float>(d);
  float acc[ITEMS][V];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
  int parity = 0;
  for (int64_t row = blockIdx.x; row < n; row += gridDim.x, parity ^= 1) {
    Vec<T, V> xv[ITEMS], gv[ITEMS];
    load_row<T, V, ITEMS>(reinterpret_cast<const Vec<T, V>*>(x + row * d),
                          reinterpret_cast<const Vec<T, V>*>(g + row * d), nv, tid,
                          threads, xv, gv);
    float ss, gsx;
    row_sums<T, V, ITEMS>(scale, nv, tid, threads, xv, gv, ss, gsx);
    ss = warp_sum(ss);
    gsx = warp_sum(gsx);
    // A row's sums go to the buffer of its parity: a warp writes row k + 2's
    // only after the barrier of row k + 1, which every warp passes after
    // reading row k's.
    if ((tid & 31) == 0) {
      sums[parity][0][tid >> 5] = ss;
      sums[parity][1][tid >> 5] = gsx;
    }
    __syncthreads();
    float tss = 0.f, tgsx = 0.f;
    for (int w = 0; w < warps; ++w) {
      tss += sums[parity][0][w];
      tgsx += sums[parity][1][w];
    }
    const float r = rsqrtf(tss * inv_d + eps);
    store_row<T, V, ITEMS>(reinterpret_cast<Vec<T, V>*>(dx + row * d), scale, nv, tid,
                           threads, xv, gv, r, r * r * (tgsx * inv_d), acc);
  }
  float* out = partial + static_cast<int64_t>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (tid + threads * i < nv) store_f<V>(out, tid + threads * i, acc[i]);
}

// dscale[c] = the sum over blocks of partial[block][c]: a block for each 32
// columns, warp w adding rows w, w + kReduceWarps, ... in order, then the
// warps' sums added in warp order.
__global__ void __launch_bounds__(32 * kReduceWarps)
rmsnorm_bwd_dscale_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                          int blocks, int d) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (c < d) {
#pragma unroll 16
    for (int i = warp; i < blocks; i += kReduceWarps)
      sum += partial[static_cast<int64_t>(i) * d + c];
  }
  sums[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && c < d) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) total += sums[w][lane];
    dscale[c] = total;
  }
}

// What ops._BWD_LAUNCH packs: addresses of x, scale (f32 [D]), g, dx, the
// partial sums [blocks, D] (f32 workspace) and dscale (f32 [D]), the stream
// and the row count; dtype (0 float32, 1 bfloat16), vector width, route (0
// warp, 1 block), threads a block, blocks, D; eps (and 4 bytes of padding).
struct BwdLaunch {
  int64_t x, scale, g, dx, partial, dscale, stream, n;
  int32_t dtype, vec, route, threads, blocks, d;
  float eps;
};
static_assert(sizeof(BwdLaunch) == 96, "ops._BWD_LAUNCH packs 96 bytes");

template <typename T, int V>
cudaError_t launch_typed(const BwdLaunch& p) {
  const T* x = reinterpret_cast<const T*>(p.x);
  const float* s = reinterpret_cast<const float*>(p.scale);
  const T* g = reinterpret_cast<const T*>(p.g);
  T* dx = reinterpret_cast<T*>(p.dx);
  float* part = reinterpret_cast<float*>(p.partial);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p.stream);
  if (p.route == 0)
    rmsnorm_bwd_warp_kernel<T, V><<<p.blocks, 32 * kWarpRows, 0, st>>>(x, s, g, dx, part,
                                                                        p.n, p.d, p.eps);
  else
    rmsnorm_bwd_block_kernel<T, V><<<p.blocks, p.threads, 0, st>>>(x, s, g, dx, part, p.n,
                                                                   p.d, p.eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dscale_kernel<<<(p.d + 31) / 32, 32 * kReduceWarps, 0, st>>>(
      part, reinterpret_cast<float*>(p.dscale), p.blocks, p.d);
  return cudaGetLastError();
}

// The plan is the wrapper's; here it is only checked against what the
// kernels need.
bool plan_ok(const BwdLaunch& p) {
  if (p.dtype != 0 && p.dtype != 1) return false;
  if (p.n <= 0 || p.d <= 0 || p.d > kMaxD || p.blocks <= 0) return false;
  if (p.vec != 1 && p.vec != (p.dtype == 0 ? 4 : 8)) return false;
  if (p.d % p.vec != 0) return false;
  if (p.route == 0)
    return p.d <= kWarpMaxD && p.threads == 32 * kWarpRows && p.blocks <= kWarpBlocks;
  if (p.route == 1)
    return p.threads % 32 == 0 && p.threads >= 32 && p.threads <= kMaxThreads &&
           static_cast<int64_t>(p.threads) * kElems >= p.d &&
           p.blocks <= kBlockWarps / (p.threads / 32);
  return false;
}

template <typename T, int V>
cudaError_t resources(int route, int threads, int* out) {
  const void* f = route == 0 ? reinterpret_cast<const void*>(rmsnorm_bwd_warp_kernel<T, V>)
                             : reinterpret_cast<const void*>(rmsnorm_bwd_block_kernel<T, V>);
  const void* kernels[2] = {f, reinterpret_cast<const void*>(rmsnorm_bwd_dscale_kernel)};
  const int block[2] = {threads, 32 * kReduceWarps};
  for (int k = 0; k < 2; ++k) {
    cudaFuncAttributes a;
    cudaError_t rc = cudaFuncGetAttributes(&a, kernels[k]);
    if (rc != cudaSuccess) return rc;
    out[4 * k] = a.numRegs;
    out[4 * k + 1] = static_cast<int>(a.localSizeBytes);
    out[4 * k + 2] = static_cast<int>(a.sharedSizeBytes);
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4 * k + 3], kernels[k],
                                                       block[k], 0);
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

}  // namespace

// Launch the backward on a BwdLaunch packed at `packed` → cudaGetLastError()
// after the last launch; cudaErrorInvalidValue for a plan the kernels do not
// take, cudaErrorMisalignedAddress for a vector width on an unaligned pointer.
extern "C" int rmsnorm_bwd_launch(const void* packed) {
  BwdLaunch p;
  memcpy(&p, packed, sizeof(p));
  if (!plan_ok(p)) return cudaErrorInvalidValue;
  if (p.vec > 1 && ((p.x | p.scale | p.g | p.dx | p.partial | p.dscale) & 15))
    return cudaErrorMisalignedAddress;
  if (p.dtype == 0)
    return p.vec == 1 ? launch_typed<float, 1>(p) : launch_typed<float, 4>(p);
  return p.vec == 1 ? launch_typed<__nv_bfloat16, 1>(p)
                    : launch_typed<__nv_bfloat16, 8>(p);
}

// out: {sizeof(BwdLaunch), elements a thread holds, widest D, warps a
// warp-route block, most threads a block of the block route, most blocks of
// a warp-route launch, most warps of a block-route launch, warps a dscale
// block}.
extern "C" int rmsnorm_bwd_constants(int* out) {
  out[0] = static_cast<int>(sizeof(BwdLaunch));
  out[1] = kElems;
  out[2] = kMaxD;
  out[3] = kWarpRows;
  out[4] = kMaxThreads;
  out[5] = kWarpBlocks;
  out[6] = kBlockWarps;
  out[7] = kReduceWarps;
  return 0;
}

// out: {registers a thread, local memory bytes a thread, static shared
// memory bytes a block, blocks an SM holds} of the row kernel for dtype (0
// float32, 1 bfloat16), vector width vec and route (0 warp, 1 block) at
// `threads` a block, then the same of the dscale kernel.
extern "C" int rmsnorm_bwd_resources(int dtype, int vec, int route, int threads,
                                     int* out) {
  if (route != 0 && route != 1) return cudaErrorInvalidValue;
  if (dtype == 0 && vec == 1) return resources<float, 1>(route, threads, out);
  if (dtype == 0 && vec == 4) return resources<float, 4>(route, threads, out);
  if (dtype == 1 && vec == 1) return resources<__nv_bfloat16, 1>(route, threads, out);
  if (dtype == 1 && vec == 8) return resources<__nv_bfloat16, 8>(route, threads, out);
  return cudaErrorInvalidValue;
}
