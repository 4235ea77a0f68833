// The backward of flash attention for Hopper (sm_90a), grouped-query layout.
//
// Replaces no TPU kernel: the JAX package never differentiates its Pallas
// flash_attention_kernel (src/repro/kernels/flash_attention/kernel.py:110);
// its training differentiates XLA attention (src/repro/models/layers.py,
// _sdpa_blockwise and _sdpa).  The port's forward is a hand-written kernel
// whose output carries no autograd graph, so its gradient is written here.
//
// With S = Q K^T, P = exp(S sm_scale - LSE) (LSE, the row's log-sum-exp,
// saved by the forward), O = P V and dO the output's gradient:
//
//   Delta = rowsum(dO * O)                     flash_bwd_delta_kernel
//   dV = P^T dO,  dK = dS^T Q sm_scale         flash_bwd_dkdv_kernel
//   dQ = dS K sm_scale,  dS = P (dP - Delta),  dP = dO V^T
//                                              flash_bwd_dq_kernel
//
// over the pairs (query row, key) that the forward's mask lets through:
// key < S, causal (key <= q_offset + t) and a window (key > q_offset + t -
// window).  Both of the last two kernels recompute S and dP for their own
// pairs, so neither writes a [T, S] tensor to device memory.
//
// No atomics.  dK and dV: one block per (key tile, kv head, batch) walks
// every query row that sees its keys, of each of the G query heads of its
// kv head, and writes its 32 keys' gradients once.  dQ: one block per
// (query tile, head, batch) walks every key tile its rows see and writes its
// 32 rows once.  Every sum runs in a fixed order, so a second call (a replay
// after a restore) gives the same bits.
//
// Bound on this card.  The backward does 5 products of 2 D operations per
// visible pair (S, dP, dV, dK, dQ) against reading q, k, v, o, dO and
// writing dq, dk, dv once: at qwen2-0.5b's train shape (B 4, T 1,024, 14 / 2
// heads, D 64, bf16, causal) 18.8 GFLOP against 14.7 MB, so operations bound
// it (0.019 ms on the bf16 tensor cores, 0.28 ms at the fp32 CUDA-core
// rate).  This first kernel is simple and right first: all products are
// fp32 FMAs on the CUDA cores (S and dP are computed twice, 7 products a
// pair in all), operands widened to fp32 in shared memory; the tensor
// cores, and a single pass with dQ kept apart, are later work.
//
// Tiles: 4 warps, 32 keys x 32 query rows.  In the pair phase lane j takes
// key j and warp w rows w, w + 4, ..., w + 28: each S and dP is a D-long dot
// product of a broadcast query row (float4 reads) and the lane's key row
// (rows padded by 4 floats, so the lanes' float4 reads hit distinct banks).
// P and dS go to shared memory ([32][33], conflict-free both ways).  In the
// accumulation phase lane j owns key j (dK, dV) or row j (dQ), and warp w
// owns columns [w D / 4, (w + 1) D / 4) of it, read as broadcasts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 32;                  // keys a tile: one a lane
constexpr int kRowsT = 32;                 // query rows a tile
constexpr int kRowsW = kRowsT / kWarps;    // rows a warp in the pair phase

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T: N values
template <typename T> struct Vec16 { static constexpr int N = 16 / sizeof(T); };

struct Args {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse; float* delta;
  void* dq; void* dk; void* dv;
  int t, s, h, kv, g, causal, window, q_offset;
  float sm_scale;
};

// Shared memory of the dK/dV and dQ kernels, in floats.
template <int D> struct Smem {
  static constexpr int kKS = D + 4;                     // padded key row
  static constexpr int kPS = kKeys + 1;                 // padded P / dS row
  static constexpr int kK = 0;                          // [kKeys][kKS]
  static constexpr int kV = kK + kKeys * kKS;           // [kKeys][kKS]
  static constexpr int kQ = kV + kKeys * kKS;           // [kRowsT][D]
  static constexpr int kDO = kQ + kRowsT * D;           // [kRowsT][D]
  static constexpr int kP = kDO + kRowsT * D;           // [kRowsT][kPS]
  static constexpr int kDS = kP + kRowsT * kPS;         // [kRowsT][kPS]
  static constexpr int kLse = kDS + kRowsT * kPS;       // [kRowsT]
  static constexpr int kDelta = kLse + kRowsT;          // [kRowsT]
  static constexpr int kFloats = kDelta + kRowsT;
  static constexpr int kBytes = kFloats * static_cast<int>(sizeof(float));
};

// Rows [0, rows) of a [*, D] operand into a [n][stride] fp32 tile, from row
// pointers src + r * row_stride (elements); rows past `valid` are zero.  16
// bytes a load (the wrapper passes rows 16-byte aligned).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          int64_t row_stride, int rows, int valid) {
  constexpr int VN = Vec16<T>::N;
  constexpr int SEG = D / VN;
  for (int e = threadIdx.x; e < rows * SEG; e += kThreads) {
    const int r = e / SEG, c = (e % SEG) * VN;
    float* out = dst + r * stride + c;
    if (r < valid) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      if constexpr (sizeof(T) == 4) {
        out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
        out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
      } else {
        const __nv_bfloat162* hh = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(hh[i]);
          out[2 * i] = f.x;
          out[2 * i + 1] = f.y;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) out[i] = 0.f;
    }
  }
}

// n consecutive floats (n a multiple of 4) stored as T at dst.
template <typename T, int N>
__device__ __forceinline__ void store_run(T* dst, const float (&x)[N], float mul) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = from_f<T>(x[i] * mul);
}

// Does query row t (position q_offset + t) see key `key`?
__device__ __forceinline__ bool visible(const Args& a, int t, int key) {
  const int pos = a.q_offset + t;
  return t < a.t && key < a.s && (!a.causal || key <= pos) &&
         (!a.window || key > pos - a.window);
}

// The pair phase: for the tile's rows w + 4 r and this lane's key j, P and
// dS into shared memory (0 where the pair is masked).  Rows [t0, t0 + 32),
// keys [k0, k0 + 32).
template <int D>
__device__ __forceinline__ void pair_phase(const Args& a, float* sm, int t0, int k0) {
  using L = Smem<D>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* kr = sm + L::kK + lane * L::kKS;
  const float* vr = sm + L::kV + lane * L::kKS;
  float sc[kRowsW], dp[kRowsW];
#pragma unroll
  for (int r = 0; r < kRowsW; ++r) sc[r] = dp[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 kf = *reinterpret_cast<const float4*>(kr + d);
    const float4 vf = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
    for (int r = 0; r < kRowsW; ++r) {
      const int i = warp + kWarps * r;
      const float4 qf = *reinterpret_cast<const float4*>(sm + L::kQ + i * D + d);
      const float4 of = *reinterpret_cast<const float4*>(sm + L::kDO + i * D + d);
      float s = sc[r], p = dp[r];
      s = fmaf(qf.x, kf.x, s); s = fmaf(qf.y, kf.y, s);
      s = fmaf(qf.z, kf.z, s); s = fmaf(qf.w, kf.w, s);
      p = fmaf(of.x, vf.x, p); p = fmaf(of.y, vf.y, p);
      p = fmaf(of.z, vf.z, p); p = fmaf(of.w, vf.w, p);
      sc[r] = s;
      dp[r] = p;
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsW; ++r) {
    const int i = warp + kWarps * r;
    const float lse = sm[L::kLse + i];
    float p = 0.f;
    if (visible(a, t0 + i, k0 + lane) && lse > -INFINITY)
      p = expf(fmaf(sc[r], a.sm_scale, -lse));
    sm[L::kP + i * L::kPS + lane] = p;
    sm[L::kDS + i * L::kPS + lane] = p * (dp[r] - sm[L::kDelta + i]);
  }
}

// Query rows [t0, t0 + 32) of head h, batch b: Q, dO, LSE and Delta into
// shared memory (rows past T: zero, LSE -inf, so they see no key).
template <typename T, int D>
__device__ __forceinline__ void load_rows(const Args& a, float* sm, int64_t b, int h,
                                          int t0) {
  using L = Smem<D>;
  const int valid = min(kRowsT, a.t - t0);
  const int64_t row_stride = static_cast<int64_t>(a.h) * D;
  const int64_t base = ((b * a.t + t0) * a.h + h) * D;
  load_tile<T, D>(sm + L::kQ, D, static_cast<const T*>(a.q) + base, row_stride,
                  kRowsT, valid);
  load_tile<T, D>(sm + L::kDO, D, static_cast<const T*>(a.dout) + base, row_stride,
                  kRowsT, valid);
  for (int i = threadIdx.x; i < kRowsT; i += kThreads) {
    const int64_t at = (b * a.h + h) * a.t + t0 + i;
    sm[L::kLse + i] = i < valid ? a.lse[at] : -INFINITY;
    sm[L::kDelta + i] = i < valid ? a.delta[at] : 0.f;
  }
}

// Keys [k0, k0 + 32) of kv head kvh, batch b: K and V into shared memory.
template <typename T, int D>
__device__ __forceinline__ void load_keys(const Args& a, float* sm, int64_t b, int kvh,
                                          int k0) {
  using L = Smem<D>;
  const int valid = min(kKeys, a.s - k0);
  const int64_t row_stride = static_cast<int64_t>(a.kv) * D;
  const int64_t base = ((b * a.s + k0) * a.kv + kvh) * D;
  load_tile<T, D>(sm + L::kK, L::kKS, static_cast<const T*>(a.k) + base, row_stride,
                  kKeys, valid);
  load_tile<T, D>(sm + L::kV, L::kKS, static_cast<const T*>(a.v) + base, row_stride,
                  kKeys, valid);
}

// Delta[b, h, t] = sum_d dO O, one warp a row; rows in o's memory order.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const Args a, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const T* o = static_cast<const T*>(a.o) + r * D;
  const T* dout = static_cast<const T*>(a.dout) + r * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(o[c]), to_f(dout[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t bt = r / a.h;          // b * T + t
    const int h = static_cast<int>(r % a.h);
    const int64_t b = bt / a.t, t = bt % a.t;
    a.delta[(b * a.h + h) * a.t + t] = acc;
  }
}

// Block (key tile, kv head, batch): dK and dV of 32 keys, summed over the G
// query heads of the kv head and every query tile that sees the keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const Args a) {
  using L = Smem<D>;
  constexpr int C = D / kWarps;              // columns a thread
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kKeys;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  load_keys<T, D>(a, sm, b, kvh, k0);

  // the query rows that see any of the keys
  const int k_last = min(a.s, k0 + kKeys) - 1;
  int t_begin = a.causal ? max(0, k0 - a.q_offset) : 0;
  int t_end = a.t;
  if (a.window) t_end = min(t_end, k_last + a.window - a.q_offset);
  t_begin = (t_begin / kRowsT) * kRowsT;

  float dk[C], dv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dk[c] = dv[c] = 0.f;
  const int c0 = warp * C;
  for (int g = 0; g < a.g; ++g) {
    const int h = kvh * a.g + g;
    for (int t0 = t_begin; t0 < t_end; t0 += kRowsT) {
      __syncthreads();   // the previous tile is consumed
      load_rows<T, D>(a, sm, b, h, t0);
      __syncthreads();
      pair_phase<D>(a, sm, t0, k0);
      __syncthreads();
      for (int i = 0; i < kRowsT; ++i) {
        const float p = sm[L::kP + i * L::kPS + lane];
        const float ds = sm[L::kDS + i * L::kPS + lane];
        const float* dor = sm + L::kDO + i * D + c0;
        const float* qr = sm + L::kQ + i * D + c0;
#pragma unroll
        for (int c = 0; c < C; c += 4) {
          const float4 of = *reinterpret_cast<const float4*>(dor + c);
          const float4 qf = *reinterpret_cast<const float4*>(qr + c);
          dv[c] = fmaf(p, of.x, dv[c]); dv[c + 1] = fmaf(p, of.y, dv[c + 1]);
          dv[c + 2] = fmaf(p, of.z, dv[c + 2]); dv[c + 3] = fmaf(p, of.w, dv[c + 3]);
          dk[c] = fmaf(ds, qf.x, dk[c]); dk[c + 1] = fmaf(ds, qf.y, dk[c + 1]);
          dk[c + 2] = fmaf(ds, qf.z, dk[c + 2]); dk[c + 3] = fmaf(ds, qf.w, dk[c + 3]);
        }
      }
    }
  }
  const int key = k0 + lane;
  if (key < a.s) {
    const int64_t at = ((b * a.s + key) * a.kv + kvh) * D + c0;
    store_run<T, C>(static_cast<T*>(a.dk) + at, dk, a.sm_scale);
    store_run<T, C>(static_cast<T*>(a.dv) + at, dv, 1.f);
  }
}

// Block (query tile, head, batch): dQ of 32 rows over every key tile they
// see; the last tiles (the longest rows under a causal mask) first.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args a) {
  using L = Smem<D>;
  constexpr int C = D / kWarps;
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * kRowsT;
  const int h = blockIdx.y, kvh = h / a.g;
  const int64_t b = blockIdx.z;
  load_rows<T, D>(a, sm, b, h, t0);

  const int pos_lo = a.q_offset + t0;
  const int pos_hi = a.q_offset + min(a.t, t0 + kRowsT) - 1;
  int k_end = a.s;
  if (a.causal) k_end = min(k_end, pos_hi + 1);
  int k_begin = a.window ? max(0, pos_lo - a.window + 1) : 0;
  k_begin = (k_begin / kKeys) * kKeys;

  float dq[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dq[c] = 0.f;
  const int c0 = warp * C;
  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();   // the previous key tile is consumed (and the rows loaded)
    load_keys<T, D>(a, sm, b, kvh, k0);
    __syncthreads();
    pair_phase<D>(a, sm, t0, k0);
    __syncthreads();
    const float* dsr = sm + L::kDS + lane * L::kPS;
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float ds = dsr[j];
      const float* kr = sm + L::kK + j * L::kKS + c0;
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 kf = *reinterpret_cast<const float4*>(kr + c);
        dq[c] = fmaf(ds, kf.x, dq[c]); dq[c + 1] = fmaf(ds, kf.y, dq[c + 1]);
        dq[c + 2] = fmaf(ds, kf.z, dq[c + 2]); dq[c + 3] = fmaf(ds, kf.w, dq[c + 3]);
      }
    }
  }
  const int t = t0 + lane;
  if (t < a.t)
    store_run<T, C>(static_cast<T*>(a.dq) + ((b * a.t + t) * a.h + h) * D + c0, dq,
                    a.sm_scale);
}

// Above 48 KB of dynamic shared memory a kernel must ask for it; asked once
// per instance and device.
template <typename T, int D>
cudaError_t prepare() {
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<D>::kBytes);
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

template <typename T, int D>
cudaError_t launch_typed(const Args& a, int b, cudaStream_t st) {
  cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(b) * a.t * a.h;
  const int64_t delta_blocks = (rows + kWarps - 1) / kWarps;
  if (delta_blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), kThreads, 0, st>>>(
      a, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3((a.s + kKeys - 1) / kKeys, a.kv, b), kThreads,
                                Smem<D>::kBytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3((a.t + kRowsT - 1) / kRowsT, a.h, b), kThreads,
                              Smem<D>::kBytes, st>>>(a);
  return cudaGetLastError();
}

// The one argument of flash_attention_bwd_launch, packed by the wrapper
// (ops._BWD_LAUNCH, "<11q10if4x"): addresses of q, k, v, o, dO (contiguous
// [B, T, H, D] and [B, S, KV, D], rows 16-byte aligned), LSE and the Delta
// workspace ([B, H, T] fp32), dq, dk, dv (contiguous, in q's type), the
// stream; then dtype (0 float32, 1 bfloat16), sizes, flags and the scale.
struct BwdLaunch {
  int64_t q, k, v, o, dout, lse, delta, dq, dk, dv, stream;
  int32_t dtype, b, t, s, h, kv, d, causal, window, q_offset;
  float sm_scale;
};
static_assert(sizeof(BwdLaunch) == 136, "ops._BWD_LAUNCH packs 136 bytes");

}  // namespace

// Launch the three kernels on a BwdLaunch packed at `packed` →
// cudaGetLastError() after the last launch (or the first failed one).
extern "C" int flash_attention_bwd_launch(const void* packed) {
  BwdLaunch p;
  memcpy(&p, packed, sizeof(p));
  if (p.b <= 0 || p.b > 65535 || p.t <= 0 || p.s <= 0 || p.kv <= 0 || p.h <= 0 ||
      p.h % p.kv != 0 || p.h > 65535 || p.window < 0)
    return cudaErrorInvalidValue;
  if ((p.q | p.k | p.v | p.o | p.dout | p.dq | p.dk | p.dv) & 15)
    return cudaErrorMisalignedAddress;
  Args a{reinterpret_cast<const void*>(p.q), reinterpret_cast<const void*>(p.k),
         reinterpret_cast<const void*>(p.v), reinterpret_cast<const void*>(p.o),
         reinterpret_cast<const void*>(p.dout), reinterpret_cast<const float*>(p.lse),
         reinterpret_cast<float*>(p.delta), reinterpret_cast<void*>(p.dq),
         reinterpret_cast<void*>(p.dk), reinterpret_cast<void*>(p.dv),
         p.t, p.s, p.h, p.kv, p.h / p.kv, p.causal, p.window, p.q_offset, p.sm_scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p.stream);
  if (p.dtype == 0 && p.d == 64) return launch_typed<float, 64>(a, p.b, st);
  if (p.dtype == 0 && p.d == 128) return launch_typed<float, 128>(a, p.b, st);
  if (p.dtype == 1 && p.d == 64) return launch_typed<__nv_bfloat16, 64>(a, p.b, st);
  if (p.dtype == 1 && p.d == 128) return launch_typed<__nv_bfloat16, 128>(a, p.b, st);
  return cudaErrorInvalidValue;
}

// out: {sizeof(BwdLaunch), keys a dK/dV block, query rows a dQ block}.
extern "C" int flash_attention_bwd_constants(int* out) {
  out[0] = static_cast<int>(sizeof(BwdLaunch));
  out[1] = kKeys;
  out[2] = kRowsT;
  return 0;
}

// out: {dynamic shared memory of a block in bytes, registers a thread of the
// dK/dV kernel, of the dQ kernel} for dtype (0 float32, 1 bfloat16) at head
// dim d.
namespace {
template <typename T, int D>
cudaError_t bwd_resources(int* out) {
  cudaFuncAttributes a1, a2;
  cudaError_t err = cudaFuncGetAttributes(&a1, flash_bwd_dkdv_kernel<T, D>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a2, flash_bwd_dq_kernel<T, D>);
  if (err != cudaSuccess) return err;
  out[0] = Smem<D>::kBytes;
  out[1] = a1.numRegs;
  out[2] = a2.numRegs;
  return cudaSuccess;
}
}  // namespace

extern "C" int flash_attention_bwd_resources(int dtype, int d, int* out) {
  if (dtype == 0 && d == 64) return bwd_resources<float, 64>(out);
  if (dtype == 0 && d == 128) return bwd_resources<float, 128>(out);
  if (dtype == 1 && d == 64) return bwd_resources<__nv_bfloat16, 64>(out);
  if (dtype == 1 && d == 128) return bwd_resources<__nv_bfloat16, 128>(out);
  return cudaErrorInvalidValue;
}
