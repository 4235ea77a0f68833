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
//   Delta = rowsum(dO * O),  dP = dO V^T,  dS = P (dP - Delta),
//   dV = P^T dO,  dK = dS^T Q sm_scale,  dQ = dS K sm_scale
//
// over the pairs (query row, key) that the forward's mask lets through:
// key < S, causal (key <= q_offset + t) and a window (key > q_offset + t -
// window).  Neither route writes a [T, S] tensor to device memory.
//
// Two routes, chosen by the wrapper from (dtype, D) alone
// (kernels/flash_attention/ops.py, _bwd_route), never as a reaction to a
// failure:
//
//   fma  float32: flash_bwd_delta_kernel, flash_bwd_dkdv_kernel,
//        flash_bwd_dq_kernel, fp32 FMAs on the CUDA cores.  float32 stays
//        off the tensor cores because its tolerance of 2e-5 cannot be met
//        with bf16 products (as in the forward, flash_attention.cu).
//   mma  bf16 at D 64 and 128: flash_bwd_delta_kernel,
//        flash_bwd_dkdv_mma_kernel, flash_bwd_reduce_kernel,
//        flash_bwd_dq_mma_kernel, every product on mma.sync bf16 -> fp32.
//
// Both are one host call (flash_attention_bwd_launch): three device
// launches on the fma route, four on the mma route.  No atomics on either:
// every sum runs in a fixed order, so a second call (a replay after a
// restore) gives the same bits.
//
// Bound on this card.  The backward does 5 products of 2 D operations per
// visible pair (S, dP, dV, dK, dQ) against reading q, k, v, o, dO and
// writing dq, dk, dv once: at qwen2-0.5b's train shape (B 4, T 1,024, 14 / 2
// heads, D 64, bf16, causal) 18.8 GFLOP against 14.7 MB, so operations bound
// it (0.019 ms on the bf16 tensor cores).
//
// The fma route (the first kernels of this file; float32 only since the
// mma route).  dK and dV: one block per (32 keys, kv head, batch) walks every
// query row that sees its keys, of each of the G query heads of its kv
// head, and writes its keys' gradients once.  dQ: one block per (32 rows,
// head, batch) walks every key tile its rows see.  Both recompute S and dP
// (7 products a pair).  4 warps; in the pair phase lane j takes key j and
// warp w rows w, w + 4, ..., w + 28: each S and dP is a D-long dot product
// of a broadcast query row (float4 reads) and the lane's key row (rows
// padded by 4 floats, so the lanes' float4 reads hit distinct banks).  P
// and dS go to shared memory ([32][33], conflict-free both ways).  In the
// accumulation phase lane j owns key j (dK, dV) or row j (dQ), and warp w
// owns columns [w D / 4, (w + 1) D / 4) of it, read as broadcasts.
//
// The mma route.  The fma route ran the train shape in bf16 at 124-130x the
// bound (2.36-2.47 ms on an H100, PERF.md) for four causes, each met here:
//
//   1. No tensor cores: every product an fp32 FMA, operands widened to
//      fp32 in shared memory.  Here all products are mma.sync.m16n8k16 bf16
//      -> fp32 on bf16 tiles in rows padded by 16 bytes (the 8 rows of an
//      ldmatrix in 8 distinct bank groups), filled by cp.async.  A operands
//      by ldmatrix, B operands by ldmatrix (Q^T, dO^T, K^T, V^T: stored
//      row-major as the "col" operand wants) or ldmatrix.trans (Q, dO, K as
//      the B of dK, dV, dQ).  The C fragment of P^T, dS^T (dK/dV) or dS (dQ)
//      becomes the A fragment of the next product in registers, score tiles
//      2j and 2j + 1 making the k16 step j, as the forward does with P.
//   2. Few blocks with long serial walks: 256 blocks of 4 warps, each
//      walking G = 7 heads.  Here a dK/dV block is one (64 keys, query head,
//      batch): 16 x 14 x 4 = 896 blocks at the train shape, key tile 0 (the
//      longest causal walk) first.  Each writes its head's dK and dV
//      partials in fp32 to a workspace [B, S, H, D] (torch.empty by the
//      wrapper); flash_bwd_reduce_kernel then sums the G partials of each kv
//      head in head order, scales dK by sm_scale and writes dk, dv in bf16.
//   3. S and dP computed in both kernels: still so (S, dP, dV, dK in the
//      dK/dV kernel, S, dP, dQ in the dQ kernel: 7 products a pair against
//      the bound's 5), the price of no float atomics: dQ sums over keys, a
//      dK/dV block owns keys.
//   4. No overlap of loads and arithmetic: each tile loaded, synchronised,
//      computed, with P and dS through shared memory.  Here the next row
//      tile (dK/dV: Q, dO, LSE, Delta) or key tile (dQ: K, V) loads by
//      cp.async into the second of two buffers while this one is computed,
//      and P, dS stay in registers.
//
// dK/dV kernel: warp w owns keys k0 + 16 w .. + 15 and, for each row step
// of NQ query rows (64 at D 64, 32 at D 128), computes S^T = K Q^T and
// dP^T = V dO^T (16 keys x NQ rows), P^T = 2^(S^T sm_scale log2 e - LSE
// log2 e), dS^T = P^T (dP^T - Delta), then dV += P^T dO and dK += dS^T Q
// (16 keys x D, fp32 accumulators).  At D 64 the warp's K and V A fragments
// stay in registers for the whole walk; at D 128 they come from shared
// memory by ldmatrix at each use, and the row step is 32, so that the dK
// and dV accumulators (128 registers a lane) fit without spilling.
// dQ kernel: one block per (64 query rows, head, batch), the last (longest
// causal) tiles first; warp w owns 16 rows, holds their Q and dO A
// fragments, LSE and Delta, and for each key step of NK keys (64 at D 64,
// 32 at D 128) computes S = Q K^T, dP = dO V^T, P, dS = P (dP - Delta) and
// dQ += dS K; dQ is scaled by sm_scale and written once in bf16 through
// the warp's own rows of the Q tile, 16 bytes a lane.
//
// Masks.  A warp whose keys (dK/dV) or rows (dQ) see no pair of a tile
// skips it; only a tile that crosses the diagonal, the window's edge or
// (dQ) the end of S takes an element mask, and a masked P is 0.  Rows past
// T are zero in shared memory with LSE +inf, so their P is 2^-inf = 0 with
// no mask; keys past S are zero and their dK/dV rows never stored (dK/dV).
//
// Rounding.  S, P, dP and dS are fp32; P and dS are rounded to bf16 only
// as the A operand of a product, as the forward rounds P; accumulators,
// partials and Delta are fp32; dQ, dK, dV are rounded once to bf16.

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
  float* wk; float* wv;   // the mma route's dK, dV partials [B, S, H, D]
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

// ---- the mma route: bf16 on the tensor cores ---------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaKeys = 16 * kMmaWarps;   // keys a dK/dV block: 16 a warp
constexpr int kMmaRows = 16 * kMmaWarps;   // query rows a dQ block: 16 a warp
constexpr int kReduceThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct MmaBwd {
  // Row stride of the shared tiles in bf16: one 16-byte pad a row keeps
  // rows 16-byte aligned for cp.async and ldmatrix and puts the 8 rows of
  // an ldmatrix matrix in 8 distinct bank groups.
  static constexpr int kStride = D + 8;
  // query rows a dK/dV step and keys a dQ step
  static constexpr int kStep = D == 64 ? 64 : 32;
  // the dK/dV warps keep their K and V A fragments in registers
  static constexpr bool kHoldKV = D == 64;
  // dK/dV: K, V [kMmaKeys][S]; two buffers of Q, dO [kStep][S]; two of
  // LSE, Delta [kStep] (fp32)
  static constexpr int kDkdvSmem =
      2 * kStride * (2 * kMmaKeys + 4 * kStep) + 4 * 4 * kStep;
  // dQ: Q, dO [kMmaRows][S]; two buffers of K, V [kStep][S]
  static constexpr int kDqSmem = 2 * kStride * (2 * kMmaRows + 4 * kStep);
};

// PTX wrappers, the same as flash_attention.cu's (kept here: a build hashes
// this file alone).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of the
// i-th.  Plain: lane l gets row l/4, columns 2(l%4) and 2(l%4)+1 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// Transposed: lane l gets rows 2(l%4) and 2(l%4)+1 of column l/4.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// d[16x8] += a[16x16] b[16x8], bf16 operands, fp32 accumulators.  Lane l,
// g = l/4, t = l%4: a = {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..)}, b = {(k 2t..2t+1, n g), (k 2t+8.., n g)},
// d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the SFU, a subnormal result flushed to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Block (b h, y): keys [64 y, 64 y + 64) of kv head h / G, batch b, against
// the rows of query head h: that head's partial dK and dV of the keys into
// the workspace (fp32, unscaled).  Grid (B H, key tiles): key tile 0, the
// longest causal walk, first.  Warp w owns keys 16 w .. 16 w + 15 of the
// tile; lane l holds keys l/4 and l/4 + 8 of them in every C fragment.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const Args a) {
  using bf16 = __nv_bfloat16;
  using L = MmaBwd<D>;
  constexpr int S = L::kStride;
  constexpr int SEG = D / 8;         // 16-byte segments a row
  constexpr int KD = D / 16;         // k16 steps of S^T and dP^T
  constexpr int NQ = L::kStep;       // query rows a step
  constexpr int NR = NQ / 8;         // n8 tiles of S^T (rows)
  constexpr int ND = D / 8;          // n8 tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);          // [kMmaKeys][S]
  bf16* vs = ks + kMmaKeys * S;                          // [kMmaKeys][S]
  bf16* qs = vs + kMmaKeys * S;                          // [2][NQ][S]
  bf16* ds_ = qs + 2 * NQ * S;                           // [2][NQ][S] (dO)
  float* ls = reinterpret_cast<float*>(ds_ + 2 * NQ * S);  // [2][NQ] LSE
  float* dl = ls + 2 * NQ;                               // [2][NQ] Delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x % a.h;
  const int64_t b = blockIdx.x / a.h;
  const int kvh = h / a.g;
  const int k0 = blockIdx.y * kMmaKeys;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  // the query rows that see any of the keys
  const int k_last = min(a.s, k0 + kMmaKeys) - 1;
  int t_begin = a.causal ? max(0, k0 - a.q_offset) : 0;
  int t_end = a.t;
  if (a.window) t_end = min(t_end, k_last + a.window - a.q_offset);
  t_begin = (t_begin / NQ) * NQ;
  const int n_steps = t_end > t_begin ? (t_end - t_begin + NQ - 1) / NQ : 0;

  // rows [t0, t0 + NQ) of head h into buffer `buf`: rows past T are zero
  // with LSE +inf and Delta 0
  auto load_rows = [&](int t0, int buf) {
    bf16* qd = qs + buf * NQ * S;
    bf16* dd = ds_ + buf * NQ * S;
    for (int e = tid; e < NQ * SEG; e += kMmaThreads) {
      const int r = e / SEG, c = (e % SEG) * 8, t = t0 + r;
      if (t < a.t) {
        const int64_t at = ((b * a.t + t) * a.h + h) * D + c;
        cp_async16(qd + r * S + c, q + at);
        cp_async16(dd + r * S + c, dout + at);
      } else {
        *reinterpret_cast<uint4*>(qd + r * S + c) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dd + r * S + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (tid < NQ) {
      const int t = t0 + tid;
      if (t < a.t) {
        const int64_t at = (b * a.h + h) * a.t + t;
        cp_async4(ls + buf * NQ + tid, a.lse + at);
        cp_async4(dl + buf * NQ + tid, a.delta + at);
      } else {
        ls[buf * NQ + tid] = INFINITY;
        dl[buf * NQ + tid] = 0.f;
      }
    }
  };

  const int gr = lane >> 2, gc = 2 * (lane & 3);
  const int wk0 = k0 + warp * 16;        // the warp's first key
  const float scale = a.sm_scale * kLog2e;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  if (n_steps > 0) {   // K, V and the first row tile: one commit group
    const int64_t kstride = static_cast<int64_t>(a.kv) * D;
    const bf16* kg = static_cast<const bf16*>(a.k) + (b * a.s * a.kv + kvh) * D;
    const bf16* vg = static_cast<const bf16*>(a.v) + (b * a.s * a.kv + kvh) * D;
    for (int e = tid; e < kMmaKeys * SEG; e += kMmaThreads) {
      const int r = e / SEG, c = (e % SEG) * 8, key = k0 + r;
      if (key < a.s) {
        cp_async16(ks + r * S + c, kg + key * kstride + c);
        cp_async16(vs + r * S + c, vg + key * kstride + c);
      } else {
        *reinterpret_cast<uint4*>(ks + r * S + c) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vs + r * S + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    load_rows(t_begin, 0);
    cp_async_commit();
  }

  // the warp's K and V A fragments (held at D 64; else read at each use)
  uint32_t kf[L::kHoldKV ? KD : 1][4], vf[L::kHoldKV ? KD : 1][4];
  const bf16* ka = ks + (warp * 16 + (lane & 15)) * S + (lane >> 4) * 8;
  const bf16* va = vs + (warp * 16 + (lane & 15)) * S + (lane >> 4) * 8;

  for (int it = 0; it < n_steps; ++it) {
    const int t0 = t_begin + it * NQ;
    if (it + 1 < n_steps) {
      load_rows(t0 + NQ, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();   // this tile (and K, V) have arrived
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (L::kHoldKV) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_x4(kf[kk], ka + kk * 16);
          ldsm_x4(vf[kk], va + kk * 16);
        }
      }
    }
    const bf16* qt = qs + (it & 1) * NQ * S;
    const bf16* dt = ds_ + (it & 1) * NQ * S;
    const float* lt = ls + (it & 1) * NQ;
    const float* dlt = dl + (it & 1) * NQ;

    // does this warp see any pair of the step, and must it mask?
    const int pos_lo = a.q_offset + t0, pos_hi = pos_lo + NQ - 1;
    const bool seen = wk0 < a.s && !(a.causal && wk0 > pos_hi) &&
                      !(a.window && wk0 + 15 <= pos_lo - a.window);
    if (seen) {
      const bool masked = (a.causal && wk0 + 15 > pos_lo) ||
                          (a.window && wk0 <= pos_hi - a.window);

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x NQ rows
      float st[NR][4], dpt[NR][4];
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kx[4], vx[4];
        if constexpr (L::kHoldKV) {
#pragma unroll
          for (int e = 0; e < 4; ++e) { kx[e] = kf[kk][e]; vx[e] = vf[kk][e]; }
        } else {
          ldsm_x4(kx, ka + kk * 16);
          ldsm_x4(vx, va + kk * 16);
        }
#pragma unroll
        for (int jp = 0; jp < NR / 2; ++jp) {
          const int off = (jp * 16 + (lane & 7) + (lane >> 4) * 8) * S + kk * 16 +
                          ((lane >> 3) & 1) * 8;
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, qt + off);
          mma_bf16(st[2 * jp], kx, qb[0], qb[1]);
          mma_bf16(st[2 * jp + 1], kx, qb[2], qb[3]);
          ldsm_x4(ob, dt + off);
          mma_bf16(dpt[2 * jp], vx, ob[0], ob[1]);
          mma_bf16(dpt[2 * jp + 1], vx, ob[2], ob[3]);
        }
      }

      // P^T and dS^T in fp32, rounded to bf16 as A fragments: element e of
      // tile j is (key gr + 8 (e / 2), row 8 j + gc + e % 2)
      uint32_t pa[NR / 2][4], da[NR / 2][4];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int r = j * 8 + gc;
        const float2 lse = *reinterpret_cast<const float2*>(lt + r);
        const float2 del = *reinterpret_cast<const float2*>(dlt + r);
        const float base[2] = {lse.x * kLog2e, lse.y * kLog2e};
        const float dd[2] = {del.x, del.y};
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(st[j][e], scale, -base[e & 1]));
          if (masked) {
            const int key = wk0 + gr + (e >> 1) * 8, pos = pos_lo + r + (e & 1);
            if ((a.causal && key > pos) || (a.window && key <= pos - a.window))
              p[e] = 0.f;
          }
          ds[e] = p[e] * (dpt[j][e] - dd[e & 1]);
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        da[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO, dK += dS^T Q: the rows are the k dimension, dO and Q
      // the row-major B operands (ldmatrix.trans)
#pragma unroll
      for (int kk = 0; kk < NR / 2; ++kk) {
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          const int off = (kk * 16 + (lane & 15)) * S + dp * 16 + (lane >> 4) * 8;
          uint32_t ob[4], qb[4];
          ldsm_x4_t(ob, dt + off);
          mma_bf16(dv[2 * dp], pa[kk], ob[0], ob[1]);
          mma_bf16(dv[2 * dp + 1], pa[kk], ob[2], ob[3]);
          ldsm_x4_t(qb, qt + off);
          mma_bf16(dk[2 * dp], da[kk], qb[0], qb[1]);
          mma_bf16(dk[2 * dp + 1], da[kk], qb[2], qb[3]);
        }
      }
    }
    __syncthreads();   // the buffer is free for the step after next
  }

  // this head's partials of the warp's keys (zero where no row sees them)
  const int key0 = wk0 + gr, key1 = key0 + 8;
  float* wk = a.wk + ((b * a.s) * a.h + h) * D + gc;
  float* wv = a.wv + ((b * a.s) * a.h + h) * D + gc;
  const int64_t row = static_cast<int64_t>(a.h) * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (key0 < a.s) {
      *reinterpret_cast<float2*>(wk + key0 * row + n * 8) = make_float2(dk[n][0], dk[n][1]);
      *reinterpret_cast<float2*>(wv + key0 * row + n * 8) = make_float2(dv[n][0], dv[n][1]);
    }
    if (key1 < a.s) {
      *reinterpret_cast<float2*>(wk + key1 * row + n * 8) = make_float2(dk[n][2], dk[n][3]);
      *reinterpret_cast<float2*>(wv + key1 * row + n * 8) = make_float2(dv[n][2], dv[n][3]);
    }
  }
}

// dk = sm_scale sum_g wk[b, s, kvh G + g], dv = sum_g wv[...], the G query
// heads in order from 0, fp32, written once in bf16.  A thread owns 4
// consecutive columns of one (b, s, kv head) row.
template <int D>
__global__ void __launch_bounds__(kReduceThreads)
flash_bwd_reduce_kernel(const Args a, int64_t n) {
  constexpr int Q4 = D / 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % Q4) * 4;
  const int64_t row = i / Q4;                 // (b S + s) KV + kvh
  const int kvh = static_cast<int>(row % a.kv);
  const int64_t at = ((row / a.kv) * a.h + static_cast<int64_t>(kvh) * a.g) * D + c;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int g = 0; g < a.g; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(a.wk + at + g * D);
    const float4 y = *reinterpret_cast<const float4*>(a.wv + at + g * D);
    sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
    sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
  }
  uint2 uk, uv;
  uk.x = pack_bf16(sk.x * a.sm_scale, sk.y * a.sm_scale);
  uk.y = pack_bf16(sk.z * a.sm_scale, sk.w * a.sm_scale);
  uv.x = pack_bf16(sv.x, sv.y);
  uv.y = pack_bf16(sv.z, sv.w);
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.dk) + row * D + c) = uk;
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.dv) + row * D + c) = uv;
}

// Block (b h, y): query rows [64 tile, 64 tile + 64) of head h, batch b,
// tile = gridDim.y - 1 - y (the last, longest causal rows first).  Warp w
// owns rows 16 w .. 16 w + 15 of the tile; lane l holds rows l/4 and
// l/4 + 8 of them.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const Args a) {
  using bf16 = __nv_bfloat16;
  using L = MmaBwd<D>;
  constexpr int S = L::kStride;
  constexpr int SEG = D / 8;
  constexpr int KD = D / 16;         // k16 steps of S and dP
  constexpr int NK = L::kStep;       // keys a step
  constexpr int NT = NK / 8;         // n8 tiles of S (keys)
  constexpr int ND = D / 8;          // n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kMmaRows][S]
  bf16* os = qs + kMmaRows * S;                   // [kMmaRows][S] (dO)
  bf16* ks = os + kMmaRows * S;                   // [2][NK][S]
  bf16* vs = ks + 2 * NK * S;                     // [2][NK][S]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x % a.h;
  const int64_t b = blockIdx.x / a.h;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const int kvh = h / a.g;
  const int64_t kstride = static_cast<int64_t>(a.kv) * D;
  const bf16* kg = static_cast<const bf16*>(a.k) + (b * a.s * a.kv + kvh) * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + (b * a.s * a.kv + kvh) * D;

  // the block's key range: causal ends at its last row's diagonal, the
  // window begins at its first row's
  const int rows = min(kMmaRows, a.t - t0);
  const int pos_lo = a.q_offset + t0, pos_hi = pos_lo + rows - 1;
  int k_end = a.s;
  if (a.causal) k_end = min(k_end, pos_hi + 1);
  int k_begin = a.window ? max(0, pos_lo - a.window + 1) : 0;
  k_begin = (k_begin / NK) * NK;
  const int n_steps = k_end > k_begin ? (k_end - k_begin + NK - 1) / NK : 0;

  // keys [k0, k0 + NK) into buffer `buf`; keys past S are zero
  auto load_kv = [&](int k0, int buf) {
    bf16* kd = ks + buf * NK * S;
    bf16* vd = vs + buf * NK * S;
    for (int e = tid; e < NK * SEG; e += kMmaThreads) {
      const int r = e / SEG, c = (e % SEG) * 8, key = k0 + r;
      if (key < a.s) {
        cp_async16(kd + r * S + c, kg + key * kstride + c);
        cp_async16(vd + r * S + c, vg + key * kstride + c);
      } else {
        *reinterpret_cast<uint4*>(kd + r * S + c) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd + r * S + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  if (n_steps > 0) {   // Q, dO and the first key tile: one commit group
    const bf16* q = static_cast<const bf16*>(a.q);
    const bf16* dout = static_cast<const bf16*>(a.dout);
    for (int e = tid; e < kMmaRows * SEG; e += kMmaThreads) {
      const int r = e / SEG, c = (e % SEG) * 8;
      if (r < rows) {
        const int64_t at = ((b * a.t + t0 + r) * a.h + h) * D + c;
        cp_async16(qs + r * S + c, q + at);
        cp_async16(os + r * S + c, dout + at);
      } else {
        *reinterpret_cast<uint4*>(qs + r * S + c) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(os + r * S + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    load_kv(k_begin, 0);
    cp_async_commit();
  }

  const int gr = lane >> 2, gc = 2 * (lane & 3);
  const int wrow0 = warp * 16;
  const int wpos_lo = pos_lo + wrow0, wpos_hi = wpos_lo + 15;
  const int pos0 = wpos_lo + gr, pos1 = pos0 + 8;    // this lane's two rows
  const bool warp_live = wrow0 < rows;
  const float scale = a.sm_scale * kLog2e;
  // LSE log2 e and Delta of this lane's rows (rows past T: +inf, 0)
  float base[2], del[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + wrow0 + gr + 8 * i;
    const int64_t at = (b * a.h + h) * a.t + t;
    base[i] = t < a.t ? a.lse[at] * kLog2e : INFINITY;
    del[i] = t < a.t ? a.delta[at] : 0.f;
  }

  uint32_t qf[KD][4], of[KD][4];
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    const int k0 = k_begin + it * NK;
    if (it + 1 < n_steps) {
      load_kv(k0 + NK, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();   // this tile (and Q, dO) have arrived
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int off = (wrow0 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(qf[kk], qs + off);
        ldsm_x4(of[kk], os + off);
      }
    }
    const bf16* kt = ks + (it & 1) * NK * S;
    const bf16* vt = vs + (it & 1) * NK * S;

    const bool seen = warp_live && !(a.causal && k0 > wpos_hi) &&
                      !(a.window && k0 + NK - 1 <= wpos_lo - a.window);
    if (seen) {
      const bool masked = k0 + NK > a.s || (a.causal && k0 + NK - 1 > wpos_lo) ||
                          (a.window && k0 <= wpos_hi - a.window);

      // S = Q K^T and dP = dO V^T: 16 rows x NK keys
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          const int off = (jp * 16 + (lane & 7) + (lane >> 4) * 8) * S + kk * 16 +
                          ((lane >> 3) & 1) * 8;
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, kt + off);
          mma_bf16(sc[2 * jp], qf[kk], kb[0], kb[1]);
          mma_bf16(sc[2 * jp + 1], qf[kk], kb[2], kb[3]);
          ldsm_x4(vb, vt + off);
          mma_bf16(dp[2 * jp], of[kk], vb[0], vb[1]);
          mma_bf16(dp[2 * jp + 1], of[kk], vb[2], vb[3]);
        }
      }

      // dS = P (dP - Delta) in fp32, rounded to bf16 as the A fragment of
      // dS K: element e of tile j is (row gr + 8 (e / 2), key 8 j + gc + e % 2)
      uint32_t sa[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(sc[j][e], scale, -base[e >> 1]));
          if (masked) {
            const int key = k0 + j * 8 + gc + (e & 1);
            const int pos = e < 2 ? pos0 : pos1;
            if (key >= a.s || (a.causal && key > pos) ||
                (a.window && key <= pos - a.window))
              p = 0.f;
          }
          ds[e] = p * (dp[j][e] - del[e >> 1]);
        }
        sa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        sa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS K: the keys are the k dimension, K the row-major B operand
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
        for (int dd = 0; dd < ND / 2; ++dd) {
          uint32_t kb[4];
          ldsm_x4_t(kb, kt + (kk * 16 + (lane & 15)) * S + dd * 16 + (lane >> 4) * 8);
          mma_bf16(dq[2 * dd], sa[kk], kb[0], kb[1]);
          mma_bf16(dq[2 * dd + 1], sa[kk], kb[2], kb[3]);
        }
      }
    }
    __syncthreads();   // the buffer is free for the step after next
  }

  // dQ sm_scale through this warp's own rows of the Q tile (only this warp
  // ever read them) to 16-byte stores
  bf16* st = qs + wrow0 * S;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(st + gr * S + n * 8 + gc) =
        pack_bf16(dq[n][0] * a.sm_scale, dq[n][1] * a.sm_scale);
    *reinterpret_cast<uint32_t*>(st + (gr + 8) * S + n * 8 + gc) =
        pack_bf16(dq[n][2] * a.sm_scale, dq[n][3] * a.sm_scale);
  }
  __syncwarp();
  bf16* dqg = static_cast<bf16*>(a.dq);
  for (int e = lane; e < 16 * SEG; e += 32) {
    const int r = e / SEG, c = (e % SEG) * 8, t = t0 + wrow0 + r;
    if (t < a.t)   // dq is contiguous [B, T, H, D]
      *reinterpret_cast<uint4*>(dqg + ((b * a.t + t) * a.h + h) * D + c) =
          *reinterpret_cast<const uint4*>(st + r * S + c);
  }
}

// Above 48 KB of dynamic shared memory a kernel must ask for it; the mma
// route's kernels also ask for the largest carveout, so that as many blocks
// as fit share an SM.  Asked once per instance and device.
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

template <int D>
cudaError_t prepare_mma() {
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MmaBwd<D>::kDkdvSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MmaBwd<D>::kDqSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

template <typename T, int D>
cudaError_t launch_delta(const Args& a, int b, cudaStream_t st) {
  const int64_t rows = static_cast<int64_t>(b) * a.t * a.h;
  const int64_t delta_blocks = (rows + kWarps - 1) / kWarps;
  if (delta_blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), kThreads, 0, st>>>(
      a, rows);
  return cudaGetLastError();
}

// the fma route (float32): Delta, dK/dV, dQ
template <typename T, int D>
cudaError_t launch_typed(const Args& a, int b, cudaStream_t st) {
  cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return err;
  err = launch_delta<T, D>(a, b, st);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3((a.s + kKeys - 1) / kKeys, a.kv, b), kThreads,
                                Smem<D>::kBytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3((a.t + kRowsT - 1) / kRowsT, a.h, b), kThreads,
                              Smem<D>::kBytes, st>>>(a);
  return cudaGetLastError();
}

// the mma route (bf16): Delta, dK/dV partials, their reduce, dQ
template <int D>
cudaError_t launch_mma(const Args& a, int b, cudaStream_t st) {
  const int key_tiles = (a.s + kMmaKeys - 1) / kMmaKeys;
  const int row_tiles = (a.t + kMmaRows - 1) / kMmaRows;
  const int64_t n = static_cast<int64_t>(b) * a.s * a.kv * (D / 4);
  const int64_t reduce_blocks = (n + kReduceThreads - 1) / kReduceThreads;
  if (key_tiles > 65535 || row_tiles > 65535 || reduce_blocks > 2147483647LL ||
      a.wk == nullptr || a.wv == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare_mma<D>();
  if (err != cudaSuccess) return err;
  err = launch_delta<__nv_bfloat16, D>(a, b, st);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma_kernel<D><<<dim3(a.h * b, key_tiles), kMmaThreads,
                                 MmaBwd<D>::kDkdvSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_reduce_kernel<D><<<static_cast<unsigned>(reduce_blocks), kReduceThreads, 0,
                               st>>>(a, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma_kernel<D><<<dim3(a.h * b, row_tiles), kMmaThreads,
                               MmaBwd<D>::kDqSmem, st>>>(a);
  return cudaGetLastError();
}

// The one argument of flash_attention_bwd_launch, packed by the wrapper
// (ops._BWD_LAUNCH, "<13q11if"): addresses of q, k, v, o, dO (contiguous
// [B, T, H, D] and [B, S, KV, D], rows 16-byte aligned), LSE and the Delta
// workspace ([B, H, T] fp32), dq, dk, dv (contiguous, in q's type), the
// mma route's dK and dV partials ([B, S, H, D] fp32; 0 on the fma route),
// the stream; then the route (0 fma, 1 mma), dtype (0 float32, 1
// bfloat16), sizes, flags and the scale.
struct BwdLaunch {
  int64_t q, k, v, o, dout, lse, delta, dq, dk, dv, wk, wv, stream;
  int32_t route, dtype, b, t, s, h, kv, d, causal, window, q_offset;
  float sm_scale;
};
static_assert(sizeof(BwdLaunch) == 152, "ops._BWD_LAUNCH packs 152 bytes");

}  // namespace

// Launch a route's kernels on a BwdLaunch packed at `packed` →
// cudaGetLastError() after the last launch (or the first failed one).
extern "C" int flash_attention_bwd_launch(const void* packed) {
  BwdLaunch p;
  memcpy(&p, packed, sizeof(p));
  if (p.b <= 0 || p.b > 65535 || p.t <= 0 || p.s <= 0 || p.kv <= 0 || p.h <= 0 ||
      p.h % p.kv != 0 || p.h > 65535 || p.window < 0 ||
      static_cast<int64_t>(p.b) * p.h > 2147483647LL)
    return cudaErrorInvalidValue;
  if ((p.q | p.k | p.v | p.o | p.dout | p.dq | p.dk | p.dv | p.wk | p.wv) & 15)
    return cudaErrorMisalignedAddress;
  Args a{reinterpret_cast<const void*>(p.q), reinterpret_cast<const void*>(p.k),
         reinterpret_cast<const void*>(p.v), reinterpret_cast<const void*>(p.o),
         reinterpret_cast<const void*>(p.dout), reinterpret_cast<const float*>(p.lse),
         reinterpret_cast<float*>(p.delta), reinterpret_cast<void*>(p.dq),
         reinterpret_cast<void*>(p.dk), reinterpret_cast<void*>(p.dv),
         reinterpret_cast<float*>(p.wk), reinterpret_cast<float*>(p.wv),
         p.t, p.s, p.h, p.kv, p.h / p.kv, p.causal, p.window, p.q_offset, p.sm_scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p.stream);
  if (p.route == 0 && p.dtype == 0 && p.d == 64) return launch_typed<float, 64>(a, p.b, st);
  if (p.route == 0 && p.dtype == 0 && p.d == 128) return launch_typed<float, 128>(a, p.b, st);
  if (p.route == 1 && p.dtype == 1 && p.d == 64) return launch_mma<64>(a, p.b, st);
  if (p.route == 1 && p.dtype == 1 && p.d == 128) return launch_mma<128>(a, p.b, st);
  return cudaErrorInvalidValue;
}

// out: {sizeof(BwdLaunch), keys a dK/dV block and query rows a dQ block of
// the fma route, of the mma route, the mma route's query rows a dK/dV step
// (= keys a dQ step) at D 64 and at D 128, threads a reduce block}.
extern "C" int flash_attention_bwd_constants(int* out) {
  out[0] = static_cast<int>(sizeof(BwdLaunch));
  out[1] = kKeys;
  out[2] = kRowsT;
  out[3] = kMmaKeys;
  out[4] = kMmaRows;
  out[5] = MmaBwd<64>::kStep;
  out[6] = MmaBwd<128>::kStep;
  out[7] = kReduceThreads;
  return 0;
}

// out: {dynamic shared memory bytes, registers a thread, local (spill)
// bytes a thread} of each kernel of a route at head dim d, in launch
// order: fma (float32) Delta, dK/dV, dQ; mma (bf16) Delta, dK/dV, reduce,
// dQ.
namespace {
cudaError_t attrs(int* out, const void* fn, int smem) {
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return err;
  out[0] = smem;
  out[1] = at.numRegs;
  out[2] = static_cast<int>(at.localSizeBytes);
  return cudaSuccess;
}

template <int D>
cudaError_t fma_resources(int* out) {
  cudaError_t err = attrs(out, reinterpret_cast<const void*>(
                                   flash_bwd_delta_kernel<float, D>), 0);
  if (err == cudaSuccess)
    err = attrs(out + 3, reinterpret_cast<const void*>(flash_bwd_dkdv_kernel<float, D>),
                Smem<D>::kBytes);
  if (err == cudaSuccess)
    err = attrs(out + 6, reinterpret_cast<const void*>(flash_bwd_dq_kernel<float, D>),
                Smem<D>::kBytes);
  return err;
}

template <int D>
cudaError_t mma_resources(int* out) {
  cudaError_t err = attrs(out, reinterpret_cast<const void*>(
                                   flash_bwd_delta_kernel<__nv_bfloat16, D>), 0);
  if (err == cudaSuccess)
    err = attrs(out + 3, reinterpret_cast<const void*>(flash_bwd_dkdv_mma_kernel<D>),
                MmaBwd<D>::kDkdvSmem);
  if (err == cudaSuccess)
    err = attrs(out + 6, reinterpret_cast<const void*>(flash_bwd_reduce_kernel<D>), 0);
  if (err == cudaSuccess)
    err = attrs(out + 9, reinterpret_cast<const void*>(flash_bwd_dq_mma_kernel<D>),
                MmaBwd<D>::kDqSmem);
  return err;
}
}  // namespace

extern "C" int flash_attention_bwd_resources(int route, int d, int* out) {
  if (route == 0 && d == 64) return fma_resources<64>(out);
  if (route == 0 && d == 128) return fma_resources<128>(out);
  if (route == 1 && d == 64) return mma_resources<64>(out);
  if (route == 1 && d == 128) return mma_resources<128>(out);
  return cudaErrorInvalidValue;
}
