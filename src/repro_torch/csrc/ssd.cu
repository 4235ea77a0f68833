// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py (ssd_scan_kernel,
// pallas_call at :86, body _ssd_kernel at :26).  Same function: for each
// (batch, head) and each chunk of Q steps, with cum = cumsum(dt * A) inside
// the chunk and total its last value,
//
//   Y_diag[q, p] = sum_{k <= q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k[p]
//   Y_off[q, p]  = exp(cum_q) (C_q . S_prev[p, :])
//   S[p, n]      = exp(total) S_prev[p, n]
//                  + sum_k dt_k x_k[p] exp(total - cum_k) B_k[n]
//
// with S the [P, N] state carried from chunk to chunk, all in fp32, and y
// written once in x's type.  Head h reads group h / (H / G) of B and C.
//
// Bound on this card.  At the mamba2-2.7b prefill shape (B 2, T 4096, H 80,
// P 64, G 1, N 128, bf16) the kernel reads x, dt, B, C once and writes y
// once: about 175 MB, 0.052 ms at 3.35 TB/s.  The arithmetic is about 32
// GFLOP (the lower triangle of each chunk's products), 0.033 ms on the bf16
// tensor cores, so bytes bound it.  This first kernel runs fp32 FMAs on the
// CUDA cores (no TF32, no tensor cores) and recomputes C B^T for every head
// of a group, about 62 GFLOP, so it stays far above the bound; a parallel
// chunk pass with tensor cores and one C B^T per group is later work.
//
// Design.  The TPU kernel walks the chunks on a sequential grid axis and
// carries S in VMEM scratch.  Here one block of 256 threads owns one
// (batch, head) and loops over the chunks itself, with S in shared memory
// (32 KB fp32), so nothing carries between blocks.  The [Q, Q] decay-masked
// product (256 KiB in fp32 at Q = 256) never exists whole: a chunk is cut
// into tiles of 64 query rows, and for each tile the 32-row key tiles at or
// below the diagonal are loaded one after another; the [64, 32] piece of
// (C B^T) * L lives in shared memory only while it is multiplied into the
// tile's [64, P] accumulator in registers.  Above the diagonal nothing is
// computed: whole key tiles are skipped, and inside the diagonal tiles an
// entry with k > q is set to 0 without evaluating its exponent, which is
// positive there and could overflow.  Operands are read through their
// strides (x, B and C are column slices of the model's conv output), so
// nothing is copied; a ragged last chunk is masked, not padded.  Every
// reduction runs in a fixed order, so every run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;   // one dt / cum entry per thread
constexpr int kP = 64;           // widest head (P) the kernel takes
constexpr int kN = 128;          // widest state (N) the kernel takes
constexpr int kTQ = 64;          // query rows of a tile
constexpr int kTK = 32;          // key rows of a tile
constexpr int kPadN = kN + 4;    // row pads keep float4 rows 16-byte aligned
constexpr int kPadP = kP + 4;    // and spread rows over the banks
constexpr int kPadK = kTK + 4;

struct Smem {
  float st[kN][kP];        // the carried state, transposed: st[n][p] = S[p][n]
  float cs[kTQ][kPadN];    // C rows of the query tile
  float bs[kTK][kPadN];    // B rows of the key tile
  float xs[kTK][kPadP];    // dt * x (times the decay to the chunk's end) rows
  float ms[kTQ][kPadK];    // (C B^T) * L on (query tile, key tile)
  float dt[kMaxChunk];
  float cum[kMaxChunk];
  float warp_sum[kThreads / 32];
};

struct Args {
  const void* x; const float* dt; const float* a; const void* b; const void* c;
  void* y;
  int batch, t, h, p, g, n, chunk;
  int64_t sxb, sxt, sxh;   // x [B, T, H, P], P contiguous
  int64_t sdb, sdt, sdh;   // dt [B, T, H]
  int64_t sbb, sbt, sbg;   // b [B, T, G, N], N contiguous
  int64_t scb, sct, scg;   // c [B, T, G, N], N contiguous
};                         // y: contiguous [B, T, H, P]

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [0, rows) of a [rows, kN] tile from a row-major source with row
// stride `stride`; rows past `valid` and columns past n are zero.
template <typename T>
__device__ __forceinline__ void load_rows_n(float (*dst)[kPadN], const T* src,
                                            int64_t stride, int rows,
                                            int valid, int n) {
  for (int e = threadIdx.x; e < rows * kN; e += kThreads) {
    const int r = e / kN, col = e % kN;
    dst[r][col] = (r < valid && col < n) ? to_f(src[r * stride + col]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_kernel(const Args args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.x / args.h, hi = blockIdx.x % args.h;
  const int gi = hi / (args.h / args.g);
  const int p = args.p, n = args.n, chunk = args.chunk;
  const float a = args.a[hi];
  const T* x = static_cast<const T*>(args.x) + bi * args.sxb + hi * args.sxh;
  const float* dtp = args.dt + bi * args.sdb + hi * args.sdh;
  const T* bp = static_cast<const T*>(args.b) + bi * args.sbb + gi * args.sbg;
  const T* cp = static_cast<const T*>(args.c) + bi * args.scb + gi * args.scg;
  const int64_t syt = static_cast<int64_t>(args.h) * p;
  T* y = static_cast<T*>(args.y) + static_cast<int64_t>(bi) * args.t * syt
         + static_cast<int64_t>(hi) * p;

  // Thread roles.  Output tile [kTQ, kP]: rows ty*4 + i, columns tx*4 + j.
  const int tx = tid % 16, ty = tid / 16;
  // (C B^T) * L tile [kTQ, kTK]: rows mq*2 + r, columns mk + 8*c (a quarter
  // warp reads 8 distinct B rows, which fall in distinct banks).
  const int mk = tid % 8, mq = tid / 8;
  // State [kP, kN]: p = tx*4 + j, n = ty + 16*i.

  for (int e = tid; e < kN * kP; e += kThreads) (&sm.st[0][0])[e] = 0.f;

  for (int t0 = 0; t0 < args.t; t0 += chunk) {
    const int qc = min(chunk, args.t - t0);   // steps in this chunk
    const int64_t off_x = t0 * args.sxt, off_b = t0 * args.sbt,
                  off_c = t0 * args.sct;

    // dt and cum = inclusive cumsum of dt * A: a warp scan by shuffles,
    // then the sums of the earlier warps in order.  Past qc, dt = 0 and
    // cum stays at total.
    const float d = tid < qc ? dtp[(t0 + tid) * args.sdt] : 0.f;
    float v = d * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) sm.warp_sum[warp] = v;
    __syncthreads();
    float base = 0.f;
    for (int w = 0; w < warp; ++w) base += sm.warp_sum[w];
    sm.dt[tid] = d;
    sm.cum[tid] = base + v;
    __syncthreads();
    const float total = sm.cum[qc - 1];

    for (int q0 = 0; q0 < qc; q0 += kTQ) {
      load_rows_n(sm.cs, cp + off_c + q0 * args.sct, args.sct, kTQ, qc - q0, n);
      __syncthreads();

      // Y_off: exp(cum_q) * (C_q . S[p, :])
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < kN; k += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(&sm.cs[ty * 4 + i][k]);
#pragma unroll
        for (int u = 0; u < 4; ++u) sv[u] = ld4(&sm.st[k + u][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c4[4] = {cv[i].x, cv[i].y, cv[i].z, cv[i].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[i][0] = fmaf(c4[u], sv[u].x, acc[i][0]);
            acc[i][1] = fmaf(c4[u], sv[u].y, acc[i][1]);
            acc[i][2] = fmaf(c4[u], sv[u].z, acc[i][2]);
            acc[i][3] = fmaf(c4[u], sv[u].w, acc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float decay_in = expf(sm.cum[q0 + ty * 4 + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= decay_in;
      }

      // Y_diag over the key tiles at or below the diagonal
      const int k_end = min(q0 + kTQ, qc);
      for (int k0 = 0; k0 < k_end; k0 += kTK) {
        load_rows_n(sm.bs, bp + off_b + k0 * args.sbt, args.sbt, kTK, qc - k0, n);
        for (int e = tid; e < kTK * kP; e += kThreads) {
          const int r = e / kP, col = e % kP;
          sm.xs[r][col] = (k0 + r < qc && col < p)
              ? to_f(x[off_x + (k0 + r) * args.sxt + col]) * sm.dt[k0 + r]
              : 0.f;
        }
        __syncthreads();

        float dot[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) dot[r][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < kN; k += 4) {
          float4 cv[2], bv[4];
#pragma unroll
          for (int r = 0; r < 2; ++r) cv[r] = ld4(&sm.cs[mq * 2 + r][k]);
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = ld4(&sm.bs[mk + 8 * c][k]);
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              dot[r][c] = fmaf(cv[r].x, bv[c].x, dot[r][c]);
              dot[r][c] = fmaf(cv[r].y, bv[c].y, dot[r][c]);
              dot[r][c] = fmaf(cv[r].z, bv[c].z, dot[r][c]);
              dot[r][c] = fmaf(cv[r].w, bv[c].w, dot[r][c]);
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ql = q0 + mq * 2 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int kl = k0 + mk + 8 * c;
            sm.ms[mq * 2 + r][mk + 8 * c] =
                kl <= ql ? dot[r][c] * expf(sm.cum[ql] - sm.cum[kl]) : 0.f;
          }
        }
        __syncthreads();

#pragma unroll 2
        for (int k = 0; k < kTK; k += 4) {
          float4 mv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = ld4(&sm.ms[ty * 4 + i][k]);
#pragma unroll
          for (int u = 0; u < 4; ++u) xv[u] = ld4(&sm.xs[k + u][tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float m4[4] = {mv[i].x, mv[i].y, mv[i].z, mv[i].w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[i][0] = fmaf(m4[u], xv[u].x, acc[i][0]);
              acc[i][1] = fmaf(m4[u], xv[u].y, acc[i][1]);
              acc[i][2] = fmaf(m4[u], xv[u].z, acc[i][2]);
              acc[i][3] = fmaf(m4[u], xv[u].w, acc[i][3]);
            }
          }
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= qc) continue;
        T* yr = y + (t0 + row) * syt;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (tx * 4 + j < p) yr[tx * 4 + j] = from_f<T>(acc[i][j]);
      }
    }

    // Carry: S = exp(total) S_prev + sum_k dt_k x_k exp(total - cum_k) B_k.
    // The last chunk's state is not needed.
    if (t0 + chunk >= args.t) break;
    float s[8][4];
    const float et = expf(total);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = sm.st[ty + 16 * i][tx * 4 + j] * et;
    for (int k0 = 0; k0 < qc; k0 += kTK) {
      load_rows_n(sm.bs, bp + off_b + k0 * args.sbt, args.sbt, kTK, qc - k0, n);
      for (int e = tid; e < kTK * kP; e += kThreads) {
        const int r = e / kP, col = e % kP;
        sm.xs[r][col] = (k0 + r < qc && col < p)
            ? to_f(x[off_x + (k0 + r) * args.sxt + col]) * sm.dt[k0 + r]
                  * expf(total - sm.cum[k0 + r])
            : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kTK; ++k) {
        const float4 xv = ld4(&sm.xs[k][tx * 4]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float bv = sm.bs[k][ty + 16 * i];
          s[i][0] = fmaf(xv.x, bv, s[i][0]);
          s[i][1] = fmaf(xv.y, bv, s[i][1]);
          s[i][2] = fmaf(xv.z, bv, s[i][2]);
          s[i][3] = fmaf(xv.w, bv, s[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.st[ty + 16 * i][tx * 4 + j] = s[i][j];
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_typed(const Args& args, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory must be asked for (per device)
  const int bytes = static_cast<int>(sizeof(Smem));
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<args.batch * args.h, kThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, b, c and y); dt and a are float32.
// strides: 12 element strides, x (b, t, h), dt (b, t, h), b (b, t, g),
// c (b, t, g); the last axis of x, b and c is contiguous, y is a contiguous
// [batch, t, h, p].  Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt,
                               const void* a, const void* b, const void* c,
                               void* y, int batch, int t, int h, int p, int g,
                               int n, int chunk, const int64_t* strides,
                               void* stream) {
  if (batch <= 0 || t <= 0 || h <= 0 || g <= 0 || h % g != 0 || p <= 0 ||
      p > kP || n <= 0 || n > kN || chunk <= 0 || chunk > kMaxChunk ||
      static_cast<int64_t>(batch) * h > 2147483647LL)
    return cudaErrorInvalidValue;
  Args args{x, static_cast<const float*>(dt), static_cast<const float*>(a),
            b, c, y, batch, t, h, p, g, n, chunk,
            strides[0], strides[1], strides[2], strides[3], strides[4],
            strides[5], strides[6], strides[7], strides[8], strides[9],
            strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(args, st);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(args, st);
  return cudaErrorInvalidValue;
}
