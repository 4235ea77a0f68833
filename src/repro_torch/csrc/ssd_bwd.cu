// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a): five
// passes on the CUDA cores, all sums in fp32 and in a fixed order.
//
// Replaces no TPU kernel: the JAX package trains mamba2 by differentiating
// XLA's ssd_chunked (src/repro/models/mamba2.py:83), never its Pallas scan.
// This kernel is the gradient of the port's scan (csrc/ssd.cu), so that the
// port trains on its own kernels.  Per (batch, head) and chunk of Q steps,
// with u_k = dt_k x_k, cum = cumsum(dt A) inside the chunk, total its last
// value, L_qk = exp(cum_q - cum_k) for k <= q and w_k = exp(total - cum_k),
// the forward is
//
//   y_q = sum_{k<=q} (C_q . B_k) L_qk u_k + exp(cum_q) C_q . S_prev
//   S_c = sum_k w_k u_k B_k^T,   S_prev[c+1] = exp(total_c) S_prev[c] + S_c
//
// and for the output's gradient dY this computes dx, ddt, dA, dB and dC.
// The wrapper (kernels/ssd/ops.py) first recomputes cum, C B^T and S_prev
// (in fp32) with the forward's passes 1-3 from the saved inputs, then
// launches the five passes below in order on the caller's stream:
//
//   5. chunk out, grid (head, chunk, batch): the inter-chunk term.  The
//      chunk's own share of the gradient of the state entering it,
//      dS_local = (exp(cum) dY)^T C, a [P, Q].[Q, N] product; dC_q =
//      exp(cum_q) dY_q S_prev (per head) and dcum_q = C_q . dC_q.
//   6. state, grid (head, batch): the reverse state pass, the only
//      sequential loop (nc steps: 4 at T 1,024, 16 at T 4,096).  G = 0;
//      from the last chunk to the first, dS[c] = G, dtot[c] = exp(total_c)
//      sum(G S_prev[c]), G = dS_local[c] + exp(total_c) G.  dS overwrites
//      dS_local in place.
//   7. state side, grid (head, chunk, batch): S_c's terms.  du_k = w_k dS
//      B_k, dB_k = w_k dS^T u_k (per head), dcum_k -= B_k . dB_k and
//      dtot += the same summed over k.
//   8. diag, grid (head, chunk, batch): the intra-chunk term over 64 x 64
//      tiles (q tile >= key tile).  dM = dY u^T, dCB = dM L; du += (C B^T
//      L)^T dY, dC += dCB B, dB += dCB^T C, dcum_q += sum_k dCB C B^T and
//      dcum_k -= the column sums.  Then R_j = sum_{q>=j} dcum_q + dtot
//      (total is cum's last entry, which every dt of the chunk feeds), ddt
//      = A R + sum_p du x, dx = dt du and the chunk's share of dA, sum dt R.
//   9. reduce, one thread an output: dB and dC summed over each group's
//      heads in order (all 80 heads of mamba2-2.7b share one B and one C),
//      dA over (batch, chunk) in order.
//
// Bound on this card.  At the mamba2-2.7b training shape (B 2, T 1024, H
// 80, P 64, G 1, N 128, Q 256, bf16) the backward must read x and dY and
// write dx (21 MB each), plus dt, B, C and their gradients (about 3 MB):
// about 66 MB, 0.0198 ms at 3.35 TB/s.  The arithmetic it needs (the
// recompute included, the diag's dB and dC formed once a group from the
// heads' summed dCB), counted by chip_smoke.py's ssd_bwd_ops_count, is
// about 19.3 GFLOP: 0.0195 ms on the bf16 tensor cores, so bytes bound it,
// barely; 0.29 ms at the CUDA cores' 67 TFLOP/s fp32, which these passes
// use.  This decomposition does more: pass 8 forms dB and dC per head
// (another ~10.6 GFLOP at this shape) for pass 9 to sum.
//
// Design.  A kernel that is right first: every product runs as fp32 FMAs
// on the CUDA cores from shared-memory tiles (fp32, rows padded by one
// word so that the warps' column reads hit distinct banks), each thread
// holding a 4 x 8 (or 4 x 4) block of outputs.  Intermediates cross device
// memory between passes: dS (fp32 [B, nc, H, P, N]), du [B, H, nc, Q, P],
// and dB, dC per head [B, H, nc, Q, N] that pass 9 sums.  Each output
// element is owned by one block, which adds to it in a fixed order; sums
// over threads run as fixed shuffle trees and then over warps in order.
// No atomics, so a replay gives the same bits.  x, B and C are read
// through their strides (column slices of the model's conv output); dY is
// contiguous.  A ragged last chunk is masked, as in the forward: rows at
// or past its end add nothing, and the masked upper triangle never
// evaluates an exponent (it would be positive).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 256;   // the forward's largest chunk
constexpr int kP = 64;           // widest head (P)
constexpr int kN = 128;          // widest state (N)
constexpr int kTile = 64;        // rows of a q or key tile
constexpr int kThreads = 256;    // every pass
constexpr int kWarps = kThreads / 32;
constexpr int XS = kP + 1;       // row strides of the fp32 shared tiles
constexpr int NS = kN + 1;
constexpr int WS = kTile + 1;
constexpr int kPerThread = kP * kN / kThreads;   // state pass elements

enum Pass { kChunkOut = 0, kState = 1, kStateSide = 2, kDiag = 3, kReduce = 4 };

struct Args {
  const void* x; const float* dt; const float* a; const void* b;
  const void* c; const void* dy;
  const float* cum; const float* dtc; const float* prev; const float* cb;
  float* ds; float* dcum; float* dtot; float* du; float* dbh; float* dch;
  float* dapart; void* dx; float* ddt; float* da; void* db; void* dc;
  int batch, t, h, p, g, n, chunk, nc;
  int64_t sxb, sxt, sxh;   // x [B, T, H, P], P contiguous
  int64_t sdb, sdt, sdh;   // dt [B, T, H] (the passes read dtc instead)
  int64_t sbb, sbt, sbg;   // b [B, T, G, N], N contiguous
  int64_t scb, sct, scg;   // c [B, T, G, N], N contiguous
};
// cum, dtc, dcum: [B, H, nc, Q] fp32 (dtc zero past a ragged end); prev,
// ds: [B, nc, H, P, N] fp32; cb: [B, nc, G, Q, Q] fp32, lower triangle;
// dtot, dapart: [B, H, nc]; du: [B, H, nc, Q, P]; dbh, dch: [B, H, nc, Q,
// N]; dy, dx: contiguous [B, T, H, P] in x's type; ddt: [B, T, H]; da:
// [H]; db, dc: contiguous [B, T, G, N] in x's type.

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// rows [0, kTile) x columns [0, COLS) of an fp32 shared tile (row stride
// ds) from a row-major source with row stride ss, times scale[r] where
// given; zero past valid_rows and valid_cols.
template <int COLS, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ds, const T* src,
                                          int64_t ss, int valid_rows,
                                          int valid_cols,
                                          const float* scale = nullptr) {
  for (int e = threadIdx.x; e < kTile * COLS; e += kThreads) {
    const int r = e / COLS, col = e - r * COLS;
    float v = 0.f;
    if (r < valid_rows && col < valid_cols) {
      v = to_f(src[r * ss + col]);
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * ds + col] = v;
  }
}

// The sum of v over the block, in a fixed order (a shuffle tree in each
// warp, then the warps in order); valid in thread 0.  Every thread calls.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The sum of v over the 16 lanes of a half warp, by a fixed shuffle tree.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Thread t of a block owns rows 4 (t / 16) .. + 3 of a 64-row tile and the
// columns t % 16 + 16 j of its width.

__device__ __forceinline__ int64_t bhc(const Args& a, int bi, int hi, int ci) {
  return (static_cast<int64_t>(bi) * a.h + hi) * a.nc + ci;
}

// ---- pass 5: the inter-chunk term -------------------------------------------

constexpr int chunk_out_smem() {
  return (kP * NS + kTile * NS + kTile * XS + kMaxChunk) * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_out_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  float* ps = sm;                   // [kP][NS]: S_prev of the chunk
  float* cs = ps + kP * NS;         // [kTile][NS]: C rows
  float* ys = cs + kTile * NS;      // [kTile][XS]: exp(cum) dY rows
  float* ecum = ys + kTile * XS;    // [kMaxChunk]: exp(cum)

  const int tid = threadIdx.x, r4 = (tid >> 4) * 4, c16 = tid & 15;
  const int hi = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int gi = hi / (a.h / a.g);
  const int q = a.chunk, t0 = ci * q, qc = min(q, a.t - t0), p = a.p, n = a.n;
  const int64_t hc = bhc(a, bi, hi, ci);
  const int64_t syt = static_cast<int64_t>(a.h) * p;
  for (int i = tid; i < q; i += kThreads) ecum[i] = expf(a.cum[hc * q + i]);
  const int64_t soff = ((static_cast<int64_t>(bi) * a.nc + ci) * a.h + hi) * p * n;
  load_tile<kN>(ps, NS, a.prev + soff, n, p, n);   // p <= kTile rows
  const T* cp = static_cast<const T*>(a.c) + bi * a.scb + gi * a.scg + t0 * a.sct;
  const T* dyp = static_cast<const T*>(a.dy) + (static_cast<int64_t>(bi) * a.t + t0) * syt
                 + static_cast<int64_t>(hi) * p;
  float* dcp = a.dch + hc * q * n;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < q; r0 += kTile) {
    __syncthreads();   // ecum and S_prev written; the last tile used
    load_tile<kN>(cs, NS, cp + r0 * a.sct, a.sct, qc - r0, n);
    load_tile<kP>(ys, XS, dyp + r0 * syt, syt, qc - r0, p, ecum + r0);
    __syncthreads();
    // dS_local[p][n] += sum_k ys[k][p] C_k[n]
    for (int k = 0; k < kTile; ++k) {
      float yv[4], cv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = ys[k * XS + r4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) cv[j] = cs[k * NS + c16 + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(yv[i], cv[j], acc[i][j]);
    }
    // dC_q[n] = sum_p ys[q][p] S_prev[p][n] for the tile's rows
    float dc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dc[i][j] = 0.f;
    for (int pp = 0; pp < kP; ++pp) {
      float yv[4], pv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = ys[(r4 + i) * XS + pp];
#pragma unroll
      for (int j = 0; j < 8; ++j) pv[j] = ps[pp * NS + c16 + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dc[i][j] = fmaf(yv[i], pv[j], dc[i][j]);
    }
    // dcum_q = C_q . dC_q: each thread's 8 columns, then its half warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + r4 + i;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s = fmaf(cs[(r4 + i) * NS + c16 + 16 * j], dc[i][j], s);
      s = half_warp_sum(s);
      if (row < q) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c16 + 16 * j < n) dcp[static_cast<int64_t>(row) * n + c16 + 16 * j] = dc[i][j];
        if (c16 == 0) a.dcum[hc * q + row] = s;
      }
    }
  }
  float* dsp = a.ds + soff;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (r4 + i < p && c16 + 16 * j < n) dsp[(r4 + i) * n + c16 + 16 * j] = acc[i][j];
}

// ---- pass 6: the reverse state pass ------------------------------------------

__global__ void __launch_bounds__(kThreads) ssd_bwd_state_kernel(const Args a) {
  __shared__ float red[kWarps];
  const int tid = threadIdx.x, hi = blockIdx.x, bi = blockIdx.y;
  const int pn = a.p * a.n, q = a.chunk, nc = a.nc;
  const int64_t cstride = static_cast<int64_t>(a.h) * pn;
  const int64_t base = (static_cast<int64_t>(bi) * nc * a.h + hi) * pn;
  float* ds = a.ds + base;
  const float* prev = a.prev + base;
  float gr[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) gr[j] = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const float e = expf(a.cum[bhc(a, bi, hi, c) * q + q - 1]);
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int el = tid + j * kThreads;
      if (el < pn) {
        const int64_t o = c * cstride + el;
        part = fmaf(gr[j], prev[o], part);
        const float local = ds[o];
        ds[o] = gr[j];
        gr[j] = fmaf(e, gr[j], local);
      }
    }
    const float s = block_sum(part, red);
    if (tid == 0) a.dtot[bhc(a, bi, hi, c)] = e * s;
  }
}

// ---- pass 7: the chunk state's terms -----------------------------------------

constexpr int state_side_smem() {
  return (kP * NS + kTile * NS + kTile * XS + 2 * kMaxChunk + kWarps) * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_side_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  float* dss = sm;                  // [kP][NS]: dS of the chunk
  float* bs = dss + kP * NS;        // [kTile][NS]: B rows
  float* us = bs + kTile * NS;      // [kTile][XS]: u = dt x rows
  float* wk = us + kTile * XS;      // [kMaxChunk]: exp(total - cum)
  float* dw = wk + kMaxChunk;       // [kMaxChunk]: B_k . dB_k
  float* red = dw + kMaxChunk;      // [kWarps]

  const int tid = threadIdx.x, r4 = (tid >> 4) * 4, c16 = tid & 15;
  const int hi = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int gi = hi / (a.h / a.g);
  const int q = a.chunk, t0 = ci * q, qc = min(q, a.t - t0), p = a.p, n = a.n;
  const int64_t hc = bhc(a, bi, hi, ci);
  const float* cum = a.cum + hc * q;
  const float* dtc = a.dtc + hc * q;
  const float total = cum[q - 1];
  for (int i = tid; i < q; i += kThreads) {
    wk[i] = expf(total - cum[i]);
    dw[i] = 0.f;
  }
  const int64_t soff = ((static_cast<int64_t>(bi) * a.nc + ci) * a.h + hi) * p * n;
  load_tile<kN>(dss, NS, a.ds + soff, n, p, n);
  const T* bp = static_cast<const T*>(a.b) + bi * a.sbb + gi * a.sbg + t0 * a.sbt;
  const T* xp = static_cast<const T*>(a.x) + bi * a.sxb + hi * a.sxh + t0 * a.sxt;
  float* dup = a.du + hc * q * p;
  float* dbp = a.dbh + hc * q * n;

  for (int r0 = 0; r0 < q; r0 += kTile) {
    __syncthreads();
    load_tile<kN>(bs, NS, bp + r0 * a.sbt, a.sbt, qc - r0, n);
    load_tile<kP>(us, XS, xp + r0 * a.sxt, a.sxt, qc - r0, p, dtc + r0);
    __syncthreads();
    // du_k[p] = w_k sum_n dS[p][n] B_k[n]
    float du[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) du[i][j] = 0.f;
    for (int nn = 0; nn < kN; ++nn) {
      float bv[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = bs[(r4 + i) * NS + nn];
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = dss[(c16 + 16 * j) * NS + nn];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) du[i][j] = fmaf(bv[i], dv[j], du[i][j]);
    }
    // dB_k[n] = w_k sum_p dS[p][n] u_k[p]
    float db[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) db[i][j] = 0.f;
    for (int pp = 0; pp < kP; ++pp) {
      float uv[4], dv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) uv[i] = us[(r4 + i) * XS + pp];
#pragma unroll
      for (int j = 0; j < 8; ++j) dv[j] = dss[pp * NS + c16 + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) db[i][j] = fmaf(uv[i], dv[j], db[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + r4 + i;
      const float w = row < q ? wk[row] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        db[i][j] *= w;
        s = fmaf(bs[(r4 + i) * NS + c16 + 16 * j], db[i][j], s);
      }
      s = half_warp_sum(s);
      if (row < q) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c16 + 16 * j < p) dup[static_cast<int64_t>(row) * p + c16 + 16 * j] = w * du[i][j];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c16 + 16 * j < n) dbp[static_cast<int64_t>(row) * n + c16 + 16 * j] = db[i][j];
        if (c16 == 0) dw[row] = s;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < q; i += kThreads) a.dcum[hc * q + i] -= dw[i];
  const float s = block_sum(tid < q ? dw[tid] : 0.f, red);
  if (tid == 0) a.dtot[hc] += s;
}

// ---- pass 8: the intra-chunk term, then dx, ddt and dA's share ----------------

constexpr int diag_smem() {
  return (2 * kTile * XS + 2 * kTile * NS + 3 * kTile * WS + 4 * kMaxChunk + kWarps)
         * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_diag_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  float* ys = sm;                   // [kTile][XS]: dY rows of the q tile
  float* us = ys + kTile * XS;      // [kTile][XS]: u rows of the key tile
  float* cs = us + kTile * XS;      // [kTile][NS]: C rows of the q tile
  float* bs = cs + kTile * NS;      // [kTile][NS]: B rows of the key tile
  float* w1 = bs + kTile * NS;      // [kTile][WS]: C B^T, then C B^T L
  float* w2 = w1 + kTile * WS;      // [kTile][WS]: dCB = dM L
  float* w3 = w2 + kTile * WS;      // [kTile][WS]: dCB C B^T
  float* cum_s = w3 + kTile * WS;   // [kMaxChunk]
  float* dt_s = cum_s + kMaxChunk;  // [kMaxChunk]
  float* drow = dt_s + kMaxChunk;   // [kMaxChunk]: row sums of dCB C B^T
  float* dcol = drow + kMaxChunk;   // [kMaxChunk]: minus its column sums
  float* red = dcol + kMaxChunk;    // [kWarps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r4 = (tid >> 4) * 4, c16 = tid & 15;
  const int hi = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int gi = hi / (a.h / a.g);
  const int q = a.chunk, t0 = ci * q, qc = min(q, a.t - t0), p = a.p, n = a.n;
  const int64_t hc = bhc(a, bi, hi, ci);
  const int64_t syt = static_cast<int64_t>(a.h) * p;
  for (int i = tid; i < q; i += kThreads) {
    cum_s[i] = a.cum[hc * q + i];
    dt_s[i] = a.dtc[hc * q + i];
    drow[i] = 0.f;
    dcol[i] = 0.f;
  }
  const T* xp = static_cast<const T*>(a.x) + bi * a.sxb + hi * a.sxh + t0 * a.sxt;
  const T* bp = static_cast<const T*>(a.b) + bi * a.sbb + gi * a.sbg + t0 * a.sbt;
  const T* cp = static_cast<const T*>(a.c) + bi * a.scb + gi * a.scg + t0 * a.sct;
  const T* dyp = static_cast<const T*>(a.dy) + (static_cast<int64_t>(bi) * a.t + t0) * syt
                 + static_cast<int64_t>(hi) * p;
  const float* cbm = a.cb + ((static_cast<int64_t>(bi) * a.nc + ci) * a.g + gi) * q * q;
  float* dup = a.du + hc * q * p;
  float* dbp = a.dbh + hc * q * n;
  float* dcp = a.dch + hc * q * n;
  const int nt = (qc + kTile - 1) / kTile;

  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();   // cum_s and dt_s written; the last key tile used
    load_tile<kP>(us, XS, xp + k0 * a.sxt, a.sxt, qc - k0, p, dt_s + k0);
    load_tile<kN>(bs, NS, bp + k0 * a.sbt, a.sbt, qc - k0, n);
    float du[4][4], db[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) du[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) db[i][j] = 0.f;
    }
    for (int qt = kt; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();   // the last q tile used
      load_tile<kP>(ys, XS, dyp + q0 * syt, syt, qc - q0, p);
      load_tile<kN>(cs, NS, cp + q0 * a.sct, a.sct, qc - q0, n);
      // C B^T on k <= q < qc only: the forward's pass 2 wrote no more
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile, col = e - r * kTile;
        const int qq = q0 + r, kk = k0 + col;
        w1[r * WS + col] = (qq < qc && kk <= qq) ? cbm[static_cast<int64_t>(qq) * q + kk] : 0.f;
      }
      __syncthreads();
      // dM[q][k] = sum_p dY_q[p] u_k[p]; then dCB, dCB C B^T and C B^T L
      float m[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) m[i][j] = 0.f;
      for (int pp = 0; pp < kP; ++pp) {
        float yv[4], uv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = ys[(r4 + i) * XS + pp];
#pragma unroll
        for (int j = 0; j < 4; ++j) uv[j] = us[(c16 + 16 * j) * XS + pp];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) m[i][j] = fmaf(yv[i], uv[j], m[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r4 + i, col = c16 + 16 * j;
          const int qq = q0 + r, kk = k0 + col;
          // the exponent only where k <= q: above the diagonal it is positive
          const float l = (qq < qc && kk <= qq) ? expf(cum_s[qq] - cum_s[kk]) : 0.f;
          const float cbv = w1[r * WS + col];
          const float dcb = m[i][j] * l;
          w2[r * WS + col] = dcb;
          w3[r * WS + col] = dcb * cbv;
          w1[r * WS + col] = cbv * l;
        }
      }
      __syncthreads();
      if (tid < kTile) {
        if (q0 + tid < q) {
          float s = 0.f;
          for (int col = 0; col < kTile; ++col) s += w3[tid * WS + col];
          drow[q0 + tid] += s;
        }
      } else if (tid < 2 * kTile) {
        const int col = tid - kTile;
        if (k0 + col < q) {
          float s = 0.f;
          for (int r = 0; r < kTile; ++r) s += w3[r * WS + col];
          dcol[k0 + col] -= s;
        }
      }
      // du_k[p] += sum_q (C B^T L)[q][k] dY_q[p]; dB_k[n] += sum_q dCB[q][k] C_q[n]
      for (int r = 0; r < kTile; ++r) {
        float wv[4], yv[4], w2v[4], cv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wv[i] = w1[r * WS + r4 + i];
          w2v[i] = w2[r * WS + r4 + i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) yv[j] = ys[r * XS + c16 + 16 * j];
#pragma unroll
        for (int j = 0; j < 8; ++j) cv[j] = cs[r * NS + c16 + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) du[i][j] = fmaf(wv[i], yv[j], du[i][j]);
#pragma unroll
          for (int j = 0; j < 8; ++j) db[i][j] = fmaf(w2v[i], cv[j], db[i][j]);
        }
      }
      // dC_q[n] += sum_k dCB[q][k] B_k[n], added to this block's dC rows
      float dc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dc[i][j] = 0.f;
      for (int col = 0; col < kTile; ++col) {
        float wv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = w2[(r4 + i) * WS + col];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bs[col * NS + c16 + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) dc[i][j] = fmaf(wv[i], bv[j], dc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + r4 + i;
        if (row < qc) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (c16 + 16 * j < n) dcp[static_cast<int64_t>(row) * n + c16 + 16 * j] += dc[i][j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + r4 + i;
      if (row < qc) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c16 + 16 * j < p) dup[static_cast<int64_t>(row) * p + c16 + 16 * j] += du[i][j];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c16 + 16 * j < n) dbp[static_cast<int64_t>(row) * n + c16 + 16 * j] += db[i][j];
      }
    }
  }
  __syncthreads();   // du, drow and dcol complete

  // R_j = sum_{q >= j} dcum_q + dtot: a scan over reversed positions, by
  // shuffles in each warp, then the sums of the earlier warps in order
  const int j = q - 1 - tid;
  float v = tid < q ? a.dcum[hc * q + j] + drow[j] + dcol[j] : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) red[warp] = v;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += red[w];
  __syncthreads();   // red read; drow[j] is this thread's alone
  if (tid < q) drow[j] = base + v + a.dtot[hc];
  __syncthreads();
  const float dshare = block_sum(tid < q ? dt_s[tid] * drow[tid] : 0.f, red);
  if (tid == 0) a.dapart[hc] = dshare;

  // dx = dt du and ddt = A R + sum_p du x: a warp a row
  const float A = a.a[hi];
  T* dxp = static_cast<T*>(a.dx) + (static_cast<int64_t>(bi) * a.t + t0) * syt
           + static_cast<int64_t>(hi) * p;
  float* ddt = a.ddt + (static_cast<int64_t>(bi) * a.t + t0) * a.h + hi;
  for (int row = warp; row < qc; row += kWarps) {
    float s = 0.f;
    for (int pp = lane; pp < kP; pp += 32) {
      if (pp < p) {
        const float d = dup[static_cast<int64_t>(row) * p + pp];
        s = fmaf(d, to_f(xp[row * a.sxt + pp]), s);
        dxp[row * syt + pp] = from_f<T>(dt_s[row] * d);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) ddt[static_cast<int64_t>(row) * a.h] = fmaf(A, drow[row], s);
  }
}

// ---- pass 9: sums over each group's heads and over (batch, chunk) ------------

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_kernel(const Args a) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t total = static_cast<int64_t>(a.batch) * a.t * a.g * a.n;
  if (idx < total) {
    const int nn = static_cast<int>(idx % a.n);
    int64_t rest = idx / a.n;
    const int gi = static_cast<int>(rest % a.g);
    rest /= a.g;
    const int tt = static_cast<int>(rest % a.t);
    const int bi = static_cast<int>(rest / a.t);
    const int q = a.chunk, ci = tt / q, r = a.h / a.g;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < r; ++k) {
      const int64_t off = (bhc(a, bi, gi * r + k, ci) * q + (tt - ci * q)) * a.n + nn;
      sb += a.dbh[off];
      sc += a.dch[off];
    }
    static_cast<T*>(a.db)[idx] = from_f<T>(sb);
    static_cast<T*>(a.dc)[idx] = from_f<T>(sc);
  }
  if (blockIdx.x == 0) {
    for (int hh = threadIdx.x; hh < a.h; hh += kThreads) {
      float s = 0.f;
      for (int bi = 0; bi < a.batch; ++bi)
        for (int ci = 0; ci < a.nc; ++ci) s += a.dapart[bhc(a, bi, hh, ci)];
      a.da[hh] = s;
    }
  }
}

// ---- launch ----------------------------------------------------------------------

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// f(kernel, grid, dynamic shared memory) for pass `pass`.
template <typename T, typename F>
cudaError_t with_pass(int pass, const Args& a, F&& f) {
  const dim3 chunks(a.h, a.nc, a.batch);
  switch (pass) {
    case kChunkOut:
      return f(ssd_bwd_chunk_out_kernel<T>, chunks, chunk_out_smem());
    case kState:
      return f(ssd_bwd_state_kernel, dim3(a.h, a.batch), 0);
    case kStateSide:
      return f(ssd_bwd_state_side_kernel<T>, chunks, state_side_smem());
    case kDiag:
      return f(ssd_bwd_diag_kernel<T>, chunks, diag_smem());
    case kReduce: {
      const int64_t total = static_cast<int64_t>(a.batch) * a.t * a.g * a.n;
      return f(ssd_bwd_reduce_kernel<T>,
               dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads)), 0);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run_pass(int pass, const Args& a, cudaStream_t st) {
  return with_pass<T>(pass, a, [&](auto kernel, dim3 grid, int smem) {
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(a);
    return cudaGetLastError();
  });
}

// out: dynamic shared memory of a block (bytes), blocks an SM holds at
// once, registers a thread, local (spill) bytes a thread.
template <typename T>
cudaError_t pass_resources(int pass, int* out) {
  return with_pass<T>(pass, Args{}, [&](auto kernel, dim3, int smem) {
    out[0] = smem;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    out[2] = attr.numRegs;
    out[3] = static_cast<int>(attr.localSizeBytes);
    return err;
  });
}

}  // namespace

// pass: 0 chunk out, 1 state, 2 state side, 3 diag, 4 reduce.  dtype: 0
// float32, 1 bfloat16 (x, b, c, dy, dx, db and dc); everything else is
// float32.  ptrs (22): x, dt, a, b, c, dy, cum, dtc, prev, cb, ds, dcum,
// dtot, du, dbh, dch, dapart, dx, ddt, da, db, dc (a pass ignores what it
// does not read or write).  dims: batch, t, h, p, g, n, chunk (the scan's
// Q, at most t).  strides: 12 element strides, x (b, t, h), dt (b, t, h),
// b (b, t, g), c (b, t, g); the last axis of x, b and c is contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_bwd_pass_launch(int pass, int dtype, void* const* ptrs,
                                   const int* dims, const int64_t* strides,
                                   void* stream) {
  const int batch = dims[0], t = dims[1], h = dims[2], p = dims[3],
            g = dims[4], n = dims[5], chunk = dims[6];
  if (pass < 0 || pass > 4 || batch <= 0 || t <= 0 || h <= 0 || g <= 0 ||
      h % g != 0 || p <= 0 || p > kP || n <= 0 || n > kN || chunk <= 0 ||
      chunk > kMaxChunk || chunk > t)
    return cudaErrorInvalidValue;
  const int nc = (t + chunk - 1) / chunk;
  if (h > 65535 || nc > 65535 || batch > 65535 ||
      (static_cast<int64_t>(batch) * t * g * n + kThreads - 1) / kThreads > 0x7fffffff)
    return cudaErrorInvalidValue;   // grid limits
  Args a{ptrs[0], static_cast<const float*>(ptrs[1]),
         static_cast<const float*>(ptrs[2]), ptrs[3], ptrs[4], ptrs[5],
         static_cast<const float*>(ptrs[6]), static_cast<const float*>(ptrs[7]),
         static_cast<const float*>(ptrs[8]), static_cast<const float*>(ptrs[9]),
         static_cast<float*>(ptrs[10]), static_cast<float*>(ptrs[11]),
         static_cast<float*>(ptrs[12]), static_cast<float*>(ptrs[13]),
         static_cast<float*>(ptrs[14]), static_cast<float*>(ptrs[15]),
         static_cast<float*>(ptrs[16]), ptrs[17], static_cast<float*>(ptrs[18]),
         static_cast<float*>(ptrs[19]), ptrs[20], ptrs[21],
         batch, t, h, p, g, n, chunk, nc,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_pass<float>(pass, a, st);
  if (dtype == 1) return run_pass<__nv_bfloat16>(pass, a, st);
  return cudaErrorInvalidValue;
}

// The five passes of one backward call in order, each checked with
// cudaGetLastError() before the next is launched; arguments as for
// ssd_bwd_pass_launch.  On an error *failed_pass names the pass.
extern "C" int ssd_bwd_launch(int dtype, void* const* ptrs, const int* dims,
                              const int64_t* strides, void* stream,
                              int* failed_pass) {
  for (int pass = kChunkOut; pass <= kReduce; ++pass) {
    const int err = ssd_bwd_pass_launch(pass, dtype, ptrs, dims, strides, stream);
    if (err != cudaSuccess) {
      *failed_pass = pass;
      return err;
    }
  }
  return cudaSuccess;
}

// A pass's dynamic shared memory a block (out[0], bytes), the blocks one SM
// holds at once (out[1]), its registers a thread (out[2]) and local bytes a
// thread (out[3]), for the build report.  Returns a CUDA error code.
extern "C" int ssd_bwd_resources(int pass, int dtype, int* out) {
  if (dtype == 0) return pass_resources<float>(pass, out);
  if (dtype == 1) return pass_resources<__nv_bfloat16>(pass, out);
  return cudaErrorInvalidValue;
}
