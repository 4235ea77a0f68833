// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a), in two
// routes chosen by the operands' type: "mma" for bfloat16 (the tensor
// cores) and "fma" for float32 (the CUDA cores).  All sums run in fp32 and
// in a fixed order, with no float atomics, so a replay gives the same bits.
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
// launches the route's passes in order on the caller's stream.
//
// Route "fma" (float32), five passes of fp32 FMAs on the CUDA cores:
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
// Each thread holds a 4 x 8 (or 4 x 4) block of outputs, fed from fp32
// shared tiles (rows padded by one word); dB and dC per head cross device
// memory ([B, H, nc, Q, N] fp32 each) for pass 9 to sum.
//
// Route "mma" (bfloat16): dB and dC are formed once a group, never a head,
// by two identities that drop the per-head dB and dC the fma route reads:
//
//   chunk out:  dcum_q = C_q . dC_q = exp(cum_q) dY_q . (S_prev C_q), that
//               is dY against the forward's y_off;
//   state side: B_k . dB_k = u_k . du_k, with du_k = w_k dS B_k.
//
// Its six passes:
//
//   5. chunk out, grid (head, chunk, batch): dS_local = (exp(cum) dY)^T C,
//      and Z = C S_prev^T a q tile at a time, dcum_q = exp(cum_q) dY_q . Z_q.
//   6. state slices, grid (slice of 1,024 (p, n) elements, head, batch):
//      the reverse state pass, elementwise over (p, n), each slice writing
//      its partial sum(G S_prev[c]) for each chunk.
//   7. state side, grid (head, chunk, batch): du = w (B dS^T), dcum_k -=
//      u_k . du_k, dtot = exp(total) (the slices' partials in order) +
//      sum_k u_k . du_k.
//   8. diag, grid (head, chunk, batch), 64 x 64 tile pairs with q tile >=
//      key tile: dM = dY x^T (exact), dCB_h = dt_k dM L to an fp32
//      workspace (the lower-triangle tiles, [B, H, nc, tiles, 64, 64]), du
//      += (C B^T L)^T dY, dcum's row and column sums of dCB C B^T; then dx
//      = dt du, ddt = A R + sum_p du x and the chunk's share of dA.
//   9. group, grid (64-row tile, {dC, dB} x head slice, batch x chunk x
//      group): dC[q] = sum_h exp(cum_h,q) dY_h,q S_prev,h + dCB_s B and
//      dB[k] = sum_h w_h,k dt_h,k dS_h^T x_h,k + dCB_s^T C, with dCB_s the
//      slice's dCB_h summed in head order.  The sum over the heads runs
//      inside the accumulation (a head's product is scaled per row in fp32
//      and added); each slice writes an fp32 partial [S, B, nc, G, Q, N].
//  10. reduce, one thread an output: the slices' partials in slice order,
//      into dB and dC in x's type, and dA over (batch, chunk) in order.
//
// Every product of the mma route is mma.sync.m16n8k16 bf16 -> fp32 with
// operands brought in by ldmatrix / ldmatrix.trans from bf16 tiles (rows
// padded by 16 bytes) that cp.async fills, 16 bytes a copy where the rows
// allow it and one element a thread otherwise.  The inputs x, dY, B and
// C arrive in bf16 and enter as they are (dY x^T is a product of two of
// them, exact up to the fp32 sums).  A product with an fp32 operand
// (exp(cum) dY, S_prev, dS, C B^T L, dCB_s) takes it as two bf16 terms,
// hi = bf16(v) and lo = bf16(v - hi), in two products into one fp32
// accumulator: about 16 significant bits, and no fp32 intermediate is
// rounded to a single bf16.  C B^T is the forward's
// pass 2 output (fp32, from L2).  The route allocates no per-head [B, H,
// nc, Q, N] buffer.
//
// Bound on this card.  At the mamba2-2.7b training shape (B 2, T 1024, H
// 80, P 64, G 1, N 128, Q 256, bf16) the backward must read x and dY and
// write dx (21 MB each), plus dt, B, C and their gradients (about 3 MB):
// about 66 MB, 0.0198 ms at 3.35 TB/s.  The arithmetic it needs (the
// recompute included, the diag's dB and dC formed once a group from the
// heads' summed dCB), counted by chip_smoke.py's ssd_bwd_ops_count, is
// about 19.3 GFLOP: 0.0195 ms on the bf16 tensor cores, so bytes bound it,
// barely.  The mma route does about twice that count, ~40 GFLOP on the
// tensor cores at this shape: every fp32 operand is two products, C
// S_prev^T is formed per head for dcum (~2.7 GFLOP before the split), and
// the group pass's intra-chunk products run per head slice; its dCB
// workspace moves ~210 MB through device memory (105 MB written by the
// diag, read once by the dB and once by the dC blocks).
// The fma route forms dB and dC per head (another ~10.6 GFLOP at this
// shape) for pass 9 to sum.
//
// Both routes: x, B and C are read through their strides (column slices of
// the model's conv output); dY is contiguous.  A ragged last chunk is
// masked: rows at or past its end add nothing, and the masked upper
// triangle never evaluates an exponent (it would be positive).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

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
// Row strides of the mma route's bf16 tiles: one 16-byte pad a row keeps
// rows 16-byte aligned for cp.async and ldmatrix and spreads 8 rows over
// all 32 banks.
constexpr int XB = kP + 8, NB = kN + 8, TB = kTile + 8;
constexpr int kSlice = 4 * kThreads;   // (p, n) elements a state-slices block

enum Pass {
  // route "fma" (float32)
  kChunkOut = 0, kState = 1, kStateSide = 2, kDiag = 3, kReduce = 4,
  // route "mma" (bfloat16)
  kChunkOutMma = 5, kStateSlices = 6, kStateSideMma = 7, kDiagMma = 8,
  kGroup = 9, kReduceSlices = 10
};

struct Args {
  const void* x; const float* dt; const float* a; const void* b;
  const void* c; const void* dy;
  const float* cum; const float* dtc; const float* prev; const float* cb;
  float* ds; float* dcum; float* dtot; float* du; float* dbh; float* dch;
  float* dapart; void* dx; float* ddt; float* da; void* db; void* dc;
  float* dcbw; float* ptot; float* pdb; float* pdc;
  int batch, t, h, p, g, n, chunk, nc, sslices, gslices;
  int64_t sxb, sxt, sxh;   // x [B, T, H, P], P contiguous
  int64_t sdb, sdt, sdh;   // dt [B, T, H] (the passes read dtc instead)
  int64_t sbb, sbt, sbg;   // b [B, T, G, N], N contiguous
  int64_t scb, sct, scg;   // c [B, T, G, N], N contiguous
  bool x_vec, b_vec, c_vec, dy_vec;   // bf16 rows by 16-byte cp.async
  bool ds_vec, prev_vec;              // fp32 rows by 16-byte loads
};
// cum, dtc, dcum: [B, H, nc, Q] fp32 (dtc zero past a ragged end); prev,
// ds: [B, nc, H, P, N] fp32; cb: [B, nc, G, Q, Q] fp32, lower triangle;
// dtot, dapart: [B, H, nc]; du: [B, H, nc, Q, P]; dbh, dch (fma): [B, H,
// nc, Q, N]; dy, dx: contiguous [B, T, H, P] in x's type; ddt: [B, T, H];
// da: [H]; db, dc: contiguous [B, T, G, N] in x's type.  mma only: dcbw
// [B, H, nc, tiles, 64, 64] (tile (qt, kt), kt <= qt, at qt (qt + 1) / 2 +
// kt), ptot [B, H, nc, sslices], pdb, pdc [gslices, B, nc, G, Q, N].

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

// ---- the mma route's tools (PTX wrappers as in csrc/ssd.cu) ------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// d += (a_hi + a_lo) b: an fp32 operand fed as its two bf16 terms.
__device__ __forceinline__ void mma_split_a(float (&d)[4], const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4], uint32_t b0,
                                            uint32_t b1) {
  mma_bf16(d, ah, b0, b1);
  mma_bf16(d, al, b0, b1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as two bf16 pairs: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

__device__ __forceinline__ float2 bf16x2_at(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// rows [0, rows) x columns [0, cols) of a bf16 shared tile with row stride
// dst_stride from a row-major source with row stride src_stride; rows past
// `valid_rows` and columns past `valid_cols` are zero.  With `vec` (source
// rows 16-byte aligned, valid_cols a whole number of 16-byte segments)
// each segment is one cp.async of the caller's current commit group;
// otherwise one element a thread, loaded now.
__device__ __forceinline__ void copy_tile(bf16* dst, int dst_stride, const bf16* src,
                                          int64_t src_stride, int rows, int valid_rows,
                                          int cols, int valid_cols, bool vec) {
  constexpr int V = 8;
  if (vec) {
    const int segs = cols / V;
    for (int e = threadIdx.x; e < rows * segs; e += kThreads) {
      const int r = e / segs, s = e - r * segs;
      bf16* d = dst + r * dst_stride + s * V;
      if (r < valid_rows && s * V < valid_cols)
        cp_async16(d, src + r * src_stride + s * V);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols, col = e - r * cols;
      dst[r * dst_stride + col] = (r < valid_rows && col < valid_cols)
                                      ? src[r * src_stride + col]
                                      : __float2bfloat16(0.f);
    }
  }
}

// An fp32 [kP][kN] tile (row stride ss; zero past valid_rows and
// valid_cols) into two bf16 shared tiles, hi and lo (row stride NB).  With
// `vec` (source rows 16-byte aligned, valid_cols % 4 == 0) 16-byte loads.
__device__ __forceinline__ void split_tile(bf16* hi, bf16* lo, const float* src,
                                           int64_t ss, int valid_rows, int valid_cols,
                                           bool vec) {
  for (int e = threadIdx.x; e < kP * kN / 4; e += kThreads) {
    const int r = e / (kN / 4), c4 = (e - r * (kN / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < valid_rows) {
      if (vec && c4 < valid_cols) {
        const float4 f = *reinterpret_cast<const float4*>(src + r * ss + c4);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c4 + i < valid_cols) v[i] = src[r * ss + c4 + i];
      }
    }
    uint32_t h0, l0, h1, l1;
    split2(v[0], v[1], h0, l0);
    split2(v[2], v[3], h1, l1);
    *reinterpret_cast<uint2*>(hi + r * NB + c4) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(lo + r * NB + c4) = make_uint2(l0, l1);
  }
}

// (v0, v1) into columns col, col+1 of a row of `cols` elements.
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int col, int cols, float v0, float v1) {
  if ((cols & 1) == 0 && col + 1 < cols) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
    }
  } else {
    if (col < cols) row[col] = from_f<T>(v0);
    if (col + 1 < cols) row[col + 1] = from_f<T>(v1);
  }
}

// The sum of v over the four lanes that share a fragment row (t = l % 4).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// dA[h] = its chunks' shares summed over (batch, chunk) in order; block 0.
__device__ __forceinline__ void da_sum(const Args& a) {
  if (blockIdx.x != 0) return;
  for (int hh = threadIdx.x; hh < a.h; hh += kThreads) {
    float s = 0.f;
    for (int bi = 0; bi < a.batch; ++bi)
      for (int ci = 0; ci < a.nc; ++ci) s += a.dapart[bhc(a, bi, hh, ci)];
    a.da[hh] = s;
  }
}

// ============================================================================
// Route "fma" (float32)
// ============================================================================

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

// ============================================================================
// Route "mma" (bfloat16): the tensor cores, dB and dC once a group
// ============================================================================

// Warp w of a 64-row output tile: rows 16 (w % 4) .. + 15; with a 128-wide
// output columns 64 (w / 4) .. + 63 (8 fragments of 8), with a 64-wide one
// columns 32 (w / 4) .. + 31 (4 fragments).

// ---- pass 5: the inter-chunk term -------------------------------------------

constexpr int chunk_out_mma_smem() {
  return (3 * kP * NB + 3 * kTile * XB) * 2 + (kMaxChunk + 2 * kTile) * 4;
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_out_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sh = reinterpret_cast<bf16*>(smem_raw);   // [kP][NB]: S_prev, hi
  bf16* sl = sh + kP * NB;                         // [kP][NB]: S_prev, lo
  bf16* cs = sl + kP * NB;                         // [kTile][NB]: C rows
  bf16* ys = cs + kTile * NB;                      // [kTile][XB]: dY rows
  bf16* eh = ys + kTile * XB;                      // [kTile][XB]: exp(cum) dY, hi
  bf16* el = eh + kTile * XB;                      // [kTile][XB]: exp(cum) dY, lo
  float* ecum = reinterpret_cast<float*>(el + kTile * XB);   // [kMaxChunk]
  float* rpart = ecum + kMaxChunk;                 // [2][kTile]: row partials

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int hi = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int gi = hi / (a.h / a.g);
  const int q = a.chunk, t0 = ci * q, qc = min(q, a.t - t0), p = a.p, n = a.n;
  const int64_t hc = bhc(a, bi, hi, ci);
  const int64_t syt = static_cast<int64_t>(a.h) * p;
  const int64_t soff = ((static_cast<int64_t>(bi) * a.nc + ci) * a.h + hi) * p * n;
  for (int i = tid; i < q; i += kThreads) ecum[i] = expf(a.cum[hc * q + i]);
  split_tile(sh, sl, a.prev + soff, n, p, n, a.prev_vec);
  const bf16* cp = static_cast<const bf16*>(a.c) + bi * a.scb + gi * a.scg + t0 * a.sct;
  const bf16* dyp = static_cast<const bf16*>(a.dy)
                    + (static_cast<int64_t>(bi) * a.t + t0) * syt + static_cast<int64_t>(hi) * p;

  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 64, wz = (warp >> 2) * 32;
  const int nk = (n + 15) & ~15;
  float acc[8][4] = {};   // dS_local: p rows wm.., n columns wn..
  for (int r0 = 0; r0 < q; r0 += kTile) {
    const int valid = min(kTile, qc - r0);
    __syncthreads();   // ecum and S_prev written; the last tile used
    copy_tile(cs, NB, cp + r0 * a.sct, a.sct, kTile, valid, kN, n, a.c_vec);
    copy_tile(ys, XB, dyp + r0 * syt, syt, kTile, valid, kP, p, a.dy_vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int e = tid; e < kTile * kP / 2; e += kThreads) {
      const int r = e / (kP / 2), col = 2 * (e - r * (kP / 2));
      const float s = r < valid ? ecum[r0 + r] : 0.f;
      const float2 v = bf16x2_at(ys + r * XB + col);
      uint32_t h, l;
      split2(v.x * s, v.y * s, h, l);
      *reinterpret_cast<uint32_t*>(eh + r * XB + col) = h;
      *reinterpret_cast<uint32_t*>(el + r * XB + col) = l;
    }
    __syncthreads();
    // dS_local[p][n] += sum_k (exp(cum) dY)[k][p] C[k][n]
#pragma unroll
    for (int kb = 0; kb < kTile; kb += 16) {
      uint32_t ah[4], al[4];
      const int ao = (kb + (lane & 7) + ((lane >> 4) << 3)) * XB + wm + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(ah, eh + ao);
      ldsm_x4_t(al, el + ao);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bf[4];
        ldsm_x4_t(bf, cs + (kb + (lane & 15)) * NB + wn + nt * 16 + (lane >> 4) * 8);
        mma_split_a(acc[2 * nt], ah, al, bf[0], bf[1]);
        mma_split_a(acc[2 * nt + 1], ah, al, bf[2], bf[3]);
      }
    }
    // Z[q][p] = sum_n C[q][n] S_prev[p][n] (q rows wm.., p columns wz..),
    // then dcum_q = exp(cum_q) sum_p dY[q][p] Z[q][p]
    float z[4][4] = {};
    for (int kk = 0; kk < nk; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, cs + (wm + (lane & 15)) * NB + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bh[4], bl[4];
        const int bo = (wz + nt * 16 + (lane & 7) + (lane >> 4) * 8) * NB + kk
                       + ((lane >> 3) & 1) * 8;
        ldsm_x4(bh, sh + bo);
        ldsm_x4(bl, sl + bo);
        mma_bf16(z[2 * nt], af, bh[0], bh[1]);
        mma_bf16(z[2 * nt], af, bl[0], bl[1]);
        mma_bf16(z[2 * nt + 1], af, bh[2], bh[3]);
        mma_bf16(z[2 * nt + 1], af, bl[2], bl[3]);
      }
    }
    float s0 = 0.f, s1 = 0.f;   // rows wm + gq and wm + gq + 8
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int col = wz + f * 8 + 2 * tq;
      const float2 y0 = bf16x2_at(ys + (wm + gq) * XB + col);
      const float2 y1 = bf16x2_at(ys + (wm + gq + 8) * XB + col);
      s0 = fmaf(y0.x, z[f][0], s0);
      s0 = fmaf(y0.y, z[f][1], s0);
      s1 = fmaf(y1.x, z[f][2], s1);
      s1 = fmaf(y1.y, z[f][3], s1);
    }
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
    if (tq == 0) {
      rpart[(warp >> 2) * kTile + wm + gq] = s0;
      rpart[(warp >> 2) * kTile + wm + gq + 8] = s1;
    }
    __syncthreads();
    if (tid < kTile && r0 + tid < q)
      a.dcum[hc * q + r0 + tid] =
          tid < valid ? ecum[r0 + tid] * (rpart[tid] + rpart[kTile + tid]) : 0.f;
  }
  float* dsp = a.ds + soff;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = wn + nt * 8 + 2 * tq;
    if (wm + gq < p) store_pair(dsp + (wm + gq) * n, col, n, acc[nt][0], acc[nt][1]);
    if (wm + gq + 8 < p) store_pair(dsp + (wm + gq + 8) * n, col, n, acc[nt][2], acc[nt][3]);
  }
}

// ---- pass 6: the reverse state pass, in slices of (p, n) -----------------------

__global__ void __launch_bounds__(kThreads) ssd_bwd_state_slices_kernel(const Args a) {
  __shared__ float red[kWarps];
  const int pn = a.p * a.n;
  const int e0 = static_cast<int>(blockIdx.x) * kSlice + static_cast<int>(threadIdx.x) * 4;
  const int hi = blockIdx.y, bi = blockIdx.z, nc = a.nc, q = a.chunk;
  // four elements a thread: one 16-byte access where all four lie inside,
  // else one at a time; a thread past the slice's end touches nothing
  const bool whole = (pn & 3) == 0 && e0 + 4 <= pn;
  const int64_t cstride = static_cast<int64_t>(a.h) * pn;
  const int64_t base = (static_cast<int64_t>(bi) * nc * a.h + hi) * pn + e0;
  float g[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t o = base + c * cstride;
    const float e = expf(a.cum[bhc(a, bi, hi, c) * q + q - 1]);
    float loc[4] = {0.f, 0.f, 0.f, 0.f}, pv[4] = {0.f, 0.f, 0.f, 0.f};
    if (whole) {
      const float4 l4 = *reinterpret_cast<const float4*>(a.ds + o);
      const float4 p4 = *reinterpret_cast<const float4*>(a.prev + o);
      loc[0] = l4.x; loc[1] = l4.y; loc[2] = l4.z; loc[3] = l4.w;
      pv[0] = p4.x; pv[1] = p4.y; pv[2] = p4.z; pv[3] = p4.w;
      *reinterpret_cast<float4*>(a.ds + o) = make_float4(g[0], g[1], g[2], g[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e0 + i < pn) {
          loc[i] = a.ds[o + i];
          pv[i] = a.prev[o + i];
          a.ds[o + i] = g[i];
        }
      }
    }
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      part = fmaf(g[i], pv[i], part);
      g[i] = fmaf(e, g[i], loc[i]);
    }
    const float s = block_sum(part, red);
    if (threadIdx.x == 0) a.ptot[bhc(a, bi, hi, c) * a.sslices + blockIdx.x] = s;
  }
}

// ---- pass 7: the chunk state's terms ------------------------------------------

constexpr int state_side_mma_smem() {
  return (3 * kP * NB + kTile * XB) * 2 + (2 * kMaxChunk + 2 * kTile + kWarps) * 4;
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_state_side_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* dh = reinterpret_cast<bf16*>(smem_raw);   // [kP][NB]: dS, hi
  bf16* dl = dh + kP * NB;                         // [kP][NB]: dS, lo
  bf16* bs = dl + kP * NB;                         // [kTile][NB]: B rows
  bf16* xs = bs + kTile * NB;                      // [kTile][XB]: x rows
  float* wk = reinterpret_cast<float*>(xs + kTile * XB);   // [kMaxChunk]: w
  float* dw = wk + kMaxChunk;                      // [kMaxChunk]: u_k . du_k
  float* rpart = dw + kMaxChunk;                   // [2][kTile]
  float* red = rpart + 2 * kTile;                  // [kWarps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int hi = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int gi = hi / (a.h / a.g);
  const int q = a.chunk, t0 = ci * q, qc = min(q, a.t - t0), p = a.p, n = a.n;
  const int64_t hc = bhc(a, bi, hi, ci);
  const float* cum = a.cum + hc * q;
  const float* dtc = a.dtc + hc * q;
  const float total = cum[q - 1];
  for (int i = tid; i < q; i += kThreads) wk[i] = expf(total - cum[i]);
  const int64_t soff = ((static_cast<int64_t>(bi) * a.nc + ci) * a.h + hi) * p * n;
  split_tile(dh, dl, a.ds + soff, n, p, n, a.ds_vec);
  const bf16* bp = static_cast<const bf16*>(a.b) + bi * a.sbb + gi * a.sbg + t0 * a.sbt;
  const bf16* xp = static_cast<const bf16*>(a.x) + bi * a.sxb + hi * a.sxh + t0 * a.sxt;
  float* dup = a.du + hc * q * p;

  const int wm = (warp & 3) * 16, wp = (warp >> 2) * 32;
  const int nk = (n + 15) & ~15;
  for (int r0 = 0; r0 < q; r0 += kTile) {
    const int valid = min(kTile, qc - r0);
    __syncthreads();   // w and dS written; the last tile used
    copy_tile(bs, NB, bp + r0 * a.sbt, a.sbt, kTile, valid, kN, n, a.b_vec);
    copy_tile(xs, XB, xp + r0 * a.sxt, a.sxt, kTile, valid, kP, p, a.x_vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    // du[k][p] = w_k sum_n B[k][n] dS[p][n]: k rows wm.., p columns wp..
    float d[4][4] = {};
    for (int kk = 0; kk < nk; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, bs + (wm + (lane & 15)) * NB + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bh[4], bl[4];
        const int bo = (wp + nt * 16 + (lane & 7) + (lane >> 4) * 8) * NB + kk
                       + ((lane >> 3) & 1) * 8;
        ldsm_x4(bh, dh + bo);
        ldsm_x4(bl, dl + bo);
        mma_bf16(d[2 * nt], af, bh[0], bh[1]);
        mma_bf16(d[2 * nt], af, bl[0], bl[1]);
        mma_bf16(d[2 * nt + 1], af, bh[2], bh[3]);
        mma_bf16(d[2 * nt + 1], af, bl[2], bl[3]);
      }
    }
    float s[2] = {0.f, 0.f};   // sum_p x du of rows wm + gq and wm + gq + 8
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = wm + gq + 8 * rr, kr = r0 + row;
      const float w = kr < q ? wk[kr] : 0.f;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int col = wp + f * 8 + 2 * tq;
        const float v0 = w * d[f][2 * rr], v1 = w * d[f][2 * rr + 1];
        if (kr < q) store_pair(dup + static_cast<int64_t>(kr) * p, col, p, v0, v1);
        const float2 xv = bf16x2_at(xs + row * XB + col);
        s[rr] = fmaf(xv.x, v0, s[rr]);
        s[rr] = fmaf(xv.y, v1, s[rr]);
      }
      s[rr] = quad_sum(s[rr]);
    }
    if (tq == 0) {
      rpart[(warp >> 2) * kTile + wm + gq] = s[0];
      rpart[(warp >> 2) * kTile + wm + gq + 8] = s[1];
    }
    __syncthreads();
    if (tid < kTile && r0 + tid < q)
      dw[r0 + tid] = dtc[r0 + tid] * (rpart[tid] + rpart[kTile + tid]);
  }
  __syncthreads();
  for (int i = tid; i < q; i += kThreads) a.dcum[hc * q + i] -= dw[i];
  const float s = block_sum(tid < q ? dw[tid] : 0.f, red);
  if (tid == 0) {
    float carry = 0.f;
    for (int j = 0; j < a.sslices; ++j) carry += a.ptot[hc * a.sslices + j];
    a.dtot[hc] = fmaf(expf(total), carry, s);
  }
}

// ---- pass 8: the intra-chunk term, then dx, ddt and dA's share ----------------

constexpr int diag_mma_smem() {
  return (2 * kTile * XB + 2 * kTile * TB) * 2 + (5 * kMaxChunk + 6 * kTile + kWarps) * 4;
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_diag_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // [kTile][XB]: x, key tile
  bf16* ys = xs + kTile * XB;                      // [kTile][XB]: dY, q tile
  bf16* lh = ys + kTile * XB;                      // [kTile][TB]: C B^T L [q][k], hi
  bf16* ll = lh + kTile * TB;                      // [kTile][TB]: lo
  float* cum_s = reinterpret_cast<float*>(ll + kTile * TB);   // [kMaxChunk]
  float* dt_s = cum_s + kMaxChunk;                 // [kMaxChunk]
  float* drow = dt_s + kMaxChunk;                  // [kMaxChunk]: row sums of dCB C B^T
  float* dcol = drow + kMaxChunk;                  // [kMaxChunk]: minus its column sums
  float* sx = dcol + kMaxChunk;                    // [kMaxChunk]: sum_p du x
  float* rpart = sx + kMaxChunk;                   // [2][kTile]
  float* cpart = rpart + 2 * kTile;                // [4][kTile]
  float* red = cpart + 4 * kTile;                  // [kWarps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int hi = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int gi = hi / (a.h / a.g);
  const int q = a.chunk, t0 = ci * q, qc = min(q, a.t - t0), p = a.p;
  const int64_t hc = bhc(a, bi, hi, ci);
  const int64_t syt = static_cast<int64_t>(a.h) * p;
  for (int i = tid; i < q; i += kThreads) {
    cum_s[i] = a.cum[hc * q + i];
    dt_s[i] = a.dtc[hc * q + i];
    drow[i] = 0.f;
    dcol[i] = 0.f;
    sx[i] = 0.f;
  }
  const bf16* xp = static_cast<const bf16*>(a.x) + bi * a.sxb + hi * a.sxh + t0 * a.sxt;
  const bf16* dyp = static_cast<const bf16*>(a.dy)
                    + (static_cast<int64_t>(bi) * a.t + t0) * syt + static_cast<int64_t>(hi) * p;
  bf16* dxp = static_cast<bf16*>(a.dx) + (static_cast<int64_t>(bi) * a.t + t0) * syt
              + static_cast<int64_t>(hi) * p;
  const float* cbm = a.cb + ((static_cast<int64_t>(bi) * a.nc + ci) * a.g + gi) * q * q;
  const float* dup = a.du + hc * q * p;
  const int ntq = (q + kTile - 1) / kTile;
  float* wsb = a.dcbw + hc * (ntq * (ntq + 1) / 2) * (kTile * kTile);
  const int nt = (qc + kTile - 1) / kTile;
  const int nkp = (p + 15) & ~15;
  // warp rows wm..wm+15 (q rows of dM, k rows of du), columns wn..wn+31
  // (k columns of dM, p columns of du)
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;

  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();   // cum_s and dt_s written; the last key tile used
    copy_tile(xs, XB, xp + k0 * a.sxt, a.sxt, kTile, min(kTile, qc - k0), kP, p, a.x_vec);
    float du[4][4] = {};
    for (int qt = kt; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      if (qt > kt) __syncthreads();   // dY, C B^T L and the partial sums used
      copy_tile(ys, XB, dyp + q0 * syt, syt, kTile, min(kTile, qc - q0), kP, p, a.dy_vec);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      // dM[q][k] = sum_p dY_q[p] x_k[p], exact
      float m[4][4] = {};
      for (int kk = 0; kk < nkp; kk += 16) {
        uint32_t af[4];
        ldsm_x4(af, ys + (wm + (lane & 15)) * XB + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nt2 = 0; nt2 < 2; ++nt2) {
          uint32_t bf[4];
          ldsm_x4(bf, xs + (wn + nt2 * 16 + (lane & 7) + (lane >> 4) * 8) * XB + kk
                          + ((lane >> 3) & 1) * 8);
          mma_bf16(m[2 * nt2], af, bf[0], bf[1]);
          mma_bf16(m[2 * nt2 + 1], af, bf[2], bf[3]);
        }
      }
      // dCB = dt_k dM L to the workspace, C B^T L split into lh and ll, and
      // the row and column sums of dCB C B^T; the exponent only where
      // k <= q < qc (above the diagonal it is positive)
      float* wt = wsb + (qt * (qt + 1) / 2 + kt) * (kTile * kTile);
      float rs[2] = {0.f, 0.f}, cs[4][2] = {};
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int kl = wn + f * 8 + 2 * tq;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int ql = wm + gq + 8 * rr, qq = q0 + ql;
          float dcb[2], cbl[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kk = k0 + kl + j;
            const bool keep = qq < qc && kk <= qq;
            const float l = keep ? expf(cum_s[qq] - cum_s[kk]) : 0.f;
            const float cbv = keep ? cbm[static_cast<int64_t>(qq) * q + kk] : 0.f;
            dcb[j] = keep ? m[f][2 * rr + j] * dt_s[kk] * l : 0.f;
            cbl[j] = cbv * l;
            const float dll = dcb[j] * cbv;
            rs[rr] += dll;
            cs[f][j] += dll;
          }
          *reinterpret_cast<float2*>(wt + ql * kTile + kl) = make_float2(dcb[0], dcb[1]);
          uint32_t h, lo;
          split2(cbl[0], cbl[1], h, lo);
          *reinterpret_cast<uint32_t*>(lh + ql * TB + kl) = h;
          *reinterpret_cast<uint32_t*>(ll + ql * TB + kl) = lo;
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        rs[rr] = quad_sum(rs[rr]);
        if (tq == 0) rpart[(warp >> 2) * kTile + wm + gq + 8 * rr] = rs[rr];
      }
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v = cs[f][j];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (gq == 0) cpart[(warp & 3) * kTile + wn + f * 8 + 2 * tq + j] = v;
        }
      __syncthreads();
      if (tid < kTile) {
        if (q0 + tid < q) drow[q0 + tid] += rpart[tid] + rpart[kTile + tid];
      } else if (tid < 2 * kTile) {
        const int col = tid - kTile;
        if (k0 + col < q)
          dcol[k0 + col] -= ((cpart[col] + cpart[kTile + col]) + cpart[2 * kTile + col])
                            + cpart[3 * kTile + col];
      }
      // du[k][p] += sum_q (C B^T L)[q][k] dY[q][p]
#pragma unroll
      for (int kb = 0; kb < kTile; kb += 16) {
        uint32_t ah[4], al[4];
        const int ao = (kb + (lane & 7) + ((lane >> 4) << 3)) * TB + wm + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(ah, lh + ao);
        ldsm_x4_t(al, ll + ao);
#pragma unroll
        for (int nt2 = 0; nt2 < 2; ++nt2) {
          uint32_t bf[4];
          ldsm_x4_t(bf, ys + (kb + (lane & 15)) * XB + wn + nt2 * 16 + (lane >> 4) * 8);
          mma_split_a(du[2 * nt2], ah, al, bf[0], bf[1]);
          mma_split_a(du[2 * nt2 + 1], ah, al, bf[2], bf[3]);
        }
      }
    }
    // the key tile's du is complete: add the state side's, write dx = dt
    // du, and sum_p du x for ddt
    __syncthreads();   // rpart read
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int kl = wm + gq + 8 * rr, kr = k0 + kl;
      if (kr < qc) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int col = wn + f * 8 + 2 * tq;
          const float* prior = dup + static_cast<int64_t>(kr) * p + col;
          const float d0 = du[f][2 * rr] + (col < p ? prior[0] : 0.f);
          const float d1 = du[f][2 * rr + 1] + (col + 1 < p ? prior[1] : 0.f);
          store_pair(dxp + kr * syt, col, p, dt_s[kr] * d0, dt_s[kr] * d1);
          const float2 xv = bf16x2_at(xs + kl * XB + col);
          s[rr] = fmaf(xv.x, d0, s[rr]);
          s[rr] = fmaf(xv.y, d1, s[rr]);
        }
      }
      s[rr] = quad_sum(s[rr]);
      if (tq == 0) rpart[(warp >> 2) * kTile + kl] = s[rr];
    }
    __syncthreads();
    if (tid < kTile && k0 + tid < qc) sx[k0 + tid] = rpart[tid] + rpart[kTile + tid];
  }
  __syncthreads();   // drow, dcol and sx complete

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

  // ddt = A R + sum_p du x
  const float A = a.a[hi];
  float* ddt = a.ddt + (static_cast<int64_t>(bi) * a.t + t0) * a.h + hi;
  for (int row = tid; row < qc; row += kThreads)
    ddt[static_cast<int64_t>(row) * a.h] = fmaf(A, drow[row], sx[row]);
}

// ---- pass 9: dB and dC once a group, in head slices -----------------------------

// Phase 1 (the heads' own terms): in_s [kTile][XB] (dY or x rows), then
// S_prev or dS split into [kP][NB] hi and lo.  Phase 2 (the summed dCB)
// reuses the same bytes: dCB_s hi and lo [kTile][TB], then B or C rows
// [kTile][NB].
constexpr int group_smem() { return (kTile * XB + 2 * kP * NB) * 2 + kTile * 4; }
static_assert(2 * kTile * TB + kTile * NB <= kTile * XB + 2 * kP * NB,
              "the group pass's second phase fits in its first's tiles");

__global__ void __launch_bounds__(kThreads) ssd_bwd_group_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* in_s = reinterpret_cast<bf16*>(smem_raw);   // phase 1
  bf16* hs = in_s + kTile * XB;
  bf16* ls = hs + kP * NB;
  bf16* dh = reinterpret_cast<bf16*>(smem_raw);      // phase 2
  bf16* dl = dh + kTile * TB;
  bf16* op = dl + kTile * TB;
  float* scale = reinterpret_cast<float*>(ls + kP * NB);   // [kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const bool is_db = blockIdx.y & 1;
  const int slice = blockIdx.y >> 1;
  const int gi = blockIdx.z % a.g, ci = (blockIdx.z / a.g) % a.nc,
            bi = blockIdx.z / (a.g * a.nc);
  const int r = a.h / a.g, j0 = slice * r / a.gslices, j1 = (slice + 1) * r / a.gslices;
  const int q = a.chunk, t0 = ci * q, qc = min(q, a.t - t0), p = a.p, n = a.n;
  const int rt = blockIdx.x, r0 = rt * kTile, valid = min(kTile, qc - r0);
  const int64_t syt = static_cast<int64_t>(a.h) * p;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 64;
  const int nkp = (p + 15) & ~15;

  // the heads' own terms, summed in head order inside the accumulator:
  // dC: exp(cum_h,q) (dY_h S_prev,h)[q]; dB: w_h,k dt_h,k (x_h dS_h)[k]
  float acc[8][4] = {};
  for (int jh = j0; jh < j1; ++jh) {
    const int hh = gi * r + jh;
    const int64_t hc = bhc(a, bi, hh, ci);
    const int64_t soff = ((static_cast<int64_t>(bi) * a.nc + ci) * a.h + hh) * p * n;
    __syncthreads();   // the last head's tiles used
    if (is_db)
      copy_tile(in_s, XB, static_cast<const bf16*>(a.x) + bi * a.sxb + hh * a.sxh
                              + (t0 + r0) * a.sxt,
                a.sxt, kTile, valid, kP, p, a.x_vec);
    else
      copy_tile(in_s, XB, static_cast<const bf16*>(a.dy)
                              + (static_cast<int64_t>(bi) * a.t + t0 + r0) * syt
                              + static_cast<int64_t>(hh) * p,
                syt, kTile, valid, kP, p, a.dy_vec);
    cp_async_commit();
    if (tid < kTile) {
      const float* cum = a.cum + hc * q;
      scale[tid] = tid < valid ? (is_db ? expf(cum[q - 1] - cum[r0 + tid]) * a.dtc[hc * q + r0 + tid]
                                        : expf(cum[r0 + tid]))
                               : 0.f;
    }
    if (is_db)
      split_tile(hs, ls, a.ds + soff, n, p, n, a.ds_vec);
    else
      split_tile(hs, ls, a.prev + soff, n, p, n, a.prev_vec);
    cp_async_wait_all();
    __syncthreads();
    float part[8][4] = {};
    for (int kk = 0; kk < nkp; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, in_s + (wm + (lane & 15)) * XB + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bh[4], bl[4];
        const int bo = (kk + (lane & 15)) * NB + wn + nt * 16 + (lane >> 4) * 8;
        ldsm_x4_t(bh, hs + bo);
        ldsm_x4_t(bl, ls + bo);
        mma_bf16(part[2 * nt], af, bh[0], bh[1]);
        mma_bf16(part[2 * nt], af, bl[0], bl[1]);
        mma_bf16(part[2 * nt + 1], af, bh[2], bh[3]);
        mma_bf16(part[2 * nt + 1], af, bl[2], bl[3]);
      }
    }
    const float s0 = scale[wm + gq], s1 = scale[wm + gq + 8];
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      acc[f][0] = fmaf(s0, part[f][0], acc[f][0]);
      acc[f][1] = fmaf(s0, part[f][1], acc[f][1]);
      acc[f][2] = fmaf(s1, part[f][2], acc[f][2]);
      acc[f][3] = fmaf(s1, part[f][3], acc[f][3]);
    }
  }

  // the intra-chunk term: dCB_s = the slice's dCB_h summed in head order,
  // a tile (qt, kt) at a time; dC[q] += dCB_s B, dB[k] += dCB_s^T C
  const int nt = (qc + kTile - 1) / kTile, ntq = (q + kTile - 1) / kTile;
  const int64_t ntri = ntq * (ntq + 1) / 2;
  if (rt < nt) {
    const int first = is_db ? rt : 0, last = is_db ? nt - 1 : rt;
    for (int ot = first; ot <= last; ++ot) {
      const int qt = is_db ? ot : rt, kt = is_db ? rt : ot;
      __syncthreads();   // the last tiles used
      if (is_db)
        copy_tile(op, NB, static_cast<const bf16*>(a.c) + bi * a.scb + gi * a.scg
                              + (t0 + qt * kTile) * a.sct,
                  a.sct, kTile, min(kTile, qc - qt * kTile), kN, n, a.c_vec);
      else
        copy_tile(op, NB, static_cast<const bf16*>(a.b) + bi * a.sbb + gi * a.sbg
                              + (t0 + kt * kTile) * a.sbt,
                  a.sbt, kTile, min(kTile, qc - kt * kTile), kN, n, a.b_vec);
      cp_async_commit();
      const int64_t tile = qt * (qt + 1) / 2 + kt;
      for (int e = tid; e < kTile * kTile / 4; e += kThreads) {
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int jh = j0; jh < j1; ++jh) {
          const float4 v = *reinterpret_cast<const float4*>(
              a.dcbw + (bhc(a, bi, gi * r + jh, ci) * ntri + tile) * (kTile * kTile) + 4 * e);
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        const int rr = (4 * e) / kTile, cc = (4 * e) % kTile;
        uint32_t h0, l0, h1, l1;
        split2(sum.x, sum.y, h0, l0);
        split2(sum.z, sum.w, h1, l1);
        *reinterpret_cast<uint2*>(dh + rr * TB + cc) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(dl + rr * TB + cc) = make_uint2(l0, l1);
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int kb = 0; kb < kTile; kb += 16) {
        uint32_t ah[4], al[4];
        if (is_db) {   // A = dCB_s^T: k rows, q depth, from the [q][k] tile
          const int ao = (kb + (lane & 7) + ((lane >> 4) << 3)) * TB + wm + ((lane >> 3) & 1) * 8;
          ldsm_x4_t(ah, dh + ao);
          ldsm_x4_t(al, dl + ao);
        } else {       // A = dCB_s: q rows, k depth
          const int ao = (wm + (lane & 15)) * TB + kb + (lane >> 4) * 8;
          ldsm_x4(ah, dh + ao);
          ldsm_x4(al, dl + ao);
        }
#pragma unroll
        for (int nt2 = 0; nt2 < 4; ++nt2) {
          uint32_t bf[4];
          ldsm_x4_t(bf, op + (kb + (lane & 15)) * NB + wn + nt2 * 16 + (lane >> 4) * 8);
          mma_split_a(acc[2 * nt2], ah, al, bf[0], bf[1]);
          mma_split_a(acc[2 * nt2 + 1], ah, al, bf[2], bf[3]);
        }
      }
    }
  }

  float* out = (is_db ? a.pdb : a.pdc)
               + (((static_cast<int64_t>(slice) * a.batch + bi) * a.nc + ci) * a.g + gi) * q * n;
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int col = wn + f * 8 + 2 * tq, row = r0 + wm + gq;
    if (row < q) store_pair(out + static_cast<int64_t>(row) * n, col, n, acc[f][0], acc[f][1]);
    if (row + 8 < q)
      store_pair(out + static_cast<int64_t>(row + 8) * n, col, n, acc[f][2], acc[f][3]);
  }
}

// ---- pass 10: the slices' sums and dA ---------------------------------------------

__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_slices_kernel(const Args a) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t total = static_cast<int64_t>(a.batch) * a.t * a.g * a.n;
  if (idx < total) {
    const int nn = static_cast<int>(idx % a.n);
    int64_t rest = idx / a.n;
    const int gi = static_cast<int>(rest % a.g);
    rest /= a.g;
    const int tt = static_cast<int>(rest % a.t);
    const int bi = static_cast<int>(rest / a.t);
    const int q = a.chunk, ci = tt / q;
    const int64_t in_slice = ((static_cast<int64_t>(bi) * a.nc + ci) * a.g + gi) * q * a.n
                             + static_cast<int64_t>(tt - ci * q) * a.n + nn;
    const int64_t stride = static_cast<int64_t>(a.batch) * a.nc * a.g * q * a.n;
    float sb = 0.f, sc = 0.f;
    for (int s = 0; s < a.gslices; ++s) {
      sb += a.pdb[s * stride + in_slice];
      sc += a.pdc[s * stride + in_slice];
    }
    static_cast<bf16*>(a.db)[idx] = __float2bfloat16(sb);
    static_cast<bf16*>(a.dc)[idx] = __float2bfloat16(sc);
  }
  da_sum(a);
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

// f(kernel, grid, dynamic shared memory) for pass `pass`: the fma passes
// exist for float, the mma passes for bfloat16.
template <typename T, typename F>
cudaError_t with_pass(int pass, const Args& a, F&& f) {
  const dim3 chunks(a.h, a.nc, a.batch);
  const int64_t outs = static_cast<int64_t>(a.batch) * a.t * a.g * a.n;
  const dim3 out_blocks(static_cast<unsigned>((outs + kThreads - 1) / kThreads));
  if constexpr (sizeof(T) == 4) {
    switch (pass) {
      case kChunkOut:
        return f(ssd_bwd_chunk_out_kernel<T>, chunks, chunk_out_smem());
      case kState:
        return f(ssd_bwd_state_kernel, dim3(a.h, a.batch), 0);
      case kStateSide:
        return f(ssd_bwd_state_side_kernel<T>, chunks, state_side_smem());
      case kDiag:
        return f(ssd_bwd_diag_kernel<T>, chunks, diag_smem());
      case kReduce:
        return f(ssd_bwd_reduce_kernel<T>, out_blocks, 0);
    }
  } else {
    switch (pass) {
      case kChunkOutMma:
        return f(ssd_bwd_chunk_out_mma_kernel, chunks, chunk_out_mma_smem());
      case kStateSlices:
        return f(ssd_bwd_state_slices_kernel, dim3(a.sslices, a.h, a.batch), 0);
      case kStateSideMma:
        return f(ssd_bwd_state_side_mma_kernel, chunks, state_side_mma_smem());
      case kDiagMma:
        return f(ssd_bwd_diag_mma_kernel, chunks, diag_mma_smem());
      case kGroup:
        return f(ssd_bwd_group_kernel,
                 dim3((a.chunk + kTile - 1) / kTile, 2 * a.gslices, a.batch * a.nc * a.g),
                 group_smem());
      case kReduceSlices:
        return f(ssd_bwd_reduce_slices_kernel, out_blocks, 0);
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

// Rows of `width` elements of `elem` bytes at `ptr` with element strides
// s[0..2] can be copied 16 bytes at a time.
bool rows_aligned(const void* ptr, const int64_t* s, int width, int elem) {
  const int v = 16 / elem;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s[0] % v == 0 &&
         s[1] % v == 0 && s[2] % v == 0 && width % v == 0;
}

bool is_mma(int pass) { return pass >= kChunkOutMma && pass <= kReduceSlices; }

}  // namespace

// pass: route "fma" (dtype 0, float32) 0 chunk out, 1 state, 2 state side,
// 3 diag, 4 reduce; route "mma" (dtype 1, bfloat16: x, b, c, dy, dx, db and
// dc; everything else is float32) 5 chunk out, 6 state slices, 7 state
// side, 8 diag, 9 group, 10 reduce slices.  ptrs (26): x, dt, a, b, c, dy,
// cum, dtc, prev, cb, ds, dcum, dtot, du, dbh, dch, dapart, dx, ddt, da,
// db, dc, dcbw, ptot, pdb, pdc (a pass ignores what it does not read or
// write).  dims: batch, t, h, p, g, n, chunk (the scan's Q, at most t), the
// state slices (ceil(p n / 1,024)) and the group slices (1 .. h / g; both
// read by the mma route only).  strides: 12 element strides, x (b, t, h),
// dt (b, t, h), b (b, t, g), c (b, t, g); the last axis of x, b and c is
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_bwd_pass_launch(int pass, int dtype, void* const* ptrs,
                                   const int* dims, const int64_t* strides,
                                   void* stream) {
  const int batch = dims[0], t = dims[1], h = dims[2], p = dims[3],
            g = dims[4], n = dims[5], chunk = dims[6];
  if (pass < 0 || pass > kReduceSlices || dtype != (is_mma(pass) ? 1 : 0) ||
      batch <= 0 || t <= 0 || h <= 0 || g <= 0 || h % g != 0 || p <= 0 ||
      p > kP || n <= 0 || n > kN || chunk <= 0 || chunk > kMaxChunk || chunk > t)
    return cudaErrorInvalidValue;
  const int nc = (t + chunk - 1) / chunk;
  if (h > 65535 || nc > 65535 || batch > 65535 ||
      (static_cast<int64_t>(batch) * t * g * n + kThreads - 1) / kThreads > 0x7fffffff)
    return cudaErrorInvalidValue;   // grid limits
  if (is_mma(pass) &&
      (dims[7] != (p * n + kSlice - 1) / kSlice || dims[8] < 1 || dims[8] > h / g ||
       static_cast<int64_t>(batch) * nc * g > 65535))
    return cudaErrorInvalidValue;
  Args a{};
  a.x = ptrs[0];
  a.dt = static_cast<const float*>(ptrs[1]);
  a.a = static_cast<const float*>(ptrs[2]);
  a.b = ptrs[3];
  a.c = ptrs[4];
  a.dy = ptrs[5];
  a.cum = static_cast<const float*>(ptrs[6]);
  a.dtc = static_cast<const float*>(ptrs[7]);
  a.prev = static_cast<const float*>(ptrs[8]);
  a.cb = static_cast<const float*>(ptrs[9]);
  float* const* f = reinterpret_cast<float* const*>(ptrs);
  a.ds = f[10]; a.dcum = f[11]; a.dtot = f[12]; a.du = f[13]; a.dbh = f[14];
  a.dch = f[15]; a.dapart = f[16];
  a.dx = ptrs[17];
  a.ddt = f[18]; a.da = f[19];
  a.db = ptrs[20];
  a.dc = ptrs[21];
  a.dcbw = f[22]; a.ptot = f[23]; a.pdb = f[24]; a.pdc = f[25];
  a.batch = batch; a.t = t; a.h = h; a.p = p; a.g = g; a.n = n; a.chunk = chunk;
  a.nc = nc; a.sslices = dims[7]; a.gslices = dims[8];
  a.sxb = strides[0]; a.sxt = strides[1]; a.sxh = strides[2];
  a.sdb = strides[3]; a.sdt = strides[4]; a.sdh = strides[5];
  a.sbb = strides[6]; a.sbt = strides[7]; a.sbg = strides[8];
  a.scb = strides[9]; a.sct = strides[10]; a.scg = strides[11];
  const int elem = dtype == 0 ? 4 : 2;
  const int64_t dy_strides[3] = {static_cast<int64_t>(t) * h * p,
                                 static_cast<int64_t>(h) * p, p};
  a.x_vec = rows_aligned(ptrs[0], strides, p, elem);
  a.b_vec = rows_aligned(ptrs[3], strides + 6, n, elem);
  a.c_vec = rows_aligned(ptrs[4], strides + 9, n, elem);
  a.dy_vec = rows_aligned(ptrs[5], dy_strides, p, elem);
  a.ds_vec = reinterpret_cast<uintptr_t>(ptrs[10]) % 16 == 0 && n % 4 == 0;
  a.prev_vec = reinterpret_cast<uintptr_t>(ptrs[8]) % 16 == 0 && n % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_pass<float>(pass, a, st);
  return run_pass<__nv_bfloat16>(pass, a, st);
}

// The passes of one backward call in order, the route's by dtype (0:
// "fma", passes 0-4; 1: "mma", passes 5-10), each checked with
// cudaGetLastError() before the next is launched; arguments as for
// ssd_bwd_pass_launch.  On an error *failed_pass names the pass.
extern "C" int ssd_bwd_launch(int dtype, void* const* ptrs, const int* dims,
                              const int64_t* strides, void* stream,
                              int* failed_pass) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int first = dtype == 0 ? kChunkOut : kChunkOutMma;
  const int last = dtype == 0 ? kReduce : kReduceSlices;
  for (int pass = first; pass <= last; ++pass) {
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
// thread (out[3]), for the build report: the fma passes (0-4) as float32,
// the mma passes (5-10) as bfloat16.  Returns a CUDA error code.
extern "C" int ssd_bwd_resources(int pass, int* out) {
  if (pass < 0 || pass > kReduceSlices) return cudaErrorInvalidValue;
  if (is_mma(pass)) return pass_resources<__nv_bfloat16>(pass, out);
  return pass_resources<float>(pass, out);
}
