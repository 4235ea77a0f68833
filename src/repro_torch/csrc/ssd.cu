// Mamba-2 SSD chunked scan for Hopper (sm_90a): four parallel passes.
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
// with S the [P, N] state carried from chunk to chunk, and y written once
// in x's type.  Head h reads group h / (H / G) of B and C.
//
// Bound on this card.  At the mamba2-2.7b prefill shape (B 2, T 4096, H 80,
// P 64, G 1, N 128, Q 256, bf16) the scan must read x, dt, B, C once and
// write y once: about 175 MB, 0.052 ms at 3.35 TB/s.  Its arithmetic is
// about 32 GFLOP (lower triangles only), 0.033 ms on the bf16 tensor
// cores, so bytes bound it.
//
// Design.  The TPU kernel carries S across a sequential grid axis; Hopper
// has none.  The kernel it replaced here (one block per (batch, head)
// walking the chunks in series) ran 160 blocks on 132 SMs, every product
// as fp32 FMAs on the CUDA cores, and C B^T once per head.  So the scan is
// cut into four passes, each parallel over its own grid, launched one
// after another on the caller's stream (four device launches per scan
// call; bytes at the shape above):
//
//   1. chunk state, grid (head, chunk, batch), 256 threads: cum by a
//      fixed-order scan, and the chunk's own state S_c = (x ⊙ dt
//      exp(total - cum))^T B, a [P, Q].[Q, N] product, with key tiles of
//      64 through two buffers.  Reads x (84 MB), dt, and B (4 MB, from L2
//      for all but the first head of a group); writes cum and dt in the
//      chunk's layout (2.6 MB each) and S_c (84 MB fp32).
//   2. C B^T, grid (lower-triangle 64x64 tile, chunk, batch x group): once
//      per (batch, chunk, group), never per head; writes only k <= q into
//      [B, nc, G, Q, Q] fp32 (8.4 MB at G = 1, which L2 holds).
//   3. state pass, grid (4-element slices of P x N, head, batch): each
//      thread walks the chunks in order, S_prev[c] = S, then
//      S = exp(total_c) S + S_c[c], carrying S in fp32 and writing S_prev
//      in x's type to a buffer of its own (84 MB read, 42 MB written in
//      bf16).  The only sequential loop, 16 steps long.
//   4. chunk scan, grid (head, chunk, batch), 256 threads: Y = (C B^T ⊙
//      L).(dt x) + exp(cum) (C S_prev^T), both products accumulated in
//      fp32 registers, y written once (84 MB).  Warp w takes row blocks w
//      and 15 - w of 16 rows, so every warp walks 17 key steps.  Keys
//      before a row block take exp(cum_q - cum_k) as exp(cum_q - cum_r0)
//      exp(cum_r0 - cum_k), one exponent per key and one per row, both
//      <= 0; only the diagonal 16 x 16 block takes one per element, and
//      there an entry with k > q is set to 0 without its exponent being
//      used (it is positive and could overflow).  Key blocks above the
//      diagonal are never touched.  Reads x (84 MB), S_prev (42 MB), cum
//      and dt, and from L2 the chunk's C and C B^T for every head.
//
// About 0.55 GB crosses HBM in all, three times the bound's 175 MB: the
// fp32 S_c written and read once, S_prev written and read once.  Every
// bf16 product is mma.sync.m16n8k16 bf16 -> fp32 on the tensor cores,
// operands fed by ldmatrix from shared memory that cp.async filled (one
// 16-byte copy a thread and segment, one commit group a tile), except the
// chunk scan's C B^T operand, which is built in registers from 16-byte
// loads running a key step ahead of their use (the key order inside a
// step of 16 is permuted to make them 16 bytes, and x's fragments follow
// it).  What holds the passes above the bound is measured in PERF.md.
//
// Numbers.  bf16 operands of the products: C, B and x as given (already
// bf16); x·dt·exp(total - cum) in pass 1; in pass 4 (C B^T ⊙ L)·dt, or for
// keys before a row block that divided by the row factor exp(cum_q -
// cum_r0), which multiplies the fp32 accumulator instead; S_prev as the
// state pass writes it.  Each is formed in fp32 and rounded once.
// Folding dt into C B^T ⊙ L instead of into x rounds each product term
// once rather than twice and leaves x exact; the reference model's
// ssd_chunked rounds at the same two products (src/repro/models/
// mamba2.py:112, :139).  float32 inputs keep float32 products: the same
// passes and tiles, with each warp's fragment computed by fp32 FMAs on
// the CUDA cores (not TF32), within 2e-4 of the plain version.  Operands
// are read through their strides (x, B and C are column slices of the
// model's conv output), so nothing is copied; where an operand's rows are
// not 16-byte aligned, the tile loads fall back to one element a thread.
// A ragged last chunk is masked, and small P, N or Q are zero-padded to
// the tiles in shared memory.  No atomics, and every sum runs in a fixed
// order, so every run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 256;   // one cum entry per thread of pass 1
constexpr int kP = 64;           // widest head (P) the kernels take
constexpr int kN = 128;          // widest state (N) the kernels take
constexpr int kTile = 64;        // rows of a query or key tile
constexpr int kHalf = 128;        // query rows of C a chunk-scan block holds
constexpr int kStateThreads = 256, kChunkThreads = 256, kScanThreads = 256,
              kCbThreads = 128;

// Row strides of the shared tiles: one 16-byte pad per row keeps rows
// 16-byte aligned for cp.async and ldmatrix and spreads 8 rows over all
// 32 banks.
template <typename T> struct Pad {
  static constexpr int X = kP + 16 / static_cast<int>(sizeof(T));
  static constexpr int N = kN + 16 / static_cast<int>(sizeof(T));
};

enum Pass { kChunkState = 0, kCb = 1, kStatePass = 2, kChunkScan = 3 };

struct Args {
  const void* x; const float* dt; const float* a; const void* b;
  const void* c; void* y; float* cum; float* states; float* cb; void* prev;
  float* dtc;
  int batch, t, h, p, g, n, chunk, nc;
  int64_t sxb, sxt, sxh;   // x [B, T, H, P], P contiguous
  int64_t sdb, sdt, sdh;   // dt [B, T, H]
  int64_t sbb, sbt, sbg;   // b [B, T, G, N], N contiguous
  int64_t scb, sct, scg;   // c [B, T, G, N], N contiguous
  bool x_vec, b_vec, c_vec, prev_vec, cum_vec;   // 16-byte rows: cp.async
};
// cum and dtc (dt laid out the same way): [B, H, nc, Q] fp32, zero dt
// past a ragged end; states (S_c): [B, nc, H, P, N] fp32; cb:
// [B, nc, G, Q, Q]; prev (S_prev): [B, nc, H, P, N] in x's type; y:
// contiguous [B, T, H, P].

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---- PTX wrappers ----------------------------------------------------------

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

// Wait until at most `pending` of this thread's commit groups are in
// flight (waiting for more than needed is always safe).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
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

// A bf16 pair times (s_lo, s_hi) in fp32, rounded once back to bf16.
__device__ __forceinline__ uint32_t scale_bf16(uint32_t r, float s_lo, float s_hi) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r);
  return pack_bf16(__low2float(v) * s_lo, __high2float(v) * s_hi);
}

// ---- tiles -----------------------------------------------------------------

// rows [0, rows) x columns [0, cols) of a shared tile with row stride
// dst_stride from a row-major source with row stride src_stride; rows past
// `valid_rows` and columns past `valid_cols` are zero.  With `vec` (source
// rows 16-byte aligned, valid_cols a whole number of 16-byte segments)
// each segment is one cp.async of the caller's current commit group;
// otherwise one element a thread, loaded now.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int dst_stride, const T* src,
                                          int64_t src_stride, int rows,
                                          int valid_rows, int cols,
                                          int valid_cols, bool vec, int tid,
                                          int nthreads) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    const int segs = cols / V;
    for (int e = tid; e < rows * segs; e += nthreads) {
      const int r = e / segs, s = e - r * segs;
      T* d = dst + r * dst_stride + s * V;
      if (r < valid_rows && s * V < valid_cols)
        cp_async16(d, src + r * src_stride + s * V);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = tid; e < rows * cols; e += nthreads) {
      const int r = e / cols, col = e - r * cols;
      dst[r * dst_stride + col] = (r < valid_rows && col < valid_cols)
                                      ? src[r * src_stride + col]
                                      : from_f<T>(0.f);
    }
  }
}

// (v0, v1) into columns col, col+1 of a row of `cols` elements.
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int col, int cols,
                                           float v0, float v1) {
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

// Four floats rounded to T, to a 16-byte (float) or 8-byte (bf16) aligned
// address.
__device__ __forceinline__ void store4(float* d, float4 v) {
  *reinterpret_cast<float4*>(d) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* d, float4 v) {
  *reinterpret_cast<uint2*>(d) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

template <typename T> constexpr int chunk_state_smem() {
  return 2 * kTile * (Pad<T>::X + Pad<T>::N) * static_cast<int>(sizeof(T))
         + (2 * kMaxChunk + 8) * 4;
}
template <typename T> constexpr int cb_smem() {
  return 2 * kTile * Pad<T>::N * static_cast<int>(sizeof(T));
}
template <typename T> constexpr int chunk_scan_smem() {
  return (kHalf * Pad<T>::N + kP * Pad<T>::N + kMaxChunk * Pad<T>::X)
             * static_cast<int>(sizeof(T))
         + (2 + kScanThreads / 32) * kMaxChunk * 4;
}

// ---- pass 1: cum and each chunk's own state ----------------------------------

template <typename T>
__global__ void __launch_bounds__(kChunkThreads, sizeof(T) == 2 ? 4 : 2)
ssd_chunk_state_kernel(const Args args) {
  constexpr int XS = Pad<T>::X, NS = Pad<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);           // [2][64][XS]: x rows
  T* bs = xs + 2 * kTile * XS;                       // [2][64][NS]: B rows
  float* cum_s = reinterpret_cast<float*>(bs + 2 * kTile * NS);
  float* sc = cum_s + kMaxChunk;                     // dt exp(total - cum)
  float* warp_sum = sc + kMaxChunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int hi = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int gi = hi / (args.h / args.g);
  const int q = args.chunk, t0 = ci * q, qc = min(q, args.t - t0);
  const int p = args.p, n = args.n;
  const T* x = static_cast<const T*>(args.x) + bi * args.sxb + hi * args.sxh
               + t0 * args.sxt;
  const T* bp = static_cast<const T*>(args.b) + bi * args.sbb
                + gi * args.sbg + t0 * args.sbt;
  const float* dtp = args.dt + bi * args.sdb + hi * args.sdh + t0 * args.sdt;

  // key tiles of 64 rows through two buffers, one commit group a tile:
  // tile j + 2 is asked for as soon as tile j has been used
  const int ntile = (qc + kTile - 1) / kTile;
  auto fetch = [&](int j) {
    const int r0 = j * kTile, valid = min(kTile, qc - r0), buf = j & 1;
    load_tile(xs + buf * kTile * XS, XS, x + r0 * args.sxt, args.sxt, kTile,
              valid, kP, p, args.x_vec, tid, kChunkThreads);
    load_tile(bs + buf * kTile * NS, NS, bp + r0 * args.sbt, args.sbt, kTile,
              valid, kN, n, args.b_vec, tid, kChunkThreads);
    cp_async_commit();
  };
  // dt (strided: one element a thread) comes with the first tile
  if (tid < qc)
    cp_async4(sc + tid, dtp + tid * args.sdt);
  else
    sc[tid] = 0.f;
  fetch(0);
  if (ntile > 1) fetch(1);
  cp_async_wait(ntile > 1 ? 1 : 0);

  // cum = inclusive cumsum of dt * A: a warp scan by shuffles, then the
  // sums of the earlier warps in order.  Past qc, dt = 0 and cum stays at
  // total.
  const float a = args.a[hi];
  const float d = sc[tid];
  float v = d * a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += warp_sum[w];
  cum_s[tid] = base + v;
  __syncthreads();
  const float total = cum_s[qc - 1];
  sc[tid] = tid < qc ? d * expf(total - cum_s[tid]) : 0.f;
  if (tid < q) {
    const int64_t at = ((static_cast<int64_t>(bi) * args.h + hi) * args.nc + ci) * q
                       + tid;
    args.cum[at] = cum_s[tid];
    args.dtc[at] = d;
  }

  // S_c[p, n] = sum_k (x_k[p] sc_k) B_k[n]: warp w owns p rows m0..m0+15
  // and n columns nh..nh+63 (8 fragments of 8).
  const int m0 = (warp & 3) * 16, nh = (warp >> 2) * 64;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int j = 0; j < ntile; ++j) {
    cp_async_wait(j + 1 < ntile ? 1 : 0);   // tile j has arrived
    __syncthreads();
    const int k0 = j * kTile, kend = min(k0 + kTile, qc);
    const T* xt = xs + (j & 1) * kTile * XS;   // row k - k0 of the tile
    const T* bt = bs + (j & 1) * kTile * NS;
    if constexpr (sizeof(T) == 2) {
      for (int kb = k0; kb < kend; kb += 16) {
        // A = (x sc)^T from the k-major x tile, scaled in registers
        uint32_t af[4];
        ldsm_x4_t(af, xt + (kb - k0 + (lane & 7) + ((lane >> 4) << 3)) * XS
                          + m0 + ((lane >> 3) & 1) * 8);
        const float s0 = sc[kb + 2 * tq], s1 = sc[kb + 2 * tq + 1];
        const float s8 = sc[kb + 2 * tq + 8], s9 = sc[kb + 2 * tq + 9];
        af[0] = scale_bf16(af[0], s0, s1);
        af[1] = scale_bf16(af[1], s0, s1);
        af[2] = scale_bf16(af[2], s8, s9);
        af[3] = scale_bf16(af[3], s8, s9);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bf[4];
          ldsm_x4_t(bf, bt + (kb - k0 + (lane & 15)) * NS + nh + nt * 16
                            + (lane >> 4) * 8);
          mma_bf16(acc[2 * nt], af, bf[0], bf[1]);
          mma_bf16(acc[2 * nt + 1], af, bf[2], bf[3]);
        }
      }
    } else {
      for (int k = k0; k < kend; ++k) {
        const float s = sc[k];
        const float a0 = xt[(k - k0) * XS + m0 + gq] * s;
        const float a1 = xt[(k - k0) * XS + m0 + gq + 8] * s;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const T* br = bt + (k - k0) * NS + nh + nt * 8 + 2 * tq;
          const float b0 = br[0], b1 = br[1];
          acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
          acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
          acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
          acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
        }
      }
    }
    if (j + 2 < ntile) {
      __syncthreads();   // every warp is done with this buffer
      fetch(j + 2);
    }
  }

  float* st = args.states
              + ((static_cast<int64_t>(bi) * args.nc + ci) * args.h + hi) * p * n;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nh + nt * 8 + 2 * tq;
    if (m0 + gq < p)
      store_pair(st + (m0 + gq) * n, col, n, acc[nt][0], acc[nt][1]);
    if (m0 + gq + 8 < p)
      store_pair(st + (m0 + gq + 8) * n, col, n, acc[nt][2], acc[nt][3]);
  }
}

// ---- pass 2: C B^T once per group --------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kCbThreads) ssd_cb_kernel(const Args args) {
  constexpr int NS = Pad<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);   // [64][NS]: C rows q0..q0+63
  T* bs = cs + kTile * NS;                  // [64][NS]: B rows k0..k0+63

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  int kt = blockIdx.x, qt = 0;              // lower-triangle tile (qt, kt)
  while (kt > qt) kt -= ++qt;
  const int ci = blockIdx.y, bi = blockIdx.z / args.g, gi = blockIdx.z % args.g;
  const int q = args.chunk, t0 = ci * q, qc = min(q, args.t - t0);
  const int q0 = qt * kTile, k0 = kt * kTile, n = args.n;
  const T* cp = static_cast<const T*>(args.c) + bi * args.scb + gi * args.scg
                + (t0 + q0) * args.sct;
  const T* bp = static_cast<const T*>(args.b) + bi * args.sbb + gi * args.sbg
                + (t0 + k0) * args.sbt;
  // rows past qc of a ragged last chunk are zero (so is their C B^T)
  load_tile(cs, NS, cp, args.sct, kTile, min(kTile, qc - q0), kN, n,
            args.c_vec, tid, kCbThreads);
  load_tile(bs, NS, bp, args.sbt, kTile, min(kTile, qc - k0), kN, n,
            args.b_vec, tid, kCbThreads);
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();

  // warp w: query rows 16w..16w+15 of the tile, all 64 key columns
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int nk = (n + 15) & ~15;
  if constexpr (sizeof(T) == 2) {
    for (int kk = 0; kk < nk; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, cs + (warp * 16 + (lane & 15)) * NS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bf[4];
        ldsm_x4(bf, bs + (nt * 16 + (lane & 7) + (lane >> 4) * 8) * NS + kk
                        + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * nt], af, bf[0], bf[1]);
        mma_bf16(acc[2 * nt + 1], af, bf[2], bf[3]);
      }
    }
  } else {
    for (int kk = 0; kk < nk; ++kk) {
      const float a0 = cs[(warp * 16 + gq) * NS + kk];
      const float a1 = cs[(warp * 16 + gq + 8) * NS + kk];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float b0 = bs[(nt * 8 + 2 * tq) * NS + kk];
        const float b1 = bs[(nt * 8 + 2 * tq + 1) * NS + kk];
        acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
      }
    }
  }

  // the lower triangle k <= q only
  float* out = args.cb + ((static_cast<int64_t>(bi) * args.nc + ci) * args.g + gi)
                             * q * q;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gq + 8 * r;
    if (row >= q) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = k0 + nt * 8 + 2 * tq;
      if (col <= row) out[row * q + col] = acc[nt][2 * r];
      if (col + 1 <= row) out[row * q + col + 1] = acc[nt][2 * r + 1];
    }
  }
}

// ---- pass 3: the state entering each chunk -----------------------------------

__device__ __forceinline__ void load4(float (&v)[4], const float* src, int w,
                                      bool vec) {
  if (vec) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < w ? src[i] : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, const float (&v)[4], int w,
                                       bool vec) {
  if (vec) {
    store4(dst, make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < w) dst[i] = from_f<T>(v[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kStateThreads)
ssd_state_pass_kernel(const Args args) {
  const int pn = args.p * args.n;
  const int e = (blockIdx.x * kStateThreads + threadIdx.x) * 4;
  if (e >= pn) return;
  const int hi = blockIdx.y, bi = blockIdx.z, nc = args.nc, q = args.chunk;
  const int w = min(4, pn - e);
  const bool vec = (pn & 3) == 0;
  const int64_t cstride = static_cast<int64_t>(args.h) * pn;
  const int64_t off = (static_cast<int64_t>(bi) * nc * args.h + hi) * pn + e;
  const float* sc = args.states + off;
  T* sp = static_cast<T*>(args.prev) + off;
  const float* total = args.cum + (static_cast<int64_t>(bi) * args.h + hi) * nc * q
                       + (q - 1);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  // four chunks' S_c loaded together
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float v[4][4], decay[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < nc) {
        load4(v[u], sc + (c0 + u) * cstride, w, vec);
        decay[u] = expf(total[static_cast<int64_t>(c0 + u) * q]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < nc) {
        store4(sp + (c0 + u) * cstride, s, w, vec);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i] = s[i] * decay[u] + v[u][i];
      }
    }
  }
}

// ---- pass 4: y -----------------------------------------------------------------

// One block of 8 warps per (batch, chunk, head).  The chunk's rows come in
// 16 row blocks of 16; warp w takes row block w, then row block 15 - w, so
// every warp walks 17 key steps of 16 whatever its rows.  x, S_prev, cum
// and dt are loaded once per block; C comes in two halves of 128 rows.
template <typename T>
__global__ void __launch_bounds__(kScanThreads, 2)
ssd_chunk_scan_kernel(const Args args) {
  constexpr int XS = Pad<T>::X, NS = Pad<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);   // [128][NS]: C of half the rows
  T* sp = cs + kHalf * NS;                  // [kP][NS]: S_prev[p][n]
  T* xs = sp + kP * NS;                     // [Q][XS]: x of the chunk
  float* cum_s = reinterpret_cast<float*>(xs + kMaxChunk * XS);
  float* dt_s = cum_s + kMaxChunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  float* ck_s = dt_s + kMaxChunk + warp * kMaxChunk;   // this warp's key factors
  const int hi = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int gi = hi / (args.h / args.g);
  const int q = args.chunk, t0 = ci * q, qc = min(q, args.t - t0);
  const int p = args.p, n = args.n, nkt = (qc + kTile - 1) / kTile;
  const T* x = static_cast<const T*>(args.x) + bi * args.sxb + hi * args.sxh
               + t0 * args.sxt;
  const T* cp = static_cast<const T*>(args.c) + bi * args.scb + gi * args.scg
                + t0 * args.sct;
  const float* cbm = args.cb
      + ((static_cast<int64_t>(bi) * args.nc + ci) * args.g + gi) * q * q;

  // group 0: C's first half, S_prev, cum and dt; then one group per key
  // tile of x;
  // C's second half is asked for once the first has been used
  load_tile(cs, NS, cp, args.sct, kHalf, qc, kN, n, args.c_vec, tid,
            kScanThreads);
  if (ci > 0)
    load_tile(sp, NS, static_cast<const T*>(args.prev)
                  + ((static_cast<int64_t>(bi) * args.nc + ci) * args.h + hi) * p * n,
              n, kP, p, kN, n, args.prev_vec, tid, kScanThreads);
  const int64_t at = ((static_cast<int64_t>(bi) * args.h + hi) * args.nc + ci) * q;
  load_tile(cum_s, 0, args.cum + at, 0, 1, 1, kMaxChunk, q, args.cum_vec, tid,
            kScanThreads);
  load_tile(dt_s, 0, args.dtc + at, 0, 1, 1, kMaxChunk, q, args.cum_vec, tid,
            kScanThreads);
  cp_async_commit();
  for (int j = 0; j < nkt; ++j) {
    load_tile(xs + j * kTile * XS, XS, x + j * kTile * args.sxt, args.sxt,
              kTile, qc - j * kTile, kP, p, args.x_vec, tid, kScanThreads);
    cp_async_commit();
  }
  cp_async_wait(nkt);   // C's first half and S_prev have arrived
  __syncthreads();

  for (int half = 0; half < 2; ++half) {
    // rows r0..r0+15 of the chunk: qa = r0 + g and qb = qa + 8; keys
    // [0, k1), ns steps of 16, the last of them the diagonal block
    const int r0 = 16 * (half == 0 ? warp : 15 - warp);
    const bool live = r0 < qc;
    const int qa = r0 + gq, qb = qa + 8;
    const int k1 = live ? min(r0 + 16, qc) : 0, ns = (k1 + 15) / 16;
    const int sd = r0 / 16;   // the diagonal key step

    // The key order inside a step of 16 is permuted so that thread t's
    // four K slots of the A fragment (2t, 2t+1, 2t+8, 2t+9) hold keys
    // 4t..4t+3 (the x fragments are loaded in the same order): its C B^T
    // is one 16-byte load a row.  Element u of the 8 is row (u < 4 ? qa :
    // qb), key 16 st + 4t + (u & 3).  The loads run a step ahead of
    // their use, the first during the inter-chunk product.
    auto load_cb = [&](int st, float (&v)[8]) {
#pragma unroll
      for (int r = 0; r < 8; r += 4) {
        const int row = r == 0 ? qa : qb;
        const int kk = 16 * st + 4 * tq;
        float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
        if (st < ns && kk <= row && row < qc) {
          if ((q & 15) == 0) {   // 16-byte aligned, and inside row `row`
            w = __ldg(reinterpret_cast<const float4*>(cbm + row * q + kk));
          } else {
            w.x = __ldg(cbm + row * q + kk);
            if (kk + 1 <= row) w.y = __ldg(cbm + row * q + kk + 1);
            if (kk + 2 <= row) w.z = __ldg(cbm + row * q + kk + 2);
            if (kk + 3 <= row) w.w = __ldg(cbm + row * q + kk + 3);
          }
        }
        v[r] = w.x; v[r + 1] = w.y; v[r + 2] = w.z; v[r + 3] = w.w;
      }
    };
    float cv0[8], cv1[8];
    if constexpr (sizeof(T) == 2) load_cb(0, cv0);

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    if (ci > 0 && live) {   // Y_off = exp(cum_q) (C_q . S_prev[p, :])
      const T* cw = cs + (r0 - kHalf * half) * NS;   // this warp's C rows
      const int nk = (n + 15) & ~15;
      if constexpr (sizeof(T) == 2) {
        for (int kk = 0; kk < nk; kk += 16) {
          uint32_t af[4];
          ldsm_x4(af, cw + (lane & 15) * NS + kk + (lane >> 4) * 8);
#pragma unroll
          for (int pt = 0; pt < 4; ++pt) {
            uint32_t bf[4];
            ldsm_x4(bf, sp + (pt * 16 + (lane & 7) + (lane >> 4) * 8) * NS + kk
                            + ((lane >> 3) & 1) * 8);
            mma_bf16(acc[2 * pt], af, bf[0], bf[1]);
            mma_bf16(acc[2 * pt + 1], af, bf[2], bf[3]);
          }
        }
      } else {
        for (int kk = 0; kk < nk; ++kk) {
          const float a0 = cw[gq * NS + kk];
          const float a1 = cw[(gq + 8) * NS + kk];
#pragma unroll
          for (int pt = 0; pt < 8; ++pt) {
            const float b0 = sp[(pt * 8 + 2 * tq) * NS + kk];
            const float b1 = sp[(pt * 8 + 2 * tq + 1) * NS + kk];
            acc[pt][0] = fmaf(a0, b0, acc[pt][0]);
            acc[pt][1] = fmaf(a0, b1, acc[pt][1]);
            acc[pt][2] = fmaf(a1, b0, acc[pt][2]);
            acc[pt][3] = fmaf(a1, b1, acc[pt][3]);
          }
        }
      }
      // exp(cum_q) = exp(cum_r0) exp(cum_q - cum_r0): the second factor
      // is applied with the keys before the row block, below
      const float e0 = expf(cum_s[r0]);
#pragma unroll
      for (int pt = 0; pt < 8; ++pt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[pt][j] *= e0;
    }
    if (half == 0) {
      __syncthreads();   // every warp is done with C's first half
      load_tile(cs, NS, cp + kHalf * args.sct, args.sct, kHalf, qc - kHalf,
                kN, n, args.c_vec, tid, kScanThreads);
      cp_async_commit();
    }

    // Keys before the row block (k < r0 <= q) factor as exp(cum_q - cum_k)
    // = exp(cum_q - cum_r0) exp(cum_r0 - cum_k), both exponents <= 0: the
    // key factor (times dt) once per key, the row factor once per row on
    // the accumulator.  Only the diagonal block takes an exponent per
    // element.
    __syncwarp();
    if (live)
      for (int k = lane; k < r0; k += 32)
        ck_s[k] = expf(cum_s[r0] - cum_s[k]) * dt_s[k];
    __syncwarp();
    const float cum_a = cum_s[qa], cum_b = cum_s[qb];
    const float ra = qa < qc ? expf(cum_a - cum_s[r0]) : 0.f;   // rows past
    const float rb = qb < qc ? expf(cum_b - cum_s[r0]) : 0.f;   // qc unwritten
    if (half == 0) {
      cp_async_wait(1);   // every key tile has arrived
      __syncthreads();
    }

    // Y_diag over the keys at or below the diagonal: the operand
    // (C B^T ⊙ L) dt is built in registers from C B^T (L2), cum and dt.
    if constexpr (sizeof(T) == 2) {
#pragma unroll 2
      for (int st = 0; st < ns; ++st) {
        load_cb(st + 1, cv1);
        const int kb = 16 * st;
        float m[8];
        if (st < sd) {
          const float4 c4 = *reinterpret_cast<const float4*>(ck_s + kb + 4 * tq);
#pragma unroll
          for (int r = 0; r < 8; r += 4) {
            m[r] = cv0[r] * c4.x;
            m[r + 1] = cv0[r + 1] * c4.y;
            m[r + 2] = cv0[r + 2] * c4.z;
            m[r + 3] = cv0[r + 3] * c4.w;
          }
        } else {
#pragma unroll
          for (int pt = 0; pt < 8; ++pt) {
            acc[pt][0] *= ra; acc[pt][1] *= ra;
            acc[pt][2] *= rb; acc[pt][3] *= rb;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int row = u < 4 ? qa : qb;
            const int kk = kb + 4 * tq + (u & 3);
            m[u] = (kk <= row && row < qc)
                       ? cv0[u] * expf((u < 4 ? cum_a : cum_b) - cum_s[kk]) * dt_s[kk]
                       : 0.f;
          }
        }
        uint32_t af[4];
        af[0] = pack_bf16(m[0], m[1]);
        af[1] = pack_bf16(m[4], m[5]);
        af[2] = pack_bf16(m[2], m[3]);
        af[3] = pack_bf16(m[6], m[7]);
        // x rows in the same key order: matrix i of the four holds keys
        // 4 (r >> 1) + (r & 1) + 2 (i & 1) at its row r
#pragma unroll
        for (int pt = 0; pt < 4; ++pt) {
          uint32_t bf[4];
          ldsm_x4_t(bf, xs + (kb + 4 * ((lane & 7) >> 1) + (lane & 1)
                              + 2 * ((lane >> 3) & 1)) * XS
                            + pt * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * pt], af, bf[0], bf[1]);
          mma_bf16(acc[2 * pt + 1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          cv0[u] = cv1[u];
        }
      }
    } else {
      for (int k = 0; k < k1; ++k) {
        if (k == r0) {
#pragma unroll
          for (int pt = 0; pt < 8; ++pt) {
            acc[pt][0] *= ra; acc[pt][1] *= ra;
            acc[pt][2] *= rb; acc[pt][3] *= rb;
          }
        }
        float ma = 0.f, mb = 0.f;
        if (k <= qa && qa < qc)
          ma = cbm[qa * q + k]
               * (k < r0 ? ck_s[k] : expf(cum_a - cum_s[k]) * dt_s[k]);
        if (k <= qb && qb < qc)
          mb = cbm[qb * q + k]
               * (k < r0 ? ck_s[k] : expf(cum_b - cum_s[k]) * dt_s[k]);
#pragma unroll
        for (int pt = 0; pt < 8; ++pt) {
          const T* xr = xs + k * XS + pt * 8 + 2 * tq;
          const float x0 = xr[0], x1 = xr[1];
          acc[pt][0] = fmaf(ma, x0, acc[pt][0]);
          acc[pt][1] = fmaf(ma, x1, acc[pt][1]);
          acc[pt][2] = fmaf(mb, x0, acc[pt][2]);
          acc[pt][3] = fmaf(mb, x1, acc[pt][3]);
        }
      }
    }

    const int64_t syt = static_cast<int64_t>(args.h) * p;
    T* y = static_cast<T*>(args.y) + (static_cast<int64_t>(bi) * args.t + t0) * syt
           + static_cast<int64_t>(hi) * p;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      const int col = pt * 8 + 2 * tq;
      if (qa < qc) store_pair(y + qa * syt, col, p, acc[pt][0], acc[pt][1]);
      if (qb < qc) store_pair(y + qb * syt, col, p, acc[pt][2], acc[pt][3]);
    }
    if (half == 0) {
      cp_async_wait(0);   // C's second half has arrived
      __syncthreads();
    }
  }
}

// ---- launch ----------------------------------------------------------------------

// Above 48 KB of dynamic shared memory a kernel must ask for it; the
// largest shared-memory carveout lets as many blocks as fit share an SM.
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

// f(kernel, grid, threads, dynamic shared memory) for pass `pass`.
template <typename T, typename F>
cudaError_t with_pass(int pass, const Args& a, F&& f) {
  const int nt = (a.chunk + kTile - 1) / kTile, per_block = 4 * kStateThreads;
  switch (pass) {
    case kChunkState:
      return f(ssd_chunk_state_kernel<T>, dim3(a.h, a.nc, a.batch), kChunkThreads,
               chunk_state_smem<T>());
    case kCb:
      return f(ssd_cb_kernel<T>, dim3(nt * (nt + 1) / 2, a.nc, a.batch * a.g),
               kCbThreads, cb_smem<T>());
    case kStatePass:
      return f(ssd_state_pass_kernel<T>,
               dim3((a.p * a.n + per_block - 1) / per_block, a.h, a.batch),
               kStateThreads, 0);
    case kChunkScan:
      return f(ssd_chunk_scan_kernel<T>, dim3(a.h, a.nc, a.batch), kScanThreads,
               chunk_scan_smem<T>());
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run_pass(int pass, const Args& a, cudaStream_t st) {
  return with_pass<T>(pass, a, [&](auto kernel, dim3 grid, int threads, int smem) {
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, st>>>(a);
    return cudaGetLastError();
  });
}

// out: the dynamic shared memory of a block in bytes, and the blocks one
// SM of the current device holds at once.
template <typename T>
cudaError_t pass_resources(int pass, int* out) {
  return with_pass<T>(pass, Args{}, [&](auto kernel, dim3, int threads, int smem) {
    out[0] = smem;
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, threads,
                                                         smem);
  });
}

bool rows_aligned(const void* ptr, const int64_t* s, int width, int elem) {
  const int v = 16 / elem;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s[0] % v == 0 &&
         s[1] % v == 0 && s[2] % v == 0 && width % v == 0;
}

}  // namespace

// pass: 0 chunk state, 1 C B^T, 2 state pass, 3 chunk scan.
// dtype: 0 float32, 1 bfloat16 (x, b, c, y and prev); dt, a, cum, states,
// cb and dtc are float32.  ptrs: x, dt, a, b, c, y, cum, states, cb, prev,
// dtc (a pass ignores what it does not read or write).  dims: batch, t, h,
// p, g, n, chunk (the scan's Q, at most t).  strides: 12 element strides,
// x (b, t, h), dt (b, t, h), b (b, t, g), c (b, t, g); the last axis of x,
// b and c is contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_pass_launch(int pass, int dtype, void* const* ptrs,
                               const int* dims, const int64_t* strides,
                               void* stream) {
  const int batch = dims[0], t = dims[1], h = dims[2], p = dims[3],
            g = dims[4], n = dims[5], chunk = dims[6];
  if (pass < 0 || pass > 3 || batch <= 0 || t <= 0 || h <= 0 || g <= 0 ||
      h % g != 0 || p <= 0 || p > kP || n <= 0 || n > kN || chunk <= 0 ||
      chunk > kMaxChunk || chunk > t)
    return cudaErrorInvalidValue;
  const int nc = (t + chunk - 1) / chunk;
  if (h > 65535 || nc > 65535 || static_cast<int64_t>(batch) * nc > 65535 ||
      static_cast<int64_t>(batch) * g > 65535)
    return cudaErrorInvalidValue;   // grid y and z
  const int elem = dtype == 0 ? 4 : 2;
  const int64_t prev_strides[3] = {static_cast<int64_t>(p) * n, n, n};
  Args a{ptrs[0], static_cast<const float*>(ptrs[1]),
         static_cast<const float*>(ptrs[2]), ptrs[3], ptrs[4], ptrs[5],
         static_cast<float*>(ptrs[6]), static_cast<float*>(ptrs[7]),
         static_cast<float*>(ptrs[8]), ptrs[9], static_cast<float*>(ptrs[10]),
         batch, t, h, p, g, n, chunk, nc,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         strides[10], strides[11],
         rows_aligned(ptrs[0], strides, p, elem),
         rows_aligned(ptrs[3], strides + 6, n, elem),
         rows_aligned(ptrs[4], strides + 9, n, elem),
         rows_aligned(ptrs[9], prev_strides, n, elem), chunk % 4 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_pass<float>(pass, a, st);
  if (dtype == 1) return run_pass<__nv_bfloat16>(pass, a, st);
  return cudaErrorInvalidValue;
}

// The four passes of one scan call in order, each checked with
// cudaGetLastError() before the next is launched; arguments as for
// ssd_pass_launch.  On an error *failed_pass names the pass.
extern "C" int ssd_scan_launch(int dtype, void* const* ptrs, const int* dims,
                               const int64_t* strides, void* stream,
                               int* failed_pass) {
  for (int pass = kChunkState; pass <= kChunkScan; ++pass) {
    const int err = ssd_pass_launch(pass, dtype, ptrs, dims, strides, stream);
    if (err != cudaSuccess) {
      *failed_pass = pass;
      return err;
    }
  }
  return cudaSuccess;
}

// A pass's dynamic shared memory a block (out[0], bytes) and the blocks
// one SM holds at once (out[1]), for the build report.  Returns a CUDA
// error code.
extern "C" int ssd_pass_resources(int pass, int dtype, int* out) {
  if (dtype == 0) return pass_resources<float>(pass, out);
  if (dtype == 1) return pass_resources<__nv_bfloat16>(pass, out);
  return cudaErrorInvalidValue;
}
