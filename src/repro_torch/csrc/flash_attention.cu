// Flash attention (online softmax) for Hopper (sm_90a), grouped-query layout.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, pallas_call at :110, body _flash_kernel at :29).
// Same function: for each query row, softmax(q k^T / sqrt(D)) v over the
// visible keys, with the running max m, running sum l and the accumulator
// in fp32, masks key < S, causal (key <= q_offset + t) and a sliding
// window (key > q_offset + t - window); kv tiles that lie wholly above the
// diagonal or outside the window are never loaded.  Output = acc / max(l,
// 1e-30), cast to the input type; a row that sees no key gives 0.
//
// Two kernels, two routes, chosen by the wrapper from (dtype, T, D) alone
// (kernels/flash_attention/ops.py, _route) and never as a reaction to a
// failure:
//
//   mma  bf16 q, k, v with T >= 16 query rows (prefill): flash_mma_kernel,
//        both products on the tensor cores;
//   fma  float32 at every shape, and bf16 below 16 rows (decode: one
//        query token per slot over a cache prefix): flash_kernel, fp32
//        FMAs on the CUDA cores.  float32 stays there because the f32
//        tolerance of 2e-5 cannot be met with bf16 products.
//
// Bound on this card.  Prefill (T = S, causal) does 4 D operations per
// visible (row, key) pair against B T (H + 2 KV) D elements: at qwen2-0.5b's
// forward (B 2, T 2048, H 14, KV 2, D 64) that is 15.0 GFLOP, 0.0152 ms on
// the bf16 tensor cores (989 TFLOP/s), against 0.0050 ms for its 16.8 MB,
// so operations bound it.  Decode reads the visible K/V prefix once and does
// 4 D operations per key: bytes bound it (3.35 TB/s).
//
// The mma route.  The CUDA-core kernel it took over from (the fma route
// below) ran prefill at 70x its bound for three reasons, each met here:
//
//   1. No tensor cores: every score and P V term was an fp32 FMA, fed from
//      shared memory 4 rows per K value read.  Here S = Q K^T and O += P V
//      are mma.sync.m16n8k16 bf16 -> fp32, K fragments by ldmatrix, V
//      fragments by ldmatrix.trans (V is [keys, D] row-major and is the B
//      operand of P V), Q held in registers as A fragments for the whole
//      key loop.  The C fragment of S (rows lane/4 and lane/4 + 8, columns
//      2 (lane%4) and +1 of each n8 tile) becomes the A fragment of P V in
//      registers: score tiles 2j and 2j + 1 make the k16 step j.
//   2. Small tiles: 16 query rows a block, so each K/V tile was loaded from
//      global memory once per 16 rows.  Here a block is 4 warps x 16 rows
//      = 64 query rows of one head, and key tiles of 64 stream through two
//      shared-memory buffers filled by cp.async (16-byte copies): the next
//      tile loads while the current one is computed.  The G query heads of
//      a kv head read its K/V through L2 (2 MB at the shape above); nothing
//      is repeated or copied.
//   3. K stored transposed in fp32, so at D 128 the key tile was cut to 32
//      to stay under 48 KB of static shared memory.  Here K and V stay bf16
//      in rows padded by 16 bytes (8 rows of an ldmatrix fall in 8
//      distinct bank groups): 45 KB a block at D 64, 85 KB at D 128 as
//      dynamic shared memory after cudaFuncSetAttribute, keys 64 at both.
//      Two m16 tiles a warp (K/V fragments used twice) spilled at 255
//      registers, and 8-warp blocks ran slower on the card (PERF.md, §6).
//
// Grid (B H, query tiles), the last tiles first: under a causal mask they
// hold the longest rows, so the short ones fill the last wave.  Only a key
// tile that crosses the diagonal, the window's edge or the end of S takes
// an element mask, decided per warp; rows past T are zero in shared memory
// and never stored.  Rounding: S stays fp32 and unscaled, and the scale
// 1/sqrt(D) (times log2 e) enters p = 2^(s scale - m scale) as one FFMA
// before ex2, not the bf16 q, so q is rounded once; m and l are fp32 and
// l sums the fp32 p; p is rounded to bf16 only as the A operand of P V, as
// the reference's model path _sdpa_blockwise rounds p.astype(v.dtype)
// (src/repro/models/layers.py:213) after summing l from the unrounded p
// (:210).  O is written once in bf16 through shared
// memory, 16 bytes a lane.  No atomics and no split over keys: every sum
// runs in a fixed order (l across a row's 4 lanes by a fixed shuffle
// tree), so every run gives the same bits.
//
// The fma route.  One thread block owns a tile of query rows and loops
// over kv tiles itself.  A block serves one (batch, kv head): its rows are
// (t, g) pairs of the G = H / KV query heads that share that kv head,
// t-major, so a K/V tile loaded into shared memory serves all G heads, and
// a one-token decode query is a tile of G rows, not 128 padded ones.  Each
// warp owns 4 rows.  Scores: lane j takes keys j, j + 32, ... of the tile
// against the 4 rows (q from shared memory as broadcasts, K stored
// transposed with a padded stride so lanes read distinct banks).  The
// tile's row max is a warp shuffle reduction; p goes to shared memory; then
// each lane accumulates its D/32 output columns over the tile's keys.  l is
// kept as per-lane partial sums and reduced once at the end by a fixed
// shuffle tree, so every run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;     // query rows per warp
constexpr int kWarps = 4;    // warps per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T as floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

struct Args {
  const void* q; const void* k; const void* v; void* o;
  int t, s, h, kv, g;
  int64_t qsb, qst, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window, q_offset;
  float sm_scale;
};

template <int D, int BKV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kWarps * kRows * D + kWarps * kRows * BKV +
                          D * (BKV + 1) + BKV * D);
}

template <typename T, int D, int BKV>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const Args a) {
  constexpr int NC = BKV / 32;     // keys per lane in a tile
  constexpr int E = D / 32;        // output columns per lane
  constexpr int KT = BKV + 1;      // padded row stride of the transposed K
  constexpr int VN = Vec<T>::N;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                  // [kWarps][kRows][D]
  float* ps = qs + kWarps * kRows * D;               // [kWarps][kRows][BKV]
  float* kt = ps + kWarps * kRows * BKV;             // [D][BKV + 1]
  float* vs = kt + D * KT;                           // [BKV][D]

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int n_rows = a.t * a.g;
  const int block_row0 = blockIdx.x * (kWarps * kRows);
  const int warp_row0 = block_row0 + warp * kRows;
  const bool warp_busy = warp_row0 < n_rows;

  // this warp's rows: (t, head), and its scaled q in shared memory
  int row_t[kRows], row_h[kRows];
  bool row_ok[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp_row0 + i;
    row_ok[i] = r < n_rows;
    row_t[i] = row_ok[i] ? r / a.g : 0;
    row_h[i] = kvh * a.g + (row_ok[i] ? r % a.g : 0);
    float* qrow = qs + (warp * kRows + i) * D;
    const T* src = q + b * a.qsb + row_t[i] * a.qst + row_h[i] * a.qsh;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      qrow[d] = row_ok[i] ? to_f(src[d]) * a.sm_scale : 0.f;
    }
  }

  // kv range of the whole block: causal stops at its last row's diagonal,
  // the window starts at its first row's
  const int last_row = min(block_row0 + kWarps * kRows, n_rows) - 1;
  const int qpos_lo = a.q_offset + block_row0 / a.g;
  const int qpos_hi = a.q_offset + last_row / a.g;
  int kv_end = a.s;
  if (a.causal) kv_end = min(kv_end, qpos_hi + 1);
  int kv_begin = 0;
  if (a.window) kv_begin = max(0, qpos_lo - a.window + 1);
  kv_begin = (kv_begin / BKV) * BKV;

  float m[kRows], lsum[kRows], acc[kRows][E];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();   // the previous tile is consumed; q is written
    for (int idx = tid; idx < BKV * (D / VN); idx += kWarps * 32) {
      const int j = idx / (D / VN);
      const int c = (idx % (D / VN)) * VN;
      const int key = k0 + j;
      float kv_k[VN], kv_v[VN];
      if (key < a.s) {
        Vec<T>::load(k + b * a.ksb + key * a.kss + kvh * a.ksh + c, kv_k);
        Vec<T>::load(v + b * a.vsb + key * a.vss + kvh * a.vsh + c, kv_v);
      } else {
#pragma unroll
        for (int u = 0; u < VN; ++u) kv_k[u] = kv_v[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < VN; ++u) {
        kt[(c + u) * KT + j] = kv_k[u];
        vs[j * D + c + u] = kv_v[u];
      }
    }
    __syncthreads();
    if (!warp_busy) continue;

    // scores of this lane's keys against the warp's rows
    float sc[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) sc[i][c] = 0.f;
    const float* qw = qs + warp * kRows * D;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qw + i * D + d);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float* kc = kt + d * KT + lane + 32 * c;
        const float k0v = kc[0], k1v = kc[KT], k2v = kc[2 * KT], k3v = kc[3 * KT];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float s = sc[i][c];
          s = fmaf(qv[i].x, k0v, s);
          s = fmaf(qv[i].y, k1v, s);
          s = fmaf(qv[i].z, k2v, s);
          s = fmaf(qv[i].w, k3v, s);
          sc[i][c] = s;
        }
      }
    }

    float* pw = ps + warp * kRows * BKV;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = a.q_offset + row_t[i];
      float tmax = -INFINITY;
      bool ok[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int key = k0 + lane + 32 * c;
        ok[c] = row_ok[i] && key < a.s && (!a.causal || key <= qpos) &&
                (!a.window || key > qpos - a.window);
        if (ok[c]) tmax = fmaxf(tmax, sc[i][c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      float corr = 1.f;
      if (m_new != -INFINITY) corr = expf(m[i] - m_new);   // exp(-inf) = 0
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float p = ok[c] ? expf(sc[i][c] - m_new) : 0.f;
        pw[i * BKV + lane + 32 * c] = p;
        psum += p;
      }
      lsum[i] = lsum[i] * corr + psum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    __syncwarp();

    // acc += p v over the tile's keys
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float vj[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vj[e] = vs[j * D + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = pw[i * BKV + j];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(p, vj[e], acc[i][e]);
      }
    }
    __syncwarp();
  }

  if (!warp_busy) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float l = lsum[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (!row_ok[i]) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    // o is contiguous [B, T, H, D]
    T* dst = o + ((b * a.t + row_t[i]) * a.h + row_h[i]) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) dst[lane + 32 * e] = from_f<T>(acc[i][e] * inv);
  }
}

template <typename T, int D, int BKV>
cudaError_t launch_shape(const Args& a, int b, cudaStream_t stream) {
  const int rows_per_block = kWarps * kRows;
  const dim3 grid((a.t * a.g + rows_per_block - 1) / rows_per_block, a.kv, b);
  constexpr size_t smem = smem_bytes<D, BKV>();
  static_assert(smem <= 48 * 1024, "tile needs the dynamic shared memory opt-in");
  flash_kernel<T, D, BKV><<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const Args& a, int b, int d, cudaStream_t stream) {
  if (d == 64) return launch_shape<T, 64, 64>(a, b, stream);
  if (d == 128) return launch_shape<T, 128, 32>(a, b, stream);
  return cudaErrorInvalidValue;
}

// ---- the mma route: bf16 prefill on the tensor cores ------------------------

// Tiles of the mma route: 4 warps a block, each owning one m16 tile of 16
// query rows, and key tiles of 64.
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;   // query rows a block
constexpr int kMmaKeys = 64;               // keys a tile

template <int D> struct MmaTile {
  // Row stride of the shared tiles in bf16: one 16-byte pad a row keeps
  // rows 16-byte aligned for cp.async and ldmatrix and puts the 8 rows of
  // an ldmatrix matrix in 8 distinct bank groups.
  static constexpr int kStride = D + 8;
  // the Q tile, then two (K, V) buffers
  static constexpr int kSmem =
      static_cast<int>(sizeof(__nv_bfloat16)) * kStride * (kMmaRows + 4 * kMmaKeys);
};

// PTX wrappers, the same as ssd.cu's.
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

// Block (b h, y): query rows [64 tile, 64 tile + 64) of head h, batch b,
// with tile = gridDim.y - 1 - y (the last, longest rows first).  Warp w
// owns rows 16 w .. 16 w + 15 of the tile; lane l holds rows l/4 and
// l/4 + 8 of them.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_mma_kernel(const Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int S = MmaTile<D>::kStride;
  constexpr int SEG = D / 8;         // 16-byte segments a row
  constexpr int KD = D / 16;         // k16 steps of Q K^T
  constexpr int ND = D / 8;          // n8 tiles of O
  constexpr int NK = kMmaKeys / 8;   // n8 tiles of S
  constexpr int kThreads = kMmaWarps * 32;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kMmaRows][S]
  bf16* ks = qs + kMmaRows * S;                   // [2][kMmaKeys][S]
  bf16* vs = ks + 2 * kMmaKeys * S;               // [2][kMmaKeys][S]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x % a.h;
  const int64_t b = blockIdx.x / a.h;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const int kvh = h / a.g;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;
  bf16* o = static_cast<bf16*>(a.o);

  // the block's key range: causal ends at its last row's diagonal, the
  // window begins at its first row's
  const int rows = min(kMmaRows, a.t - t0);
  const int pos_lo = a.q_offset + t0, pos_hi = pos_lo + rows - 1;
  int kv_end = a.s;
  if (a.causal) kv_end = min(kv_end, pos_hi + 1);
  int kv_begin = 0;
  if (a.window) kv_begin = max(0, pos_lo - a.window + 1);
  kv_begin = (kv_begin / kMmaKeys) * kMmaKeys;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kMmaKeys - 1) / kMmaKeys : 0;

  // keys [k0, k0 + 64) into buffer `buf`; keys past S are zero, not read
  auto load_kv = [&](int k0, int buf) {
    bf16* kd = ks + buf * kMmaKeys * S;
    bf16* vd = vs + buf * kMmaKeys * S;
    for (int e = tid; e < kMmaKeys * SEG; e += kThreads) {
      const int r = e / SEG, c = (e % SEG) * 8, key = k0 + r;
      if (key < a.s) {
        cp_async16(kd + r * S + c, k + key * a.kss + c);
        cp_async16(vd + r * S + c, v + key * a.vss + c);
      } else {
        *reinterpret_cast<uint4*>(kd + r * S + c) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd + r * S + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  if (n_tiles > 0) {   // Q and the first key tile: one commit group
    for (int e = tid; e < kMmaRows * SEG; e += kThreads) {
      const int r = e / SEG, c = (e % SEG) * 8;
      if (r < rows)
        cp_async16(qs + r * S + c, q + (t0 + r) * a.qst + c);
      else
        *reinterpret_cast<uint4*>(qs + r * S + c) = make_uint4(0u, 0u, 0u, 0u);
    }
    load_kv(kv_begin, 0);
    cp_async_commit();
  }

  const int gr = lane >> 2, gc = 2 * (lane & 3);
  const int wrow0 = warp * 16;                       // the warp's first row
  const int wpos_lo = pos_lo + wrow0, wpos_hi = wpos_lo + 15;
  const int pos0 = wpos_lo + gr, pos1 = pos0 + 8;    // this lane's two rows
  const bool warp_live = wrow0 < rows;
  const float scale = a.sm_scale * kLog2e;

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max of the unscaled scores and running sum, rows pos0, pos1
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * kMmaKeys;
    if (it + 1 < n_tiles) {
      load_kv(k0 + kMmaKeys, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();   // this tile (and Q) have arrived
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], qs + (wrow0 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* kt = ks + (it & 1) * kMmaKeys * S;
    const bf16* vt = vs + (it & 1) * kMmaKeys * S;

    // does this warp see any key of the tile, and must it mask?
    const bool seen = warp_live && !(a.causal && k0 > wpos_hi) &&
                      !(a.window && k0 + kMmaKeys - 1 <= wpos_lo - a.window);
    if (seen) {
      const bool masked = k0 + kMmaKeys > a.s ||
                          (a.causal && k0 + kMmaKeys - 1 > wpos_lo) ||
                          (a.window && k0 <= wpos_hi - a.window);

      // S = Q K^T
      float sc[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int jp = 0; jp < NK / 2; ++jp) {
          uint32_t kf[4];
          ldsm_x4(kf, kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * S + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * jp], qf[kk], kf[0], kf[1]);
          mma_bf16(sc[2 * jp + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // mask, row max over the row's 4 lanes (of the unscaled scores:
      // the scale is positive)
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        if (masked) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + gc + (e & 1);
            const int pos = e < 2 ? pos0 : pos1;
            if (key >= a.s || (a.causal && key > pos) ||
                (a.window && key <= pos - a.window))
              sc[j][e] = -INFINITY;
          }
        }
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // p = 2^(s scale - m scale), one FFMA and one ex2 an element; a row
      // that has seen no key yet keeps m = -inf, its p and O at 0
      const float base0 = mx0 == -INFINITY ? 0.f : mx0 * scale;
      const float base1 = mx1 == -INFINITY ? 0.f : mx1 * scale;
      const float corr0 = ex2(fmaf(m0, scale, -base0));
      const float corr1 = ex2(fmaf(m1, scale, -base1));
      m0 = mx0;
      m1 = mx1;

      // p in fp32 for l; rounded to bf16 as the A operand of P V, score
      // tiles 2j and 2j + 1 making the k16 step j
      float ps0 = 0.f, ps1 = 0.f;
      uint32_t pa[NK / 2][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float p0 = ex2(fmaf(sc[j][0], scale, -base0));
        const float p1 = ex2(fmaf(sc[j][1], scale, -base0));
        const float p2 = ex2(fmaf(sc[j][2], scale, -base1));
        const float p3 = ex2(fmaf(sc[j][3], scale, -base1));
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= corr0; acc[n][1] *= corr0;
        acc[n][2] *= corr1; acc[n][3] *= corr1;
      }

      // O += P V
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t vf[4];
          ldsm_x4_t(vf, vt + (kk * 16 + (lane & 15)) * S + dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pa[kk], vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], pa[kk], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();   // the buffer is free for the tile after next
  }

  // l over the row's 4 lanes, the same bits in each; O through this warp's
  // own rows of the Q tile (only this warp ever read them) to 16-byte stores
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* st = qs + wrow0 * S;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(st + gr * S + n * 8 + gc) =
        pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(st + (gr + 8) * S + n * 8 + gc) =
        pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  __syncwarp();
  for (int e = lane; e < 16 * SEG; e += 32) {
    const int r = e / SEG, c = (e % SEG) * 8, t = t0 + wrow0 + r;
    if (t < a.t)   // o is contiguous [B, T, H, D]
      *reinterpret_cast<uint4*>(o + ((b * a.t + t) * a.h + h) * D + c) =
          *reinterpret_cast<const uint4*>(st + r * S + c);
  }
}

// Above 48 KB of dynamic shared memory a kernel must ask for it; the
// largest carveout lets as many blocks as fit share an SM.  Asked once per
// instance and device.
template <int D>
cudaError_t mma_prepare() {
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MmaTile<D>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

template <int D>
cudaError_t launch_mma(const Args& a, int b, cudaStream_t stream) {
  const int n_tiles = (a.t + kMmaRows - 1) / kMmaRows;
  if (n_tiles > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = mma_prepare<D>();
  if (err != cudaSuccess) return err;
  flash_mma_kernel<D><<<dim3(a.h * b, n_tiles), kMmaWarps * 32,
                        MmaTile<D>::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// out: the dynamic shared memory of a block in bytes, and the blocks one SM
// of the current device holds at once.
template <int D>
cudaError_t mma_resources(int* out) {
  out[0] = MmaTile<D>::kSmem;
  const cudaError_t err = mma_prepare<D>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], flash_mma_kernel<D>, kMmaWarps * 32, out[0]);
}

}  // namespace

// route: 0 the CUDA-core kernel (fma), 1 the tensor-core kernel (mma, bf16
// only).  dtype: 0 float32, 1 bfloat16.  q [B, T, H, D], k and v [B, S, KV,
// D] with the given element strides (the last axis contiguous, rows
// 16-byte aligned); o contiguous [B, T, H, D].  Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_launch(
    int route, int dtype, const void* q, const void* k, const void* v, void* o,
    int b, int t, int s, int h, int kv, int d,
    int64_t qsb, int64_t qst, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh,
    int causal, int window, int q_offset, float sm_scale, void* stream) {
  if (b <= 0 || b > 65535 || t <= 0 || s <= 0 || kv <= 0 || h % kv != 0)
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, t, s, h, kv, h / kv, qsb, qst, qsh, ksb, kss, ksh,
         vsb, vss, vsh, causal, window, q_offset, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return cudaErrorInvalidValue;
    if (d == 64) return launch_mma<64>(a, b, st);
    if (d == 128) return launch_mma<128>(a, b, st);
    return cudaErrorInvalidValue;
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_typed<float>(a, b, d, st);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(a, b, d, st);
  return cudaErrorInvalidValue;
}

// out: {dynamic shared memory of a block in bytes, blocks an SM holds} of
// the mma route's kernel at head dim d.
extern "C" int flash_attention_mma_resources(int d, int* out) {
  if (d == 64) return mma_resources<64>(out);
  if (d == 128) return mma_resources<128>(out);
  return cudaErrorInvalidValue;
}
