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
// Three kernels, three routes, chosen by the wrapper from (dtype, T, D)
// alone (kernels/flash_attention/ops.py, _route) and never as a reaction
// to a failure:
//
//   split  T < 16 query rows (decode: one query token per slot over a
//          cache prefix, and short multi-token steps), float32 and bf16:
//          flash_split_kernel, the keys split over many blocks, fp32 FMAs
//          on the CUDA cores;
//   mma    bf16 with T >= 16 rows (prefill): flash_mma_kernel, both
//          products on the tensor cores;
//   fma    float32 with T >= 16 rows: flash_kernel, fp32 FMAs on the CUDA
//          cores.  float32 stays off the tensor cores because its
//          tolerance of 2e-5 cannot be met with bf16 products.
//
// The log-sum-exp.  The two prefill kernels (mma, fma) also write each
// row's log-sum-exp lse = m sm_scale + ln(l) (natural log; -inf for a row
// that sees no key) to lse[B, H, T] in fp32 when the wrapper passes its
// address, as the forward of a call that needs a gradient does
// (FlashAttention in ops.py; the backward, flash_attention_bwd.cu, rebuilds
// P from it).  The write is one store a row after the output; everything
// before it, O's bits included, is the same with or without it.  The split
// route never writes it.
//
// Bound on this card.  Prefill (T = S, causal) does 4 D operations per
// visible (row, key) pair against B T (H + 2 KV) D elements: at qwen2-0.5b's
// forward (B 2, T 2048, H 14, KV 2, D 64) that is 15.0 GFLOP, 0.0152 ms on
// the bf16 tensor cores (989 TFLOP/s), against 0.0050 ms for its 16.8 MB,
// so operations bound it.  Decode reads the visible K/V prefix once and does
// 4 D operations per (row, key): bytes bound it.  At qwen2-0.5b's serve
// shape (B 4, T 1, S 405, H 14, KV 2, D 64, bf16) that is 843,776 bytes,
// 0.00025 ms at 3.35 TB/s.
//
// The split route.  The fma kernel below served decode until it was given
// this route; it ran the serve shape at over 100x the bound (0.030-0.039
// ms on the device, PERF.md) for causes each met here:
//
//   1. Eight blocks on 132 SMs: its grid was (row tiles, KV, B), one block
//      walking all keys of a kv head, half its warps holding no row.  Here
//      the keys are split: grid (splits, KV x row tiles, B), each block
//      taking the T G rows (8 at most, a row tile) of one kv head over one
//      split of keys.  The wrapper picks the split (ops._splits) from the
//      shape alone: keys a split a multiple of 32 (16, 32 and 64 tied in
//      probe runs on the card), at most 16 splits and about 512 blocks;
//      13 splits of 32 keys x 8 = 104 blocks at S 405, 16 of 64 at S 1,024.
//   2. K widened to fp32 and stored transposed in shared memory one scalar
//      at a time, two __syncthreads a tile.  Here a lane reads 16 bytes of
//      one key row straight from global memory (8 bf16 or 4 f32 values), so
//      D / 8 or D / 4 lanes (a key group) cover a row and a warp step covers
//      4, 2 or 1 keys; each K/V element is read once and serves every row
//      of the block from registers; the key loop has no barrier.
//   3. Nothing overlapped the next loads with the arithmetic.  Here a warp
//      takes its steps in pairs under one softmax update, and the next
//      pair's loads are issued before this pair's arithmetic (the first
//      pair's before q's).
//   4. One row's softmax ran in every lane.  Here a step's 8 partial
//      scores are reduce-scattered over the group's lanes (7 shuffles), so
//      lane l runs row l % 8's softmax alone, and p and the rescale factor
//      reach the accumulating lanes by shuffles; the rescale runs only
//      where some row's max rose.
//   5. A heavy host path: the wrapper now passes one packed argument
//      (struct Launch) instead of 26, reads the stream as a raw handle and
//      switches device only when q's is not current.
//
// Scores and softmax are fp32: q is loaded once and scaled by
// log2(e) / sqrt(D) in fp32, and p = 2^(s - m) stays fp32 (the TPU kernel
// keeps p in f32).  Each warp runs its own online softmax over its keys
// (m shared by the warp, l and the accumulators kept per key group); at
// the end the warps' (m, l, acc) are merged through shared memory in warp
// order, then key-group order.  With one split the block writes O itself.
// Otherwise each split writes its (acc[D], m, l) per row in fp32 to a
// workspace [B, KV x row tiles, splits, 8 rows, D + 2] (torch.empty by the
// wrapper); after a barrier its thread 0 fences and takes a ticket from a
// counter of its (row tile, kv head, batch), and the block that takes the
// last ticket sets the counter back to 0, loads every split's (m, l,
// acc) of its rows in one round from L2 and combines them in index order:
// m = max m_i, l = sum l_i 2^(m_i - m), O = sum acc_i 2^(m_i - m) · (1 /
// max(l, 1e-30)), written once in q's dtype.  So the split route is one device
// launch a call, the only atomic is the ticket, every sum runs in a fixed
// order whichever block ends last, and a second call gives the same bits.
// Calls on one stream run in turn, so a counter (kept per device and
// stream by the wrapper) is 0 when the next call starts.  A split whose
// keys lie wholly past the diagonal or before the window loads nothing and
// writes m = -inf, l = 0.  What still holds it above SDPA (PERF.md): a
// floor of about 4 us for one split, and the three dependent round trips
// to L2 of the combine (the partials and fence, the ticket, the loads).
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
// The fma route (float32 with T >= 16 rows; until the split route it also
// served decode).  One thread block owns a tile of query rows and loops
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
#include <string.h>

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

// 16 bytes of T as floats (from memory, or from registers), and 4 floats
// stored as T.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
  __device__ __forceinline__ static void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
  // 4 floats to 4 bf16 (8 bytes)
  __device__ __forceinline__ static void store4(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

struct Args {
  const void* q; const void* k; const void* v; void* o;
  int t, s, h, kv, g;
  int64_t qsb, qst, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window, q_offset;
  float sm_scale;
  // the split route only: keys a split, the partials' workspace and the
  // ticket counters
  int kps;
  float* ws;
  unsigned int* tickets;
  // the mma and fma routes: the rows' log-sum-exp [B, H, T], or null
  float* lse;
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
    if (a.lse != nullptr && lane == 0)
      a.lse[(b * a.h + row_h[i]) * a.t + row_t[i]] =
          m[i] == -INFINITY ? -INFINITY : m[i] + logf(l);
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
  if (a.lse != nullptr && (lane & 3) == 0) {
    // m is the row's max of the unscaled scores, l its sum of 2^((s - m)
    // sm_scale log2 e) = e^((s - m) sm_scale)
    float* lrow = a.lse + (b * a.h + h) * a.t;
    const int t_a = t0 + wrow0 + gr, t_b = t_a + 8;
    if (t_a < a.t) lrow[t_a] = m0 == -INFINITY ? -INFINITY : fmaf(m0, a.sm_scale, logf(l0));
    if (t_b < a.t) lrow[t_b] = m1 == -INFINITY ? -INFINITY : fmaf(m1, a.sm_scale, logf(l1));
  }
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

// ---- the split route: decode and short steps, the keys split over blocks -----

constexpr int kSplitWarps = 4;     // warps a block
constexpr int kSplitRows = 8;      // query rows a block (a row tile)
constexpr int kMaxSplits = 16;     // splits of one (row tile, kv head, batch)

// 16 bytes of global memory through the read-only path.
__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Block (split, kv head x row tiles + row tile, batch): rows row0 ..
// row0 + 7 of the T G (t, g) rows of kv head kvh (t-major), keys [k_lo,
// k_hi) of its split.  A warp step takes KPW keys, one a key group of LPK
// lanes; lane l loads columns c .. c + VN - 1 of its group's key and
// keeps the accumulators of those columns for all 8 rows.  Warp w takes
// steps w, w + 4, ..., two at a time.  The scores of a step are
// reduce-scattered over the group's lanes, so lane l ends with the score
// of row l % 8 and runs that row's softmax; the p and the rescale factor
// of each row reach the accumulating lanes by shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(kSplitWarps * 32)
flash_split_kernel(const Args a) {
  constexpr int VN = Vec<T>::N;              // values in 16 bytes
  constexpr int LPK = D / VN;                // lanes a key row: 8, 16 or 32
  constexpr int KPW = 32 / LPK;              // keys a warp step
  constexpr int KPB = KPW * kSplitWarps;     // keys a block step
  constexpr int R = kSplitRows;
  constexpr int C4 = D / 4;                  // float4 columns a row
  constexpr int kThreads = kSplitWarps * 32;
  constexpr int PART = R * (D + 2);          // floats of one split's partial
  constexpr unsigned kAll = 0xffffffffu;
  constexpr float kLog2e = 1.4426950408889634f;
  static_assert(R == 8 && LPK >= 8, "the score scatter maps 8 rows on 8 lanes");
  // each warp's and key group's partial (acc, l) per row, and its m; a
  // key group's [R][D] block is padded by 4 floats, so that a warp's float4
  // stores (lanes 32 floats apart collide) take 4 bank wavefronts, not 8
  constexpr int GS = R * D + 4;
  __shared__ __align__(16) float acc_s[kSplitWarps][KPW][GS];
  __shared__ float l_s[kSplitWarps][KPW][R];
  __shared__ float m_s[kSplitWarps][R];
  __shared__ int last_s;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = lane / LPK;                 // this lane's key in a step
  const int c = (lane % LPK) * VN;           // its first column
  const int grp = kg * LPK;                  // the first lane of its group
  const int row_tiles = gridDim.y / a.kv;
  const int kvh = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * R;
  const int64_t b = blockIdx.z;
  const int n_rows = a.t * a.g;
  const int split = blockIdx.x, n_split = gridDim.x;

  // the keys of this split that any row of the block sees
  const int pos_lo = a.q_offset + row0 / a.g;
  const int pos_hi = a.q_offset + (min(row0 + R, n_rows) - 1) / a.g;
  int k_lo = split * a.kps, k_hi = min(a.s, k_lo + a.kps);
  if (a.causal) k_hi = min(k_hi, pos_hi + 1);
  if (a.window) k_lo = max(k_lo, pos_lo - a.window + 1);

  // row lane % 8's softmax state over this key group's keys (m is the
  // same in every group of the warp)
  const int my_row = row0 + (lane & 7);
  const bool my_ok = my_row < n_rows;
  const int my_pos = a.q_offset + (my_ok ? my_row / a.g : 0);
  float m = -INFINITY, l = 0.f;
  float acc[R][VN];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < VN; ++j) acc[r][j] = 0.f;

  if (k_lo < k_hi) {   // block-uniform: an empty split loads nothing
    const T* kb = k + b * a.ksb + kvh * a.ksh + c;
    const T* vb = v + b * a.vsb + kvh * a.vsh + c;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    // Steps go in pairs (A, B = A + KPB keys) under one softmax update, and
    // the next pair is loaded while this one is computed.  The first pair's
    // loads are issued before q's, so both are in flight at once.
    const int key0 = k_lo + warp * KPW + kg;
    uint4 ka = zero, va = zero, kb2 = zero, vb2 = zero;
    if (key0 < k_hi) {
      ka = ldg16(kb + key0 * a.kss);
      va = ldg16(vb + key0 * a.vss);
    }
    if (key0 + KPB < k_hi) {
      kb2 = ldg16(kb + (key0 + KPB) * a.kss);
      vb2 = ldg16(vb + (key0 + KPB) * a.vss);
    }
    // this lane's columns of the block's rows, scaled; rows past T G are 0.
    // Row row0 + r is (t, g): one division for the first, then steps.
    float qf[R][VN];
    int t = row0 / a.g, g = row0 - t * a.g;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r < n_rows) {
        Vec<T>::load(q + b * a.qsb + t * a.qst + (kvh * a.g + g) * a.qsh + c,
                     qf[r]);
      } else {
#pragma unroll
        for (int j = 0; j < VN; ++j) qf[r][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) qf[r][j] *= a.sm_scale * kLog2e;
      if (++g == a.g) {
        g = 0;
        ++t;
      }
    }

    // row lane % 8's score at this group's key of one step, -inf if masked
    auto score = [&](const float (&kf)[VN], int key) {
      float sc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sc[r] = 0.f;
#pragma unroll
        for (int j = 0; j < VN; ++j) sc[r] = fmaf(qf[r][j], kf[j], sc[r]);
      }
      // reduce-scatter over lane bits 2, 1, 0: each level keeps half the
      // rows and adds the partner's; then the rest of the group
      float s4[4], s2[2];
      const bool h2 = lane & 4, h1 = lane & 2, h0 = lane & 1;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s4[i] = (h2 ? sc[i + 4] : sc[i]) +
                __shfl_xor_sync(kAll, h2 ? sc[i] : sc[i + 4], 4);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        s2[i] = (h1 ? s4[i + 2] : s4[i]) +
                __shfl_xor_sync(kAll, h1 ? s4[i] : s4[i + 2], 2);
      float x = (h0 ? s2[1] : s2[0]) +
                __shfl_xor_sync(kAll, h0 ? s2[0] : s2[1], 1);
#pragma unroll
      for (int off = 8; off < LPK; off <<= 1) x += __shfl_xor_sync(kAll, x, off);
      const bool ok = key < k_hi && my_ok && (!a.causal || key <= my_pos) &&
                      (!a.window || key > my_pos - a.window);
      return ok ? x : -INFINITY;
    };
    // warp-uniform: every lane runs every pair, so the shuffles see all 32
    for (int k0 = k_lo + warp * KPW; k0 < k_hi; k0 += 2 * KPB) {
      const int key_a = k0 + kg, key_b = key_a + KPB;
      uint4 na = zero, nva = zero, nb = zero, nvb = zero;
      if (key_a + 2 * KPB < k_hi) {
        na = ldg16(kb + (key_a + 2 * KPB) * a.kss);
        nva = ldg16(vb + (key_a + 2 * KPB) * a.vss);
      }
      if (key_b + 2 * KPB < k_hi) {
        nb = ldg16(kb + (key_b + 2 * KPB) * a.kss);
        nvb = ldg16(vb + (key_b + 2 * KPB) * a.vss);
      }
      float kfa[VN], vfa[VN], kfb[VN], vfb[VN];
      Vec<T>::unpack(ka, kfa);
      Vec<T>::unpack(va, vfa);
      Vec<T>::unpack(kb2, kfb);
      Vec<T>::unpack(vb2, vfb);
      const float sa = score(kfa, key_a), sb = score(kfb, key_b);

      // the softmax of row lane % 8 over the pair's keys of the warp
      float mx = fmaxf(sa, sb);
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
      // a row that has seen no key yet keeps m = -inf, and its exponents
      // run against 0 (2^-inf = 0: a masked key gives p = 0)
      const float m_new = fmaxf(m, mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = ex2(m - base);
      const float pa = ex2(sa - base), pb = ex2(sb - base);
      l = fmaf(l, corr, pa) + pb;
      m = m_new;

      // every row's accumulators: rescaled only where some row's max rose
      if (__any_sync(kAll, corr != 1.f)) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float cr = __shfl_sync(kAll, corr, grp + r);
#pragma unroll
          for (int j = 0; j < VN; ++j) acc[r][j] *= cr;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float par = __shfl_sync(kAll, pa, grp + r);
        const float pbr = __shfl_sync(kAll, pb, grp + r);
#pragma unroll
        for (int j = 0; j < VN; ++j)
          acc[r][j] = fmaf(pbr, vfb[j], fmaf(par, vfa[j], acc[r][j]));
      }
      ka = na;
      va = nva;
      kb2 = nb;
      vb2 = nvb;
    }
  }

  // each key group's partials to shared memory (l from the group's first
  // 8 lanes, m, the same in every group, from the warp's first 8)
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < VN; j += 4)
      *reinterpret_cast<float4*>(&acc_s[warp][kg][r * D + c + j]) =
          make_float4(acc[r][j], acc[r][j + 1], acc[r][j + 2], acc[r][j + 3]);
  if (lane - grp < 8) l_s[warp][kg][lane & 7] = l;
  if (lane < 8) m_s[warp][lane] = m;
  __syncthreads();

  // merge the warps in warp order, key groups in group order: this block's
  // (acc, m, l) per row; four columns a thread
  float* part = n_split == 1 ? nullptr
                : a.ws + (b * gridDim.y + blockIdx.y) * n_split * PART;
  for (int e = tid; e < R * C4; e += kThreads) {
    const int r = e / C4, d = (e % C4) * 4;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mm = fmaxf(mm, m_s[w][r]);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float ww = m_s[w][r] == -INFINITY ? 0.f : ex2(m_s[w][r] - mm);
#pragma unroll
      for (int g = 0; g < KPW; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(&acc_s[w][g][r * D + d]);
        sum.x += x.x * ww; sum.y += x.y * ww;
        sum.z += x.z * ww; sum.w += x.w * ww;
        ll += l_s[w][g][r] * ww;
      }
    }
    const int gr = row0 + r;
    if (n_split == 1) {   // the only split: O here
      if (gr < n_rows) {
        const float inv = 1.f / fmaxf(ll, 1e-30f);
        const int t = gr / a.g, h = kvh * a.g + gr % a.g;
        // o is contiguous [B, T, H, D]
        Vec<T>::store4(o + ((b * a.t + t) * a.h + h) * D + d,
                       make_float4(sum.x * inv, sum.y * inv, sum.z * inv,
                                   sum.w * inv));
      }
    } else {
      float* mine = part + split * PART;
      *reinterpret_cast<float4*>(mine + r * D + d) = sum;
      if (d == 0) {
        mine[R * D + r] = mm;
        mine[R * D + R + r] = ll;
      }
    }
  }
  if (n_split == 1) return;

  // the last block of the (row tile, kv head, batch) to finish combines:
  // the barrier orders the block's writes before thread 0's fence and
  // ticket, and the last ticket's fence and barrier order its reads after
  // every split's writes
  __syncthreads();
  if (tid == 0) {
    unsigned int* ticket = a.tickets + b * gridDim.y + blockIdx.y;
    __threadfence();
    last_s = atomicAdd(ticket, 1u) == static_cast<unsigned int>(n_split - 1);
    if (last_s) {
      *ticket = 0u;   // every split has taken its ticket
      __threadfence();
    }
  }
  __syncthreads();
  if (!last_s) return;

  // every split's (m, l, acc) of this thread's row and columns in one round
  // of loads from L2, then the splits in index order
  for (int e = tid; e < R * C4; e += kThreads) {
    const int r = e / C4, d = (e % C4) * 4, gr = row0 + r;
    if (gr >= n_rows) continue;
    float mi[kMaxSplits], li[kMaxSplits];
    float4 xi[kMaxSplits];
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i) {
      if (i < n_split) {
        mi[i] = __ldcg(part + i * PART + R * D + r);
        li[i] = __ldcg(part + i * PART + R * D + R + r);
        xi[i] = __ldcg(reinterpret_cast<const float4*>(part + i * PART + r * D + d));
      }
    }
    float mm = -INFINITY;
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i)
      if (i < n_split) mm = fmaxf(mm, mi[i]);
    float ll = 0.f;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i) {
      if (i < n_split) {
        const float w = mi[i] == -INFINITY ? 0.f : ex2(mi[i] - mm);
        ll += li[i] * w;
        sum.x += xi[i].x * w; sum.y += xi[i].y * w;
        sum.z += xi[i].z * w; sum.w += xi[i].w * w;
      }
    }
    const float inv = 1.f / fmaxf(ll, 1e-30f);
    const int t = gr / a.g, h = kvh * a.g + gr % a.g;
    Vec<T>::store4(o + ((b * a.t + t) * a.h + h) * D + d,
                   make_float4(sum.x * inv, sum.y * inv, sum.z * inv,
                               sum.w * inv));
  }
}

// splits: blocks over the keys (1..kMaxSplits), a.kps keys each;
// row_tiles: ceil(T G / kSplitRows).
template <typename T, int D>
cudaError_t launch_split(const Args& a, int b, int splits, int row_tiles,
                         cudaStream_t stream) {
  if (splits < 1 || splits > kMaxSplits || a.kps < 1 ||
      static_cast<int64_t>(splits) * a.kps < a.s ||
      static_cast<int64_t>(row_tiles) * kSplitRows < a.t * a.g ||
      static_cast<int64_t>(a.kv) * row_tiles > 65535 ||
      (splits > 1 && (a.ws == nullptr || a.tickets == nullptr)))
    return cudaErrorInvalidValue;
  flash_split_kernel<T, D><<<dim3(splits, a.kv * row_tiles, b),
                             kSplitWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

// out: {static shared memory of a block in bytes, registers a thread,
// blocks one SM of the current device holds at once} of a split instance.
template <typename T, int D>
cudaError_t split_resources(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_split_kernel<T, D>);
  if (err != cudaSuccess) return err;
  out[0] = static_cast<int>(attr.sharedSizeBytes);
  out[1] = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], flash_split_kernel<T, D>, kSplitWarps * 32, 0);
}

template <typename T>
cudaError_t launch_split_typed(const Args& a, int b, int d, int splits,
                               int row_tiles, cudaStream_t stream) {
  if (d == 64) return launch_split<T, 64>(a, b, splits, row_tiles, stream);
  if (d == 128) return launch_split<T, 128>(a, b, splits, row_tiles, stream);
  return cudaErrorInvalidValue;
}

// The one argument of flash_attention_launch, packed by the wrapper
// (ops._LAUNCH, struct format "<16q13ifq"): addresses, element strides of
// q [B, T, H, D] and k, v [B, S, KV, D] (the last axis contiguous, rows
// 16-byte aligned), then the sizes and flags, the scale and the address of
// the log-sum-exp output [B, H, T] fp32 (0: none; the split route takes
// none).  o is contiguous [B, T, H, D].
struct Launch {
  int64_t q, k, v, o, ws, tickets, stream;
  int64_t qsb, qst, qsh, ksb, kss, ksh, vsb, vss, vsh;
  // route: 0 fma, 1 mma (bf16 only), 2 split; dtype: 0 float32, 1 bfloat16;
  // splits and kps (keys a split) for the split route
  int32_t route, dtype, b, t, s, h, kv, d, causal, window, q_offset, splits, kps;
  float sm_scale;
  int64_t lse;
};
static_assert(sizeof(Launch) == 192, "ops._LAUNCH packs 192 bytes");

}  // namespace

// Launch one route on a Launch packed at `packed` → cudaGetLastError()
// after the launch.
extern "C" int flash_attention_launch(const void* packed) {
  Launch p;
  memcpy(&p, packed, sizeof(p));
  if (p.b <= 0 || p.b > 65535 || p.t <= 0 || p.s <= 0 || p.kv <= 0 ||
      p.h % p.kv != 0)
    return cudaErrorInvalidValue;
  Args a{reinterpret_cast<const void*>(p.q), reinterpret_cast<const void*>(p.k),
         reinterpret_cast<const void*>(p.v), reinterpret_cast<void*>(p.o),
         p.t, p.s, p.h, p.kv, p.h / p.kv, p.qsb, p.qst, p.qsh, p.ksb, p.kss,
         p.ksh, p.vsb, p.vss, p.vsh, p.causal, p.window, p.q_offset,
         p.sm_scale, p.kps, reinterpret_cast<float*>(p.ws),
         reinterpret_cast<unsigned int*>(p.tickets), reinterpret_cast<float*>(p.lse)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p.stream);
  if (p.route == 2) {
    if (p.lse != 0) return cudaErrorInvalidValue;
    const int row_tiles = (a.t * a.g + kSplitRows - 1) / kSplitRows;
    if (p.dtype == 0)
      return launch_split_typed<float>(a, p.b, p.d, p.splits, row_tiles, st);
    if (p.dtype == 1)
      return launch_split_typed<__nv_bfloat16>(a, p.b, p.d, p.splits,
                                               row_tiles, st);
    return cudaErrorInvalidValue;
  }
  if (p.route == 1) {
    if (p.dtype != 1) return cudaErrorInvalidValue;
    if (p.d == 64) return launch_mma<64>(a, p.b, st);
    if (p.d == 128) return launch_mma<128>(a, p.b, st);
    return cudaErrorInvalidValue;
  }
  if (p.route != 0) return cudaErrorInvalidValue;
  if (p.dtype == 0) return launch_typed<float>(a, p.b, p.d, st);
  if (p.dtype == 1) return launch_typed<__nv_bfloat16>(a, p.b, p.d, st);
  return cudaErrorInvalidValue;
}

// out: {bytes of a Launch, query rows a split-route block, most splits}:
// the wrapper checks its own constants against these once, at load.
extern "C" int flash_attention_constants(int* out) {
  out[0] = static_cast<int>(sizeof(Launch));
  out[1] = kSplitRows;
  out[2] = kMaxSplits;
  return 0;
}

// out: {dynamic shared memory of a block in bytes, blocks an SM holds} of
// the mma route's kernel at head dim d.
extern "C" int flash_attention_mma_resources(int d, int* out) {
  if (d == 64) return mma_resources<64>(out);
  if (d == 128) return mma_resources<128>(out);
  return cudaErrorInvalidValue;
}

// out: {static shared memory of a block in bytes, registers a thread,
// blocks an SM} of the split route's kernel for dtype (0 float32, 1
// bfloat16) at head dim d.
extern "C" int flash_attention_split_resources(int dtype, int d, int* out) {
  if (dtype == 0 && d == 64) return split_resources<float, 64>(out);
  if (dtype == 0 && d == 128) return split_resources<float, 128>(out);
  if (dtype == 1 && d == 64) return split_resources<__nv_bfloat16, 64>(out);
  if (dtype == 1 && d == 128) return split_resources<__nv_bfloat16, 128>(out);
  return cudaErrorInvalidValue;
}
