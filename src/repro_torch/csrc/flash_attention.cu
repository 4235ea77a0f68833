// Flash attention (online softmax) for Hopper (sm_90a), grouped-query layout.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, pallas_call at :110).  Same function: for each
// query row, softmax(q k^T / sqrt(D)) v over the visible keys, with the
// running max m, running sum l and the accumulator in fp32, masks
// key < S, causal (key <= q_offset + t) and a sliding window
// (key > q_offset + t - window); kv tiles that lie wholly above the
// diagonal or outside the window are never loaded.  Output = acc / max(l,
// 1e-30), cast to the input type.
//
// Bound on this card.  Decode (one query token per slot over a cache
// prefix) reads the visible K/V prefix once and does 4*D operations per
// (row, key): it is bound by bytes (3.35 TB/s).  Prefill (T = S, causal) does
// 2*B*H*T^2*D operations against B*T*(H + 2*KV)*D elements: it is bound by
// operations, against 989 TFLOP/s on the bf16 tensor cores.  This first
// kernel runs on the CUDA cores in fp32 (no TF32, no tensor cores), so
// prefill stays far above its bound; wgmma, TMA and warp specialisation
// are later work.
//
// Design.  The TPU kernel walks kv blocks on a sequential grid axis and
// carries m, l, acc in VMEM scratch; here one thread block owns a tile of
// query rows and loops over kv tiles itself, so nothing carries between
// blocks.  A block serves one (batch, kv head): its rows are (t, g) pairs of
// the G = H / KV query heads that share that kv head, t-major, so a K/V
// tile loaded into shared memory serves all G heads (the wrapper never
// materialises the reference wrapper's jnp.repeat of k and v), and a
// one-token decode query is a tile of G rows, not 128 padded ones.  Each
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

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q [B, T, H, D], k and v [B, S, KV, D] with
// the given element strides (the last axis contiguous, rows 16-byte
// aligned); o contiguous [B, T, H, D].  Returns cudaGetLastError() after
// the launch.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o,
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
  if (dtype == 0) return launch_typed<float>(a, b, d, st);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(a, b, d, st);
  return cudaErrorInvalidValue;
}
