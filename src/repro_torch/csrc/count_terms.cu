// Count-terms kernels for Hopper (sm_90a): the row-stationary mapping and the
// 14 access-count terms of the energy model, in float64.
//
// They replace the Pallas kernels of the JAX package,
// src/repro/kernels/count_terms/kernel.py:
//
//   count_terms   <- count_terms_kernel  (pallas_call at kernel.py:99, body
//                    _count_terms_kernel): terms summed per network segment,
//                    out [14, n_u, n_net].
//   count_layers  <- count_layers_kernel (pallas_call at kernel.py:146, body
//                    _count_layers_kernel): the same terms per layer, no sum,
//                    out [14, n_u, L].
//
// The arithmetic is op for op that of rs_mapping.mapping, energymodel._counts
// and energymodel._count_terms in src/repro_torch/core, which the plain
// versions in kernels/count_terms/ref.py run.  The build passes --fmad=false,
// so no multiply-add is contracted and every per-layer value rounds as the
// plain version's separate operations do: count_layers matches it bit for
// bit.  The one fused operation is the explicit fma() of the division
// helpers below.
//
// Floor and ceiling division.  fdiv(a, b) = floor(a / b) as numpy's
// floor_divide (npy_divmod) and torch.div(..., rounding_mode="floor") give
// it, without their fmod, which is a software loop on the card.  For b > 0
// and a quotient below 2^52, floor of the correctly rounded a / b is the
// true floor or one above it (rounding to nearest never crosses the
// representable integer below); the sign of the residual fma(-q, b, a)
// tells which, and the fused residual is exact wherever a, b and q are
// integers.  cdiv is the same with ceil.  fdiv(0, b) and cdiv(0, b) are +0,
// as in the plain version.
//
// count_terms: the mapping once per mapping-unique row.  The RS mapping
// depends on a config only through energymodel._MAPPING_COLUMNS; the count
// rows that share a mapping row differ only in gb_psum_words, which enters
// the terms only through
//
//   A = inter_rounds * max(w_psum - gb_psum_words, 0)   (psum DRAM traffic)
//   B = inter_rounds * min(w_psum, gb_psum_words)       (psum GB traffic)
//
// and A + B = inter_rounds * w_psum is a mapping-level value.  So terms 2,
// 4-10, 12 and 13 are mapping-level, and per count row
//
//   t0 = M0 + sum A,  t1 = M1 + sum A,  t3 = 2 (sum B + M1),  t11 = sum B + M1,
//
// M0 = sum (ifmap + weights) and M1 = sum ofmap.  This reassociation is exact
// only because every one of those values is an integer below 2^53 (shapes,
// word counts and the floor/ceiling quotients of integers; the engine's
// largest per-layer term at extended_grid() x 18 CNNs is 7.6e9): integer
// sums below 2^53 are exact in any order, so the 12 integer terms equal the
// plain version's sums bit for bit.  Beyond that they round, but never
// cancel: every value added is >= 0, and sum A and sum B are each summed
// directly.  Terms 8 and 13 (divisions by the active PEs) are not integers;
// they are summed in the fixed order below and agree with the plain
// version's own order to rounding.
//
// Block layout: one block of 64 threads (two warps) per (mapping row,
// network).  Its count rows are the run of m in inv_m, which is
// non-decreasing (energymodel._prepare_fields groups the count rows by
// mapping row); the block finds the run's ends by a 64-ary search (two
// steps up to 4,096 count rows) and takes its rows 16 a pass.  The
// threads stride over the network's layers, thread t taking layer a + t of
// each stride of 64: it evaluates that layer's mapping once for the pass,
// adds the 12 mapping-level parts to its own sums, and leaves
// inter_rounds and w_psum in shared memory.  Then each count row's four
// neighbouring threads add its A and B over the stride's layers (thread
// slice s: layers s, s + 4, ...).  A thread's sums run in layer order; at
// the end a fixed tree adds them: shuffles down 16, 8, 4, 2, 1 within each
// warp and the two warp sums in warp order for the mapping sums, shuffles
// down 2, 1 among a row's four threads for its A and B.  No atomics: the
// same inputs give the same bits on every call.  The operands travel as
// column addresses (nothing is stacked) and the segments by value, at most
// 256 networks a launch, in one launch argument.
//
// What bounds them on an H100:
//   count_terms:  FP64 arithmetic and its latency.  About 280 FP64
//                 instructions per (mapping row, layer) pair, a dozen of them
//                 in the divisions' dependent chains, and ~6 per (count
//                 row, layer) pair; it reads kilobytes and writes
//                 [14, n_u, n_net].  Mapping rows x networks blocks (3,240 at
//                 extended_grid() x 18, 2,520 at a 9,800-point mega_grid()
//                 chunk); the longest network (275 layers with the pad)
//                 takes five strides.  A probe of 64, 128 and 256 threads a
//                 block and 8, 16 and 32 count rows a pass put 64 and 16
//                 first (PERF.md).
//   count_layers: writing its output, 14 * n_u * L * 8 bytes (413 MB at
//                 extended_grid x 18 networks, 2.25 GB at mega_grid).  One
//                 thread owns one (count row, layer) pair with the layer
//                 index fastest, so each of the 14 stores of a warp is one
//                 contiguous 256-byte run.

// Plain C interface for ctypes: each launcher returns cudaGetLastError() of
// its launch (0 on success).  Kernels run on the caller's stream, allocate
// nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// Operands: count_layers takes cfg [7, n_u] in energymodel._COUNT_COLUMNS
// order and lay [16, L] in kernels/count_terms/ops.py LAYER_FIELDS order,
// row-major; count_terms takes the same columns one address each (struct
// Launch).
constexpr int kTerms = 14;
constexpr int kThreads = 64;    // count_terms: threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;       // count_terms: count rows a pass
constexpr int kSlices = kThreads / kTile;   // threads a count row
static_assert(kSlices <= 32 && (kSlices & (kSlices - 1)) == 0,
              "a count row's threads are neighbouring lanes of one warp");
constexpr int kMaxNets = 256;   // count_terms: segments a launch
constexpr int kLayersBlock = 256;

__device__ __forceinline__ double fdiv(double a, double b) {
  double q = floor(a / b);
  if (fma(-q, b, a) < 0.0) q -= 1.0;
  return q;
}

__device__ __forceinline__ double cdiv(double a, double b) {
  double q = ceil(a / b);
  if (fma(-q, b, a) > 0.0) q += 1.0;
  return q;
}

// The config columns the mapping reads (rf_ifmap_words enters nothing).
struct MapCfg {
  double rows, cols, gb_ifmap_words, rf_weight_words, rf_psum_words;
};

struct Layer {
  double c_ch, m, ky, kx, ix, iy, oy, ox, macs, weights, ifmap_vol, ofmap;
  bool acc, pool;
};

// Layer l; col(k) is the column of LAYER_FIELDS[k].
template <typename Col>
__device__ __forceinline__ Layer load_layer(Col col, int64_t l) {
  Layer y;
  y.c_ch = col(0)[l];
  y.m = col(1)[l];
  y.ky = col(2)[l];
  y.kx = col(3)[l];
  // stride (4) and is_dw (14) enter no term.
  y.ix = col(5)[l];
  y.iy = col(6)[l];
  y.oy = col(7)[l];
  y.ox = col(8)[l];
  y.macs = col(9)[l];
  y.weights = col(10)[l];
  y.ifmap_vol = col(11)[l];
  y.ofmap = col(12)[l];
  y.acc = col(13)[l] != 0.0;
  y.pool = col(15)[l] != 0.0;
  return y;
}

// What energymodel._counts reads of rs_mapping.mapping.
struct Map {
  double ky_serial, n_c, n_m, w_psum, active;
};

__device__ __forceinline__ Map map_at(const MapCfg& c, const Layer& y) {
  const double one = 1.0;
  const double ky_serial = cdiv(y.ky, c.rows);
  const double ky_map = cdiv(y.ky, ky_serial);
  const double fold = fmax(one, fdiv(c.rows, ky_map));
  const double oy_pass = fmin(y.oy, c.cols);
  const double col_rep = fmax(one, fdiv(c.cols, oy_pass));
  const double sets_rows = fmin(cdiv(y.oy, oy_pass), fold);
  const double fold2 = fmax(one, fdiv(fold, sets_rows));
  const double cap_c_sp = y.acc ? fmin(y.c_ch, fold2) : one;
  const double fold_m = fmax(one, fdiv(fold2, cap_c_sp));
  const double plane_count = y.acc ? y.m : y.c_ch;
  const double cap_m_sp = fmax(fmin(plane_count, fold_m * col_rep), one);
  double cap_c = cap_c_sp;
  const double p_rf = fmax(
      one, fmin(c.rf_psum_words * one, fdiv(c.rf_weight_words * one, y.kx)));
  const double p = fmin(p_rf, cdiv(plane_count, cap_m_sp));
  double cap_m = fmax(fmin(plane_count, cap_m_sp * p), one);
  const double ch_fit = fmax(one, fdiv(c.gb_ifmap_words, y.ix * y.iy));
  cap_c = fmin(cap_c, ch_fit);
  cap_m = y.acc ? cap_m : fmin(cap_m, ch_fit);
  Map mp;
  mp.ky_serial = ky_serial;
  mp.n_c = y.acc ? cdiv(y.c_ch, cap_c) : one;
  mp.n_m = cdiv(plane_count, cap_m);
  mp.w_psum = cap_m * y.ox * y.oy;
  const double cap_c_sp_eff = fmin(cap_c_sp, cap_c);
  const double cap_m_sp_eff = fmin(cap_m_sp, cap_m);
  const double active = ky_map * oy_pass * sets_rows *
                        (y.acc ? cap_c_sp_eff * cap_m_sp_eff : cap_m_sp_eff);
  mp.active = fmin(active, c.rows * c.cols);
  return mp;
}

// ---------------------------------------------------------------------------
// count_layers: the 14 terms of energymodel._count_terms per (count row,
// layer), in the plain version's order of operations.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void count_terms_at(const MapCfg& c,
                                               double gb_psum_words,
                                               const Layer& y,
                                               double t[kTerms]) {
  const Map mp = map_at(c, y);
  const double one = 1.0;
  const double pool_ops = y.c_ch * y.ox * y.oy * y.kx * y.ky;
  const double ifmap_dram_reads = y.ifmap_vol * one;
  const double gb_ifmap_writes = ifmap_dram_reads;
  const double gb_ifmap_reads = y.ifmap_vol * (y.acc ? mp.n_m : 1.0);
  const double gb_wt_reads = y.weights * mp.ky_serial;
  const double inter_rounds = fmax(mp.n_c * mp.ky_serial - 1.0, 0.0);
  const double overflow = fmax(mp.w_psum - gb_psum_words, 0.0);
  const double held = fmin(mp.w_psum, gb_psum_words * one);
  const double psum_dram_writes = inter_rounds * overflow;
  const double psum_dram_reads = psum_dram_writes;
  const double psum_gb_inter = inter_rounds * held;
  const double gb_psum_writes = psum_gb_inter + y.ofmap;
  const double gb_psum_reads = psum_gb_inter + y.ofmap;
  const double dram_reads = ifmap_dram_reads + y.weights + psum_dram_reads;
  const double dram_writes = y.ofmap + psum_dram_writes;
  const double words_into_array =
      gb_ifmap_reads + gb_wt_reads + psum_gb_inter + psum_dram_reads;
  const double words_out_of_array = gb_psum_writes + psum_dram_writes;
  const double ops = y.pool ? pool_ops : y.macs;
  const double rf_accesses =
      (4.0 * ops) + words_into_array + words_out_of_array;

  t[0] = dram_reads;
  t[1] = dram_writes;
  t[2] = gb_ifmap_reads + gb_ifmap_writes;
  t[3] = gb_psum_reads + gb_psum_writes;
  t[4] = gb_wt_reads + y.weights;
  t[5] = rf_accesses;
  t[6] = y.pool ? 0.0 : y.macs;
  t[7] = y.pool ? pool_ops : 0.0;
  t[8] = (c.rows * c.cols - mp.active) * ops / mp.active;
  t[9] = words_into_array + words_out_of_array;
  t[10] = gb_ifmap_reads + gb_wt_reads;
  t[11] = gb_psum_reads;
  t[12] = words_out_of_array;
  t[13] = ops / mp.active;
}

// Thread i over the flat [n_u, L] index, layer fastest.
__global__ void count_layers_kernel(const double* __restrict__ cfg, int64_t n_u,
                                    const double* __restrict__ lay, int64_t L,
                                    double* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t plane = n_u * L;
  if (i >= plane) return;
  const int64_t u = i / L;
  const int64_t l = i - u * L;
  MapCfg c;
  c.rows = cfg[0 * n_u + u];
  c.cols = cfg[1 * n_u + u];
  c.gb_ifmap_words = cfg[2 * n_u + u];
  c.rf_weight_words = cfg[5 * n_u + u];
  c.rf_psum_words = cfg[6 * n_u + u];
  double t[kTerms];
  const Layer y = load_layer([&](int k) { return lay + k * L; }, l);
  count_terms_at(c, cfg[3 * n_u + u], y, t);
#pragma unroll
  for (int k = 0; k < kTerms; ++k) out[(int64_t)k * plane + i] = t[k];
}

// ---------------------------------------------------------------------------
// count_terms: mapping-level sums once per (mapping row, network), the
// gb_psum_words-dependent part per count row.
// ---------------------------------------------------------------------------

// The launch argument (ops._LAUNCH packs it): the addresses of the cfg_m
// columns [n_m] (MAPPING_COLUMNS order), of the layer columns [L]
// (LAYER_FIELDS order), of gb_psum_words [n_u], inv_m [n_u] and out, and the
// stream, as int64; then the sizes; then this launch's segments [a, b) on
// the layer axis, for networks j0 .. j0 + n_net - 1 of out's n_out.
struct Launch {
  int64_t cfg[6], lay[16];
  int64_t gb_psum, inv_m, out, stream;
  int64_t n_m, n_u, L, n_out;
  int32_t j0, n_net;
  int32_t seg[2 * kMaxNets];
};
static_assert(sizeof(Launch) == 248 + 8 * kMaxNets,
              "ops._LAUNCH and ops._SEGMENTS pack 2296 bytes");

// One step of lower_bound for one key: the answer lies in [at, at + len];
// `below` of the step's probes (every step-th entry from at) were below the
// key, so the answer lies after the last of them and at or before the next.
__device__ __forceinline__ void narrow(int below, int step, int& at, int& len) {
  if (below == 0) {
    len = 0;
  } else {
    const int end = at + min(below * step, len);
    at += (below - 1) * step + 1;
    len = end - at;
  }
}

// The first indices lo and hi of the non-decreasing v[0, n) whose values are
// not below m and m + 1, found by the whole block (every thread calls it and
// gets both): each step the threads probe up to kThreads evenly spaced
// entries of each window, the two keys' loads in flight together, and
// __syncthreads_count counts those below the key (two steps up to 4,096
// rows).  32-bit positions: launch_ok keeps n below 2^30.
__device__ void run_of(const int64_t* __restrict__ v, int n, int64_t m,
                       int& lo, int& hi) {
  int len_lo = n, len_hi = n;
  lo = hi = 0;
  while (len_lo > 0 || len_hi > 0) {
    const int step_lo = (len_lo + kThreads - 1) / kThreads;
    const int step_hi = (len_hi + kThreads - 1) / kThreads;
    const int off_lo = static_cast<int>(threadIdx.x) * step_lo;
    const int off_hi = static_cast<int>(threadIdx.x) * step_hi;
    const bool b_lo = off_lo < len_lo && v[lo + off_lo] < m;
    const bool b_hi = off_hi < len_hi && v[hi + off_hi] < m + 1;
    const int below_lo = __syncthreads_count(b_lo);
    const int below_hi = __syncthreads_count(b_hi);
    narrow(below_lo, step_lo, lo, len_lo);
    narrow(below_hi, step_hi, hi, len_hi);
  }
}

// Mapping-level sums of a thread, then of the block.
enum { M0, M1, M2, M4, M5, M6, M7, M8, M9, M10, M12, M13, kSums };

__global__ void __launch_bounds__(kThreads)
count_terms_kernel(const __grid_constant__ Launch p) {
  const double* __restrict__ gb_psum = reinterpret_cast<const double*>(p.gb_psum);
  const int64_t* __restrict__ inv_m = reinterpret_cast<const int64_t*>(p.inv_m);
  double* __restrict__ out = reinterpret_cast<double*>(p.out);

  const int64_t mrow = blockIdx.x;
  const int jj = blockIdx.y;
  const int64_t j = p.j0 + jj;
  const int64_t a = p.seg[2 * jj], b = p.seg[2 * jj + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // In the count-row phase thread tid serves row r of the pass, layers
  // slice, slice + kSlices, ... of each stride.
  const int r = tid / kSlices, slice = tid % kSlices;
  MapCfg c;
  c.rows = reinterpret_cast<const double*>(p.cfg[0])[mrow];
  c.cols = reinterpret_cast<const double*>(p.cfg[1])[mrow];
  c.gb_ifmap_words = reinterpret_cast<const double*>(p.cfg[2])[mrow];
  c.rf_weight_words = reinterpret_cast<const double*>(p.cfg[4])[mrow];
  c.rf_psum_words = reinterpret_cast<const double*>(p.cfg[5])[mrow];
  int lo, hi;
  run_of(inv_m, static_cast<int>(p.n_u), mrow, lo, hi);

  __shared__ double ir_s[kThreads], w_s[kThreads];   // a stride's layers
  __shared__ double part[kWarps][kSums];
  __shared__ double tot[kSums + 2 * kTile];           // then sum A, sum B

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n_t = hi - t0 < kTile ? hi - t0 : kTile;
    const double g = r < n_t ? gb_psum[t0 + r] : 0.0;
    double s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = 0.0;
    double sum_a = 0.0, sum_b = 0.0;

    for (int64_t l0 = a; l0 < b; l0 += kThreads) {
      const int n_l = static_cast<int>(b - l0 < kThreads ? b - l0 : kThreads);
      if (tid < n_l) {
        const Layer y = load_layer(
            [&](int k) { return reinterpret_cast<const double*>(p.lay[k]); },
            l0 + tid);
        const Map mp = map_at(c, y);
        const double one = 1.0;
        const double pool_ops = y.c_ch * y.ox * y.oy * y.kx * y.ky;
        const double ifmap_dram_reads = y.ifmap_vol * one;
        const double gb_ifmap_reads = y.ifmap_vol * (y.acc ? mp.n_m : 1.0);
        const double gb_wt_reads = y.weights * mp.ky_serial;
        const double inter_rounds = fmax(mp.n_c * mp.ky_serial - 1.0, 0.0);
        const double irw = inter_rounds * mp.w_psum;   // A + B
        const double ops = y.pool ? pool_ops : y.macs;
        const double gb_reads = gb_ifmap_reads + gb_wt_reads;
        const double noc = (gb_reads + irw) + (irw + y.ofmap);
        s[M0] += ifmap_dram_reads + y.weights;
        s[M1] += y.ofmap;
        s[M2] += gb_ifmap_reads + ifmap_dram_reads;
        s[M4] += gb_wt_reads + y.weights;
        s[M5] += (4.0 * ops) + noc;
        s[M6] += y.pool ? 0.0 : y.macs;
        s[M7] += y.pool ? pool_ops : 0.0;
        s[M8] += (c.rows * c.cols - mp.active) * ops / mp.active;
        s[M9] += noc;
        s[M10] += gb_reads;
        s[M12] += irw + y.ofmap;
        s[M13] += ops / mp.active;
        ir_s[tid] = inter_rounds;
        w_s[tid] = mp.w_psum;
      }
      __syncthreads();
      if (r < n_t) {
        for (int i = slice; i < n_l; i += kSlices) {
          sum_a += ir_s[i] * fmax(w_s[i] - g, 0.0);
          sum_b += ir_s[i] * fmin(w_s[i], g);
        }
      }
      __syncthreads();   // ir_s and w_s are rewritten by the next stride
    }

    // Fixed-order trees: the mapping sums by shuffles within each warp,
    // then the warps in warp order; a row's A and B sums by shuffles over
    // its kSlices neighbouring lanes.
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      double v = s[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) part[warp][k] = v;
    }
#pragma unroll
    for (int off = kSlices / 2; off > 0; off >>= 1) {
      sum_a += __shfl_down_sync(0xffffffffu, sum_a, off, kSlices);
      sum_b += __shfl_down_sync(0xffffffffu, sum_b, off, kSlices);
    }
    if (slice == 0 && r < n_t) {
      tot[kSums + r] = sum_a;
      tot[kSums + kTile + r] = sum_b;
    }
    __syncthreads();
    if (tid < kSums) {
      double v = part[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += part[w][tid];
      tot[tid] = v;
    }
    __syncthreads();

    for (int i = tid; i < kTerms * n_t; i += kThreads) {
      const int k = i / n_t, u = i - k * n_t;
      const double sa = tot[kSums + u], sb = tot[kSums + kTile + u];
      double v;
      switch (k) {
        case 0: v = tot[M0] + sa; break;
        case 1: v = tot[M1] + sa; break;
        case 2: v = tot[M2]; break;
        case 3: v = 2.0 * (sb + tot[M1]); break;
        case 4: v = tot[M4]; break;
        case 5: v = tot[M5]; break;
        case 6: v = tot[M6]; break;
        case 7: v = tot[M7]; break;
        case 8: v = tot[M8]; break;
        case 9: v = tot[M9]; break;
        case 10: v = tot[M10]; break;
        case 11: v = sb + tot[M1]; break;
        case 12: v = tot[M12]; break;
        default: v = tot[M13]; break;
      }
      out[((int64_t)k * p.n_u + t0 + u) * p.n_out + j] = v;
    }
    __syncthreads();   // tot is reused by the next pass
  }
}

bool launch_ok(const Launch& p) {
  if (p.n_m <= 0 || p.n_u <= 0 || p.n_u >= (int64_t(1) << 30) || p.L <= 0 ||
      p.n_net <= 0 || p.n_net > kMaxNets || p.j0 < 0 ||
      p.j0 + p.n_net > p.n_out)
    return false;
  for (int i = 0; i < p.n_net; ++i) {
    const int64_t a = p.seg[2 * i], b = p.seg[2 * i + 1];
    if (a < 0 || b < a || b > p.L) return false;
  }
  return true;
}

}  // namespace

extern "C" {

int count_terms_launch(const void* packed) {
  Launch p;
  memcpy(&p, packed, sizeof(p));
  if (!launch_ok(p)) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(p.n_m), static_cast<unsigned>(p.n_net));
  count_terms_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(p.stream)>>>(p);
  return (int)cudaGetLastError();
}

// out: {sizeof(Launch), threads a block, count rows a pass, segments a
// launch} of count_terms.
int count_terms_constants(int* out) {
  out[0] = static_cast<int>(sizeof(Launch));
  out[1] = kThreads;
  out[2] = kTile;
  out[3] = kMaxNets;
  return 0;
}

// out: {registers a thread, local memory bytes a thread, blocks an SM holds}
// of count_terms_kernel (kernel 0, kThreads a block) or count_layers_kernel
// (kernel 1, kLayersBlock a block).
int count_terms_resources(int kernel, int* out) {
  if (kernel != 0 && kernel != 1) return cudaErrorInvalidValue;
  const void* fn = kernel == 0 ? reinterpret_cast<const void*>(count_terms_kernel)
                               : reinterpret_cast<const void*>(count_layers_kernel);
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, fn);
  if (rc != cudaSuccess) return rc;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], fn, kernel == 0 ? kThreads : kLayersBlock, 0);
}

int count_layers_launch(const double* cfg, int64_t n_u, const double* lay,
                        int64_t L, double* out, void* stream) {
  const int64_t total = n_u * L;
  if (total <= 0) return 0;
  const int64_t blocks = (total + kLayersBlock - 1) / kLayersBlock;
  count_layers_kernel<<<(unsigned)blocks, kLayersBlock, 0,
                        (cudaStream_t)stream>>>(cfg, n_u, lay, L, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
