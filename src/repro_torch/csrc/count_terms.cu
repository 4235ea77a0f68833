// Count-terms kernels for Hopper (sm_90a): the row-stationary mapping and the
// 14 access-count terms of the energy model, per (count-unique config row,
// layer) pair, in float64.
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
// versions in kernels/count_terms/ref.py run.  Every intermediate but terms 8
// and 13 is an integer below 2^53, so the per-layer terms match the plain
// version bit for bit.  The build passes --fmad=false, so no multiply-add is
// contracted and terms 8 and 13 round exactly as the plain version's separate
// operations do.  The aggregate kernel sums each segment in layer order; the
// plain version's tree-ordered sum differs in the last bits of terms 8 and 13
// only (all terms are >= 0, so the sum has no cancellation).
//
// What bounds them on an H100:
//   count_terms:  FP64 arithmetic.  It reads 7 config columns per row and 16
//                 layer columns, writes [14, n_u, n_net]: kilobytes against
//                 about 100 elementwise FP64 operations per (row, layer)
//                 pair, 12 of them floor or ceiling divisions of a dozen
//                 instructions each.  One thread owns one (row, network)
//                 pair and keeps the 14 sums in registers; the threads of a
//                 block walk the same layer columns in step, so each layer
//                 load is one broadcast.  No atomics, a fixed order: the same
//                 inputs give the same bits on every run.  This replaces the
//                 TPU's one-hot [block_l, n_net] matmul, which the MXU needed
//                 and Hopper does not.
//   count_layers: writing its output, 14 * n_u * L * 8 bytes (413 MB at
//                 extended_grid x 18 networks, 2.25 GB at mega_grid).  One
//                 thread owns one (row, layer) pair with the layer index
//                 fastest, so each of the 14 stores of a warp is one
//                 contiguous 256-byte run.
//
// Plain C interface for ctypes: each launcher returns cudaGetLastError() of
// its launch (0 on success).  Kernels run on the caller's stream, allocate
// nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Operand layouts: cfg [7, n_u] in energymodel._COUNT_COLUMNS order, lay
// [16, L] in kernels/count_terms/ops.py LAYER_FIELDS order, both row-major.
constexpr int kTerms = 14;

// numpy's floor division of doubles (npy_divmod), which torch.div(...,
// rounding_mode="floor") also follows: exact whatever the quotient's size.
__device__ __forceinline__ double fdiv(double a, double b) {
  double mod = fmod(a, b);
  double div = (a - mod) / b;
  if (mod != 0.0) {
    if ((b < 0.0) != (mod < 0.0)) {
      div -= 1.0;
    }
  }
  double floordiv;
  if (div != 0.0) {
    floordiv = floor(div);
    if (div - floordiv > 0.5) floordiv += 1.0;
  } else {
    floordiv = copysign(0.0, a / b);
  }
  return floordiv;
}

__device__ __forceinline__ double cdiv(double a, double b) {
  return -fdiv(-a, b);
}

struct Cfg {
  double rows, cols, gb_ifmap_words, gb_psum_words, rf_ifmap_words,
      rf_weight_words, rf_psum_words;
};

__device__ __forceinline__ Cfg load_cfg(const double* __restrict__ cfg,
                                        int64_t n_u, int64_t u) {
  Cfg c;
  c.rows = cfg[0 * n_u + u];
  c.cols = cfg[1 * n_u + u];
  c.gb_ifmap_words = cfg[2 * n_u + u];
  c.gb_psum_words = cfg[3 * n_u + u];
  c.rf_ifmap_words = cfg[4 * n_u + u];
  c.rf_weight_words = cfg[5 * n_u + u];
  c.rf_psum_words = cfg[6 * n_u + u];
  return c;
}

// The 14 terms of energymodel._count_terms for one (config, layer) pair.
__device__ __forceinline__ void count_terms_at(const Cfg& c,
                                               const double* __restrict__ lay,
                                               int64_t L, int64_t l,
                                               double t[kTerms]) {
  const double c_ch = lay[0 * L + l];
  const double m = lay[1 * L + l];
  const double ky = lay[2 * L + l];
  const double kx = lay[3 * L + l];
  // stride (4) and is_dw (14) enter no term.
  const double ix = lay[5 * L + l];
  const double iy = lay[6 * L + l];
  const double oy = lay[7 * L + l];
  const double ox = lay[8 * L + l];
  const double macs = lay[9 * L + l];
  const double weights = lay[10 * L + l];
  const double ifmap_vol = lay[11 * L + l];
  const double ofmap = lay[12 * L + l];
  const bool acc = lay[13 * L + l] != 0.0;
  const bool pool = lay[15 * L + l] != 0.0;

  // ---- rs_mapping.mapping ----
  const double one = 1.0;
  const double ky_serial = cdiv(ky, c.rows);
  const double ky_map = cdiv(ky, ky_serial);
  const double fold = fmax(one, fdiv(c.rows, ky_map));
  const double oy_pass = fmin(oy, c.cols);
  const double col_rep = fmax(one, fdiv(c.cols, oy_pass));
  const double sets_rows = fmin(cdiv(oy, oy_pass), fold);
  const double fold2 = fmax(one, fdiv(fold, sets_rows));
  const double cap_c_sp = acc ? fmin(c_ch, fold2) : one;
  const double fold_m = fmax(one, fdiv(fold2, cap_c_sp));
  const double plane_count = acc ? m : c_ch;
  const double cap_m_sp = fmax(fmin(plane_count, fold_m * col_rep), one);
  double cap_c = cap_c_sp;
  const double p_rf =
      fmax(one, fmin(c.rf_psum_words * one, fdiv(c.rf_weight_words * one, kx)));
  const double p = fmin(p_rf, cdiv(plane_count, cap_m_sp));
  double cap_m = fmax(fmin(plane_count, cap_m_sp * p), one);
  const double ch_fit = fmax(one, fdiv(c.gb_ifmap_words, ix * iy));
  cap_c = fmin(cap_c, ch_fit);
  cap_m = acc ? cap_m : fmin(cap_m, ch_fit);
  const double n_c = acc ? cdiv(c_ch, cap_c) : one;
  const double n_m = cdiv(plane_count, cap_m);
  const double w_psum = cap_m * ox * oy;
  const double cap_c_sp_eff = fmin(cap_c_sp, cap_c);
  const double cap_m_sp_eff = fmin(cap_m_sp, cap_m);
  double active = ky_map * oy_pass * sets_rows *
                  (acc ? cap_c_sp_eff * cap_m_sp_eff : cap_m_sp_eff);
  active = fmin(active, c.rows * c.cols);

  // ---- energymodel._counts ----
  const double pool_ops = c_ch * ox * oy * kx * ky;
  const double ifmap_dram_reads = ifmap_vol * one;
  const double gb_ifmap_writes = ifmap_dram_reads;
  const double gb_ifmap_reads = ifmap_vol * (acc ? n_m : 1.0);
  const double gb_wt_reads = weights * ky_serial;
  const double inter_rounds = fmax(n_c * ky_serial - 1.0, 0.0);
  const double overflow = fmax(w_psum - c.gb_psum_words, 0.0);
  const double held = fmin(w_psum, c.gb_psum_words * one);
  const double psum_dram_writes = inter_rounds * overflow;
  const double psum_dram_reads = psum_dram_writes;
  const double psum_gb_inter = inter_rounds * held;
  const double gb_psum_writes = psum_gb_inter + ofmap;
  const double gb_psum_reads = psum_gb_inter + ofmap;
  const double dram_reads = ifmap_dram_reads + weights + psum_dram_reads;
  const double dram_writes = ofmap + psum_dram_writes;
  const double words_into_array =
      gb_ifmap_reads + gb_wt_reads + psum_gb_inter + psum_dram_reads;
  const double words_out_of_array = gb_psum_writes + psum_dram_writes;
  const double ops = pool ? pool_ops : macs;
  const double rf_accesses =
      (4.0 * ops) + words_into_array + words_out_of_array;

  // ---- energymodel._count_terms ----
  t[0] = dram_reads;
  t[1] = dram_writes;
  t[2] = gb_ifmap_reads + gb_ifmap_writes;
  t[3] = gb_psum_reads + gb_psum_writes;
  t[4] = gb_wt_reads + weights;
  t[5] = rf_accesses;
  t[6] = pool ? 0.0 : macs;
  t[7] = pool ? pool_ops : 0.0;
  t[8] = (c.rows * c.cols - active) * ops / active;
  t[9] = words_into_array + words_out_of_array;
  t[10] = gb_ifmap_reads + gb_wt_reads;
  t[11] = gb_psum_reads;
  t[12] = words_out_of_array;
  t[13] = ops / active;
}

// Thread (u, j): row u = blockIdx.x * blockDim.x + threadIdx.x, network
// j = blockIdx.y; sums layers [seg_start[j], seg_stop[j]) in order.
__global__ void count_terms_kernel(const double* __restrict__ cfg, int64_t n_u,
                                   const double* __restrict__ lay, int64_t L,
                                   const int64_t* __restrict__ seg_start,
                                   const int64_t* __restrict__ seg_stop,
                                   int64_t n_net, double* __restrict__ out) {
  const int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t j = blockIdx.y;
  if (u >= n_u) return;
  const Cfg c = load_cfg(cfg, n_u, u);
  double s[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) s[k] = 0.0;
  const int64_t a = seg_start[j], b = seg_stop[j];
  for (int64_t l = a; l < b; ++l) {
    double t[kTerms];
    count_terms_at(c, lay, L, l, t);
#pragma unroll
    for (int k = 0; k < kTerms; ++k) s[k] += t[k];
  }
#pragma unroll
  for (int k = 0; k < kTerms; ++k) out[((int64_t)k * n_u + u) * n_net + j] = s[k];
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
  const Cfg c = load_cfg(cfg, n_u, u);
  double t[kTerms];
  count_terms_at(c, lay, L, l, t);
#pragma unroll
  for (int k = 0; k < kTerms; ++k) out[(int64_t)k * plane + i] = t[k];
}

constexpr int kTermsBlock = 128;
constexpr int kLayersBlock = 256;

}  // namespace

extern "C" {

int count_terms_launch(const double* cfg, int64_t n_u, const double* lay,
                       int64_t L, const int64_t* seg_start,
                       const int64_t* seg_stop, int64_t n_net, double* out,
                       void* stream) {
  if (n_u <= 0 || n_net <= 0) return 0;
  dim3 grid((unsigned)((n_u + kTermsBlock - 1) / kTermsBlock), (unsigned)n_net);
  count_terms_kernel<<<grid, kTermsBlock, 0, (cudaStream_t)stream>>>(
      cfg, n_u, lay, L, seg_start, seg_stop, n_net, out);
  return (int)cudaGetLastError();
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
