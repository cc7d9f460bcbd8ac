// One M-step of an EM sweep, on the card: the cross-block sum of an
// em_stats body's partial rows and the M-step, one launch after the body.
//
// A new kernel with no TPU counterpart: the reference runs the same
// arithmetic as XLA ops inside its lax.scan bodies (hgmm/models/gmm.py:121
// step, hgmm/models/gmm_tree.py:120 em_step: gaussians.mstep_update, then
// pack_loglik_weights for the next sweep). Plain twin:
// hgmm_torch/ops/em_ref.py:em_step on em_ref.EmPartials (sum_partials, then
// the torch code of ops/gaussians.py: mstep_update, pack_loglik_weights, and
// em_ref.pack_table).
//
// It reads the body's partial rows, not S, so a fit's sweep is two kernels:
//   - the plain rows [nb, K*10 + 1] of em_stats_kernel and
//     em_stats_tiled_kernel: component j sums columns 10 j .. 10 j + 9 of
//     every row;
//   - the grouped rows [n_chunks, branch*10 + 1] of em_stats_grouped_kernel:
//     component j of parent p = j / branch sums columns (j - p branch) * 10
//     .. + 9 of its parent's rows parent_off[p] .. parent_off[p + 1] - 1;
//   - the loglik: the last column of every row.
// Block j < K takes component j: lane l < 30 of warp w sums feature l % 10 of
// the rows r0 + 3 w + l / 10 + 3 W i (W warps, ops/fused_em.py:plan_em_step)
// on four float64 accumulators, twelve loads in flight (row u of a batch on
// accumulator u mod 4), so a warp reads three rows' 40 contiguous bytes at
// once; the slots are added through shared memory in a fixed order (each of
// the three row positions over the warps in order, then the three), and S is
// rounded to float32, as em_stats' reduce writes it for its public calls and
// as the twin casts it. total and cov_floor are read while the rows come in. Block K sums the loglik column (a lane a row, the lanes
// by a fixed butterfly, the warps in order) and writes the floor rows.
// Warp 0 of block j then runs the M-step in float64:
//   - the M-step of gaussians.mstep_update: empty when T0 <= max(1e-6 total,
//     MIN_WEIGHT) (pi = 0, mu = 0, Sigma = I); pi = T0 / total, mu = T1 / T0,
//     Sigma = T2 / T0 - mu mu^T (its diagonal for "diag", its mean eigenvalue
//     for "iso") + cov_reg I; then psd_floor at max(cov_floor, cov_reg, 1e-9)
//     through the trigonometric sym3_eigvalsh, less its 2e-4 norm_bound
//     allowance;
//   - precision_terms: the explicit 3 x 3 Cholesky inverse and logdet, log pi
//     floored at -1e30 for pi = 0;
//   - the outputs: pi, mu and Sigma into the fit's parameter buffers, the next
//     sweep's packed weight table [rows, 12] (row j < K: -1/2 W[:, j] and two
//     zero columns; rows K.. floor rows) and the sweep's loglik into
//     logliks[it].
// The chain is spread over lanes where it does not depend on itself: lane f
// divides feature f by T0 (nine divisions at once), lanes 0-3 take the four
// logarithms (log l11, l22, l33, log pi) at once; the rest (the arccosine and
// cosine of sym3_eigvalsh, the Cholesky factor) is one dependent chain.
// T2 / T0 - mu mu^T cancels: at 40 m the terms are ~1,600 m^2 for a 4e-4 m^2
// variance, so float64 arithmetic is kept inside (the statistics come in
// float32 all the same).
//
// total and cov_floor are device scalars (float32), read here and never on
// the host, so a fit's sweeps make no host read.
//
// What bounds it: latency. It reads the partial rows (nb (10 K + 1) floats,
// 21 KB at K = 8 and 528 rows) and writes 25 K + 1 floats; a component's chain
// (a square root, an arccosine and a cosine, three more square roots, a
// logarithm, in float64) is a few microseconds, against the separate reduce
// launch and the ~200 small torch launches of a sweep's M-step it replaces.
#include "hgmm_kernels.cuh"

namespace hgmm {

constexpr int EMS_MAX_WARPS = 16;  // a component's warps, at most (ops/fused_em.py:EMS_MAX_WARPS)
constexpr int EMS_UNROLL = 12;     // rows a lane has in flight (ops/fused_em.py:EMS_ROWS_A_LANE)
constexpr double LOG_2PI_D = 1.8378770664093453;
constexpr double MIN_WEIGHT = 1e-6;  // gaussians.mstep_update's default, which every fit uses

// Ascending smallest eigenvalue of the symmetric [[a, b, c], [b, d, e],
// [c, e, f]] by gaussians.sym3_eigvalsh's trigonometric method.
__device__ double sym3_lmin(double a0, double d0, double f0, double b, double c, double e) {
  const double q = (a0 + d0 + f0) / 3.0;
  const double a = a0 - q, d = d0 - q, f = f0 - q;
  const double p2 = a * a + d * d + f * f + 2.0 * (b * b + c * c + e * e);
  const double p = sqrt(fmax(p2, 0.0) / 6.0);
  const double sp = fmax(p, 1e-30);
  const double an = a / sp, dn = d / sp, fn = f / sp, bn = b / sp, cn = c / sp, en = e / sp;
  const double det = an * (dn * fn - en * en) - bn * (bn * fn - en * cn) + cn * (bn * en - dn * cn);
  const double r = fmin(fmax(0.5 * det, -1.0), 1.0);
  const double phi = acos(r) / 3.0;
  return q + 2.0 * p * cos(phi + 2.0943951023931953);
}

__global__ void __launch_bounds__(EMS_MAX_WARPS * 32)
    em_step_kernel(const float* __restrict__ partial, int n_rows, int width,
                   const int* __restrict__ parent_off, int branch, const float* __restrict__ total_p,
                   const float* __restrict__ cov_floor_p, int k, int rows, double cov_reg, int cov_type,
                   float* __restrict__ pi_out, float* __restrict__ mu_out, float* __restrict__ sigma_out,
                   float* __restrict__ wn, float* __restrict__ logliks, int it) {
  __shared__ double slot_s[EMS_MAX_WARPS * 3][10];
  const int j = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5, nw = blockDim.x >> 5;
  if (j == k) {  // the loglik, every row's last column, and the floor rows
    double a = 0.0;
    for (int r = t; r < n_rows; r += blockDim.x) a += __ldg(partial + (size_t)r * width + width - 1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(FULL_MASK, a, off);
    if (lane == 0) slot_s[warp][0] = a;
    for (int idx = t; idx < (rows - k) * 12; idx += blockDim.x)
      wn[(size_t)k * 12 + idx] = idx % 12 == 9 ? NEG_INF : 0.0f;
    __syncthreads();
    if (t == 0) {
      double s = 0.0;
      for (int w = 0; w < nw; ++w) s += slot_s[w][0];
      logliks[it] = (float)s;
    }
    return;
  }
  const float total_f = *total_p, cov_floor_f = *cov_floor_p;  // read while the rows come in
  int r0 = 0, r1 = n_rows, col = 10 * j;
  if (branch > 0) {
    const int p = j / branch;
    r0 = parent_off[p];
    r1 = parent_off[p + 1];
    col = (j - p * branch) * 10;
  }
  if (lane < 30) {
    const int g = 3 * warp + lane / 10, gs = 3 * nw;  // row slot g of gs
    const float* src = partial + col + lane % 10;
    double a[4] = {0.0, 0.0, 0.0, 0.0};
    for (int r = r0 + g; r < r1; r += EMS_UNROLL * gs) {  // rows past r1 load as zeros
      float v[EMS_UNROLL];
#pragma unroll
      for (int u = 0; u < EMS_UNROLL; ++u) v[u] = r + u * gs < r1 ? __ldg(src + (size_t)(r + u * gs) * width) : 0.0f;
#pragma unroll
      for (int u = 0; u < EMS_UNROLL; ++u) a[u & 3] += v[u];
    }
    slot_s[g][lane % 10] = (a[0] + a[1]) + (a[2] + a[3]);
  }
  __syncthreads();
  if (warp != 0) return;
  // Lane l < 30 adds slot l / 10 of every warp in warp order; lane f < 10
  // then the three: S[j, f] = (s_f + s_f+10) + s_f+20.
  double part = 0.0;
  if (lane < 30)
    for (int w = 0; w < nw; ++w) part += slot_s[3 * w + lane / 10][lane % 10];
  const double p1 = __shfl_down_sync(FULL_MASK, part, 10), p2 = __shfl_down_sync(FULL_MASK, part, 20);
  const double Sf = lane < 10 ? (double)(float)((part + p1) + p2) : 0.0;  // lane f < 10: S[j, f] in float32

  const double total = total_f;
  const double floor = fmax(1e-6 * total, MIN_WEIGHT);
  const double T0 = __shfl_sync(FULL_MASK, Sf, 9);
  const bool empty = T0 <= floor;
  const double safe = fmax(T0, floor);
  const double q = Sf / safe;  // lane f < 9: S[j, f] / T0
  double pi = empty ? 0.0 : T0 / total;
  double mu[3];
  for (int i = 0; i < 3; ++i) mu[i] = empty ? 0.0 : __shfl_sync(FULL_MASK, q, 6 + i);
  // Sigma as [xx, yy, zz, xy, xz, yz] (sym_pack's order, S's columns 0..5).
  double sg[6];
  sg[0] = __shfl_sync(FULL_MASK, q, 0) - mu[0] * mu[0];
  sg[1] = __shfl_sync(FULL_MASK, q, 1) - mu[1] * mu[1];
  sg[2] = __shfl_sync(FULL_MASK, q, 2) - mu[2] * mu[2];
  sg[3] = __shfl_sync(FULL_MASK, q, 3) - mu[0] * mu[1];
  sg[4] = __shfl_sync(FULL_MASK, q, 4) - mu[0] * mu[2];
  sg[5] = __shfl_sync(FULL_MASK, q, 5) - mu[1] * mu[2];
  if (cov_type == 1) {  // iso
    const double var = (sg[0] + sg[1] + sg[2]) / 3.0;
    sg[0] = sg[1] = sg[2] = var;
  }
  if (cov_type != 0) sg[3] = sg[4] = sg[5] = 0.0;  // iso and diag
  for (int i = 0; i < 3; ++i) sg[i] += cov_reg;
  if (empty) {
    sg[0] = sg[1] = sg[2] = 1.0;
    sg[3] = sg[4] = sg[5] = 0.0;
  }
  // psd_floor: the smallest eigenvalue less the allowance for its error,
  // raised to the floor by adding the deficit times I.
  const double floor_eig = fmax((double)cov_floor_f, fmax(cov_reg, 1e-9));
  const double norm_bound = fabs(sg[0] + sg[1] + sg[2]) +
      sqrt(fmax(sg[0] * sg[0] + sg[1] * sg[1] + sg[2] * sg[2] +
                2.0 * (sg[3] * sg[3] + sg[4] * sg[4] + sg[5] * sg[5]), 0.0));
  const double lmin = sym3_lmin(sg[0], sg[1], sg[2], sg[3], sg[4], sg[5]) - 2e-4 * norm_bound;
  const double bump = fmax(floor_eig - lmin, 0.0);
  for (int i = 0; i < 3; ++i) sg[i] += bump;

  // precision_terms: Sigma = L L^T, Sigma^-1 = L^-T L^-1, logdet = 2 sum log l_ii.
  const double tiny = 1e-30;
  const double l11 = sqrt(fmax(sg[0], tiny));
  const double l21 = sg[3] / l11, l31 = sg[4] / l11;
  const double l22 = sqrt(fmax(sg[1] - l21 * l21, tiny));
  const double l32 = (sg[5] - l21 * l31) / l22;
  const double l33 = sqrt(fmax(sg[2] - l31 * l31 - l32 * l32, tiny));
  // The four logarithms at once: lanes 0-2 log l_ii, lane 3 log pi.
  const double lg = log(lane == 0 ? l11 : lane == 1 ? l22 : lane == 2 ? l33 : fmax(pi, 1e-38));
  const double m11 = 1.0 / l11, m22 = 1.0 / l22, m33 = 1.0 / l33;
  const double m21 = -l21 * m11 * m22;
  const double m31 = (l21 * l32 - l31 * l22) * m11 * m22 * m33;
  const double m32 = -l32 * m22 * m33;
  const double i00 = m11 * m11 + m21 * m21 + m31 * m31;
  const double i01 = m21 * m22 + m31 * m32;
  const double i02 = m31 * m33;
  const double i11 = m22 * m22 + m32 * m32;
  const double i12 = m32 * m33;
  const double i22 = m33 * m33;
  const double logdet = 2.0 * (__shfl_sync(FULL_MASK, lg, 0) + __shfl_sync(FULL_MASK, lg, 1) +
                               __shfl_sync(FULL_MASK, lg, 2));
  const double log_pi = pi > 0.0 ? __shfl_sync(FULL_MASK, lg, 3) : -1e30;
  if (lane != 0) return;
  pi_out[j] = (float)pi;
  for (int i = 0; i < 3; ++i) mu_out[3 * j + i] = (float)mu[i];
  float* sj = sigma_out + 9 * (size_t)j;  // [3, 3] row-major from the packed six
  sj[0] = (float)sg[0];
  sj[1] = sj[3] = (float)sg[3];
  sj[2] = sj[6] = (float)sg[4];
  sj[4] = (float)sg[1];
  sj[5] = sj[7] = (float)sg[5];
  sj[8] = (float)sg[2];
  const double b0 = i00 * mu[0] + i01 * mu[1] + i02 * mu[2];
  const double b1 = i01 * mu[0] + i11 * mu[1] + i12 * mu[2];
  const double b2 = i02 * mu[0] + i12 * mu[1] + i22 * mu[2];
  const double c = mu[0] * b0 + mu[1] * b1 + mu[2] * b2 + logdet + 3.0 * LOG_2PI_D - 2.0 * log_pi;
  // -1/2 W[:, j]: W's cross rows carry the factor 2, its linear rows -2 b.
  float4* row = reinterpret_cast<float4*>(wn + (size_t)j * 12);
  row[0] = make_float4((float)(-0.5 * i00), (float)(-0.5 * i11), (float)(-0.5 * i22), (float)(-i01));
  row[1] = make_float4((float)(-i02), (float)(-i12), (float)b0, (float)b1);
  row[2] = make_float4((float)b2, (float)(-0.5 * c), 0.0f, 0.0f);
}

}  // namespace hgmm

extern "C" {

// The sum of an em_stats body's partial rows and the M-step of em_ref.em_step
// into pi [K], mu [K, 3], sigma [K, 3, 3], the packed table wn [rows, 12]
// (rows >= K) and logliks[it]. branch 0: the plain rows, partial [n_rows,
// K*10 + 1]; branch > 0: the grouped rows, partial [n_rows, branch*10 + 1]
// with parent_off [ceil(K / branch) + 1] (each parent's first row, then
// n_rows); wn 16-byte aligned (a row is three float4). total and cov_floor
// are float32 scalars on the card; cov_type 0 full, 1 iso, 2 diag; warps: a
// component's warps (1..EMS_MAX_WARPS, ops/fused_em.py:plan_em_step).
// Returns the CUDA error code of the launch.
int hgmm_em_step(const void* partial, int n_rows, const void* parent_off, int branch,
                 const void* total, const void* cov_floor, int k, int rows, double cov_reg, int cov_type,
                 void* pi, void* mu, void* sigma, void* wn, void* logliks, int it, int warps,
                 void* stream) {
  if (k < 1 || rows < k || n_rows < 0 || branch < 0 || (branch > 0 && parent_off == nullptr) ||
      cov_type < 0 || cov_type > 2 || it < 0 || warps < 1 || warps > hgmm::EMS_MAX_WARPS ||
      reinterpret_cast<size_t>(wn) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int width = (branch > 0 ? branch : k) * 10 + 1;
  hgmm::em_step_kernel<<<k + 1, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), n_rows, width, static_cast<const int*>(parent_off), branch,
      static_cast<const float*>(total), static_cast<const float*>(cov_floor), k, rows, cov_reg, cov_type,
      static_cast<float*>(pi), static_cast<float*>(mu), static_cast<float*>(sigma),
      static_cast<float*>(wn), static_cast<float*>(logliks), it);
  return (int)cudaGetLastError();
}

}  // extern "C"
