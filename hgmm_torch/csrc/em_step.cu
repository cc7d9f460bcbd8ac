// One M-step of an EM sweep, on the card: em_stats' finishing pass.
//
// A new kernel with no TPU counterpart: the reference runs the same
// arithmetic as XLA ops inside its lax.scan bodies (hgmm/models/gmm.py:121
// step, hgmm/models/gmm_tree.py:120 em_step: gaussians.mstep_update, then
// pack_loglik_weights for the next sweep). Plain twin:
// hgmm_torch/ops/em_ref.py:em_step, which calls the torch code of
// ops/gaussians.py (mstep_update, pack_loglik_weights) and em_ref.pack_table.
//
// One launch after the reduce of any em_stats body. One thread a component,
// in float64 from the float32 statistics S [K, 10] (T2 | T1 | T0):
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
// T2 / T0 - mu mu^T cancels: at 40 m the terms are ~1,600 m^2 for a 4e-4 m^2
// variance, so float64 arithmetic is kept inside (the statistics come in
// float32 all the same).
//
// total and cov_floor are device scalars (float32), read here and never on
// the host, so a fit's sweeps make no host read.
//
// What bounds it: latency. It reads K*10 + 1 floats and writes 25 K + 1;
// a thread's chain (a square root, an arccosine and two cosines, three more
// square roots, four logarithms, in float64) is a few microseconds, against
// the ~200 small torch launches of a sweep's M-step that it replaces.
#include "hgmm_kernels.cuh"

namespace hgmm {

constexpr int EMS_THREADS = 128;
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

__global__ void __launch_bounds__(EMS_THREADS)
    em_step_kernel(const float* __restrict__ S, const float* __restrict__ loglik,
                   const float* __restrict__ total_p, const float* __restrict__ cov_floor_p, int k,
                   int rows, double cov_reg, int cov_type, float* __restrict__ pi_out,
                   float* __restrict__ mu_out, float* __restrict__ sigma_out, float* __restrict__ wn,
                   float* __restrict__ logliks, int it) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j == 0) logliks[it] = *loglik;
  if (j >= rows) return;
  float* row = wn + (size_t)j * 12;
  if (j >= k) {  // a floor row: zero weights, the bias at the mask floor
    for (int f = 0; f < 12; ++f) row[f] = f == 9 ? NEG_INF : 0.0f;
    return;
  }
  const float* sj = S + (size_t)j * 10;
  const double total = *total_p;
  const double floor = fmax(1e-6 * total, MIN_WEIGHT);
  const double T0 = sj[9];
  const bool empty = T0 <= floor;
  const double safe = fmax(T0, floor);
  double pi = empty ? 0.0 : T0 / total;
  double mu[3];
  for (int i = 0; i < 3; ++i) mu[i] = empty ? 0.0 : sj[6 + i] / safe;
  // Sigma as [xx, yy, zz, xy, xz, yz] (sym_pack's order, S's columns 0..5).
  double sg[6];
  sg[0] = sj[0] / safe - mu[0] * mu[0];
  sg[1] = sj[1] / safe - mu[1] * mu[1];
  sg[2] = sj[2] / safe - mu[2] * mu[2];
  sg[3] = sj[3] / safe - mu[0] * mu[1];
  sg[4] = sj[4] / safe - mu[0] * mu[2];
  sg[5] = sj[5] / safe - mu[1] * mu[2];
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
  const double floor_eig = fmax((double)*cov_floor_p, fmax(cov_reg, 1e-9));
  const double norm_bound = fabs(sg[0] + sg[1] + sg[2]) +
      sqrt(fmax(sg[0] * sg[0] + sg[1] * sg[1] + sg[2] * sg[2] +
                2.0 * (sg[3] * sg[3] + sg[4] * sg[4] + sg[5] * sg[5]), 0.0));
  const double lmin = sym3_lmin(sg[0], sg[1], sg[2], sg[3], sg[4], sg[5]) - 2e-4 * norm_bound;
  const double bump = fmax(floor_eig - lmin, 0.0);
  for (int i = 0; i < 3; ++i) sg[i] += bump;

  pi_out[j] = (float)pi;
  for (int i = 0; i < 3; ++i) mu_out[3 * j + i] = (float)mu[i];
  const int at[9] = {0, 3, 4, 3, 1, 5, 4, 5, 2};  // [3, 3] row-major from the packed six
  for (int i = 0; i < 9; ++i) sigma_out[9 * (size_t)j + i] = (float)sg[at[i]];

  // precision_terms: Sigma = L L^T, Sigma^-1 = L^-T L^-1, logdet = 2 sum log l_ii.
  const double tiny = 1e-30;
  const double l11 = sqrt(fmax(sg[0], tiny));
  const double l21 = sg[3] / l11, l31 = sg[4] / l11;
  const double l22 = sqrt(fmax(sg[1] - l21 * l21, tiny));
  const double l32 = (sg[5] - l21 * l31) / l22;
  const double l33 = sqrt(fmax(sg[2] - l31 * l31 - l32 * l32, tiny));
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
  const double logdet = 2.0 * (log(l11) + log(l22) + log(l33));
  const double b0 = i00 * mu[0] + i01 * mu[1] + i02 * mu[2];
  const double b1 = i01 * mu[0] + i11 * mu[1] + i12 * mu[2];
  const double b2 = i02 * mu[0] + i12 * mu[1] + i22 * mu[2];
  const double log_pi = pi > 0.0 ? log(fmax(pi, 1e-38)) : -1e30;
  const double c = mu[0] * b0 + mu[1] * b1 + mu[2] * b2 + logdet + 3.0 * LOG_2PI_D - 2.0 * log_pi;
  // -1/2 W[:, j]: W's cross rows carry the factor 2, its linear rows -2 b.
  const float out[12] = {(float)(-0.5 * i00), (float)(-0.5 * i11), (float)(-0.5 * i22), (float)(-i01),
                         (float)(-i02), (float)(-i12), (float)b0, (float)b1, (float)b2,
                         (float)(-0.5 * c), 0.0f, 0.0f};
  for (int f = 0; f < 12; ++f) row[f] = out[f];
}

}  // namespace hgmm

extern "C" {

// The M-step of em_ref.em_step from S [K, 10] and the loglik (the reduced
// output of an em_stats call) into pi [K], mu [K, 3], sigma [K, 3, 3], the
// packed table wn [rows, 12] (rows >= K) and logliks[it]; total and
// cov_floor are float32 scalars on the card; cov_type 0 full, 1 iso, 2 diag.
// Returns the CUDA error code of the launch.
int hgmm_em_step(const void* S, const void* loglik, const void* total, const void* cov_floor, int k,
                 int rows, double cov_reg, int cov_type, void* pi, void* mu,
                 void* sigma, void* wn, void* logliks, int it, void* stream) {
  if (k < 1 || rows < k || cov_type < 0 || cov_type > 2 || it < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + hgmm::EMS_THREADS - 1) / hgmm::EMS_THREADS;
  hgmm::em_step_kernel<<<blocks, hgmm::EMS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<const float*>(loglik), static_cast<const float*>(total),
      static_cast<const float*>(cov_floor), k, rows, cov_reg, cov_type,
      static_cast<float*>(pi), static_cast<float*>(mu), static_cast<float*>(sigma),
      static_cast<float*>(wn), static_cast<float*>(logliks), it);
  return (int)cudaGetLastError();
}

}  // extern "C"
