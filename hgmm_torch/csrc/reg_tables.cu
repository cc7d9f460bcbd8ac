// A registration level's two tables, on the card: wn and aux [K, 12] of a
// mixture (pi, mu, sigma), one launch a level of register_tree.
//
// A new kernel with no TPU counterpart: the reference builds the same terms
// as XLA ops (hgmm/pipelines/register.py:model_terms: precision_terms,
// pack_loglik_weights, sym_pack). Plain twin: hgmm_torch/ops/em_ref.py:
// model_terms, then em_ref.pack_table of W and the cat of [mu | A6 | b3]
// (what ops.reg_problem builds from W, mu, A6, b3 on the card).
//
// One thread a component, a grid-stride loop. The arithmetic is
// gaussians.precision_terms', in float64 as em_step.cu's (which writes the
// same wn rows for a fit's next sweep), rounded to float32 on the write:
//   - Sigma = L L^T by the explicit 3 x 3 Cholesky on its lower triangle,
//     each pivot clamped at 1e-30; A = Sigma^-1 = L^-T L^-1; logdet =
//     2 sum log l_ii;
//   - b = A mu, c = mu . b + logdet + 3 log 2pi - 2 log pi, with log pi
//     floored at -1e30 where pi = 0, so a compacted cut's padding rows (pi 0,
//     mu 0, Sigma I) get a bias of -1e30 and stay inert in reg_stats;
//   - wn row j: -1/2 W[:, j] = [-a00/2, -a11/2, -a22/2, -a01, -a02, -a12,
//     b0, b1, b2, -c/2, 0, 0] (W's cross rows carry the factor 2, its linear
//     rows -2 b);
//   - aux row j: [mu | sym_pack(A) | b] = [mu0, mu1, mu2, a00, a11, a22, a01,
//     a02, a12, b0, b1, b2], the layout reg_stats.cu's add_aux reads.
//
// What bounds it: launch latency. It reads 13 floats and writes 24 a
// component (148 bytes: 75.8 KB at K = 512, ~0.02 us at 3.35 TB/s); a
// thread's float64 chain (three square roots, three divisions, four
// logarithms) is a few microseconds. It replaces ~157 small torch launches a
// level (precision_terms twice, sym_pack twice, pack_table and a cat), whose
// host time kept the card idle between a level's cut and its scan.
#include "hgmm_kernels.cuh"

namespace hgmm {

constexpr int RT_THREADS = 128;
constexpr double RT_LOG_2PI = 1.8378770664093453;

__global__ void __launch_bounds__(RT_THREADS)
reg_tables_kernel(const float* __restrict__ pi, const float* __restrict__ mu,
                  const float* __restrict__ sigma, int k, float* __restrict__ wn,
                  float* __restrict__ aux) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < k; j += gridDim.x * blockDim.x) {
    const float* s = sigma + 9 * (size_t)j;
    const double m0 = mu[3 * j], m1 = mu[3 * j + 1], m2 = mu[3 * j + 2];
    const double p = pi[j];
    const double tiny = 1e-30;
    const double l11 = sqrt(fmax((double)s[0], tiny));
    const double l21 = s[3] / l11, l31 = s[6] / l11;
    const double l22 = sqrt(fmax(s[4] - l21 * l21, tiny));
    const double l32 = (s[7] - l21 * l31) / l22;
    const double l33 = sqrt(fmax(s[8] - l31 * l31 - l32 * l32, tiny));
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
    const double log_pi = p > 0.0 ? log(fmax(p, 1e-38)) : -1e30;
    const double b0 = i00 * m0 + i01 * m1 + i02 * m2;
    const double b1 = i01 * m0 + i11 * m1 + i12 * m2;
    const double b2 = i02 * m0 + i12 * m1 + i22 * m2;
    const double c = m0 * b0 + m1 * b1 + m2 * b2 + logdet + 3.0 * RT_LOG_2PI - 2.0 * log_pi;
    float4* w = reinterpret_cast<float4*>(wn + (size_t)j * 12);
    w[0] = make_float4((float)(-0.5 * i00), (float)(-0.5 * i11), (float)(-0.5 * i22), (float)(-i01));
    w[1] = make_float4((float)(-i02), (float)(-i12), (float)b0, (float)b1);
    w[2] = make_float4((float)b2, (float)(-0.5 * c), 0.0f, 0.0f);
    float4* a = reinterpret_cast<float4*>(aux + (size_t)j * 12);
    a[0] = make_float4((float)m0, (float)m1, (float)m2, (float)i00);
    a[1] = make_float4((float)i11, (float)i22, (float)i01, (float)i02);
    a[2] = make_float4((float)i12, (float)b0, (float)b1, (float)b2);
  }
}

}  // namespace hgmm

extern "C" {

// wn and aux [K, 12] (16-byte aligned: a row is three float4) of the mixture
// pi [K], mu [K, 3], sigma [K, 3, 3] (float32, contiguous, on the card), on
// `stream`. Returns the CUDA error code of the launch.
int hgmm_reg_tables(const void* pi, const void* mu, const void* sigma, int k, void* wn, void* aux,
                    void* stream) {
  if (k < 1 || reinterpret_cast<size_t>(wn) % 16 != 0 || reinterpret_cast<size_t>(aux) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (k + hgmm::RT_THREADS - 1) / hgmm::RT_THREADS;
  hgmm::reg_tables_kernel<<<blocks, hgmm::RT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pi), static_cast<const float*>(mu), static_cast<const float*>(sigma), k,
      static_cast<float*>(wn), static_cast<float*>(aux));
  return (int)cudaGetLastError();
}

}  // extern "C"
