// Shared device helpers of the hgmm_torch kernels (sm_90a, float32).
//
// Layouts, fixed by the Python wrappers in hgmm_torch/ops/fused_em.py:
//   pts4   [4, N] f32, rows x, y, z, w (point weight, 0 for padding)
//   wn     [rows, 12] f32, row j < K = -1/2 * W[:, j] (the natural-log
//          logit weights of gaussians.pack_loglik_weights) plus two zero
//          columns, so the logit of component j is  l_j = wn_j . psi(y);
//          rows K.. (the tiled em_stats' padding) are floor rows: zero
//          weights, bias NEG_INF (em_ref.pack_table; em_step.cu writes it)
//   parent [N] int32 (masked kernels), -1 or out of range = no component
//
// Every kernel computes the softmax of em_ref._soft with an exact per-point
// max (no global shift): m = max(l_j, outlier), m_safe = max(m, NEG_INF),
// e_j = exp2(l_j log2e - m_safe log2e), s = sum e_j (+ outlier term),
// gamma_j = w e_j / max(s, 1e-38), lse = w (m_safe + log max(s, 1e-38)),
// and a point with m <= NEG_INF (every visible logit at the mask floor) is
// dead: gamma = 0 and lse = 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace hgmm {

constexpr float NEG_INF = -1e30f;  // em_ref.NEG_INF, the mask floor
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL_MASK = 0xffffffffu;  // every lane of a warp

// The registration scan's state, float32 [SCAN_FLOATS] on the card
// (ops/em_ref.py:SCAN_*): the pose reg_stats reads (R row-major, t), the
// pose at the start of the iteration, the loglik of the iteration's first
// statistics, the last live loglik and delta, the done flag (0 or 1), and
// the steps reg_step ran with done unset.
constexpr int SCAN_POSE = 0;
constexpr int SCAN_START = 12;
constexpr int SCAN_LL = 24;
constexpr int SCAN_LL_LAST = 25;
constexpr int SCAN_D_LAST = 26;
constexpr int SCAN_DONE = 27;
constexpr int SCAN_LIVE = 28;
constexpr int SCAN_FLOATS = 32;

struct Psi {
  float v[10];  // [x^2, y^2, z^2, xy, xz, yz, x, y, z, 1]
};

__device__ __forceinline__ Psi features(float x, float y, float z) {
  Psi p;
  p.v[0] = x * x;
  p.v[1] = y * y;
  p.v[2] = z * z;
  p.v[3] = x * y;
  p.v[4] = x * z;
  p.v[5] = y * z;
  p.v[6] = x;
  p.v[7] = y;
  p.v[8] = z;
  p.v[9] = 1.0f;
  return p;
}

// l_j = wn_j . psi from row j of wn as three float4 (a, b, c). Every kernel
// evaluates a logit in this order, so equal inputs give equal bits.
__device__ __forceinline__ float logit3(const float4 a, const float4 b, const float4 c, const Psi& p) {
  float l = a.x * p.v[0];
  l = fmaf(a.y, p.v[1], l);
  l = fmaf(a.z, p.v[2], l);
  l = fmaf(a.w, p.v[3], l);
  l = fmaf(b.x, p.v[4], l);
  l = fmaf(b.y, p.v[5], l);
  l = fmaf(b.z, p.v[6], l);
  l = fmaf(b.w, p.v[7], l);
  l = fmaf(c.x, p.v[8], l);
  l = c.y + l;  // psi[9] == 1
  return l;
}

// The same with the row in shared memory (every thread of a warp reading the
// same row is a broadcast).
__device__ __forceinline__ float logit(const float4* __restrict__ w, const Psi& p) {
  return logit3(w[0], w[1], w[2], p);
}

// The component range a point sees: all K, or its parent's child block.
__device__ __forceinline__ void visible_range(const int* __restrict__ parent, int i, int k,
                                              int branch, int* j0, int* j1) {
  if (parent == nullptr) {
    *j0 = 0;
    *j1 = k;
    return;
  }
  const int p = parent[i];
  if (p < 0 || (long long)p * branch >= k) {
    *j0 = *j1 = 0;
    return;
  }
  *j0 = p * branch;
  *j1 = min(*j0 + branch, k);
}

// Scale and log-evidence of a point from its max m and its Gaussian sum s
// (each term exp2(l_j log2e - m2)). gamma_j = scale * e_j.
struct Soft {
  float scale;
  float lse;
};

__device__ __forceinline__ Soft finish_soft(float m, float m2, float s, bool has_outlier,
                                            float outlier, float w) {
  if (has_outlier) s += exp2f(fmaf(outlier, LOG2E, -m2));
  Soft r;
  if (!(m > NEG_INF)) {  // dead point
    r.scale = 0.0f;
    r.lse = 0.0f;
    return r;
  }
  const float ss = fmaxf(s, 1e-38f);
  r.scale = w / ss;
  r.lse = w * (fmaxf(m, NEG_INF) + logf(ss));
  return r;
}

// Asynchronous 4-byte copy from device to shared memory (cp.async): the copy
// is in flight while the thread goes on; cp_async_wait_all() waits for this
// thread's copies, and a barrier then makes them visible to the block.
__device__ __forceinline__ void cp_async_f32(float* smem_dst, const float* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sum `m` per-block partials [nb, m] over blocks in a fixed order
// (float64 accumulation), so the result does not depend on scheduling.
cudaError_t launch_reduce_partials(const float* partial, int nb, int m, float* out,
                                   cudaStream_t stream);

// One registration step (csrc/reg_step.cu, hgmm_reg_step's arguments) on
// `stream`; hgmm_reg_scan (csrc/reg_stats.cu) launches a scan's steps
// through it.
cudaError_t launch_reg_step(const float* partial, int nb, float* scan, float* logliks, float* deltas, int it,
                            int solver, int first, int last, double tol, int blocks, cudaStream_t stream);

}  // namespace hgmm
