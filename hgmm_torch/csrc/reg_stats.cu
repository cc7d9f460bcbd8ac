// Registration E-step statistics with the pose applied in the kernel.
//
// Replaces the TPU kernel hgmm/ops/fused_em.py:_reg_stats_kernel. Plain twin:
// hgmm_torch/ops/em_ref.py:reg_stats.
//
// Per point: y = R x + t, psi(y), the exact two-pass softmax over K with the
// optional outlier, and in the second pass the unnormalized contraction
// red = sum_j e_j [mu_j | A6_j | b3_j] (12 values). With gamma = scale * e:
//   nu = gamma mu, M = sym(gamma A6), u = gamma b3, w_eff = sum_j gamma_j,
//   horn += [x, 1]^T [nu, w_eff]                      (16, x untransformed)
//   r = M y - u, J = [-[y]_x | I], A += J^T M J (21), b -= J^T r (6)
//   loglik += w lse.
// Each thread keeps its 44 sums in registers over its grid-stride points;
// the block reduces them by warp butterflies and then over warps in order,
// and writes a [59] partial (horn 16, A 36 filled symmetric, b 6, loglik);
// reduce_partials sums the blocks in a fixed order in float64.
//
// top_k gating (em_ref.top_k_mask_logits): pass 1 also keeps the KMAX
// largest logits, with multiplicity, in a register array sorted by an
// unrolled compare-exchange insertion (a fixed-size array, so nothing spills
// to local memory); the threshold is the top_k-th of them. Pass 2 skips every
// component whose logit, recomputed by the same logit() call as in pass 1,
// is below it, so ties at the threshold are kept and the outlier term is
// never gated. KMAX is 0 (no gating), 8 or 32; the wrapper refuses top_k > 32.
//
// What bounds it on the card: at K=512 it is arithmetic, 2 logit evaluations
// (10 FMA each) + 1 exp2 + 13 FMA per point and component, reading the
// weights and the [K, 12] aux table from shared memory as broadcast float4
// loads; at K=8 it is the 16 bytes a point from device memory and the launch.
#include "hgmm_kernels.cuh"

namespace hgmm {

constexpr int NACC = 44;   // horn 16 + A upper 21 + b 6 + loglik 1
constexpr int NOUT = 59;   // horn 16 + A 36 + b 6 + loglik 1
constexpr int NWARPS = TILE / 32;

// Pass 1 with gating: the exact max over the K logits and the outlier, and in
// *th the top_k-th largest logit counted with multiplicity (1 <= top_k <= KMAX).
template <int KMAX>
__device__ __forceinline__ float max_logit_top_k(const float4* __restrict__ w4, const Psi& p,
                                                 int k, int top_k, bool has_outlier,
                                                 float outlier, float* th) {
  float top[KMAX];  // descending
#pragma unroll
  for (int c = 0; c < KMAX; ++c) top[c] = -INFINITY;
  for (int j = 0; j < k; ++j) {
    float v = logit(w4 + 3 * j, p);
    if (v > top[KMAX - 1]) {
#pragma unroll
      for (int c = 0; c < KMAX; ++c) {
        const float hi = fmaxf(top[c], v);
        v = fminf(top[c], v);
        top[c] = hi;
      }
    }
  }
  float kth = top[0];
#pragma unroll
  for (int c = 1; c < KMAX; ++c)
    if (c < top_k) kth = top[c];
  *th = kth;
  return has_outlier ? fmaxf(top[0], outlier) : top[0];
}

template <int KMAX>
__global__ void __launch_bounds__(TILE)
    reg_stats_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ pose12,
                     const float* __restrict__ wn, const float* __restrict__ aux, int k,
                     int top_k, int has_outlier, float outlier, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float4* w4 = smem4;          // [k * 3] packed weights
  float4* a4 = w4 + 3 * k;     // [k * 3] aux rows: mu(3) A6(6) b3(3)
  float* red_s = reinterpret_cast<float*>(a4 + 3 * k);  // [NWARPS * NACC]
  const int t = threadIdx.x;
  for (int idx = t; idx < 3 * k; idx += TILE) {
    w4[idx] = reinterpret_cast<const float4*>(wn)[idx];
    a4[idx] = reinterpret_cast<const float4*>(aux)[idx];
  }
  float P[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) P[c] = pose12[c];  // R row-major, then t
  float acc[NACC];
#pragma unroll
  for (int c = 0; c < NACC; ++c) acc[c] = 0.0f;
  __syncthreads();

  for (int i = blockIdx.x * TILE + t; i < n; i += gridDim.x * TILE) {
    const float x0 = pts4[i], x1 = pts4[(size_t)n + i], x2 = pts4[2 * (size_t)n + i];
    const float w = pts4[3 * (size_t)n + i];
    const float y0 = fmaf(P[0], x0, fmaf(P[1], x1, fmaf(P[2], x2, P[9])));
    const float y1 = fmaf(P[3], x0, fmaf(P[4], x1, fmaf(P[5], x2, P[10])));
    const float y2 = fmaf(P[6], x0, fmaf(P[7], x1, fmaf(P[8], x2, P[11])));
    const Psi p = features(y0, y1, y2);
    float th = -INFINITY;
    float m;
    if constexpr (KMAX == 0) {
      m = max_logit(w4, p, 0, k, has_outlier, outlier);
    } else {
      m = max_logit_top_k<KMAX>(w4, p, k, top_k, has_outlier, outlier, &th);
    }
    const float m2 = fmaxf(m, NEG_INF) * LOG2E;
    float s = 0.0f;
    float red[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) red[c] = 0.0f;
    for (int j = 0; j < k; ++j) {
      const float l = logit(w4 + 3 * j, p);
      if constexpr (KMAX > 0) {
        if (l < th) continue;  // gated out: e = 0, as em_ref's NEG_INF gives
      }
      const float e = exp2f(fmaf(l, LOG2E, -m2));
      s += e;
      const float4 a = a4[3 * j], b = a4[3 * j + 1], c = a4[3 * j + 2];
      red[0] = fmaf(e, a.x, red[0]);
      red[1] = fmaf(e, a.y, red[1]);
      red[2] = fmaf(e, a.z, red[2]);
      red[3] = fmaf(e, a.w, red[3]);
      red[4] = fmaf(e, b.x, red[4]);
      red[5] = fmaf(e, b.y, red[5]);
      red[6] = fmaf(e, b.z, red[6]);
      red[7] = fmaf(e, b.w, red[7]);
      red[8] = fmaf(e, c.x, red[8]);
      red[9] = fmaf(e, c.y, red[9]);
      red[10] = fmaf(e, c.z, red[10]);
      red[11] = fmaf(e, c.w, red[11]);
    }
    const Soft r = finish_soft(m, m2, s, has_outlier, outlier, w);
    acc[NACC - 1] += r.lse;
    if (r.scale == 0.0f) continue;  // dead or zero-weight: no statistics
    const float sc = r.scale;
    const float nu0 = red[0] * sc, nu1 = red[1] * sc, nu2 = red[2] * sc;
    const float m00 = red[3] * sc, m11 = red[4] * sc, m22 = red[5] * sc;
    const float m01 = red[6] * sc, m02 = red[7] * sc, m12 = red[8] * sc;
    const float u0 = red[9] * sc, u1 = red[10] * sc, u2 = red[11] * sc;
    const float weff = s * sc;  // Gaussian mass only; the outlier is excluded

    // Horn moments P^T Q with P = [x, 1], Q = [nu, w_eff].
    const float Pv[4] = {x0, x1, x2, 1.0f};
    const float Qv[4] = {nu0, nu1, nu2, weff};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[4 * a + b] = fmaf(Pv[a], Qv[b], acc[4 * a + b]);

    // Mahalanobis Gauss-Newton: r = M y - u, J = [-[y]_x | I].
    const float r0 = m00 * y0 + m01 * y1 + m02 * y2 - u0;
    const float r1 = m01 * y0 + m11 * y1 + m12 * y2 - u1;
    const float r2 = m02 * y0 + m12 * y1 + m22 * y2 - u2;
    const float J[3][6] = {{0.0f, y2, -y1, 1.0f, 0.0f, 0.0f},
                           {-y2, 0.0f, y0, 0.0f, 1.0f, 0.0f},
                           {y1, -y0, 0.0f, 0.0f, 0.0f, 1.0f}};
    const float M[3][3] = {{m00, m01, m02}, {m01, m11, m12}, {m02, m12, m22}};
    float MJ[3][6];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int c = 0; c < 6; ++c) MJ[a][c] = M[a][0] * J[0][c] + M[a][1] * J[1][c] + M[a][2] * J[2][c];
    int q = 16;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int c = a; c < 6; ++c, ++q)
        acc[q] += J[0][a] * MJ[0][c] + J[1][a] * MJ[1][c] + J[2][a] * MJ[2][c];
    const float rr[3] = {r0, r1, r2};
#pragma unroll
    for (int a = 0; a < 6; ++a)
      acc[37 + a] -= J[0][a] * rr[0] + J[1][a] * rr[1] + J[2][a] * rr[2];
  }

  // Block reduction in a fixed order: warp butterflies, then warps in order.
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int c = 0; c < NACC; ++c) {
    float v = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red_s[warp * NACC + c] = v;
  }
  __syncthreads();
  if (t < NACC) {
    float v = 0.0f;
    for (int ww = 0; ww < NWARPS; ++ww) v += red_s[ww * NACC + t];
    red_s[t] = v;  // each t < NACC reads only column t above, then writes row 0
  }
  __syncthreads();
  if (t < NOUT) {
    // Output slot t -> accumulator: horn 0..15, A 16..51 (6x6 row-major,
    // from the upper triangle), b 52..57, loglik 58.
    int src;
    if (t < 16) {
      src = t;
    } else if (t < 52) {
      int a = (t - 16) / 6, c = (t - 16) % 6;
      if (a > c) { const int tmp = a; a = c; c = tmp; }
      src = 16 + a * 6 - a * (a - 1) / 2 + (c - a);
    } else {
      src = 37 + (t - 52);  // b 37..42, loglik 43
    }
    partial[(size_t)blockIdx.x * NOUT + t] = red_s[src];
  }
}

}  // namespace hgmm

namespace {

template <int KMAX>
cudaError_t launch(const float* pts4, int n, const float* pose12, const float* wn,
                   const float* aux, int k, int top_k, int has_outlier, float outlier,
                   float* partial, int nb, cudaStream_t s) {
  const size_t smem = sizeof(float4) * 6 * (size_t)k + sizeof(float) * hgmm::NWARPS * hgmm::NACC;
  cudaError_t err = cudaFuncSetAttribute(hgmm::reg_stats_kernel<KMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  hgmm::reg_stats_kernel<KMAX><<<nb, hgmm::TILE, smem, s>>>(pts4, n, pose12, wn, aux, k, top_k,
                                                            has_outlier, outlier, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// horn [4,4], A [6,6], b [6] and loglik of em_ref.reg_stats at the pose
// pose12 = [R row-major (9), t (3)] into out[59]. wn and aux are [K, 12].
// top_k: 0 = no gating, else 1..32 (< K). partial is [nb, 59] scratch.
// Returns the CUDA error code (0 on success).
int hgmm_reg_stats(const void* pts4, int n, const void* pose12, const void* wn, const void* aux,
                   int k, int top_k, int has_outlier, float outlier, void* partial, int nb,
                   void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(pts4);
  const auto* pose = static_cast<const float*>(pose12);
  const auto* w = static_cast<const float*>(wn);
  const auto* a = static_cast<const float*>(aux);
  auto* part = static_cast<float*>(partial);
  if (top_k < 0 || top_k > 32) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      top_k == 0  ? launch<0>(p, n, pose, w, a, k, top_k, has_outlier, outlier, part, nb, s)
      : top_k <= 8 ? launch<8>(p, n, pose, w, a, k, top_k, has_outlier, outlier, part, nb, s)
                   : launch<32>(p, n, pose, w, a, k, top_k, has_outlier, outlier, part, nb, s);
  if (err != cudaSuccess) return (int)err;
  return (int)hgmm::launch_reduce_partials(part, nb, hgmm::NOUT, static_cast<float*>(out), s);
}

}  // extern "C"
