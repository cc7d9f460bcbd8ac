// Fused EM E-step + sufficient statistics, with and without the tree's
// parent mask.
//
// Replaces the TPU kernel hgmm/ops/fused_em.py:_em_stats_kernel (both its
// plain form and its parent_ref-masked form). Plain twin:
// hgmm_torch/ops/em_ref.py:em_stats / em_stats_masked.
//
// Computes S = Gamma^T Psi [K, 10] and loglik = sum_i w_i lse_i without ever
// writing the [N, K] responsibilities to memory.
//
// Design. One block of TILE threads walks tiles of TILE points (grid-stride).
//   Phase 1, one thread per point: psi(y), then the exact two-pass softmax
//     over the K components (or, masked, the parent's `branch` children);
//     psi, the max and the softmax scale go to shared memory.
//   Phase 2, threads per component: thread (g, j) recomputes l_ij for the
//     points g, g + G, ... of the tile, gamma_ij = scale_i exp2(l_ij - m_i),
//     and accumulates gamma_ij psi_i in registers; the tile's sum is added to
//     the (g, j) slot of a block-private [G*K, 10] shared accumulator that no
//     other thread touches. Masked, a thread skips the points of other parents.
// Each block then writes its [K*10 + 1] partial (groups summed in order),
// and reduce_partials sums the blocks in a fixed order in float64, so the
// result is reproducible run to run (the M-step's T2/T0 - mu mu^T cancels
// in float32; a scheduling-dependent sum order would show there).
//
// What bounds it on the card: at K=512 it is arithmetic, about 3 logit
// evaluations (10 FMA each) + 2 exp2 + 10 FMA per point and component, from
// shared memory that every thread of a warp reads at the same address; at
// K=8 it is the 16 bytes a point that it reads from device memory and the
// launch itself. Making it fast (tensor cores, fewer logit passes) is later
// work; this kernel is the simple, exact one.
#include "hgmm_kernels.cuh"

namespace hgmm {

template <bool MASKED>
__global__ void __launch_bounds__(TILE)
    em_stats_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ wn, int k,
                    const int* __restrict__ parent, int branch, int has_outlier, float outlier,
                    int groups, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float4* w4 = smem4;                           // [k * 3]  packed weights
  float4* pt4 = w4 + 3 * k;                     // [TILE * 3] psi(9), m2, scale, (1)
  int* par_s = reinterpret_cast<int*>(pt4 + 3 * TILE);  // [TILE]
  float* ll_s = reinterpret_cast<float*>(par_s + TILE);  // [TILE]
  float* acc_s = ll_s + TILE;                   // [slots * 10]
  const int t = threadIdx.x;
  const int slots = groups * k;

  for (int idx = t; idx < 3 * k; idx += TILE) w4[idx] = reinterpret_cast<const float4*>(wn)[idx];
  for (int idx = t; idx < slots * 10; idx += TILE) acc_s[idx] = 0.0f;

  // Phase-2 role of this thread: group g, first component j_first; with one
  // group a thread takes components j_first, j_first + TILE, ...
  const int g = groups > 1 ? t / k : 0;
  const int j_first = groups > 1 ? t % k : t;
  const bool has_role = groups > 1 ? t < slots : t < k;

  float ll_acc = 0.0f;
  const int ntiles = (n + TILE - 1) / TILE;
  __syncthreads();

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int base = tile * TILE;
    const int i = base + t;
    // ---- Phase 1: this thread's point.
    float4 q0 = make_float4(0.f, 0.f, 0.f, 0.f), q1 = q0, q2 = q0;
    int par = -1;
    if (i < n) {
      const float x = pts4[i], y = pts4[(size_t)n + i], z = pts4[2 * (size_t)n + i];
      const float w = pts4[3 * (size_t)n + i];
      const Psi p = features(x, y, z);
      int j0, j1;
      visible_range(MASKED ? parent : nullptr, i, k, branch, &j0, &j1);
      if (MASKED) par = parent[i];
      const float m = max_logit(w4, p, j0, j1, has_outlier, outlier);
      const float m2 = fmaxf(m, NEG_INF) * LOG2E;
      float s = 0.0f;
      for (int j = j0; j < j1; ++j) s += exp2f(fmaf(logit(w4 + 3 * j, p), LOG2E, -m2));
      const Soft r = finish_soft(m, m2, s, has_outlier, outlier, w);
      ll_acc += r.lse;
      q0 = make_float4(p.v[0], p.v[1], p.v[2], p.v[3]);
      q1 = make_float4(p.v[4], p.v[5], p.v[6], p.v[7]);
      q2 = make_float4(p.v[8], m2, r.scale, 0.f);
    }
    pt4[3 * t] = q0;
    pt4[3 * t + 1] = q1;
    pt4[3 * t + 2] = q2;
    par_s[t] = par;
    __syncthreads();

    // ---- Phase 2: this thread's components over the tile's points.
    const int tile_n = min(TILE, n - base);
    if (has_role) {
      for (int j = j_first; j < k; j += TILE) {
        const float4* wj = w4 + 3 * j;
        const int pj = MASKED ? j / branch : 0;
        float acc[10];
#pragma unroll
        for (int f = 0; f < 10; ++f) acc[f] = 0.0f;
        for (int ip = g; ip < tile_n; ip += groups) {
          const float4 c = pt4[3 * ip + 2];
          if (c.z == 0.0f) continue;  // dead, zero-weight or outside the tile
          if (MASKED && par_s[ip] != pj) continue;
          const float4 a = pt4[3 * ip], b = pt4[3 * ip + 1];
          Psi p;
          p.v[0] = a.x; p.v[1] = a.y; p.v[2] = a.z; p.v[3] = a.w;
          p.v[4] = b.x; p.v[5] = b.y; p.v[6] = b.z; p.v[7] = b.w;
          p.v[8] = c.x; p.v[9] = 1.0f;
          const float gam = c.z * exp2f(fmaf(logit(wj, p), LOG2E, -c.y));
#pragma unroll
          for (int f = 0; f < 10; ++f) acc[f] = fmaf(gam, p.v[f], acc[f]);
        }
        float* slot = acc_s + (size_t)(g * k + j) * 10;
#pragma unroll
        for (int f = 0; f < 10; ++f) slot[f] += acc[f];
      }
    }
    __syncthreads();
  }

  // ---- Block partial: groups summed in order, then the loglik tree.
  const int m_out = k * 10 + 1;
  float* out = partial + (size_t)blockIdx.x * m_out;
  for (int idx = t; idx < k * 10; idx += TILE) {
    float s = 0.0f;
    for (int gg = 0; gg < groups; ++gg) s += acc_s[(size_t)gg * k * 10 + idx];
    out[idx] = s;
  }
  ll_s[t] = ll_acc;
  __syncthreads();
  for (int stride = TILE / 2; stride > 0; stride >>= 1) {
    if (t < stride) ll_s[t] += ll_s[t + stride];
    __syncthreads();
  }
  if (t == 0) out[k * 10] = ll_s[0];
}

// One warp per output: lane l sums the blocks l, l + 32, ... in float64, then
// a butterfly over the lanes. The order is fixed, so the sum is reproducible.
__global__ void reduce_partials_kernel(const float* __restrict__ partial, int nb, int m,
                                       float* __restrict__ out) {
  const int o = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (o >= m) return;  // o is uniform across the warp
  double s = 0.0;
  for (int b = lane; b < nb; b += 32) s += (double)partial[(size_t)b * m + o];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[o] = (float)s;
}

cudaError_t launch_reduce_partials(const float* partial, int nb, int m, float* out,
                                   cudaStream_t stream) {
  reduce_partials_kernel<<<(m + 7) / 8, 256, 0, stream>>>(partial, nb, m, out);
  return cudaGetLastError();
}

size_t em_stats_smem_bytes(int k, int groups) {
  return sizeof(float4) * (3 * (size_t)k + 3 * TILE) + sizeof(int) * TILE +
         sizeof(float) * (TILE + (size_t)groups * k * 10);
}

template <bool MASKED>
cudaError_t launch_em_stats(const float* pts4, int n, const float* wn, int k, const int* parent,
                            int branch, int has_outlier, float outlier, float* partial, int nb,
                            float* out, cudaStream_t stream) {
  const int groups = k < TILE ? TILE / k : 1;
  const size_t smem = em_stats_smem_bytes(k, groups);
  cudaError_t err = cudaFuncSetAttribute(em_stats_kernel<MASKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  em_stats_kernel<MASKED><<<nb, TILE, smem, stream>>>(pts4, n, wn, k, parent, branch, has_outlier,
                                                      outlier, groups, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_partials(partial, nb, k * 10 + 1, out, stream);
}

}  // namespace hgmm

extern "C" {

// S and loglik of em_ref.em_stats / em_stats_masked (parent == NULL: no mask)
// into out[K*10 + 1] (S row-major, then loglik). partial is [nb, K*10 + 1]
// scratch. Returns the CUDA error code of the launches (0 on success).
int hgmm_em_stats(const void* pts4, int n, const void* wn, int k, const void* parent, int branch,
                  int has_outlier, float outlier, void* partial, int nb, void* out,
                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const float*>(pts4);
  const auto w = static_cast<const float*>(wn);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<float*>(out);
  if (parent != nullptr)
    return (int)hgmm::launch_em_stats<true>(p, n, w, k, static_cast<const int*>(parent), branch,
                                            has_outlier, outlier, part, nb, o, s);
  return (int)hgmm::launch_em_stats<false>(p, n, w, k, nullptr, 1, has_outlier, outlier, part,
                                           nb, o, s);
}

const char* hgmm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
