// Hard assignment: the argmax component of each point, optionally within its
// parent's child block.
//
// Replaces the TPU kernel hgmm/ops/fused_em.py:_assign_kernel. Plain twin:
// hgmm_torch/ops/em_ref.py:assign.
//
// The result is that of one scan of the visible components in index order
// with a strict '>', so ties go to the lowest index and a NaN logit never
// wins. Masked, it is that of em_ref's argmax over the row in which every
// component outside the block holds NEG_INF: when the block's best logit
// does not exceed NEG_INF, the lowest masked-out index can win.
//
// What bounds it on the card: the 16 bytes of point, 4 of parent and 4 of
// output a point (3.1 us at 437,645 points), the table's reads and the
// launch. The grid is persistent (ops/fused_em.py:plan_assign, at most
// AS_BLOCKS_PER_SM blocks an SM) and a lane holds AS_PT points at once, so
// their loads and scans overlap.
//   - unmasked (assign_all_kernel; the tree's level 0, K = 8): a thread takes
//     a point and scans all K rows from shared memory, where each block stages
//     the table once; every lane of a warp reads the same row, a broadcast,
//     and each row read serves the thread's AS_PT points.
//   - masked (assign_masked_kernel): AS_LANES = 8 lanes take a point, lane c
//     its children c, c + 8, ... of the parent's block, read through the
//     read-only path: only the parent's rows (its 8 rows are 384 contiguous
//     bytes), never the whole table (24 KB at K = 512). The lanes' (best,
//     index) pairs are merged by a butterfly that keeps the larger logit and,
//     on equal logits, the lower index: the scan's result, bit for bit, since
//     every logit is evaluated by logit3 in one order. These gathers of 384
//     scattered bytes a point, not the points' bytes, set its time.
#include "hgmm_kernels.cuh"

namespace hgmm {

constexpr int AS_THREADS = 256;  // ops/fused_em.py:AS_THREADS
constexpr int AS_LANES = 8;      // ops/fused_em.py:AS_MASKED_LANES
constexpr int AS_PT = 2;         // ops/fused_em.py:AS_PT, points a lane holds at once

__global__ void __launch_bounds__(AS_THREADS)
    assign_all_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ wn, int k,
                      int* __restrict__ out) {
  extern __shared__ float4 w_s[];  // [3 k]
  for (int idx = threadIdx.x; idx < 3 * k; idx += AS_THREADS)
    w_s[idx] = reinterpret_cast<const float4*>(wn)[idx];
  __syncthreads();
  const int stride = gridDim.x * AS_THREADS;
  for (int base = blockIdx.x * AS_THREADS + threadIdx.x; base < n; base += AS_PT * stride) {
    Psi p[AS_PT];
    float best[AS_PT];
    int idx[AS_PT];
#pragma unroll
    for (int q = 0; q < AS_PT; ++q) {
      const int i = base + q * stride;
      p[q] = i < n ? features(pts4[i], pts4[(size_t)n + i], pts4[2 * (size_t)n + i])
                   : features(0.0f, 0.0f, 0.0f);
      best[q] = -INFINITY;
      idx[q] = -1;
    }
    for (int j = 0; j < k; ++j) {
      const float4 a = w_s[3 * j], b = w_s[3 * j + 1], c = w_s[3 * j + 2];
#pragma unroll
      for (int q = 0; q < AS_PT; ++q) {
        const float l = logit3(a, b, c, p[q]);
        if (l > best[q]) {
          best[q] = l;
          idx[q] = j;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < AS_PT; ++q) {
      const int i = base + q * stride;
      if (i < n) out[i] = idx[q] < 0 ? 0 : idx[q];  // no masked-out row: every logit NaN gives 0
    }
  }
}

__global__ void __launch_bounds__(AS_THREADS)
    assign_masked_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ wn, int k,
                         const int* __restrict__ parent, int branch, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int c = lane & (AS_LANES - 1);
  const int stride = gridDim.x * (AS_THREADS / AS_LANES);
  const float4* w4 = reinterpret_cast<const float4*>(wn);
  // The warp's first point (uniform across the warp, for the shuffles).
  for (int base = (blockIdx.x * AS_THREADS + (threadIdx.x & ~31)) / AS_LANES; base < n;
       base += AS_PT * stride) {
    Psi p[AS_PT];
    int ii[AS_PT], j0[AS_PT], j1[AS_PT];
    float best[AS_PT];
    int idx[AS_PT];
#pragma unroll
    for (int q = 0; q < AS_PT; ++q) {
      ii[q] = base + q * stride + lane / AS_LANES;
      float x = 0.0f, y = 0.0f, z = 0.0f;
      j0[q] = j1[q] = 0;
      if (ii[q] < n) {
        x = pts4[ii[q]];
        y = pts4[(size_t)n + ii[q]];
        z = pts4[2 * (size_t)n + ii[q]];
        visible_range(parent, ii[q], k, branch, &j0[q], &j1[q]);
      }
      p[q] = features(x, y, z);
      best[q] = -INFINITY;
      idx[q] = -1;
    }
#pragma unroll
    for (int q = 0; q < AS_PT; ++q)
      for (int j = j0[q] + c; j < j1[q]; j += AS_LANES) {
        const float l = logit3(__ldg(w4 + 3 * j), __ldg(w4 + 3 * j + 1), __ldg(w4 + 3 * j + 2), p[q]);
        if (l > best[q]) {
          best[q] = l;
          idx[q] = j;
        }
      }
#pragma unroll
    for (int q = 0; q < AS_PT; ++q) {
#pragma unroll
      for (int off = 1; off < AS_LANES; off <<= 1) {
        const float ob = __shfl_xor_sync(FULL_MASK, best[q], off);
        const int oi = __shfl_xor_sync(FULL_MASK, idx[q], off);
        if (ob > best[q] || (ob == best[q] && oi < idx[q])) {  // equal: both -inf with -1, or both live
          best[q] = ob;
          idx[q] = oi;
        }
      }
      if (c != 0 || ii[q] >= n) continue;
      // The lowest index outside [j0, j1), which em_ref sees at NEG_INF.
      const int masked_idx = j0[q] > 0 ? 0 : (j1[q] < k ? j1[q] : -1);
      int id = idx[q];
      if (masked_idx >= 0 && !(best[q] > NEG_INF))
        id = (best[q] == NEG_INF && id >= 0) ? min(id, masked_idx) : masked_idx;
      out[ii[q]] = id < 0 ? 0 : id;
    }
  }
}

}  // namespace hgmm

extern "C" {

// Argmax component of each point into out[N] (int32); parent == NULL: no
// mask (one thread a point, the table staged in shared memory), else 8 lanes
// a point. nb blocks of AS_THREADS. wn is [>= K, 12]. Returns the CUDA error
// code of the launch.
int hgmm_assign(const void* pts4, int n, const void* wn, int k, const void* parent, int branch,
                int nb, void* out, void* stream) {
  if (k < 1 || nb < 1 || branch < 1) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const float*>(pts4);
  const auto w = static_cast<const float*>(wn);
  auto o = static_cast<int*>(out);
  if (parent == nullptr) {
    const size_t smem = sizeof(float4) * 3 * (size_t)k;
    const cudaError_t err = cudaFuncSetAttribute(hgmm::assign_all_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    hgmm::assign_all_kernel<<<nb, hgmm::AS_THREADS, smem, s>>>(p, n, w, k, o);
  } else {
    hgmm::assign_masked_kernel<<<nb, hgmm::AS_THREADS, 0, s>>>(p, n, w, k, static_cast<const int*>(parent),
                                                               branch, o);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
