// Hard assignment: the argmax component of each point, optionally within its
// parent's child block.
//
// Replaces the TPU kernel hgmm/ops/fused_em.py:_assign_kernel. Plain twin:
// hgmm_torch/ops/em_ref.py:assign.
//
// One thread per point (grid-stride), the packed weights in shared memory.
// The scan runs in index order with a strict '>', so ties go to the lowest
// index. Masked, the result is that of em_ref's argmax over the row in which
// every component outside the block holds NEG_INF: when the block's best
// logit does not exceed NEG_INF, the lowest masked-out index can win.
//
// What bounds it on the card: at K=512 it is arithmetic (10 FMA and a compare
// per point and component, all K unmasked); masked it reads 16 bytes of
// point and 4 of parent and writes 4 a point, so it is bound by bytes and
// by the launch.
#include "hgmm_kernels.cuh"

namespace hgmm {

__global__ void __launch_bounds__(TILE)
    assign_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ wn, int k,
                  const int* __restrict__ parent, int branch, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* w4 = smem4;  // [k * 3]
  for (int idx = threadIdx.x; idx < 3 * k; idx += TILE)
    w4[idx] = reinterpret_cast<const float4*>(wn)[idx];
  __syncthreads();
  for (int i = blockIdx.x * TILE + threadIdx.x; i < n; i += gridDim.x * TILE) {
    const Psi p = features(pts4[i], pts4[(size_t)n + i], pts4[2 * (size_t)n + i]);
    int j0, j1;
    visible_range(parent, i, k, branch, &j0, &j1);
    float best = -INFINITY;
    int idx = -1;
    for (int j = j0; j < j1; ++j) {
      const float l = logit(w4 + 3 * j, p);
      if (l > best) {
        best = l;
        idx = j;
      }
    }
    // The lowest index outside [j0, j1), which em_ref sees at NEG_INF.
    const int masked_idx = j0 > 0 ? 0 : (j1 < k ? j1 : -1);
    if (masked_idx >= 0 && !(best > NEG_INF))
      idx = (best == NEG_INF && idx >= 0) ? min(idx, masked_idx) : masked_idx;
    out[i] = idx < 0 ? 0 : idx;
  }
}

}  // namespace hgmm

extern "C" {

// Argmax component of each point into out[N] (int32); parent == NULL: no mask.
// Returns the CUDA error code of the launch (0 on success).
int hgmm_assign(const void* pts4, int n, const void* wn, int k, const void* parent, int branch,
                int nb, void* out, void* stream) {
  const size_t smem = sizeof(float4) * 3 * (size_t)k;
  cudaError_t err = cudaFuncSetAttribute(hgmm::assign_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  hgmm::assign_kernel<<<nb, hgmm::TILE, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts4), n, static_cast<const float*>(wn), k,
      static_cast<const int*>(parent), branch, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
