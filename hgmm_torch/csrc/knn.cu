// Nearest target point of every query point, by brute force in float32.
//
// Replaces the TPU kernel hgmm/ops/knn.py:_knn_kernel. Plain twin:
// hgmm_torch/ops/knn.py:nearest_neighbor_ref.
//
// The TPU kernel factors d2 = |q|^2 - 2 q.t + |t|^2 into one matmul, splits it
// into bf16 hi/lo halves and pads targets with a penalty, all to put it on the
// MXU. Here each thread owns QPT queries in registers and every block streams
// all targets through shared memory in tiles of float4 {x, y, z, 0}, in index
// order. A pair costs 3 subtractions, 1 multiply and 2 FMA: the direct
// difference (q - t)^2, exact to rounding, where the factored form cancels
// when two points are close together and far from the origin (nearest-
// neighbour d2 ~1e-6 at |q|^2 ~1 in object scans, |q|^2 ~2,500 in metres on
// KITTI). Each thread keeps a running (min d2, argmin) updated on a strict <,
// so of equal distances the lowest target index wins, as argmin does in the
// twin. No atomics, no cross-block state; the ragged last tile is bounded by
// its count, not padded.
//
// What bounds it on the card: arithmetic, ~9 lane instructions a pair
// (the 6 above, a compare and two selects) against one broadcast 16-byte
// shared-memory load per target for QPT queries; 437,645 x 437,645 pairs is
// ~1.7e12 instructions, >= ~45-60 ms on 132 SMs.
#include <cuda_runtime.h>
#include <math.h>

namespace hgmm {

constexpr int KNN_THREADS = 128;
constexpr int KNN_QPT = 4;       // queries per thread
constexpr int KNN_TILE = 1024;   // targets per shared-memory tile (16 KB)
constexpr int KNN_QPB = KNN_THREADS * KNN_QPT;  // queries per block

__global__ void __launch_bounds__(KNN_THREADS)
    knn_kernel(const float* __restrict__ query, int nq, const float* __restrict__ target, int nt,
               int* __restrict__ out_idx, float* __restrict__ out_d2) {
  __shared__ float4 tile[KNN_TILE];
  float qx[KNN_QPT], qy[KNN_QPT], qz[KNN_QPT], best[KNN_QPT];
  int arg[KNN_QPT];
  const int q0 = blockIdx.x * KNN_QPB + threadIdx.x;
#pragma unroll
  for (int u = 0; u < KNN_QPT; ++u) {
    const int i = q0 + u * KNN_THREADS;
    const bool in = i < nq;
    qx[u] = in ? query[3 * (size_t)i] : 0.0f;
    qy[u] = in ? query[3 * (size_t)i + 1] : 0.0f;
    qz[u] = in ? query[3 * (size_t)i + 2] : 0.0f;
    best[u] = INFINITY;
    arg[u] = 0;
  }
  float* tile_f = reinterpret_cast<float*>(tile);
  for (int t0 = 0; t0 < nt; t0 += KNN_TILE) {
    const int cnt = min(KNN_TILE, nt - t0);
    __syncthreads();  // the previous tile is no longer read
    // Coalesced copy of cnt x 3 floats into the x, y, z slots of the float4s.
    const float* src = target + 3 * (size_t)t0;
    for (int e = threadIdx.x; e < 3 * cnt; e += KNN_THREADS) {
      const int r = e / 3;
      tile_f[4 * r + (e - 3 * r)] = src[e];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 t = tile[j];
#pragma unroll
      for (int u = 0; u < KNN_QPT; ++u) {
        const float dx = qx[u] - t.x, dy = qy[u] - t.y, dz = qz[u] - t.z;
        const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        if (d < best[u]) {
          best[u] = d;
          arg[u] = t0 + j;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < KNN_QPT; ++u) {
    const int i = q0 + u * KNN_THREADS;
    if (i < nq) {
      out_idx[i] = arg[u];
      out_d2[i] = best[u];
    }
  }
}

}  // namespace hgmm

extern "C" {

// For each of the nq query points (query [nq, 3] f32) the index (out_idx
// [nq] int32) and squared distance (out_d2 [nq] f32) of its nearest point in
// target [nt, 3] f32, nt >= 1. Returns the CUDA error code (0 on success).
int hgmm_knn(const void* query, int nq, const void* target, int nt, void* out_idx, void* out_d2,
             void* stream) {
  const int nb = (nq + hgmm::KNN_QPB - 1) / hgmm::KNN_QPB;
  hgmm::knn_kernel<<<nb, hgmm::KNN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), nq, static_cast<const float*>(target), nt,
      static_cast<int*>(out_idx), static_cast<float*>(out_d2));
  return (int)cudaGetLastError();
}

}  // extern "C"
