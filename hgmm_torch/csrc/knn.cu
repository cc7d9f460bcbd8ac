// Nearest target point of every query point, by brute force in float32.
//
// Replaces the TPU kernel hgmm/ops/knn.py:_knn_kernel. Plain twin:
// hgmm_torch/ops/knn.py:nearest_neighbor_ref.
//
// What it computes. For every query the lowest-indexed target at the smallest
// d2 = (qx - tx)^2 + (qy - ty)^2 + (qz - tz)^2, evaluated in the direct form,
// exact to rounding. The TPU kernel factors d2 = |q|^2 - 2 q.t + |t|^2 into a
// matmul (bf16 hi/lo halves, penalty-padded targets) to reach its matrix
// unit; the factored form cancels when two points are close together and far
// from the origin (nearest-neighbour d2 ~1e-6 at |q|^2 ~1 in object scans,
// |q|^2 ~2,500 in metres on KITTI), so it is not taken over. A NaN distance
// never wins (fminf ignores it); a query with no finite distance gets index 0
// and d2 = +inf. No atomics: two runs give the same bits.
//
// What bounds it on the card: arithmetic on the float32 lanes. Two floors
// are quoted for 437,645 x 437,645 pairs, and they count different things:
//   22.9 ms  hgmm_torch/eval/roofline.py:kernel_bound("knn"), the one every
//            share in PERF.md and chip_smoke.py uses: 8 flop a pair (3
//            subtractions, 1 multiply, 2 FMA) at the card's 67 TFLOP/s, which
//            credits every lane instruction with an FMA's two flop;
//   34.3 ms  the direct form's own floor: those are 6 lane instructions a
//            pair, at one instruction a lane and clock (33.5e12/s), before
//            the minimum is taken at all.
//
// Design (what each part does about that bound).
// - The index is not tracked pair by pair. Inside a chunk of KNN_CHUNK targets
//   a query keeps only cmin = fminf(cmin, d): 7 lane instructions a pair
//   instead of 9 with a compare and two selects. After the chunk, for a query
//   whose cmin fell below its best, the warp rescans that chunk together: a
//   chunk is 32 targets, lane j evaluates target j for that query (shuffled
//   to it) and a ballot gives the first target with d == cmin. dist2() is
//   one function of explicit round-to-nearest intrinsics, so the rescan
//   reproduces d bit for bit. Strict < across chunks and the lowest lane
//   inside one keep "lowest index wins". A query's minimum improves
//   ~ln(chunks) times over a whole search, and a rescan costs the warp ~20
//   instructions, so rescans are well under one per cent of the work (a loop
//   over the chunk by the one lane alone stalls its whole warp for ~300
//   instructions: 7 % of a call at 4 target splits, 34 % at 26, timed on
//   the H100).
// - A thread holds KNN_QPT = 8 queries in registers: one broadcast 16-byte
//   shared-memory load per target serves 8 pairs.
// - Targets stream through two shared-memory tiles of float4 {x, y, z, -}.
//   The next tile is copied with cp.async (4-byte copies straight from the
//   [Nt, 3] rows, so the caller pads nothing; 16-byte copies from a padded
//   [Nt, 4] copy are 0.5 % faster on the H100 and cost that copy)
//   while the current one is scanned: one barrier
//   a tile. A tile is 8 KB and linear, and its copy is
//   12 instructions a thread against ~29,000 of arithmetic, so the tensor
//   memory accelerator (descriptor, mbarrier) would save nothing here.
// - The ragged last tile is padded to a whole chunk with +inf coordinates:
//   their distance is +inf (or NaN for an infinite query) and never wins.
// - The grid is query blocks x target splits; the split count comes from
//   hgmm_torch/ops/knn.py:plan_knn, which fills the SMs evenly and gives
//   small searches more than a handful of blocks. With more than one split
//   each block writes its (d2, index) partial and knn_merge_kernel takes the
//   smaller d2 in split order (strict <, so the lower index wins).
#include "hgmm_kernels.cuh"

namespace hgmm {

constexpr int KNN_THREADS = 128;
constexpr int KNN_QPT = 8;      // queries per thread (ops/knn.py:KNN_QPB = 128 * 8)
constexpr int KNN_TILE = 512;   // targets per shared-memory tile (ops/knn.py:KNN_TILE)
constexpr int KNN_CHUNK = 32;   // targets between two looks at the index: one a lane
constexpr int KNN_QPB = KNN_THREADS * KNN_QPT;
static_assert(KNN_TILE % KNN_CHUNK == 0, "a tile is whole chunks");
static_assert(KNN_CHUNK == 32, "the rescan gives each lane of a warp one target of the chunk");

// The one evaluation of d2: explicit intrinsics, so that the compiler
// contracts nothing and the scan and the rescan round alike.
__device__ __forceinline__ float dist2(float qx, float qy, float qz, const float4& t) {
  const float dx = __fsub_rn(qx, t.x), dy = __fsub_rn(qy, t.y), dz = __fsub_rn(qz, t.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// Start the copy of targets [t0, t0 + cnt) into `tile`, and pad the tile to a
// whole chunk with +inf rows.
__device__ __forceinline__ void knn_load_tile(float4* tile, const float* __restrict__ target,
                                              int t0, int cnt) {
  float* tile_f = reinterpret_cast<float*>(tile);
  const float* src = target + 3 * (size_t)t0;
  for (int e = threadIdx.x; e < 3 * cnt; e += KNN_THREADS) {
    const int r = e / 3;
    cp_async_f32(tile_f + 4 * r + (e - 3 * r), src + e);
  }
  const int padded = (cnt + KNN_CHUNK - 1) / KNN_CHUNK * KNN_CHUNK;
  for (int r = cnt + threadIdx.x; r < padded; r += KNN_THREADS)
    tile[r] = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
  cp_async_commit();
}

// Block (bx, by): queries [bx * KNN_QPB, ...) against targets
// [by * span, min(nt, (by + 1) * span)). Writes row `by` of out_d2 / out_idx
// ([splits, nq]; with one split these are the results).
__global__ void __launch_bounds__(KNN_THREADS, 4)
    knn_kernel(const float* __restrict__ query, int nq, const float* __restrict__ target, int nt,
               int span, int* __restrict__ out_idx, float* __restrict__ out_d2) {
  __shared__ float4 tiles[2][KNN_TILE];
  float qx[KNN_QPT], qy[KNN_QPT], qz[KNN_QPT], best[KNN_QPT], cmin[KNN_QPT];
  int arg[KNN_QPT];
  const int q0 = blockIdx.x * KNN_QPB + threadIdx.x;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < KNN_QPT; ++u) {
    const int i = q0 + u * KNN_THREADS;
    const bool in = i < nq;
    qx[u] = in ? query[3 * (size_t)i] : 0.0f;
    qy[u] = in ? query[3 * (size_t)i + 1] : 0.0f;
    qz[u] = in ? query[3 * (size_t)i + 2] : 0.0f;
    best[u] = cmin[u] = INFINITY;
    arg[u] = 0;
  }
  const int begin = blockIdx.y * span;
  const int end = min(nt, begin + span);
  const int ntiles = (end - begin + KNN_TILE - 1) / KNN_TILE;
  if (ntiles > 0) knn_load_tile(tiles[0], target, begin, min(KNN_TILE, end - begin));
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = begin + it * KNN_TILE;
    const int cnt = min(KNN_TILE, end - t0);
    cp_async_wait_all();
    __syncthreads();  // tile `it` has landed; nobody reads the other buffer any more
    if (it + 1 < ntiles)
      knn_load_tile(tiles[(it + 1) & 1], target, t0 + KNN_TILE, min(KNN_TILE, end - t0 - KNN_TILE));
    const float4* tile = tiles[it & 1];
    for (int c0 = 0; c0 < cnt; c0 += KNN_CHUNK) {
#pragma unroll 8
      for (int j = 0; j < KNN_CHUNK; ++j) {
        const float4 t = tile[c0 + j];
#pragma unroll
        for (int u = 0; u < KNN_QPT; ++u) cmin[u] = fminf(cmin[u], dist2(qx[u], qy[u], qz[u], t));
      }
#pragma unroll
      for (int u = 0; u < KNN_QPT; ++u) {
        // Rare: some lanes' minimum fell in this chunk. The warp takes them in
        // turn: lane j evaluates target j of the chunk for that lane's query,
        // and the lowest lane at exactly that distance is the index.
        unsigned need = __ballot_sync(FULL_MASK, cmin[u] < best[u]);
        while (need) {
          const int src = __ffs(need) - 1;
          need &= need - 1;
          const float sx = __shfl_sync(FULL_MASK, qx[u], src);
          const float sy = __shfl_sync(FULL_MASK, qy[u], src);
          const float sz = __shfl_sync(FULL_MASK, qz[u], src);
          const float sm = __shfl_sync(FULL_MASK, cmin[u], src);
          const unsigned hit = __ballot_sync(FULL_MASK, dist2(sx, sy, sz, tile[c0 + lane]) == sm);
          if (lane == src) {
            arg[u] = t0 + c0 + __ffs(hit) - 1;
            best[u] = sm;
          }
        }
      }
    }
  }
  out_idx += (size_t)blockIdx.y * nq;
  out_d2 += (size_t)blockIdx.y * nq;
#pragma unroll
  for (int u = 0; u < KNN_QPT; ++u) {
    const int i = q0 + u * KNN_THREADS;
    if (i < nq) {
      out_idx[i] = arg[u];
      out_d2[i] = best[u];
    }
  }
}

// The smaller d2 of the `splits` partials of each query, in split order: a
// later split wins only on a strictly smaller d2, so equal distances keep the
// lowest target index.
__global__ void knn_merge_kernel(const int* __restrict__ part_idx, const float* __restrict__ part_d2,
                                 int nq, int splits, int* __restrict__ out_idx,
                                 float* __restrict__ out_d2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float best = part_d2[i];
  int arg = part_idx[i];
  for (int s = 1; s < splits; ++s) {
    const float d = part_d2[(size_t)s * nq + i];
    if (d < best) {
      best = d;
      arg = part_idx[(size_t)s * nq + i];
    }
  }
  out_idx[i] = arg;
  out_d2[i] = best;
}

}  // namespace hgmm

extern "C" {

// For each of the nq query points (query [nq, 3] f32) the index (out_idx
// [nq] int32) and squared distance (out_d2 [nq] f32) of its nearest point in
// target [nt, 3] f32, nt >= 1. The targets are cut into `splits` runs of
// `span` targets (splits * span >= nt); with splits > 1, part_idx and part_d2
// are [splits, nq] scratch. Returns the CUDA error code (0 on success).
int hgmm_knn(const void* query, int nq, const void* target, int nt, int splits, int span,
             void* part_idx, void* part_d2, void* out_idx, void* out_d2, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + hgmm::KNN_QPB - 1) / hgmm::KNN_QPB, splits);
  const bool merge = splits > 1;
  hgmm::knn_kernel<<<grid, hgmm::KNN_THREADS, 0, s>>>(
      static_cast<const float*>(query), nq, static_cast<const float*>(target), nt, span,
      static_cast<int*>(merge ? part_idx : out_idx), static_cast<float*>(merge ? part_d2 : out_d2));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return (int)err;
  hgmm::knn_merge_kernel<<<(nq + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(part_idx), static_cast<const float*>(part_d2), nq, splits,
      static_cast<int*>(out_idx), static_cast<float*>(out_d2));
  return (int)cudaGetLastError();
}

}  // extern "C"
