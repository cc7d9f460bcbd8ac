// Fused EM E-step + sufficient statistics, with and without the tree's
// parent mask.
//
// Replaces the TPU kernel hgmm/ops/fused_em.py:_em_stats_kernel (both its
// plain form and its parent_ref-masked form). Plain twin:
// hgmm_torch/ops/em_ref.py:em_stats / em_stats_masked.
//
// Computes S = Gamma^T Psi [K, 10] and loglik = sum_i w_i lse_i without ever
// writing the [N, K] responsibilities to memory. Every block writes a
// [K*10 + 1] partial and reduce_partials sums the blocks in a fixed order in
// float64, so the result is reproducible run to run (the M-step's
// T2/T0 - mu mu^T cancels in float32; a scheduling-dependent sum order would
// show there). A fit's sweep launches the body alone (out NULL) and em_step
// (csrc/em_step.cu) sums the rows in its place, in a fixed order too.
//
// Three kernel bodies; hgmm_torch/ops/fused_em.py picks by K and the mask
// alone (plan_em_tiles for the unmasked ones).
//
// em_stats_tiled_kernel: unmasked, K >= 33 (the bench sweep, K = 512).
//   What bounds it on the card: float32 arithmetic. A point and component
//   need 10 FMA for the logit, one exp2 and 10 FMA for the statistics; at
//   K = 512 that is 641 us for 2^21 points at the 67 TFLOP/s peak, against
//   10 us for the 16 bytes a point. A scheme that reads one operand of every
//   FMA from shared memory stops at ~28 TFLOP/s on this card (the float32
//   probes of csrc/probes.cu), so the design is about registers:
//   - One block of 256 threads takes a tile of P points and ALL K components.
//     Thread (pg, cg) owns an 8 x 8 tile of logits: 8 points of point group
//     pg, 8 components of component group cg. For each feature it loads 8
//     psi values and 8 weights from shared memory (four 16-byte loads) for 64
//     FMAs. Every logit is evaluated ONCE and stays in its register.
//   - Per point the max over the thread's 8 logits, then over the component
//     groups by warp shuffles (the lanes of a warp lie along the components of
//     one point group; the 8 points are reduced by halving, 9 shuffles in
//     place of 40: whole butterflies cost 5 % of a sweep more on the
//     H100) and, where a point group spans several
//     warps, one shared-memory exchange behind a named barrier that only
//     those warps wait at. e = exp2(l log2e - m log2e) ONCE a pair, in place, by the
//     special-function unit alone (exp2_ftz); the sum the same way; the
//     scale w / s and the log-evidence once a point (finish_soft, the outlier
//     term included), then shuffled to the lanes.
//   - The thread keeps its 8 x 10 statistics in registers across all tiles of
//     its block and adds (scale e) psi, reading psi again from shared memory.
//     At the end the point groups' sums are added in group order.
//   - The grid is persistent (at most one block an SM, tiles grid-stride), so
//     there are <= 132 partial rows. 64 independent FMA chains a thread hide
//     latency by instruction-level parallelism, not occupancy.
//   - The next tile's points (16 bytes a point) come in by cp.async while the
//     current tile computes, staged by the point group that will read them, so
//     the loop has no block-wide barrier and the point groups drift apart. The
//     tensor memory accelerator would move the same few hundred bytes a tile,
//     and the tensor cores (wgmma) are not used on purpose: the quadratic
//     form's terms reach ~1e6 at metric scale and cancel, which bf16 or TF32
//     operands lose, and the product is 10 deep.
//   - K is padded to the tiling (a power of two) with rows of zero weights
//     and a bias at the mask floor: e = 0, never the max of a live point, and
//     a point with every logit at the floor stays dead. Their statistics are
//     not written.
//
// em_stats_kernel: unmasked calls with K <= 32 (the tree's level 0 and the
//   flat fit at K = branch = 8). What bounds it: the 16 bytes a point (2.1 us
//   at 437,645 points) and, at the odometry bucket, the launch. So each point
//   is read once and each logit evaluated once, and nothing waits on a
//   block-wide barrier until the end:
//   - L = 1, 2 or 4 lanes take a point (L = ceil(K / 8) to a power of two,
//     a template argument; ops/fused_em.py:plan_em_lanes); lane s of the L
//     owns components 8 s .. 8 s + 7 and keeps their logits, one exp2 a pair
//     and their 8 x 10 statistics in registers. The max and the sum over the
//     L lanes go by butterflies, so the L lanes hold equal bits. A warp takes
//     32 / L points at once, grid-stride, the next point's 16 bytes loaded
//     while this one computes. (Four lanes of 2 components at K = 8 ran the
//     kernel faster at the odometry bucket but wrote four times the partial
//     rows, and lost at every size measured: PERF.md.)
//   - The weight table sits in shared memory with one float4 of padding after
//     every 8 rows, so the L lanes of a point (rows 8 s + c) read L banks.
//   - The grid is persistent (ops/fused_em.py:plan_em_lanes, at most
//     ES_BLOCKS_PER_SM blocks an SM); at the end a warp's lanes are summed in
//     lane order through a shared-memory transpose, the warps in warp order,
//     into the block's partial row, and reduce_partials adds the rows.
//   33 <= K < 64 runs the tiled body on 64 padded rows, which was the faster
//   of the two there (PERF.md).
//
// em_stats_grouped_kernel: masked calls (the tree's levels 1 and 2).
//   What bounds it: a point needs only its parent's `branch` children, so
//   the work is N branch pairs, not N K. The wrapper (ops/fused_em.py:
//   group_by_parent) sorts the level's points by parent once (a stable sort
//   and one gather; points without a parent and zero-weight rows, which add
//   exactly nothing, are left out) and plans chunks of at most P points of one
//   parent (plan_parent_chunks). One warp takes a chunk: the parent's children
//   weights sit in shared memory, a lane takes points lane, lane + 32, ...
//   and keeps the branch logits, one exp2 a pair and the branch x 10
//   statistics in registers. The warp's lanes are summed in lane order
//   through shared memory into the chunk's [branch*10 + 1] partial row, and
//   em_grouped_reduce_kernel adds a parent's chunks, in chunk order and in
//   float64, into its rows of S (and every chunk into the loglik).
//   It holds at most EG_BMAX = 8 children in registers.
//
// em_stats_grouped_wide_kernel: masked calls with branch > 8 (a tree of
//   branch 12 or 16). The same chunks, rows and reduce as the grouped body;
//   what differs is that a point's normaliser needs all `branch` children,
//   and a register array sized by the branch would spill. So a lane works in
//   two passes over its points:
//   - pass 1: the max over every child's logit, then the sum of exp2 in
//     child order (the grouped body's arithmetic), the log-evidence, and the
//     point's m log2e and scale w / s into its slot in shared memory (a chunk
//     is at most 32 EG_MAX_PPT points);
//   - pass 2, once a group of 8 children: the group's logits again, gamma =
//     exp2(l log2e - m log2e) scale, the same acc[8][10] registers as the
//     grouped body; then the warp's lanes summed in lane order into the
//     group's columns of the chunk's row.
//   So a child's statistics have the bits the grouped body would give it;
//   the logits of a point are evaluated 2 + 1 times. The parent's rows (3
//   float4 a child) sit in dynamic shared memory beside the transpose and
//   the slots; the warps a block shrink where branch makes that too large
//   (ops/fused_em.py:plan_grouped_wide). Bound: the same 16 bytes a point.
#include "hgmm_kernels.cuh"

namespace hgmm {

constexpr int ES_THREADS = 128;         // ops/fused_em.py:ES_THREADS
constexpr int ES_WARPS = ES_THREADS / 32;
constexpr int ES_CT = 8;                // components a lane
constexpr int ES_KMAX = 33;             // the first body takes K < ES_KMAX
constexpr int ES_ROW = ES_CT * 10 + 1;  // a lane's row in the transpose (odd: no bank conflict)
constexpr int ES_COLS = (10 * (ES_KMAX - 1) + 1 + 31) / 32;  // columns of a partial row a lane sums

// float4 index of table row j in shared memory: one float4 of padding after
// every 8 rows, so rows 8 s + c of s = 0..3 fall in 4 different banks.
__device__ __forceinline__ int es_row(int j) { return 3 * j + (j >> 3); }

template <int L>
__global__ void __launch_bounds__(ES_THREADS, 4)
    em_stats_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ wn, int k,
                    int has_outlier, float outlier, float* __restrict__ partial) {
  constexpr int PPW = 32 / L;  // points a warp takes at once
  __shared__ float4 w_s[3 * ES_KMAX + ES_KMAX / 8];
  __shared__ float tr_s[ES_WARPS][32 * ES_ROW];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int s = lane & (L - 1);              // this lane's components: 8 s .. 8 s + 7
  const int nc = min(ES_CT, k - ES_CT * s);  // of them below K (<= 0: none)
  for (int idx = t; idx < 3 * k; idx += ES_THREADS)
    w_s[es_row(idx / 3) + idx % 3] = reinterpret_cast<const float4*>(wn)[idx];
  __syncthreads();
  const float4* w4 = w_s + es_row(ES_CT * s);

  float acc[ES_CT][10];
#pragma unroll
  for (int c = 0; c < ES_CT; ++c)
#pragma unroll
    for (int f = 0; f < 10; ++f) acc[c][f] = 0.0f;
  float ll = 0.0f;

  // Point slots: the warp's first point is `base` (uniform across the warp, so
  // every lane takes part in the shuffles); a lane past N computes a point of
  // weight 0 at the origin, which adds exactly nothing.
  const int stride = gridDim.x * (ES_THREADS / L);
  int base = blockIdx.x * (ES_THREADS / L) + warp * PPW;
  const int g = lane / L;
  auto load = [&](int i, float& x, float& y, float& z, float& w) {
    if (i < n) {
      x = pts4[i];
      y = pts4[(size_t)n + i];
      z = pts4[2 * (size_t)n + i];
      w = pts4[3 * (size_t)n + i];
    } else {
      x = y = z = w = 0.0f;
    }
  };
  float nx, ny, nz, nw;
  load(base + g, nx, ny, nz, nw);
  for (; base < n; base += stride) {
    const Psi p = features(nx, ny, nz);
    const float w = nw;
    load(base + stride + g, nx, ny, nz, nw);  // the next point, in flight meanwhile
    // The weights are read from shared memory for every point: an offset the
    // compiler cannot see through keeps it from hoisting the 80 loop-invariant
    // loads into registers beside the 80 statistics (which spilled at L = 1).
    int opaque;
    asm volatile("mov.u32 %0, 0;" : "=r"(opaque));
    const float4* wr = w4 + opaque;
    float e[ES_CT];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < ES_CT; ++c) {
      e[c] = c < nc ? logit(wr + 3 * c, p) : -INFINITY;
      m = fmaxf(m, e[c]);
    }
#pragma unroll
    for (int off = 1; off < L; off <<= 1) m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, off));
    if (has_outlier) m = fmaxf(m, outlier);
    const float m2 = fmaxf(m, NEG_INF) * LOG2E;
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < ES_CT; ++c) {
      e[c] = c < nc ? exp2f(fmaf(e[c], LOG2E, -m2)) : 0.0f;
      sum += e[c];
    }
#pragma unroll
    for (int off = 1; off < L; off <<= 1) sum += __shfl_xor_sync(FULL_MASK, sum, off);
    const Soft r = finish_soft(m, m2, sum, has_outlier, outlier, w);
    if (s == 0) ll += r.lse;  // one lane a point
    if (r.scale != 0.0f) {    // equal on the L lanes of a point; 0 when dead or of weight 0
#pragma unroll
      for (int c = 0; c < ES_CT; ++c) {
        const float gam = e[c] * r.scale;
#pragma unroll
        for (int f = 0; f < 10; ++f) acc[c][f] = fmaf(gam, p.v[f], acc[c][f]);
      }
    }
  }

  // The warp's lanes summed in lane order: each lane posts its row; column
  // o = 10 j + f of S sums the PPW lanes that own j, the loglik column every
  // lane. Then the warps in warp order into the block's partial row.
  float* tr = tr_s[warp];
#pragma unroll
  for (int c = 0; c < ES_CT; ++c)
#pragma unroll
    for (int f = 0; f < 10; ++f) tr[lane * ES_ROW + c * 10 + f] = acc[c][f];
  tr[lane * ES_ROW + ES_CT * 10] = ll;
  __syncwarp();
  const int m_out = k * 10 + 1;
  float v[ES_COLS];
#pragma unroll
  for (int q = 0; q < ES_COLS; ++q) {
    const int o = lane + 32 * q;
    float a = 0.0f;
    if (o < k * 10) {
      const int j = o / 10, sj = j / ES_CT;
      const float* col = tr + sj * ES_ROW + (j - ES_CT * sj) * 10 + (o - 10 * j);
      for (int gg = 0; gg < PPW; ++gg) a += col[gg * L * ES_ROW];
    } else if (o == k * 10) {
      for (int l = 0; l < 32; ++l) a += tr[l * ES_ROW + ES_CT * 10];
    }
    v[q] = a;
  }
  __syncwarp();  // the warp's transpose is read: its first m_out floats take the warp's row
#pragma unroll
  for (int q = 0; q < ES_COLS; ++q)
    if (lane + 32 * q < m_out) tr[lane + 32 * q] = v[q];
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * m_out;
  for (int o = t; o < m_out; o += ES_THREADS) {
    float a = 0.0f;
#pragma unroll
    for (int ww = 0; ww < ES_WARPS; ++ww) a += tr_s[ww][o];
    out[o] = a;
  }
}

template <int L>
cudaError_t launch_em_stats(const float* pts4, int n, const float* wn, int k, int has_outlier,
                            float outlier, float* partial, int nb, float* out, cudaStream_t stream) {
  em_stats_kernel<L><<<nb, ES_THREADS, 0, stream>>>(pts4, n, wn, k, has_outlier, outlier, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return err;
  return launch_reduce_partials(partial, nb, k * 10 + 1, out, stream);
}

// ---------------------------------------------------------------------------
// The register-tiled kernel (unmasked, K >= 33).

constexpr int EMT_THREADS = 256;
constexpr int EMT_PT = 8;  // points a thread (ops/fused_em.py:EMT_PT)
constexpr int EMT_CT = 8;  // components a thread (ops/fused_em.py:EMT_CT)

// 2^x by the special-function unit alone (ex2.approx.ftz). exp2f wraps the
// same instruction in a range guard (a compare and two multiplies) that keeps
// results below 2^-126 as denormals; here they flush to 0, a change of under
// 1.2e-38 in a softmax term whose largest is 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reduce v[0..7] (one value a point) over the SEG lanes of a point group with
// `op`, by halving: after each of three exchanges a lane carries half as many
// points, then whole butterflies on the one that is left: 9 shuffles instead
// of 40 at SEG = 32. Lane li ends with the total of point
// 4 bit(SEG/2) + 2 bit(SEG/4) + bit(SEG/8) of li; lane emt_owner(i) of the
// group's lanes is the first that holds point i.
template <int SEG, typename Op>
__device__ __forceinline__ float emt_reduce8(const float (&v)[8], int li, Op op) {
  const bool b4 = li & (SEG / 2), b2 = li & (SEG / 4), b1 = li & (SEG / 8);
  float a[4], b[2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    a[q] = op(b4 ? v[4 + q] : v[q], __shfl_xor_sync(FULL_MASK, b4 ? v[q] : v[4 + q], SEG / 2));
#pragma unroll
  for (int q = 0; q < 2; ++q)
    b[q] = op(b2 ? a[2 + q] : a[q], __shfl_xor_sync(FULL_MASK, b2 ? a[q] : a[2 + q], SEG / 4));
  float c = op(b1 ? b[1] : b[0], __shfl_xor_sync(FULL_MASK, b1 ? b[0] : b[1], SEG / 8));
#pragma unroll
  for (int off = SEG / 16; off > 0; off >>= 1) c = op(c, __shfl_xor_sync(FULL_MASK, c, off));
  return c;
}

template <int SEG>
__device__ __forceinline__ constexpr int emt_owner(int i) {
  return ((i >> 2) & 1) * (SEG / 2) + ((i >> 1) & 1) * (SEG / 4) + (i & 1) * (SEG / 8);
}

// Shared-memory floats of the tiled kernel with NCG component groups
// (ops/fused_em.py:EmTilePlan.smem_bytes repeats this sum).
constexpr size_t emt_smem_floats(int ncg) {
  const int kp = ncg * EMT_CT, npg = EMT_THREADS / ncg, p = npg * EMT_PT;
  const int nw = ncg > 32 ? ncg / 32 : 1;
  return (size_t)10 * kp + 20 * p + 8 * p + 2 * p * nw + (size_t)npg * kp * 10 + EMT_THREADS;
}

// NCG component groups of 8 components: K_pad = 8 NCG. The 256 threads form
// 256 / NCG point groups of 8 points: a tile is P = 2048 / NCG points.
// Thread t: component group cg = t % NCG, point group pg = t / NCG. Its
// components are j(c) = (c / 4) (K_pad / 2) + 4 cg + c % 4, c = 0..7: two
// runs of 4, so that the lanes of a warp read consecutive 16-byte words of a
// feature's weight row (no bank conflict) while they share their psi words
// (a broadcast).
template <int NCG>
__global__ void __launch_bounds__(EMT_THREADS, 1)
    em_stats_tiled_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ wn,
                          int k, int has_outlier, float outlier, float* __restrict__ partial) {
  constexpr int KP = NCG * EMT_CT;
  constexpr int NPG = EMT_THREADS / NCG;
  constexpr int P = NPG * EMT_PT;
  constexpr int SEG = NCG < 32 ? NCG : 32;  // lanes of a warp on one point group
  constexpr int NW = NCG / SEG;             // warps a point group spans
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [10][KP], feature-major
  float* psi_s = w_s + 10 * KP;                  // [2][10][P]: 9 features, then the weight
  float* raw_s = psi_s + 20 * P;                 // [2][4][P]: x, y, z, w as copied
  float* red_s = raw_s + 8 * P;                  // [2][P][NW]: max, then sum, across warps
  float* stage_s = red_s + 2 * P * NW;           // [NPG][KP * 10]
  float* ll_s = stage_s + NPG * KP * 10;         // [EMT_THREADS]
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int cg = t % NCG;
  const int pg = t / NCG;
  const int li = lane & (SEG - 1);     // position among the lanes of this point group
  const int seg0 = lane & ~(SEG - 1);  // first of them
  const int wi = cg / 32;              // this warp among the warps of the group
  // After emt_reduce8 this lane holds point `mine` of its group's eight;
  // one lane a point and warp posts it to the other warps.
  const int mine = 4 * ((li / (SEG / 2)) & 1) + 2 * ((li / (SEG / 4)) & 1) + ((li / (SEG / 8)) & 1);
  const bool posts = (li & (SEG / 8 - 1)) == 0;
  const int ntiles = (n + P - 1) / P;

  // The weight table [KP, 12] -> feature-major rows.
  for (int idx = t; idx < KP * 12; idx += EMT_THREADS) {
    const int j = idx / 12, f = idx - 12 * j;
    if (f < 10) w_s[f * KP + j] = wn[idx];
  }

  // The first 8 threads of a point group stage its 8 points of a tile: the
  // copy of the tile's rows into raw_s[buf] (zeros outside the cloud), and
  // psi of a landed copy. Nobody else reads those rows, so the point groups
  // need no barrier between them and drift apart: while one is in its exp2
  // pass (the special-function unit), its scheduler issues another's FMAs.
  const bool stager = cg < EMT_PT;
  const int row = pg * EMT_PT + cg;
  auto start_copy = [&](int tile, int buf) {
    if (stager) {
      float* dst = raw_s + buf * 4 * P + row;
      const long long i = (long long)tile * P + row;
      if (tile < ntiles && i < n) {
#pragma unroll
        for (int r = 0; r < 4; ++r) cp_async_f32(dst + r * P, pts4 + (size_t)r * n + i);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) dst[r * P] = 0.0f;
      }
    }
    cp_async_commit();
  };
  auto stage_psi = [&](int buf) {  // the thread reads what it copied itself
    if (stager) {
      const float* src = raw_s + buf * 4 * P + row;
      const Psi p = features(src[0], src[P], src[2 * P]);
      float* dst = psi_s + buf * 10 * P + row;
#pragma unroll
      for (int f = 0; f < 9; ++f) dst[f * P] = p.v[f];
      dst[9 * P] = src[3 * P];
    }
  };
  // Barrier of one point group: its NW warps, or the lanes of its one warp.
  auto group_sync = [&]() {
    if constexpr (NW > 1) {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + pg), "r"(NCG) : "memory");
    } else {
      __syncwarp();
    }
  };

  float acc[EMT_CT][10];
#pragma unroll
  for (int c = 0; c < EMT_CT; ++c)
#pragma unroll
    for (int f = 0; f < 10; ++f) acc[c][f] = 0.0f;
  float ll_acc = 0.0f;

  start_copy(blockIdx.x, 0);
  cp_async_wait_all();
  stage_psi(0);
  start_copy(blockIdx.x + gridDim.x, 1);
  __syncthreads();  // the weight table and the first tile's psi

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const float* psi = psi_s + (it & 1) * 10 * P + pg * EMT_PT;
    const float* wrow = w_s + 4 * cg;
    float* red_max = red_s + (pg * EMT_PT) * NW;  // this group's [8][NW] exchange slots
    float* red_sum = red_max + P * NW;

    // ---- One logit pass: l[i][c] = wn_j(c) . psi_i, in the order of logit().
    float l[EMT_PT][EMT_CT];
    float pv[EMT_PT], wv[EMT_CT];
    auto load_psi = [&](int f) {
      const float4 a = *reinterpret_cast<const float4*>(psi + f * P);
      const float4 b = *reinterpret_cast<const float4*>(psi + f * P + 4);
      pv[0] = a.x; pv[1] = a.y; pv[2] = a.z; pv[3] = a.w;
      pv[4] = b.x; pv[5] = b.y; pv[6] = b.z; pv[7] = b.w;
    };
    auto load_w = [&](int f) {
      const float4 a = *reinterpret_cast<const float4*>(wrow + f * KP);
      const float4 b = *reinterpret_cast<const float4*>(wrow + f * KP + KP / 2);
      wv[0] = a.x; wv[1] = a.y; wv[2] = a.z; wv[3] = a.w;
      wv[4] = b.x; wv[5] = b.y; wv[6] = b.z; wv[7] = b.w;
    };
    load_psi(0);
    load_w(0);
#pragma unroll
    for (int i = 0; i < EMT_PT; ++i)
#pragma unroll
      for (int c = 0; c < EMT_CT; ++c) l[i][c] = wv[c] * pv[i];
#pragma unroll
    for (int f = 1; f < 9; ++f) {
      load_psi(f);
      load_w(f);
#pragma unroll
      for (int i = 0; i < EMT_PT; ++i)
#pragma unroll
        for (int c = 0; c < EMT_CT; ++c) l[i][c] = fmaf(wv[c], pv[i], l[i][c]);
    }
    load_w(9);  // psi[9] == 1
#pragma unroll
    for (int i = 0; i < EMT_PT; ++i)
#pragma unroll
      for (int c = 0; c < EMT_CT; ++c) l[i][c] = wv[c] + l[i][c];

    // ---- The exact max of each point: thread, lanes, then warps.
    float m[EMT_PT];
#pragma unroll
    for (int i = 0; i < EMT_PT; ++i) {
      m[i] = l[i][0];
#pragma unroll
      for (int c = 1; c < EMT_CT; ++c) m[i] = fmaxf(m[i], l[i][c]);
    }
    float m_mine = emt_reduce8<SEG>(m, li, [](float a, float b) { return fmaxf(a, b); });
    if constexpr (NW > 1) {
      if (posts) red_max[mine * NW + wi] = m_mine;
    }
    group_sync();  // everyone of the group has left the last tile's statistics pass
    if constexpr (NW > 1) {
      m_mine = red_max[mine * NW];
#pragma unroll
      for (int w = 1; w < NW; ++w) m_mine = fmaxf(m_mine, red_max[mine * NW + w]);
    }
    if (has_outlier) m_mine = fmaxf(m_mine, outlier);
    // The next tile's psi, for after the next group_sync; then the copy of
    // the tile after it into the raw buffer just consumed.
    cp_async_wait_all();
    stage_psi((it + 1) & 1);
    start_copy(tile + 2 * gridDim.x, it & 1);

    // ---- e = exp2(l log2e - m log2e), once a pair and in place; its sum.
    float s[EMT_PT];
#pragma unroll
    for (int i = 0; i < EMT_PT; ++i) {
      const float mi = __shfl_sync(FULL_MASK, m_mine, seg0 + emt_owner<SEG>(i));
      // A dead point (every logit at the floor) gets e = 0: the floor times
      // log2e rounds, and exp2 of that residue would overflow.
      const float m2 = mi > NEG_INF ? mi * LOG2E : INFINITY;
      s[i] = 0.0f;
#pragma unroll
      for (int c = 0; c < EMT_CT; ++c) {
        l[i][c] = exp2_ftz(fmaf(l[i][c], LOG2E, -m2));
        s[i] += l[i][c];
      }
    }
    float s_mine = emt_reduce8<SEG>(s, li, [](float a, float b) { return a + b; });
    if constexpr (NW > 1) {
      if (posts) red_sum[mine * NW + wi] = s_mine;
    }
    group_sync();  // the next tile's psi is visible to the group
    if constexpr (NW > 1) {
      s_mine = red_sum[mine * NW];
#pragma unroll
      for (int w = 1; w < NW; ++w) s_mine += red_sum[mine * NW + w];
    }

    // ---- Scale and log-evidence of this lane's point (the lanes that hold
    // the same point compute the same); the scales then go round by shuffle.
    const Soft r = finish_soft(m_mine, fmaxf(m_mine, NEG_INF) * LOG2E, s_mine, has_outlier, outlier,
                               psi[9 * P + mine]);
    if (posts && wi == 0) ll_acc += r.lse;  // one lane a point

    // ---- Statistics: acc[c][:] += (scale_i e_ic) psi_i.
#pragma unroll
    for (int i = 0; i < EMT_PT; ++i) {
      const float scale = __shfl_sync(FULL_MASK, r.scale, seg0 + emt_owner<SEG>(i));
#pragma unroll
      for (int c = 0; c < EMT_CT; ++c) {
        l[i][c] *= scale;
        acc[c][9] += l[i][c];
      }
    }
#pragma unroll
    for (int f = 0; f < 9; ++f) {
      load_psi(f);
#pragma unroll
      for (int i = 0; i < EMT_PT; ++i)
#pragma unroll
        for (int c = 0; c < EMT_CT; ++c) acc[c][f] = fmaf(l[i][c], pv[i], acc[c][f]);
    }
  }

  // ---- Block partial: the point groups summed in order, then the loglik tree.
#pragma unroll
  for (int c = 0; c < EMT_CT; ++c) {
    const int j = (c / 4) * (KP / 2) + 4 * cg + (c & 3);
#pragma unroll
    for (int f = 0; f < 10; ++f) stage_s[(size_t)pg * KP * 10 + j * 10 + f] = acc[c][f];
  }
  ll_s[t] = ll_acc;
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * (k * 10 + 1);
  for (int idx = t; idx < k * 10; idx += EMT_THREADS) {
    float v = 0.0f;
    for (int g = 0; g < NPG; ++g) v += stage_s[(size_t)g * KP * 10 + idx];
    out[idx] = v;
  }
  for (int stride = EMT_THREADS / 2; stride > 0; stride >>= 1) {
    if (t < stride) ll_s[t] += ll_s[t + stride];
    __syncthreads();
  }
  if (t == 0) out[k * 10] = ll_s[0];
}

template <int NCG>
cudaError_t launch_em_stats_tiled(const float* pts4, int n, const float* wn, int k, int has_outlier,
                                  float outlier, float* partial, int nb, float* out,
                                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * emt_smem_floats(NCG);
  cudaError_t err = cudaFuncSetAttribute(em_stats_tiled_kernel<NCG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  em_stats_tiled_kernel<NCG><<<nb, EMT_THREADS, smem, stream>>>(pts4, n, wn, k, has_outlier,
                                                                outlier, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return err;
  return launch_reduce_partials(partial, nb, k * 10 + 1, out, stream);
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

}  // namespace hgmm

namespace hgmm {

// ---------------------------------------------------------------------------
// The masked E-step by parent chunks (ops/fused_em.py:group_by_parent).

constexpr int EG_BMAX = 8;            // largest branch of the grouped body (ops/fused_em.py:EG_BMAX)
constexpr int EG_WARPS = 4;           // chunks a block, one a warp
constexpr int EG_ROW = EG_BMAX * 10 + 1;  // a lane's row in the transpose (odd: no bank conflict)
constexpr int EG_MAX_PPT = 16;        // points a lane in a chunk, at most (ops/fused_em.py:EG_MAX_PPT)
// The wide body's shared memory a warp past the parent's rows: the transpose
// and two floats a point slot (ops/fused_em.py:EGW_WARP_FLOATS).
constexpr int EGW_WARP_FLOATS = 32 * EG_ROW + 2 * 32 * EG_MAX_PPT;

// chunks [n_chunks, 3] int32: (parent, first point, point count) in the
// sorted buffer pts4 [4, n]; a chunk's parent p has children j0 = p branch ..
// min(j0 + branch, k) - 1. partial [n_chunks, branch*10 + 1].
__global__ void __launch_bounds__(EG_WARPS * 32)
    em_stats_grouped_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ wn,
                            int k, int branch, const int* __restrict__ chunks, int n_chunks,
                            float* __restrict__ partial) {
  __shared__ float4 w_s[EG_WARPS][3 * EG_BMAX];
  __shared__ float tr_s[EG_WARPS][32 * EG_ROW];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int chunk = blockIdx.x * EG_WARPS + wi;
  if (chunk >= n_chunks) return;  // uniform across the warp; no block barrier below
  const int par = chunks[3 * chunk], first = chunks[3 * chunk + 1], count = chunks[3 * chunk + 2];
  const int j0 = par * branch;
  const int nc = min(branch, k - j0);
  float4* w4 = w_s[wi];
  if (lane < 3 * nc) w4[lane] = reinterpret_cast<const float4*>(wn)[3 * j0 + lane];
  __syncwarp();

  float acc[EG_BMAX][10];
#pragma unroll
  for (int c = 0; c < EG_BMAX; ++c)
#pragma unroll
    for (int f = 0; f < 10; ++f) acc[c][f] = 0.0f;
  float ll = 0.0f;
  for (int i = first + lane; i < first + count; i += 32) {
    const Psi p = features(pts4[i], pts4[(size_t)n + i], pts4[2 * (size_t)n + i]);
    const float w = pts4[3 * (size_t)n + i];
    float e[EG_BMAX];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < EG_BMAX; ++c) {
      e[c] = c < nc ? logit(w4 + 3 * c, p) : -INFINITY;
      m = fmaxf(m, e[c]);
    }
    const float m2 = fmaxf(m, NEG_INF) * LOG2E;
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < EG_BMAX; ++c) {
      e[c] = c < nc ? exp2f(fmaf(e[c], LOG2E, -m2)) : 0.0f;
      s += e[c];
    }
    const Soft r = finish_soft(m, m2, s, false, 0.0f, w);
    ll += r.lse;
    if (r.scale == 0.0f) continue;
#pragma unroll
    for (int c = 0; c < EG_BMAX; ++c) {
      const float g = e[c] * r.scale;
#pragma unroll
      for (int f = 0; f < 10; ++f) acc[c][f] = fmaf(g, p.v[f], acc[c][f]);
    }
  }
  // The warp's lanes summed in lane order: each lane posts its row, then
  // lane l adds column l, l + 32, ... over the rows.
  float* tr = tr_s[wi];
#pragma unroll
  for (int c = 0; c < EG_BMAX; ++c)
#pragma unroll
    for (int f = 0; f < 10; ++f) tr[lane * EG_ROW + c * 10 + f] = acc[c][f];
  tr[lane * EG_ROW + EG_BMAX * 10] = ll;
  __syncwarp();
  const int row = branch * 10 + 1;
  float* out = partial + (size_t)chunk * row;
  for (int col = lane; col < row; col += 32) {
    const int src = col == branch * 10 ? EG_BMAX * 10 : col;
    float v = 0.0f;
    if (col == branch * 10 || col < nc * 10)
      for (int l = 0; l < 32; ++l) v += tr[l * EG_ROW + src];
    out[col] = v;
  }
}

// The masked E-step for branch > EG_BMAX: the chunks, rows and row layout of
// em_stats_grouped_kernel, a warp a chunk, blockDim.x / 32 warps a block.
// Shared memory a warp: the parent's rows [3 branch] float4, the transpose
// [32 EG_ROW], then m log2e and the scale of each point slot [32 EG_MAX_PPT]
// each.
__global__ void __launch_bounds__(EG_WARPS * 32)
    em_stats_grouped_wide_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ wn,
                                 int k, int branch, const int* __restrict__ chunks, int n_chunks,
                                 float* __restrict__ partial) {
  extern __shared__ float4 egw_smem4[];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int chunk = blockIdx.x * (blockDim.x >> 5) + wi;
  if (chunk >= n_chunks) return;  // uniform across the warp; no block barrier below
  float4* w4 = egw_smem4 + (size_t)wi * (3 * branch + EGW_WARP_FLOATS / 4);
  float* tr = reinterpret_cast<float*>(w4 + 3 * branch);
  float* m2_s = tr + 32 * EG_ROW;
  float* sc_s = m2_s + 32 * EG_MAX_PPT;
  const int par = chunks[3 * chunk], first = chunks[3 * chunk + 1], count = chunks[3 * chunk + 2];
  const int j0 = par * branch;
  const int nc = min(branch, k - j0);
  for (int idx = lane; idx < 3 * nc; idx += 32) w4[idx] = reinterpret_cast<const float4*>(wn)[3 * j0 + idx];
  __syncwarp();

  // Pass 1: each of the lane's points over all nc children; slot = i - first.
  float ll = 0.0f;
  for (int slot = lane; slot < count; slot += 32) {
    const int i = first + slot;
    const Psi p = features(pts4[i], pts4[(size_t)n + i], pts4[2 * (size_t)n + i]);
    float m = -INFINITY;
    for (int c = 0; c < nc; ++c) m = fmaxf(m, logit(w4 + 3 * c, p));
    const float m2 = fmaxf(m, NEG_INF) * LOG2E;
    float s = 0.0f;
    for (int c = 0; c < nc; ++c) s += exp2f(fmaf(logit(w4 + 3 * c, p), LOG2E, -m2));
    const Soft r = finish_soft(m, m2, s, false, 0.0f, pts4[3 * (size_t)n + i]);
    ll += r.lse;
    m2_s[slot] = m2;
    sc_s[slot] = r.scale;
  }

  // Pass 2: a group of EG_BMAX children at a time.
  const int row = branch * 10 + 1;
  float* out = partial + (size_t)chunk * row;
  for (int g0 = 0; g0 < nc; g0 += EG_BMAX) {
    const int gc = min(EG_BMAX, nc - g0);
    const float4* wg = w4 + 3 * g0;
    float acc[EG_BMAX][10];
#pragma unroll
    for (int c = 0; c < EG_BMAX; ++c)
#pragma unroll
      for (int f = 0; f < 10; ++f) acc[c][f] = 0.0f;
    for (int slot = lane; slot < count; slot += 32) {
      const float scale = sc_s[slot];
      if (scale == 0.0f) continue;
      const float m2 = m2_s[slot];
      const int i = first + slot;
      const Psi p = features(pts4[i], pts4[(size_t)n + i], pts4[2 * (size_t)n + i]);
#pragma unroll
      for (int c = 0; c < EG_BMAX; ++c) {
        if (c >= gc) break;
        const float g = exp2f(fmaf(logit(wg + 3 * c, p), LOG2E, -m2)) * scale;
#pragma unroll
        for (int f = 0; f < 10; ++f) acc[c][f] = fmaf(g, p.v[f], acc[c][f]);
      }
    }
    __syncwarp();  // the last group's sums are read
#pragma unroll
    for (int c = 0; c < EG_BMAX; ++c)
#pragma unroll
      for (int f = 0; f < 10; ++f) tr[lane * EG_ROW + c * 10 + f] = acc[c][f];
    __syncwarp();
    for (int col = lane; col < gc * 10; col += 32) {
      float v = 0.0f;
      for (int l = 0; l < 32; ++l) v += tr[l * EG_ROW + col];
      out[g0 * 10 + col] = v;
    }
  }
  // Children past K (the last parent's) get zero columns; the loglik last.
  for (int col = nc * 10 + lane; col < branch * 10; col += 32) out[col] = 0.0f;
  __syncwarp();
  tr[lane * EG_ROW + EG_BMAX * 10] = ll;
  __syncwarp();
  if (lane == 0) {
    float v = 0.0f;
    for (int l = 0; l < 32; ++l) v += tr[l * EG_ROW + EG_BMAX * 10];
    out[branch * 10] = v;
  }
}

// out[o], o < K*10: S[j, f] = sum over the chunks of j's parent p = j /
// branch, in chunk order, of their column (j - p branch) * 10 + f (0 for a
// parent without chunks); out[K*10]: the loglik, every chunk's. One warp an
// output, float64, a lane's rows then a butterfly: a fixed order.
__global__ void em_grouped_reduce_kernel(const float* __restrict__ partial, int n_chunks, int branch,
                                         const int* __restrict__ parent_off, int k,
                                         float* __restrict__ out) {
  const int o = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (o > k * 10) return;  // o is uniform across the warp
  const int row = branch * 10 + 1;
  int r0 = 0, r1 = n_chunks, col = branch * 10;
  if (o < k * 10) {
    const int p = (o / 10) / branch;
    r0 = parent_off[p];
    r1 = parent_off[p + 1];
    col = o - p * branch * 10;
  }
  double s = 0.0;
  for (int r = r0 + lane; r < r1; r += 32) s += (double)partial[(size_t)r * row + col];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL_MASK, s, off);
  if (lane == 0) out[o] = (float)s;
}

}  // namespace hgmm

extern "C" {

// S and loglik of em_ref.em_stats into out[K*10 + 1] (S row-major, then
// loglik) by the first kernel body, K <= 32, `lanes` lanes a point (1, 2 or
// 4, at least K / 8). wn is [>= K, 12]; partial is [nb, K*10 + 1], the
// body's rows; out NULL: the body alone (a fit's sweep, whose em_step sums the
// rows). Returns the CUDA error code of the launches (0 on success).
int hgmm_em_stats(const void* pts4, int n, const void* wn, int k, int lanes, int has_outlier,
                  float outlier, void* partial, int nb, void* out, void* stream) {
  if (k < 1 || k >= hgmm::ES_KMAX || k > hgmm::ES_CT * lanes || nb < 1) return (int)cudaErrorInvalidValue;
  const auto p = static_cast<const float*>(pts4);
  const auto w = static_cast<const float*>(wn);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return (int)hgmm::launch_em_stats<1>(p, n, w, k, has_outlier, outlier, part, nb, o, s);
    case 2: return (int)hgmm::launch_em_stats<2>(p, n, w, k, has_outlier, outlier, part, nb, o, s);
    case 4: return (int)hgmm::launch_em_stats<4>(p, n, w, k, has_outlier, outlier, part, nb, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same S and loglik for an unmasked call with K >= 33 through the
// register-tiled kernel: wn is [k_pad, 12] with rows k..k_pad-1 at the mask
// floor, k_pad one of 64, 128, ..., 2048; partial is [nb, K*10 + 1] scratch
// with nb <= the SM count; out NULL: the body alone. Returns the CUDA error
// code (cudaErrorInvalidValue for a k_pad outside the list).
int hgmm_em_stats_tiled(const void* pts4, int n, const void* wn, int k, int k_pad, int has_outlier,
                        float outlier, void* partial, int nb, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const float*>(pts4);
  const auto w = static_cast<const float*>(wn);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<float*>(out);
  switch (k_pad) {
    case 64: return (int)hgmm::launch_em_stats_tiled<8>(p, n, w, k, has_outlier, outlier, part, nb, o, s);
    case 128: return (int)hgmm::launch_em_stats_tiled<16>(p, n, w, k, has_outlier, outlier, part, nb, o, s);
    case 256: return (int)hgmm::launch_em_stats_tiled<32>(p, n, w, k, has_outlier, outlier, part, nb, o, s);
    case 512: return (int)hgmm::launch_em_stats_tiled<64>(p, n, w, k, has_outlier, outlier, part, nb, o, s);
    case 1024: return (int)hgmm::launch_em_stats_tiled<128>(p, n, w, k, has_outlier, outlier, part, nb, o, s);
    case 2048: return (int)hgmm::launch_em_stats_tiled<256>(p, n, w, k, has_outlier, outlier, part, nb, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// S and loglik of em_ref.em_stats_masked into out[K*10 + 1], from the
// parent-sorted buffer pts4 [4, n] and its chunk table (chunks [n_chunks, 3]:
// parent, first point, count; parent_off [ceil(K / branch) + 1]: the first
// chunk of each parent, then n_chunks). partial is [n_chunks, branch*10 + 1],
// the body's rows; out NULL: the body alone. branch <= 8 runs the grouped
// body, branch > 8 the wide one with `warps` (1, 2 or 4) warps a block
// (ops/fused_em.py:plan_grouped_wide); a chunk holds at most 32 EG_MAX_PPT
// points. Returns the CUDA error code of the launches.
int hgmm_em_stats_grouped(const void* pts4, int n, const void* wn, int k, int branch,
                          const void* chunks, int n_chunks, const void* parent_off, int warps,
                          void* partial, void* out, void* stream) {
  using namespace hgmm;
  const auto s = static_cast<cudaStream_t>(stream);
  if (branch < 1 || (branch > EG_BMAX && warps != 1 && warps != 2 && warps != 4))
    return (int)cudaErrorInvalidValue;
  if (n_chunks > 0 && branch <= EG_BMAX) {
    const int blocks = (n_chunks + EG_WARPS - 1) / EG_WARPS;
    em_stats_grouped_kernel<<<blocks, EG_WARPS * 32, 0, s>>>(
        static_cast<const float*>(pts4), n, static_cast<const float*>(wn), k, branch,
        static_cast<const int*>(chunks), n_chunks, static_cast<float*>(partial));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else if (n_chunks > 0) {
    const size_t smem = (size_t)warps * (sizeof(float4) * 3 * branch + sizeof(float) * EGW_WARP_FLOATS);
    cudaError_t err = cudaFuncSetAttribute(em_stats_grouped_wide_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    em_stats_grouped_wide_kernel<<<(n_chunks + warps - 1) / warps, warps * 32, smem, s>>>(
        static_cast<const float*>(pts4), n, static_cast<const float*>(wn), k, branch,
        static_cast<const int*>(chunks), n_chunks, static_cast<float*>(partial));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (out == nullptr) return (int)cudaSuccess;
  em_grouped_reduce_kernel<<<(k * 10 + 1 + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(partial), n_chunks, branch, static_cast<const int*>(parent_off), k,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* hgmm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
