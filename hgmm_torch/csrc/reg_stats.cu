// Registration E-step statistics with the pose applied in the kernel.
//
// Replaces the TPU kernel hgmm/ops/fused_em.py:_reg_stats_kernel. Plain twin:
// hgmm_torch/ops/em_ref.py:reg_stats.
//
// Per point: y = R x + t, psi(y), the softmax over K with the optional
// outlier, and the unnormalized contraction red = sum_j e_j [mu_j | A6_j |
// b3_j] (12 values). With gamma = scale * e:
//   nu = gamma mu, M = sym(gamma A6), u = gamma b3, w_eff = sum_j gamma_j,
//   horn += [x, 1]^T [nu, w_eff]                      (16, x untransformed)
//   r = M y - u, J = [-[y]_x | I], A += J^T M J (21), b -= J^T r (6)
//   loglik += w lse.
// The 44 sums stay in registers over the thread's points; the block reduces
// them by warp butterflies and then over warps in order, and writes a [59]
// partial (horn 16, A 36 filled symmetric, b 6, loglik). The partials are
// summed in a fixed order in float64: by reduce_partials (hgmm_reg_stats with
// an output), or by the registration step kernel (csrc/reg_step.cu), which
// reads them directly inside a registration scan.
//
// What bounds it on the card: at K = 512 arithmetic (10 FMA for a logit, one
// exp2 and 13 FMA a point and component), at K = 8 the 16 bytes a point and
// the launch. Three bodies, chosen in Python (ops/fused_em.py:plan_reg_stats):
//
// reg_stats_lanes_kernel<L, 1> (no top_k): L lanes of a warp share a point and
//   split its K components (lane l takes j = l, l + L, ...), so a call at the
//   odometry bucket (N = 16,384) runs L times as many threads as points and
//   fills the card; L is 1 where the points alone fill it. Each logit is
//   evaluated ONCE: a lane takes its components in chunks of RS_CHUNK held in
//   registers and keeps a running max m, its sum s and its red[12] relative
//   to m, rescaled by exp2(m_old - m_new) once a chunk (an online softmax).
//   The L lanes then merge (m, s, red) by xor shuffles in a fixed order; lane
//   0 of the group adds the outlier term and the point's statistics.
//
// reg_stats_lanes_kernel<1, TP> (no top_k, TP = 4: the tiled body, where
//   the points fill the card several times over). At one lane a point the
//   body runs, for each point and component, six broadcast LDS.128 (the
//   weight row for the logit, the aux row for the sums) beside its ~23 FMA,
//   the exp2f's range fix-up, the j < k test and the loop's bookkeeping:
//   it is bound by the instructions a scheduler can start, not by the
//   float32 pipe the roofline counts. The tile holds TP of the thread's grid-stride points in
//   registers (psi, m, s, red: 23 floats each; x is read again and y is
//   psi's linear part at the end), so each row read from shared memory once
//   a chunk feeds TP points and the loop's bookkeeping is paid once for TP;
//   the TP chains are independent, which hides the FMA and LDS latencies at
//   one block an SM. The tables are padded in shared memory to a multiple of
//   RS_CHUNK rows with inert rows (logit -inf, aux 0: e = 0), so the inner
//   loop has no j < k test, and a chunk's exp2 and its rescale are one
//   MUFU.EX2 each (exp2_ftz). Each point's arithmetic is otherwise the
//   one-lane body's, in its order, and a thread adds its points in the same
//   order, so on the same grid the partials are the one-lane body's, bit for
//   bit (tests/test_torch_kernels.py; exp2_ftz differs only where a term is
//   below 2^-126 of the point's largest). SASS instructions a point and
//   component in the chunk loop (cuobjdump, sm_90a): 46.3 at one point a
//   thread (370 for a chunk of 8), 32.9 at 4 (1,053 for 8 components of 4
//   points), against the 22.5 FMA the roofline counts.
//
// reg_stats_top_k_kernel<KMAX, C> (top_k gating, em_ref.top_k_mask_logits):
//   one thread a point, its K components in chunks of C consecutive ones (C
//   from the plan, ops/fused_em.py:plan_top_k_chunk). Pass 1 evaluates each
//   logit once and keeps only each chunk's max (fmaxf, no branch). The chunk
//   goes into a sorted register list of the KMAX largest as one unsigned key,
//   the max's order-preserving bits with the low ones replaced by the
//   chunk's number, so an insertion is two integer min/max an entry, each
//   from the old list (no chain through the stages), and runs K / C times a
//   point instead of up to K. KMAX = 9 for top_k <= 8 and 33
//   for top_k <= 32. The top_k largest keys' chunks hold top_k components at
//   or above xb, their top_k-th key cut to its high bits, so the threshold
//   th (the top_k-th largest logit, with multiplicity) is too, and every kept
//   logit (>= th) lies in a chunk whose key is >= xb: the list's entries >=
//   xb, unless the list's last entry reaches xb (ties, or maxima within the
//   cut bits); then every chunk is taken. Stage 2 evaluates the taken
//   chunks' logits again with the same logit(), so they are the same floats,
//   into a list of the KMAX - 1 largest with their components (a compare and
//   four selects an entry, again from the old list): th is its top_k-th, and the kept components
//   are its entries >= th (ties at th kept, NaN never, the outlier never
//   gated), or, when more tie with th than it holds, the taken chunks' logits
//   >= th. Pass 1's reads are the same row for every thread of a warp (a
//   broadcast); stage 2's are a row of the thread's own, which the warp's
//   threads read with bank conflicts, so C trades the insertions against
//   them. With `counters` (int64 [3], or null: a uniform branch) each block
//   adds, one atomic each, the points it gated, the chunks stage 2 took and
//   the points that took every chunk.
//
// reg_stats_select_kernel (top_k gating with 32 < top_k < K): a list of
//   top_k logits in registers would spill, so a warp takes a point. Its lanes
//   evaluate the K logits once into the warp's slice of shared memory (lane
//   l takes j = l, l + 32, ...) and their max by butterflies. The threshold
//   th, the top_k-th largest logit counted with multiplicity
//   (em_ref.top_k_mask_logits), is found exactly by an MSB-first radix
//   select over order-preserving 32-bit keys: 4 passes of 8 bits, each a
//   256-bin histogram of the keys that share the digits found so far (lanes
//   of one digit add their count once, by __match_any_sync), a scan over the
//   bins from the top and a ballot for the bin that holds the top_k-th. A
//   NaN logit sorts below -inf and is never kept, as in the register bodies.
//   Then each lane sums e and red[12] over its kept logits (>= th, so ties
//   at th are kept; the outlier is never gated), the lanes merge by
//   butterflies, and lane 0 adds the point's statistics. The aux table is
//   read from global memory (L1), so the weight table, the warps' K logits,
//   their histograms and the sums fit in shared memory up to K = 2,048
//   (ops/fused_em.py:reg_select_smem_bytes). What bounds it: float32
//   arithmetic, 10 FMA a logit and the 4 passes over the K keys a point.
//
// Inside a registration scan the kernel reads the scan's done flag and
// returns at once when it is set (the flag is uniform, so every block takes
// the same branch); the step kernel then ignores the partials.
#include "hgmm_kernels.cuh"

namespace hgmm {

constexpr int NACC = 44;   // horn 16 + A upper 21 + b 6 + loglik 1
constexpr int NOUT = 59;   // horn 16 + A 36 + b 6 + loglik 1
constexpr int RS_THREADS = 256;
constexpr int RS_WARPS = RS_THREADS / 32;
constexpr int RS_CHUNK = 8;  // components of a lane between two rescales

// Load the weight and aux tables ([K, 12] each, three float4 a row) into
// shared memory as kp >= k rows: rows k..kp-1 are inert, zero weights and a
// bias of -inf (logit -inf, so e = 0), aux 0.
__device__ __forceinline__ void load_tables(float4* w4, float4* a4, const float* wn, const float* aux,
                                            int k, int kp) {
  for (int idx = threadIdx.x; idx < 3 * kp; idx += RS_THREADS) {
    const bool real = idx < 3 * k;
    w4[idx] = real ? reinterpret_cast<const float4*>(wn)[idx]
                   : make_float4(0.0f, idx % 3 == 2 ? -INFINITY : 0.0f, 0.0f, 0.0f);  // bias c.y
    a4[idx] = real ? reinterpret_cast<const float4*>(aux)[idx] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// red += e [mu_j | A6_j | b3_j] from row j of aux as three float4 (a, b, c).
__device__ __forceinline__ void add_aux3(float (&red)[12], float e, const float4 a, const float4 b,
                                         const float4 c) {
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

// The same with the row in shared memory.
__device__ __forceinline__ void add_aux(float (&red)[12], float e, const float4* a4, int j) {
  add_aux3(red, e, a4[3 * j], a4[3 * j + 1], a4[3 * j + 2]);
}

// A point's statistics from its contraction red, Gaussian sum s and softmax
// scale sc (= w / normalizer): horn, the upper triangle of A, and b.
__device__ __forceinline__ void add_point(float (&acc)[NACC], float x0, float x1, float x2, float y0,
                                          float y1, float y2, const float (&red)[12], float s,
                                          float sc) {
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
  for (int a = 0; a < 6; ++a) acc[37 + a] -= J[0][a] * rr[0] + J[1][a] * rr[1] + J[2][a] * rr[2];
}

// Block reduction in a fixed order (warp butterflies, then warps in order)
// and the block's [59] partial row.
__device__ __forceinline__ void write_partial(float (&acc)[NACC], float* red_s, float* partial) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int c = 0; c < NACC; ++c) {
    float v = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
    if (lane == 0) red_s[warp * NACC + c] = v;
  }
  __syncthreads();
  if (t < NACC) {
    float v = 0.0f;
    for (int ww = 0; ww < RS_WARPS; ++ww) v += red_s[ww * NACC + t];
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

// exp2((a - m) log2e), exactly 1 where a == m (also a == m == -inf).
__device__ __forceinline__ float rescale(float a, float m) {
  return a == m ? 1.0f : exp2f((a - m) * LOG2E);
}

// exp2(x) by the SFU alone (one MUFU.EX2): a result below 2^-126 is 0, where
// exp2f's range fix-up (a compare and two FMUL) keeps it subnormal. Next to
// the point's largest term, 1, such a term adds nothing.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rescale() with exp2_ftz.
__device__ __forceinline__ float rescale_ftz(float a, float m) {
  return a == m ? 1.0f : exp2_ftz((a - m) * LOG2E);
}

// The tiled body's table rows: K rounded up to RS_CHUNK.
__host__ __device__ constexpr int tiled_rows(int k) { return (k + RS_CHUNK - 1) / RS_CHUNK * RS_CHUNK; }

// Q points of one thread, i, i + stride, ..., i + (Q - 1) stride, all < n,
// through the component loop together: each weight and aux row read from
// shared memory once a chunk feeds Q points, whose psi, m, s and red stay in
// registers. Each point's arithmetic is the lanes body's at one lane, in its
// order (the logits of a chunk, its max, one rescale, then the chunk's exp2
// and sums; the outlier term, finish_soft, add_point), with exp2_ftz for the
// chunk's terms and rescale, and the points are added to acc in the
// thread's order.
template <int Q>
__device__ __forceinline__ void reg_tile(float (&acc)[NACC], const float* __restrict__ pts4, int n, long long i,
                                         long long stride, const float* pose, const float4* w4, const float4* a4,
                                         int kp, int has_outlier, float outlier) {
  Psi p[Q];
  float m[Q], s[Q], red[Q][12];
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const long long iu = i + u * stride;
    const float x0 = pts4[iu], x1 = pts4[(size_t)n + iu], x2 = pts4[2 * (size_t)n + iu];
    p[u] = features(fmaf(pose[0], x0, fmaf(pose[1], x1, fmaf(pose[2], x2, pose[9]))),
                    fmaf(pose[3], x0, fmaf(pose[4], x1, fmaf(pose[5], x2, pose[10]))),
                    fmaf(pose[6], x0, fmaf(pose[7], x1, fmaf(pose[8], x2, pose[11]))));
    m[u] = -INFINITY;
    s[u] = 0.0f;
#pragma unroll
    for (int c = 0; c < 12; ++c) red[u][c] = 0.0f;
  }
  for (int j0 = 0; j0 < kp; j0 += RS_CHUNK) {
    float l[Q][RS_CHUNK], mc[Q];
#pragma unroll
    for (int u = 0; u < Q; ++u) mc[u] = m[u];
#pragma unroll
    for (int q = 0; q < RS_CHUNK; ++q) {
      const float4* w = w4 + 3 * (j0 + q);
      const float4 a = w[0], b = w[1], c = w[2];
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        l[u][q] = logit3(a, b, c, p[u]);
        mc[u] = fmaxf(mc[u], l[u][q]);
      }
    }
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const float f = rescale_ftz(m[u], mc[u]);
      s[u] = __fmul_rn(s[u], f);  // rounded apart, as the one-lane body's: no FMA with the chunk's first term
#pragma unroll
      for (int c = 0; c < 12; ++c) red[u][c] *= f;
      m[u] = mc[u];
    }
#pragma unroll
    for (int q = 0; q < RS_CHUNK; ++q) {
      const float4* x = a4 + 3 * (j0 + q);
      const float4 a = x[0], b = x[1], c = x[2];
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        const float e = exp2_ftz((l[u][q] - m[u]) * LOG2E);
        s[u] += e;
        add_aux3(red[u], e, a, b, c);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const long long iu = i + u * stride;
    if (has_outlier && outlier > m[u]) {
      const float f = rescale(m[u], outlier);
      s[u] *= f;
#pragma unroll
      for (int c = 0; c < 12; ++c) red[u][c] *= f;
      m[u] = outlier;
    }
    const Soft r = finish_soft(m[u], fmaxf(m[u], NEG_INF) * LOG2E, s[u], has_outlier, outlier,
                               pts4[3 * (size_t)n + iu]);
    acc[NACC - 1] += r.lse;
    if (r.scale == 0.0f) continue;  // dead or zero-weight: no statistics
    // x read again; y is psi's linear part.
    add_point(acc, pts4[iu], pts4[(size_t)n + iu], pts4[2 * (size_t)n + iu], p[u].v[6], p[u].v[7], p[u].v[8],
              red[u], s[u], r.scale);
  }
}

// The lanes body at one lane and TP > 1 points a thread: a thread takes its
// grid-stride points (i = block RS_THREADS + thread, then + stride) in
// order, TP at a time while TP remain, then 2 (TP = 4) and 1 at a time.
template <int TP>
__device__ __forceinline__ void reg_stats_tiled(const float* __restrict__ pts4, int n,
                                                const float* __restrict__ pose12, const float* __restrict__ wn,
                                                const float* __restrict__ aux, int k, int has_outlier,
                                                float outlier, float* __restrict__ partial, float4* smem4) {
  __shared__ float pose[12];  // read a point at a time: registers for the tile
  const int kp = tiled_rows(k);  // no j < k test in the component loop
  float4* w4 = smem4;
  float4* a4 = w4 + 3 * kp;
  float* red_s = reinterpret_cast<float*>(a4 + 3 * kp);
  load_tables(w4, a4, wn, aux, k, kp);
  if (threadIdx.x < 12) pose[threadIdx.x] = pose12[threadIdx.x];
  float acc[NACC];
#pragma unroll
  for (int c = 0; c < NACC; ++c) acc[c] = 0.0f;
  __syncthreads();

  const long long stride = (long long)gridDim.x * RS_THREADS;
  long long i = (long long)blockIdx.x * RS_THREADS + threadIdx.x;
  for (; i + (TP - 1) * stride < n; i += TP * stride)
    reg_tile<TP>(acc, pts4, n, i, stride, pose, w4, a4, kp, has_outlier, outlier);
  if constexpr (TP > 2) {
    if (i + stride < n) {
      reg_tile<2>(acc, pts4, n, i, stride, pose, w4, a4, kp, has_outlier, outlier);
      i += 2 * stride;
    }
  }
  if (i < n) reg_tile<1>(acc, pts4, n, i, stride, pose, w4, a4, kp, has_outlier, outlier);
  write_partial(acc, red_s, partial);
}

// Registers for 2 blocks an SM (128 a thread), except at TP = 4: its tile
// (psi, m, s, red and a chunk's logits of 4 points, beside acc) takes 240,
// one block an SM (at TP = 2, capped at 128, it spilled and ran slower).
template <int L, int TP>
__global__ void __launch_bounds__(RS_THREADS, TP == 4 ? 1 : 2)
    reg_stats_lanes_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ pose12,
                           const float* __restrict__ done, const float* __restrict__ wn,
                           const float* __restrict__ aux, int k, int has_outlier, float outlier,
                           float* __restrict__ partial) {
  static_assert(TP == 1 || L == 1, "several points a thread only at one lane a point");
  if (done != nullptr && *done != 0.0f) return;  // a converged scan: same branch in every block
  extern __shared__ float4 smem4[];
  if constexpr (TP > 1) {
    reg_stats_tiled<TP>(pts4, n, pose12, wn, aux, k, has_outlier, outlier, partial, smem4);
    return;
  }
  float4* w4 = smem4;
  float4* a4 = w4 + 3 * k;
  float* red_s = reinterpret_cast<float*>(a4 + 3 * k);
  load_tables(w4, a4, wn, aux, k, k);
  float P[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) P[c] = pose12[c];  // R row-major, then t
  float acc[NACC];
#pragma unroll
  for (int c = 0; c < NACC; ++c) acc[c] = 0.0f;
  __syncthreads();

  constexpr int PPW = 32 / L;  // points a warp takes at once
  const int lane = threadIdx.x & 31;
  const int li = lane % L;
  const long long warp_id = (long long)blockIdx.x * RS_WARPS + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * RS_WARPS * PPW;
  // The loop condition is uniform across the warp (its first point), so the
  // shuffles below always run with every lane.
  for (long long i0 = warp_id * PPW; i0 < n; i0 += stride) {
    const long long i = i0 + lane / L;
    const bool valid = i < n;
    const float x0 = valid ? pts4[i] : 0.0f, x1 = valid ? pts4[(size_t)n + i] : 0.0f;
    const float x2 = valid ? pts4[2 * (size_t)n + i] : 0.0f;
    const float w = valid ? pts4[3 * (size_t)n + i] : 0.0f;
    const float y0 = fmaf(P[0], x0, fmaf(P[1], x1, fmaf(P[2], x2, P[9])));
    const float y1 = fmaf(P[3], x0, fmaf(P[4], x1, fmaf(P[5], x2, P[10])));
    const float y2 = fmaf(P[6], x0, fmaf(P[7], x1, fmaf(P[8], x2, P[11])));
    const Psi p = features(y0, y1, y2);

    // This lane's components j = li + L (RS_CHUNK c + q), each logit once
    // (an online softmax): a chunk's logits in registers, its max, one
    // rescale of (s, red) a chunk, whether the max grew or not (a branch on
    // it would diverge across the warp at nearly every chunk), then its
    // exp2 and sums. Past K a logit is -inf and adds nothing.
    float m = -INFINITY, s = 0.0f;
    float red[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) red[c] = 0.0f;
    for (int j0 = li; j0 < k; j0 += RS_CHUNK * L) {
      float l[RS_CHUNK];
      float mc = m;
#pragma unroll
      for (int q = 0; q < RS_CHUNK; ++q) {
        const int j = j0 + q * L;
        l[q] = j < k ? logit(w4 + 3 * j, p) : -INFINITY;
        mc = fmaxf(mc, l[q]);
      }
      const float f = rescale(m, mc);
      s *= f;
#pragma unroll
      for (int c = 0; c < 12; ++c) red[c] *= f;
      m = mc;
#pragma unroll
      for (int q = 0; q < RS_CHUNK; ++q) {
        const int j = j0 + q * L;
        if (j < k) {
          const float e = exp2f((l[q] - m) * LOG2E);
          s += e;
          add_aux(red, e, a4, j);
        }
      }
    }
    // The group's lanes merge in a fixed order.
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(FULL_MASK, m, off);
      const float so = __shfl_xor_sync(FULL_MASK, s, off);
      const float mm = fmaxf(m, mo);
      const float fa = rescale(m, mm), fb = rescale(mo, mm);
      s = s * fa + so * fb;
#pragma unroll
      for (int c = 0; c < 12; ++c) red[c] = red[c] * fa + __shfl_xor_sync(FULL_MASK, red[c], off) * fb;
      m = mm;
    }
    if (li != 0 || !valid) continue;
    if (has_outlier && outlier > m) {
      const float f = rescale(m, outlier);
      s *= f;
#pragma unroll
      for (int c = 0; c < 12; ++c) red[c] *= f;
      m = outlier;
    }
    const Soft r = finish_soft(m, fmaxf(m, NEG_INF) * LOG2E, s, has_outlier, outlier, w);
    acc[NACC - 1] += r.lse;
    if (r.scale == 0.0f) continue;  // dead or zero-weight: no statistics
    add_point(acc, x0, x1, x2, y0, y1, y2, red, s, r.scale);
  }
  write_partial(acc, red_s, partial);
}

// Insert v (not NaN) with its index vi into the descending list (top, idx):
// of equal values the one inserted first stays ahead. Each entry is chosen
// from the old list (keep it, take the one above, or take v), so the stages
// do not wait on each other.
template <int N>
__device__ __forceinline__ void insert_indexed(float (&top)[N], int (&idx)[N], float v, int vi) {
#pragma unroll
  for (int c = N - 1; c > 0; --c) {
    const bool here = v > top[c], above = v > top[c - 1];
    top[c] = here ? (above ? top[c - 1] : v) : top[c];
    idx[c] = here ? (above ? idx[c - 1] : vi) : idx[c];
  }
  if (v > top[0]) {
    top[0] = v;
    idx[0] = vi;
  }
}

// Insert key into the descending list of keys: entry c becomes
// max(min(key, top[c - 1]), top[c]) of the old list, two integer min/max
// that do not wait on the other entries.
template <int N>
__device__ __forceinline__ void insert_key(unsigned (&top)[N], unsigned key) {
#pragma unroll
  for (int c = N - 1; c > 0; --c) top[c] = max(min(key, top[c - 1]), top[c]);
  top[0] = max(key, top[0]);
}

// top[r - 1] for 1 <= r <= N, without indexing the registers at run time.
template <typename T, int N>
__device__ __forceinline__ T nth(const T (&top)[N], int r) {
  T v = top[0];
#pragma unroll
  for (int c = 1; c < N; ++c)
    if (c < r) v = top[c];
  return v;
}

// A key that orders float32 values as unsigned integers; NaN is 0, below -inf.
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return 0u;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

constexpr int TK_COUNTERS = 3;  // points gated, chunks stage 2 took, points that took every chunk

// The top_k body's shared memory: the weight table by chunks, a chunk of C
// rows in 3 C float4s and one of padding when 3 C is even (the stride is
// odd, so the chunks that a warp's threads read in stage 2 start on every
// bank quad), the aux table, the warps' sums (ops/fused_em.py:
// reg_top_k_smem_bytes).
size_t reg_top_k_smem_bytes(int k, int chunk) {
  const int stride = 3 * chunk + (chunk % 2 == 0 ? 1 : 0);
  return sizeof(float4) * ((size_t)(k + chunk - 1) / chunk * stride + 3 * (size_t)k) +
         sizeof(float) * RS_WARPS * NACC;
}

template <int KMAX, int C>
__global__ void __launch_bounds__(RS_THREADS)
    reg_stats_top_k_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ pose12,
                           const float* __restrict__ done, const float* __restrict__ wn,
                           const float* __restrict__ aux, int k, int top_k, int has_outlier,
                           float outlier, float* __restrict__ partial,
                           unsigned long long* __restrict__ counters) {
  if (done != nullptr && *done != 0.0f) return;
  constexpr int WS = 3 * C + (C % 2 == 0 ? 1 : 0);  // float4s a chunk (reg_top_k_smem_bytes)
  const int nch = (k + C - 1) / C, nfull = k / C;
  extern __shared__ float4 smem4[];
  __shared__ unsigned cnt_s[TK_COUNTERS];
  __shared__ float P[12];  // the pose, read a point at a time: registers for the lists
  float4* w4 = smem4;  // chunk c's row q at w4 + c WS + 3 q
  float4* a4 = w4 + nch * WS;
  float* red_s = reinterpret_cast<float*>(a4 + 3 * k);
  for (int idx = threadIdx.x; idx < 3 * k; idx += RS_THREADS) {
    const int j = idx / 3;
    w4[j / C * WS + 3 * (j % C) + idx % 3] = reinterpret_cast<const float4*>(wn)[idx];
    a4[idx] = reinterpret_cast<const float4*>(aux)[idx];
  }
  if (threadIdx.x < TK_COUNTERS) cnt_s[threadIdx.x] = 0u;
  if (threadIdx.x < 12) P[threadIdx.x] = pose12[threadIdx.x];
  float acc[NACC];
#pragma unroll
  for (int c = 0; c < NACC; ++c) acc[c] = 0.0f;
  __syncthreads();

  const unsigned low = (2u << (31 - __clz(max(nch - 1, 1)))) - 1u;  // the bits of a chunk's number
  unsigned taken = 0u, every = 0u;
  const int first = blockIdx.x * RS_THREADS + threadIdx.x, stride = gridDim.x * RS_THREADS;
  for (int i = first; i < n; i += stride) {
    const float x0 = pts4[i], x1 = pts4[(size_t)n + i], x2 = pts4[2 * (size_t)n + i];
    const float w = pts4[3 * (size_t)n + i];
    const float y0 = fmaf(P[0], x0, fmaf(P[1], x1, fmaf(P[2], x2, P[9])));
    const float y1 = fmaf(P[3], x0, fmaf(P[4], x1, fmaf(P[5], x2, P[10])));
    const float y2 = fmaf(P[6], x0, fmaf(P[7], x1, fmaf(P[8], x2, P[11])));
    const Psi p = features(y0, y1, y2);

    // Pass 1: each logit once; a chunk's max mc goes into the list as the
    // key (order_key(mc) with its low bits replaced by the chunk's number),
    // so a key orders chunks by their maxima cut to the high bits, and the
    // list of the KMAX largest keys, descending, holds chunk and max alike.
    unsigned key[KMAX];
#pragma unroll
    for (int c = 0; c < KMAX; ++c) key[c] = 0u;  // below every chunk's key
    for (int c = 0; c < nch; ++c) {
      float cm = -INFINITY;  // a NaN logit is dropped here
      const float4* wc = w4 + c * WS;
      if (c < nfull) {
#pragma unroll
        for (int q = 0; q < C; ++q) cm = fmaxf(cm, logit(wc + 3 * q, p));
      } else {
        for (int q = 0; q < k - c * C; ++q) cm = fmaxf(cm, logit(wc + 3 * q, p));
      }
      const unsigned kc = (order_key(cm + 0.0f) & ~low) | (unsigned)c;  // -0 as +0
      if (kc > key[KMAX - 1]) insert_key(key, kc);
    }
    // The top_k largest keys' chunks hold top_k components at or above the
    // cut value xb, so the threshold th is too, and every kept logit lies in
    // a chunk whose key is >= xb: the list's entries >= xb (a prefix), or
    // every chunk when the list's last entry reaches xb.
    const unsigned xb = nth(key, top_k) & ~low;
    const bool all = key[KMAX - 1] >= xb;
    int ntake = nch;
    if (!all) {
      ntake = 0;
#pragma unroll
      for (int c = 0; c < KMAX - 1; ++c) ntake += key[c] >= xb;
    }
    taken += ntake;
    every += all;

    // Stage 2: the taken chunks' logits again, the same floats, into a list
    // of the KMAX - 1 largest with their components; th is its top_k-th, and
    // its head the point's max (the max's chunk is always taken).
    float t2[KMAX - 1];
    int i2[KMAX - 1];
#pragma unroll
    for (int c = 0; c < KMAX - 1; ++c) {
      t2[c] = -INFINITY;
      i2[c] = 0;
    }
    for (int e = 0; e < ntake; ++e) {
      const int c = all ? e : (int)(nth(key, e + 1) & low);
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int j = c * C + q;
        if (j >= k) continue;
        const float v = logit(w4 + c * WS + 3 * q, p);
        if (v > t2[KMAX - 2]) insert_indexed(t2, i2, v, j);
      }
    }
    const float th = nth(t2, top_k);
    const float m = has_outlier ? fmaxf(t2[0], outlier) : t2[0];
    const float m2 = fmaxf(m, NEG_INF) * LOG2E;

    // The kept components only (>= th: ties at th kept, NaN never).
    float s = 0.0f;
    float red[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) red[c] = 0.0f;
    if (!(t2[KMAX - 2] >= th)) {
#pragma unroll
      for (int c = 0; c < KMAX - 1; ++c) {
        if (t2[c] >= th) {
          const float e = exp2f(fmaf(t2[c], LOG2E, -m2));
          s += e;
          add_aux(red, e, a4, i2[c]);
        }
      }
    } else {  // more ties at th than the list holds: the taken chunks again
      for (int e = 0; e < ntake; ++e) {
        const int c = all ? e : (int)(nth(key, e + 1) & low);
        for (int j = c * C; j < min(c * C + C, k); ++j) {
          const float l = logit(w4 + c * WS + 3 * (j - c * C), p);
          if (!(l >= th)) continue;
          const float ex = exp2f(fmaf(l, LOG2E, -m2));
          s += ex;
          add_aux(red, ex, a4, j);
        }
      }
    }
    const Soft r = finish_soft(m, m2, s, has_outlier, outlier, w);
    acc[NACC - 1] += r.lse;
    if (r.scale == 0.0f) continue;
    add_point(acc, x0, x1, x2, y0, y1, y2, red, s, r.scale);
  }
  if (counters != nullptr) {  // the same branch in every block
    const unsigned gated = first < n ? (n - 1 - first) / stride + 1 : 0;  // the points this thread took
    const unsigned v[TK_COUNTERS] = {gated, taken, every};
#pragma unroll
    for (int q = 0; q < TK_COUNTERS; ++q) {
      const unsigned sum = __reduce_add_sync(FULL_MASK, v[q]);
      if ((threadIdx.x & 31) == 0) atomicAdd(&cnt_s[q], sum);
    }
    __syncthreads();
    if (threadIdx.x < TK_COUNTERS) atomicAdd(counters + threadIdx.x, (unsigned long long)cnt_s[threadIdx.x]);
  }
  write_partial(acc, red_s, partial);
}

constexpr int RSS_BINS = 256;  // a radix digit of 8 bits

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__global__ void __launch_bounds__(RS_THREADS)
    reg_stats_select_kernel(const float* __restrict__ pts4, int n, const float* __restrict__ pose12,
                            const float* __restrict__ done, const float* __restrict__ wn,
                            const float* __restrict__ aux, int k, int top_k, int has_outlier,
                            float outlier, float* __restrict__ partial) {
  if (done != nullptr && *done != 0.0f) return;
  extern __shared__ float4 smem4[];
  float4* w4 = smem4;                                              // [3 k]
  float* lg_all = reinterpret_cast<float*>(w4 + 3 * k);            // [RS_WARPS][k]
  unsigned* hist_all = reinterpret_cast<unsigned*>(lg_all + (size_t)RS_WARPS * k);  // [RS_WARPS][256]
  float* red_s = reinterpret_cast<float*>(hist_all + RS_WARPS * RSS_BINS);          // [RS_WARPS * NACC]
  for (int idx = threadIdx.x; idx < 3 * k; idx += RS_THREADS)
    w4[idx] = reinterpret_cast<const float4*>(wn)[idx];
  const float4* a4 = reinterpret_cast<const float4*>(aux);
  float P[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) P[c] = pose12[c];
  float acc[NACC];
#pragma unroll
  for (int c = 0; c < NACC; ++c) acc[c] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* lg = lg_all + (size_t)warp * k;
  unsigned* hist = hist_all + warp * RSS_BINS;
  // A warp a point; i is uniform across the warp.
  for (long long i = (long long)blockIdx.x * RS_WARPS + warp; i < n; i += (long long)gridDim.x * RS_WARPS) {
    const float x0 = pts4[i], x1 = pts4[(size_t)n + i], x2 = pts4[2 * (size_t)n + i];
    const float w = pts4[3 * (size_t)n + i];
    const float y0 = fmaf(P[0], x0, fmaf(P[1], x1, fmaf(P[2], x2, P[9])));
    const float y1 = fmaf(P[3], x0, fmaf(P[4], x1, fmaf(P[5], x2, P[10])));
    const float y2 = fmaf(P[6], x0, fmaf(P[7], x1, fmaf(P[8], x2, P[11])));
    const Psi p = features(y0, y1, y2);

    // The K logits, once, and their max.
    float m = -INFINITY;
    for (int j = lane; j < k; j += 32) {
      const float l = logit(w4 + 3 * j, p);
      lg[j] = l;
      m = fmaxf(m, l);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, off));
    __syncwarp();

    // The top_k-th largest key: 8 bits a pass, most significant first.
    // `want` counts the keys still to pass among those with the prefix.
    unsigned prefix = 0u, mask = 0u, want = (unsigned)top_k;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int b = lane; b < RSS_BINS; b += 32) hist[b] = 0u;
      __syncwarp();
      for (int j0 = 0; j0 < k; j0 += 32) {  // uniform, for __match_any_sync
        const int j = j0 + lane;
        const unsigned key = j < k ? order_key(lg[j]) : 0u;
        const bool in = j < k && (key & mask) == prefix;
        const unsigned digit = in ? (key >> shift) & 0xffu : RSS_BINS;
        const unsigned peers = __match_any_sync(FULL_MASK, digit);
        if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], (unsigned)__popc(peers));
      }
      __syncwarp();
      // Lane l holds the digits 255 - 8 l down to 248 - 8 l.
      unsigned cnt[8], tot = 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        cnt[q] = hist[RSS_BINS - 1 - 8 * lane - q];
        tot += cnt[q];
      }
      unsigned incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(FULL_MASK, incl, off);
        if (lane >= off) incl += v;
      }
      const unsigned excl = incl - tot;
      const int src = __ffs(__ballot_sync(FULL_MASK, excl < want && want <= incl)) - 1;
      unsigned digit = 0u, above = excl;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (above + cnt[q] >= want) {
          digit = RSS_BINS - 1 - 8 * lane - q;
          break;
        }
        above += cnt[q];
      }
      digit = __shfl_sync(FULL_MASK, digit, src);
      above = __shfl_sync(FULL_MASK, above, src);
      want -= above;
      prefix |= digit << shift;
      mask |= 0xffu << shift;
      __syncwarp();  // the histogram is read before the next pass clears it
    }
    const float th = key_value(prefix);

    // The kept components: e and red over this lane's, then the lanes merged.
    const float mo = has_outlier ? fmaxf(m, outlier) : m;
    const float m2 = fmaxf(mo, NEG_INF) * LOG2E;
    float s = 0.0f;
    float red[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) red[c] = 0.0f;
    for (int j = lane; j < k; j += 32) {
      const float l = lg[j];
      if (!(l >= th)) continue;
      const float e = exp2f(fmaf(l, LOG2E, -m2));
      s += e;
      add_aux(red, e, a4, j);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(FULL_MASK, s, off);
#pragma unroll
      for (int c = 0; c < 12; ++c) red[c] += __shfl_xor_sync(FULL_MASK, red[c], off);
    }
    __syncwarp();  // lg is read before the next point writes it
    if (lane != 0) continue;
    const Soft r = finish_soft(mo, m2, s, has_outlier, outlier, w);
    acc[NACC - 1] += r.lse;
    if (r.scale == 0.0f) continue;
    add_point(acc, x0, x1, x2, y0, y1, y2, red, s, r.scale);
  }
  write_partial(acc, red_s, partial);
}

// Shared memory of the select body: the weight table, the warps' logits and
// histograms, the warps' sums (ops/fused_em.py:reg_select_smem_bytes).
size_t reg_select_smem_bytes(int k) {
  return sizeof(float4) * 3 * (size_t)k + sizeof(float) * RS_WARPS * (size_t)k +
         sizeof(unsigned) * RS_WARPS * RSS_BINS + sizeof(float) * RS_WARPS * NACC;
}

size_t reg_stats_smem_bytes(int k) {
  return sizeof(float4) * 6 * (size_t)k + sizeof(float) * RS_WARPS * NACC;
}

template <typename Kernel, typename... Args>
cudaError_t launch_reg(Kernel kernel, int nb, size_t smem, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<nb, RS_THREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

// go(kernel, smem, args...) with the top_k body of a list of KMAX and chunks
// of `chunk` components.
template <int KMAX, typename Go, typename... Args>
cudaError_t with_top_k(int chunk, int k, Go& go, Args... args) {
  const size_t smem = reg_top_k_smem_bytes(k, chunk);
  switch (chunk) {
    case 1: return go(reg_stats_top_k_kernel<KMAX, 1>, smem, args...);
    case 2: return go(reg_stats_top_k_kernel<KMAX, 2>, smem, args...);
    case 4: return go(reg_stats_top_k_kernel<KMAX, 4>, smem, args...);
    case 8: return go(reg_stats_top_k_kernel<KMAX, 8>, smem, args...);
    case 16: return go(reg_stats_top_k_kernel<KMAX, 16>, smem, args...);
    default: return cudaErrorInvalidValue;
  }
}

// go(kernel, smem, args...) with the body that top_k, lanes, points and chunk
// select (hgmm_reg_stats' arguments), its dynamic shared memory and its
// arguments: the one choice of a body, for a launch and for a scan's launches.
template <typename Go>
cudaError_t with_reg_body(const float* p, int n, const float* pose, const float* dn, const float* w,
                          const float* a, int k, int top_k, int lanes, int points, int chunk, int has_outlier,
                          float outlier, float* part, unsigned long long* cnt, Go go) {
  const size_t smem = reg_stats_smem_bytes(k);
  if (top_k < 0 || top_k >= k) return cudaErrorInvalidValue;
  if (top_k > 32)
    return go(reg_stats_select_kernel, reg_select_smem_bytes(k), p, n, pose, dn, w, a, k, top_k, has_outlier,
              outlier, part);
  if (top_k > 8) return with_top_k<33>(chunk, k, go, p, n, pose, dn, w, a, k, top_k, has_outlier, outlier, part, cnt);
  if (top_k > 0) return with_top_k<9>(chunk, k, go, p, n, pose, dn, w, a, k, top_k, has_outlier, outlier, part, cnt);
  if (lanes == 1 && points == 4)
    return go(reg_stats_lanes_kernel<1, 4>, reg_stats_smem_bytes(tiled_rows(k)), p, n, pose, dn, w, a, k,
              has_outlier, outlier, part);
  if (points != 1) return cudaErrorInvalidValue;
  switch (lanes) {
    case 1: return go(reg_stats_lanes_kernel<1, 1>, smem, p, n, pose, dn, w, a, k, has_outlier, outlier, part);
    case 2: return go(reg_stats_lanes_kernel<2, 1>, smem, p, n, pose, dn, w, a, k, has_outlier, outlier, part);
    case 4: return go(reg_stats_lanes_kernel<4, 1>, smem, p, n, pose, dn, w, a, k, has_outlier, outlier, part);
    case 8: return go(reg_stats_lanes_kernel<8, 1>, smem, p, n, pose, dn, w, a, k, has_outlier, outlier, part);
    case 16: return go(reg_stats_lanes_kernel<16, 1>, smem, p, n, pose, dn, w, a, k, has_outlier, outlier, part);
    case 32: return go(reg_stats_lanes_kernel<32, 1>, smem, p, n, pose, dn, w, a, k, has_outlier, outlier, part);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hgmm

extern "C" {

// The [nb, 59] partials of em_ref.reg_stats at the pose pose12 = [R
// row-major (9), t (3)] (and, with out != NULL, their float64 sum into
// out[59]: horn 16, A 36, b 6, loglik). wn and aux are [K, 12]. top_k: 0 =
// no gating (the lanes body with `lanes` in {1, 2, 4, 8, 16, 32}, and at one
// lane `points` in {1, 4} points a thread; 1 at more lanes), 1..32 <
// K the top_k body with chunks of `chunk` in {1, 2, 4, 8, 16} components
// and, when counters != NULL, its int64 [3] counters, 33..K-1 the select
// body (a warp a point, `lanes` ignored). `points` is read by the ungated
// body alone, `chunk` and `counters` by the top_k body alone. done: NULL, or a flag the kernel returns on when it
// is nonzero. Returns the CUDA error code (0 on success).
int hgmm_reg_stats(const void* pts4, int n, const void* pose12, const void* done, const void* wn,
                   const void* aux, int k, int top_k, int lanes, int points, int chunk, int has_outlier,
                   float outlier, void* partial, int nb, void* counters, void* out, void* stream) {
  using namespace hgmm;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  const cudaError_t err = with_reg_body(
      static_cast<const float*>(pts4), n, static_cast<const float*>(pose12), static_cast<const float*>(done),
      static_cast<const float*>(wn), static_cast<const float*>(aux), k, top_k, lanes, points, chunk, has_outlier,
      outlier, part, static_cast<unsigned long long*>(counters),
      [&](auto kernel, size_t smem, auto... args) { return launch_reg(kernel, nb, smem, s, args...); });
  if (err != cudaSuccess || out == nullptr) return (int)err;
  return (int)launch_reduce_partials(part, nb, NOUT, static_cast<float*>(out), s);
}

// A registration scan's `steps` steps on its state `scan` (float32, layout in
// hgmm_kernels.cuh), from one host call: for each step the reg_stats launch
// of hgmm_reg_stats at the pose scan[SCAN_POSE..] with the done flag
// scan[SCAN_DONE] (no sum), then the reg_step launch of hgmm_reg_step on its
// [nb, 59] partials, both on `stream`, in the order and with the arguments
// of those two entries called a step at a time. The reg_stats arguments
// are hgmm_reg_stats'; logliks, deltas, tol and blocks hgmm_reg_step's.
// schedule: [steps, 4] ints on the host, a step's (it, solver, first, last)
// (pipelines/register.py:scan_schedule). The body's dynamic shared memory is
// set once a call. Returns the first nonzero CUDA code, with the index of
// its step in *failed_step, else 0.
int hgmm_reg_scan(const void* pts4, int n, void* scan, const void* wn, const void* aux, int k, int top_k,
                  int lanes, int points, int chunk, int has_outlier, float outlier, void* partial, int nb, void* counters,
                  void* logliks, void* deltas, double tol, int blocks, const int* schedule, int steps,
                  int* failed_step, void* stream) {
  using namespace hgmm;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* state = static_cast<float*>(scan);
  auto* part = static_cast<float*>(partial);
  int step = 0;
  const cudaError_t err = with_reg_body(
      static_cast<const float*>(pts4), n, state + SCAN_POSE, state + SCAN_DONE, static_cast<const float*>(wn),
      static_cast<const float*>(aux), k, top_k, lanes, points, chunk, has_outlier, outlier, part,
      static_cast<unsigned long long*>(counters), [&](auto kernel, size_t smem, auto... args) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        for (; e == cudaSuccess && step < steps; ++step) {
          const int* row = schedule + 4 * step;
          kernel<<<nb, RS_THREADS, smem, s>>>(args...);
          e = cudaGetLastError();
          if (e == cudaSuccess)
            e = launch_reg_step(part, nb, state, static_cast<float*>(logliks), static_cast<float*>(deltas), row[0],
                                row[1], row[2], row[3], tol, blocks, s);
          if (e != cudaSuccess) break;  // `step` stays the failed one's
        }
        return e;
      });
  if (err != cudaSuccess) *failed_step = step;
  return (int)err;
}

}  // extern "C"
