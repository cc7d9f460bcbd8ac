// One step of the registration iterate, on the card: the pose solve of
// hgmm_torch/pipelines/register.py:run_registration_scan.
//
// A new kernel with no TPU counterpart: the reference runs the same
// arithmetic as XLA ops inside its lax.scan (hgmm/pipelines/register.py:
// run_registration_scan). Plain twin: hgmm_torch/ops/em_ref.py:reg_step,
// which calls the torch code of models/pose.py and models/se3.py.
//
// The scan's state lives in one float32 buffer on the card (layout in
// hgmm_kernels.cuh: the pose reg_stats reads, the iteration's start pose, the
// iteration's loglik, the last live loglik and delta, the done flag, the live
// steps). One launch of B blocks of 4 x 59 threads: one block while the rows are one
// batch of loads (nb <= 256), past it a thread block cluster of 8
// (ops/fused_em.py:plan_reg_step):
//   1. the [nb, 59] partials of reg_stats are summed in float64 in a fixed
//      order, coalesced: the rows are one stream of passes of 944 floats (16
//      rows), pass i read by block i mod B, thread t the float4 at 4 t of
//      each, so its four floats always meet the same (row of the pass,
//      column) slots; sixteen passes a block in flight at once, pass u on
//      accumulator u mod 4, added in pairs; a block's 16 rows of a pass in
//      order through shared memory; each block writes its columns into block
//      0's shared memory (distributed shared memory), and after the cluster
//      barrier block 0 adds them in rank order (its warp 0 reads the scan
//      state meanwhile);
//   2. warp 0 of block 0 solves in float64: Horn (solve_horn: H = U S V^T by a
//      one-sided Jacobi SVD, R = V diag(1, 1, det(V U^T)) U^T with U's third
//      column u1 x u2, t = nubar - R xbar), or the damped, capped
//      Gauss-Newton step (solve_wls_increment: Marquardt and Tikhonov terms,
//      6 x 6 LU with partial pivoting, the rotation norm capped at 0.3) with
//      a lane a row of the augmented [6, 7] system and the pivot found by
//      shuffles, followed by se3_exp and the left composition;
//   3. on the iteration's last step, delta = |se3_log(new o start^-1)| of the
//      poses as stored (float32), the outputs logliks[it] and deltas[it], and
//      done |= delta < tol.
// A step run with done unset adds one to the live steps (lane 0 of block 0,
// the one thread that writes the state). Once done is set, a step changes
// nothing and its last one re-emits the last live (loglik, delta), the
// reference's contract.
//
// What bounds it: latency. It moves 59 nb floats and solves a 3 x 3 SVD or a
// 6 x 6 system: a few microseconds of dependent float64 work, against the
// tens of small torch launches and the host sync of an iteration that it
// replaces. The design keeps the dependent chain short:
//   - the rows are read coalesced, a float4 a thread, 16 loads in flight (a
//     warp whose lanes stride down the rows fetches 32 sectors for 128 useful
//     bytes); past one batch of loads on 8 SMs: one SM takes ~0.8 us a batch
//     of 60 KB, and a cluster launch and its barrier ~1 us; at 528 rows the
//     cluster takes ~1.25 us less than one block (PERF.md);
//   - W and V of the Jacobi stay in registers (no dynamically indexed array);
//     a rotation takes one square root, one division and one reciprocal
//     square root, and tests convergence without a square root (ga^2 > 1e-30
//     al be);
//   - sine and cosine come from one sincos; the LU's rows are eliminated in
//     parallel lanes.
#include <cooperative_groups.h>

#include "hgmm_kernels.cuh"

namespace hgmm {

constexpr int STEP_OUT = 59;
constexpr int STEP_THREADS = 4 * STEP_OUT;    // 236: a float4 a thread, 16 rows a pass
constexpr int STEP_WINDOW = 4 * STEP_THREADS;  // floats a pass of the block
constexpr int STEP_WROWS = STEP_WINDOW / STEP_OUT;  // 16 rows a pass
constexpr int STEP_UNROLL = 16;                // passes a block has in flight at once
constexpr int STEP_CLUSTER = 8;                // blocks of a launch past one batch of passes: one cluster

struct Pose64 {
  double R[9];  // row-major
  double t[3];
};

__device__ __forceinline__ void load_pose(const float* s, Pose64* p) {
  for (int c = 0; c < 9; ++c) p->R[c] = s[c];
  for (int c = 0; c < 3; ++c) p->t[c] = s[9 + c];
}

__device__ __forceinline__ void store_pose(float* s, const Pose64& p) {
  for (int c = 0; c < 9; ++c) s[c] = (float)p.R[c];
  for (int c = 0; c < 3; ++c) s[9 + c] = (float)p.t[c];
}

__device__ __forceinline__ void matmul3(const double* a, const double* b, double* c) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

__device__ __forceinline__ void matvec3(const double* a, const double* v, double* out) {
  for (int i = 0; i < 3; ++i) out[i] = a[3 * i] * v[0] + a[3 * i + 1] * v[1] + a[3 * i + 2] * v[2];
}

__device__ __forceinline__ void cross3(const double* a, const double* b, double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ double dot3(const double* a, const double* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

// models/se3.py:_series_coeffs: a = sin t / t, b = (1 - cos t) / t^2,
// c = (t - sin t) / t^3, Taylor series below theta^2 = 1e-8.
__device__ __forceinline__ void series(double theta2, double* a, double* b, double* c) {
  const double theta = sqrt(theta2 + 1e-32);
  if (theta2 < 1e-8) {
    *a = 1.0 - theta2 / 6.0;
    *b = 0.5 - theta2 / 24.0;
    *c = 1.0 / 6.0 - theta2 / 120.0;
  } else {
    double sn, cs;
    sincos(theta, &sn, &cs);
    *a = sn / theta;
    *b = (1.0 - cs) / theta2;
    *c = (theta - sn) / (theta2 * theta + 1e-32);
  }
}

__device__ __forceinline__ void hat(const double* w, double* K) {
  K[0] = 0.0;   K[1] = -w[2]; K[2] = w[1];
  K[3] = w[2];  K[4] = 0.0;   K[5] = -w[0];
  K[6] = -w[1]; K[7] = w[0];  K[8] = 0.0;
}

// I + p K + q K^2
__device__ __forceinline__ void series_matrix(const double* w, double p, double q, double* out) {
  double K[9], KK[9];
  hat(w, K);
  matmul3(K, K, KK);
  for (int i = 0; i < 9; ++i) out[i] = (i % 4 == 0 ? 1.0 : 0.0) + p * K[i] + q * KK[i];
}

// models/se3.py:se3_exp
__device__ __forceinline__ void se3_exp(const double* xi, Pose64* out) {
  double a, b, c, V[9];
  series(dot3(xi, xi), &a, &b, &c);
  series_matrix(xi, a, b, out->R);
  series_matrix(xi, b, c, V);
  matvec3(V, xi + 3, out->t);
}

// models/se3.py:se3_log (so3_log, then V^-1 t by Cramer's rule)
__device__ __forceinline__ void se3_log(const Pose64& p, double* xi) {
  const double* R = p.R;
  double w[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const double w2 = dot3(w, w);
  const double cth = fmin(fmax((R[0] + R[4] + R[8] - 1.0) * 0.5, -1.0), 1.0);
  const bool small = w2 < 1e-12;
  const double s = 0.5 * sqrt(small ? 1.0 : w2);
  const double scale = small ? 0.5 + w2 / 48.0 : atan2(s, cth) / (2.0 * s);
  for (int i = 0; i < 3; ++i) xi[i] = scale * w[i];
  double a, b, c, V[9];
  series(dot3(xi, xi), &a, &b, &c);
  series_matrix(xi, b, c, V);
  const double c0[3] = {V[0], V[3], V[6]}, c1[3] = {V[1], V[4], V[7]}, c2[3] = {V[2], V[5], V[8]};
  double x12[3], x20[3], x01[3];
  cross3(c1, c2, x12);
  cross3(c2, c0, x20);
  cross3(c0, c1, x01);
  const double det = dot3(c0, x12);
  xi[3] = dot3(p.t, x12) / det;
  xi[4] = dot3(p.t, x20) / det;
  xi[5] = dot3(p.t, x01) / det;
}

// models/pose.py:solve_horn from the Horn moments h [4, 4] row-major.
__device__ __forceinline__ void solve_horn(const double* h, Pose64* out) {
  const double Sw = fmax(h[15], 1e-9);
  const double Sx[3] = {h[3], h[7], h[11]};
  const double Snu[3] = {h[12], h[13], h[14]};
  double W[9], V[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) W[3 * a + b] = h[4 * a + b] - Sx[a] * Snu[b] / Sw;
  // One-sided Jacobi: rotate column pairs of W (and V) until they are
  // orthogonal; then W = H V = U S.
  for (int sweep = 0; sweep < 30; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int pq = 0; pq < 3; ++pq) {
      const int p = pq == 2 ? 1 : 0, q = pq == 0 ? 1 : 2;
      double al = 0.0, be = 0.0, ga = 0.0;
      for (int i = 0; i < 3; ++i) {
        al += W[3 * i + p] * W[3 * i + p];
        be += W[3 * i + q] * W[3 * i + q];
        ga += W[3 * i + p] * W[3 * i + q];
      }
      // |ga| > 1e-15 sqrt(al be), squared: no square root on the chain
      if (!(ga * ga > 1e-30 * (al * be))) continue;
      rotated = true;
      // t = sign(zeta) / (|zeta| + sqrt(1 + zeta^2)), zeta = (be - al) / (2 ga),
      // with numerator and denominator times |2 ga|: one division, not two
      const double d = be - al, g2 = 2.0 * ga;
      const double sgn = (d == 0.0 || (d > 0.0) == (ga > 0.0)) ? 1.0 : -1.0;
      const double tt = sgn * fabs(g2) / (fabs(d) + sqrt(d * d + g2 * g2));
      const double c = rsqrt(1.0 + tt * tt), s = c * tt;
      for (int i = 0; i < 3; ++i) {
        const double wp = W[3 * i + p], wq = W[3 * i + q];
        W[3 * i + p] = c * wp - s * wq;
        W[3 * i + q] = s * wp + c * wq;
        const double vp = V[3 * i + p], vq = V[3 * i + q];
        V[3 * i + p] = c * vp - s * vq;
        V[3 * i + q] = s * vp + c * vq;
      }
    }
    if (!rotated) break;
  }
  // Columns by singular value, largest first: the bubble sort of (value,
  // column) pairs, swapping on a strictly smaller value (ties keep the lower
  // column first); the columns then picked by selects, so W and V stay in
  // registers.
  double sig[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) sig[j] = sqrt(W[j] * W[j] + W[3 + j] * W[3 + j] + W[6 + j] * W[6 + j]);
  double s0 = sig[0], s1 = sig[1], s2 = sig[2];
  int o0 = 0, o1 = 1, o2 = 2;
  if (s0 < s1) { const double x = s0; s0 = s1; s1 = x; const int y = o0; o0 = o1; o1 = y; }
  if (s1 < s2) { const double x = s1; s1 = s2; s2 = x; const int y = o1; o1 = o2; o2 = y; }
  if (s0 < s1) { const double x = s0; s0 = s1; s1 = x; const int y = o0; o0 = o1; o1 = y; }
  const int ord[3] = {o0, o1, o2};
  double u[3][3], v[3][3];  // u[j], v[j]: the j-th singular vectors
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int c = ord[j];
      u[j][i] = c == 0 ? W[3 * i] : (c == 1 ? W[3 * i + 1] : W[3 * i + 2]);
      v[j][i] = c == 0 ? V[3 * i] : (c == 1 ? V[3 * i + 1] : V[3 * i + 2]);
    }
  double R[9];
  if (!(s0 > 0.0)) {  // H = 0: torch's SVD gives U = V = I, so R = I
    for (int i = 0; i < 9; ++i) R[i] = i % 4 == 0 ? 1.0 : 0.0;
  } else {
    for (int i = 0; i < 3; ++i) u[0][i] /= s0;
    const double d01 = dot3(u[0], u[1]);
    for (int i = 0; i < 3; ++i) u[1][i] -= d01 * u[0][i];
    double n1 = sqrt(dot3(u[1], u[1]));
    if (!(n1 > 1e-300)) {  // rank one: any unit vector orthogonal to u1
      const int ax = fabs(u[0][0]) < 0.5 ? 0 : (fabs(u[0][1]) < 0.5 ? 1 : 2);
      const double e[3] = {ax == 0 ? 1.0 : 0.0, ax == 1 ? 1.0 : 0.0, ax == 2 ? 1.0 : 0.0};
      cross3(u[0], e, u[1]);
      n1 = sqrt(dot3(u[1], u[1]));
    }
    for (int i = 0; i < 3; ++i) u[1][i] /= n1;
    cross3(u[0], u[1], u[2]);  // det U = +1, so det(V U^T) = det V
    double dv[3];
    cross3(v[0], v[1], dv);
    const double d = dot3(dv, v[2]) < 0.0 ? -1.0 : 1.0;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        R[3 * a + b] = v[0][a] * u[0][b] + v[1][a] * u[1][b] + d * v[2][a] * u[2][b];
  }
  double Rx[3];
  const double xbar[3] = {Sx[0] / Sw, Sx[1] / Sw, Sx[2] / Sw};
  matvec3(R, xbar, Rx);
  for (int i = 0; i < 9; ++i) out->R[i] = R[i];
  for (int i = 0; i < 3; ++i) out->t[i] = Snu[i] / Sw - Rx[i];
}

// models/pose.py:solve_wls_increment (damping 1e-6, marquardt 1e-2,
// max_rot 0.3) from A [6, 6] row-major and b [6], on a whole warp: lane r < 6
// holds row r of the augmented [M | b] (lanes 6.. a copy of row 5 that is
// never chosen); the pivot of column c is the lowest row index with the
// largest |M[r][c]|, r >= c (the sequential scan's choice), found by three
// xor shuffles; the rows below it are eliminated at once, each with the
// arithmetic of the sequential LU; then back substitution, one row a step.
// Every lane returns the same xi.
__device__ __forceinline__ void solve_wls(const double* A, const double* b, int lane, double* xi) {
  double sumd = 0.0;
  for (int i = 0; i < 6; ++i) sumd += A[7 * i];
  const double damp = 1e-6 * fmax(sumd / 6.0, 1.0);
  const int row = min(lane, 5);
  double m[7];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    m[j] = A[6 * row + j];
    if (j == row) m[j] = m[j] + 1e-2 * fmax(A[7 * row], 1e-12 * sumd) + damp;
  }
  m[6] = b[row];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    double best = lane >= c && lane < 6 ? fabs(m[c]) : -1.0;
    int at = lane;
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      const double ob = __shfl_xor_sync(FULL_MASK, best, off);
      const int oa = __shfl_xor_sync(FULL_MASK, at, off);
      if (ob > best || (ob == best && oa < at)) {
        best = ob;
        at = oa;
      }
    }
    const int piv = __shfl_sync(FULL_MASK, at, 0);
    const int src = lane == c ? piv : (lane == piv ? c : lane);
#pragma unroll
    for (int j = c; j < 7; ++j) m[j] = __shfl_sync(FULL_MASK, m[j], src);
    double pr[7];
#pragma unroll
    for (int j = c; j < 7; ++j) pr[j] = __shfl_sync(FULL_MASK, m[j], c);
    if (lane > c && lane < 6) {
      const double f = m[c] / pr[c];
#pragma unroll
      for (int j = c; j < 7; ++j) m[j] -= f * pr[j];
    }
  }
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    double v = m[6];
#pragma unroll
    for (int j = r + 1; j < 6; ++j) v -= m[j] * xi[j];
    xi[r] = __shfl_sync(FULL_MASK, v / m[r], r);
  }
  const double rot = sqrt(dot3(xi, xi));
  const double scale = fmin(0.3 / fmax(rot, 1e-12), 1.0);
  for (int i = 0; i < 6; ++i) xi[i] *= scale;
}

__global__ void __launch_bounds__(STEP_THREADS)
    reg_step_kernel(const float* __restrict__ partial, int nb, float* __restrict__ scan,
                    float* __restrict__ logliks, float* __restrict__ deltas, int it, int solver,
                    int first, int last, double tol) {
  __shared__ double window_s[STEP_WROWS][STEP_OUT];
  __shared__ double gather_s[STEP_CLUSTER][STEP_OUT];  // block 0: every block's column sums, by rank
  __shared__ double sums[STEP_OUT];
  // The grid is one cluster (or one block): a block's rank is its index.
  const int rank = blockIdx.x, blocks = gridDim.x, t = threadIdx.x;
  // Every block reads the flag before the cluster barrier, block 0 writes the
  // state only after it: the branch is the same in every block, and a done
  // scan waits at no barrier.
  if (scan[SCAN_DONE] != 0.0f) {
    if (rank == 0 && t == 0 && last) {
      logliks[it] = scan[SCAN_LL_LAST];
      deltas[it] = scan[SCAN_D_LAST];
    }
    return;
  }
  // A cluster's first barrier phase: arrive now, wait before the first write
  // into block 0's shared memory, which must have started by then.
  if (blocks > 1) asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  float state[25];  // block 0, warp 0: the pose, the iteration's start pose, its loglik, read while the rows come in
  if (rank == 0 && t < 32) {
#pragma unroll
    for (int c = 0; c < 12; ++c) state[c] = scan[SCAN_POSE + c];
#pragma unroll
    for (int c = 0; c < 12; ++c) state[12 + c] = first ? state[c] : scan[SCAN_START + c];
    state[24] = scan[SCAN_LL];
  }
  {
    // Pass i covers rows 16 i .. 16 i + 15 and belongs to block i mod B;
    // thread t reads its float4 at 4 t, so its four floats always meet the
    // same (row of the pass, column) slots. A block loads STEP_UNROLL of its
    // passes at once (those past the last full one as zeros), the ragged last
    // pass (its block's) before them; pass u of a batch adds to accumulator
    // u mod 4, the ragged pass to the first, last.
    const int full = nb / STEP_WROWS;
    const size_t tail = (size_t)full * STEP_WINDOW + 4 * t, floats = (size_t)nb * STEP_OUT;
    const bool mine = full % blocks == rank;
    float tv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) tv[q] = mine && tail + q < floats ? __ldg(partial + tail + q) : 0.0f;
    double acc[4][4] = {};
    const float4* src = reinterpret_cast<const float4*>(partial) + t;
    for (int i0 = rank; i0 < full; i0 += STEP_UNROLL * blocks) {
      float4 v[STEP_UNROLL];
#pragma unroll
      for (int u = 0; u < STEP_UNROLL; ++u) {
        const int i = i0 + u * blocks;
        v[u] = i < full ? __ldg(src + (size_t)i * STEP_THREADS) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < STEP_UNROLL; ++u) {
        acc[u & 3][0] += v[u].x;
        acc[u & 3][1] += v[u].y;
        acc[u & 3][2] += v[u].z;
        acc[u & 3][3] += v[u].w;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[0][q] += tv[q];
      const int slot = 4 * t + q;
      window_s[slot / STEP_OUT][slot % STEP_OUT] = (acc[0][q] + acc[1][q]) + (acc[2][q] + acc[3][q]);
    }
  }
  __syncthreads();
  if (blocks > 1) asm volatile("barrier.cluster.wait;\n" ::: "memory");
  if (t < STEP_OUT) {  // the block's column: its 16 rows of a pass in order
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < STEP_WROWS; ++w) v += window_s[w][t];
    if (blocks == 1) {
      sums[t] = v;
    } else {  // into block 0's shared memory, through distributed shared memory
      cooperative_groups::this_cluster().map_shared_rank(&gather_s[0][0], 0)[rank * STEP_OUT + t] = v;
    }
  }
  if (blocks > 1) {
    // The second phase: every block's sums are in block 0 (release and
    // acquire), and the other blocks, read by no one, may exit.
    cooperative_groups::this_cluster().sync();
    if (rank != 0) return;
    if (t < STEP_OUT) {  // the blocks in rank order
      double v = 0.0;
      for (int b = 0; b < blocks; ++b) v += gather_s[b][t];
      sums[t] = v;
    }
  }
  __syncthreads();
  if (t >= 32) return;  // warp 0 of block 0 solves
  const int lane = t;
  Pose64 cur, start;
  load_pose(state, &cur);
  load_pose(state + 12, &start);
  const float ll = first ? (float)sums[58] : state[24];
  Pose64 nw;
  if (solver == 0) {
    solve_horn(sums, &nw);
  } else {
    double xi[6];
    Pose64 e;
    solve_wls(sums + 16, sums + 52, lane, xi);
    se3_exp(xi, &e);
    matmul3(e.R, cur.R, nw.R);
    matvec3(e.R, cur.t, nw.t);
    for (int i = 0; i < 3; ++i) nw.t[i] += e.t[i];
  }
  __syncwarp();  // every lane has read the state
  if (lane == 0) {
    if (first) {
      store_pose(scan + SCAN_START, start);
      scan[SCAN_LL] = ll;
    }
    store_pose(scan + SCAN_POSE, nw);
    scan[SCAN_LIVE] += 1.0f;  // a live step; read by no block of this launch
  }
  if (!last) return;
  // delta of the poses as stored (float32): new o start^-1
  Pose64 p, rel;
  for (int c = 0; c < 9; ++c) p.R[c] = (float)nw.R[c];
  for (int c = 0; c < 3; ++c) p.t[c] = (float)nw.t[c];
  double St[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) St[3 * a + b] = start.R[3 * b + a];
  matmul3(p.R, St, rel.R);
  double Rs[3];
  matvec3(rel.R, start.t, Rs);
  for (int i = 0; i < 3; ++i) rel.t[i] = p.t[i] - Rs[i];
  double xi[6];
  se3_log(rel, xi);
  double d2 = 0.0;
  for (int i = 0; i < 6; ++i) d2 += xi[i] * xi[i];
  const double delta = sqrt(d2);
  if (lane == 0) {
    logliks[it] = ll;
    deltas[it] = (float)delta;
    scan[SCAN_LL_LAST] = ll;
    scan[SCAN_D_LAST] = (float)delta;
    if (delta < tol) scan[SCAN_DONE] = 1.0f;
  }
}

// One reg_step launch on `s` (hgmm_reg_step's arguments); the scan's one
// call (csrc/reg_stats.cu:hgmm_reg_scan) launches its steps through it too.
cudaError_t launch_reg_step(const float* partial, int nb, float* scan, float* logliks, float* deltas, int it,
                            int solver, int first, int last, double tol, int blocks, cudaStream_t s) {
  if (nb < 1 || solver < 0 || solver > 1 || reinterpret_cast<size_t>(partial) % 16 != 0 ||
      (blocks != 1 && blocks != STEP_CLUSTER))
    return cudaErrorInvalidValue;
  if (blocks == 1) {  // a plain launch: a cluster launch, even of one block, costs ~1 us more (PERF.md)
    reg_step_kernel<<<1, STEP_THREADS, 0, s>>>(partial, nb, scan, logliks, deltas, it, solver, first, last, tol);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(STEP_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // the whole grid is one cluster
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, reg_step_kernel, partial, nb, scan, logliks, deltas, it, solver, first, last, tol);
}

}  // namespace hgmm

extern "C" {

// One registration step on the scan state `scan` (float32, layout in
// hgmm_kernels.cuh) from the [nb, 59] partials of reg_stats. solver: 0 Horn,
// 1 Gauss-Newton. first: the iteration's first step (records its start pose
// and loglik); last: its last (writes logliks[it], deltas[it], done). blocks:
// 1 or STEP_CLUSTER, one cluster (ops/fused_em.py:plan_reg_step). partial is
// 16-byte aligned. Returns the CUDA error code of the launch.
int hgmm_reg_step(const void* partial, int nb, void* scan, void* logliks, void* deltas, int it,
                  int solver, int first, int last, double tol, int blocks, void* stream) {
  return (int)hgmm::launch_reg_step(static_cast<const float*>(partial), nb, static_cast<float*>(scan),
                                    static_cast<float*>(logliks), static_cast<float*>(deltas), it, solver, first,
                                    last, tol, blocks, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
