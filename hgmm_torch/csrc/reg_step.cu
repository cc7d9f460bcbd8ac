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
// iteration's loglik, the last live loglik and delta, the done flag). One
// launch, one block:
//   1. the [nb, 59] partials of reg_stats are summed in float64 in a fixed
//      order (each warp takes outputs o = warp, warp + 8, ...; a lane the
//      rows lane, lane + 32, ...; then a butterfly), the reduce_partials of
//      this path;
//   2. one thread solves in float64: Horn (solve_horn: H = U S V^T by a
//      one-sided Jacobi SVD, R = V diag(1, 1, det(V U^T)) U^T with U's third
//      column u1 x u2, t = nubar - R xbar), or the damped, capped
//      Gauss-Newton step (solve_wls_increment: Marquardt and Tikhonov terms,
//      6 x 6 LU with partial pivoting, the rotation norm capped at 0.3)
//      followed by se3_exp and the left composition;
//   3. on the iteration's last step, delta = |se3_log(new o start^-1)|, the
//      outputs logliks[it] and deltas[it], and done |= delta < tol.
// Once done is set, a step changes nothing and its last one re-emits the
// last live (loglik, delta), the reference's contract.
//
// What bounds it: latency. It moves 59 nb floats and solves a 3 x 3 SVD or a
// 6 x 6 system: a few microseconds of one thread, against the tens of small
// torch launches and the host sync of an iteration that it replaces.
#include "hgmm_kernels.cuh"

namespace hgmm {

constexpr int STEP_OUT = 59;
constexpr int STEP_THREADS = 256;

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

__device__ void matmul3(const double* a, const double* b, double* c) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

__device__ void matvec3(const double* a, const double* v, double* out) {
  for (int i = 0; i < 3; ++i) out[i] = a[3 * i] * v[0] + a[3 * i + 1] * v[1] + a[3 * i + 2] * v[2];
}

__device__ void cross3(const double* a, const double* b, double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ double dot3(const double* a, const double* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

// models/se3.py:_series_coeffs: a = sin t / t, b = (1 - cos t) / t^2,
// c = (t - sin t) / t^3, Taylor series below theta^2 = 1e-8.
__device__ void series(double theta2, double* a, double* b, double* c) {
  const double theta = sqrt(theta2 + 1e-32);
  if (theta2 < 1e-8) {
    *a = 1.0 - theta2 / 6.0;
    *b = 0.5 - theta2 / 24.0;
    *c = 1.0 / 6.0 - theta2 / 120.0;
  } else {
    *a = sin(theta) / theta;
    *b = (1.0 - cos(theta)) / theta2;
    *c = (theta - sin(theta)) / (theta2 * theta + 1e-32);
  }
}

__device__ void hat(const double* w, double* K) {
  K[0] = 0.0;   K[1] = -w[2]; K[2] = w[1];
  K[3] = w[2];  K[4] = 0.0;   K[5] = -w[0];
  K[6] = -w[1]; K[7] = w[0];  K[8] = 0.0;
}

// I + p K + q K^2
__device__ void series_matrix(const double* w, double p, double q, double* out) {
  double K[9], KK[9];
  hat(w, K);
  matmul3(K, K, KK);
  for (int i = 0; i < 9; ++i) out[i] = (i % 4 == 0 ? 1.0 : 0.0) + p * K[i] + q * KK[i];
}

// models/se3.py:se3_exp
__device__ void se3_exp(const double* xi, Pose64* out) {
  double a, b, c, V[9];
  series(dot3(xi, xi), &a, &b, &c);
  series_matrix(xi, a, b, out->R);
  series_matrix(xi, b, c, V);
  matvec3(V, xi + 3, out->t);
}

// models/se3.py:se3_log (so3_log, then V^-1 t by Cramer's rule)
__device__ void se3_log(const Pose64& p, double* xi) {
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
__device__ void solve_horn(const double* h, Pose64* out) {
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
    for (int pq = 0; pq < 3; ++pq) {
      const int p = pq == 2 ? 1 : 0, q = pq == 0 ? 1 : 2;
      double al = 0.0, be = 0.0, ga = 0.0;
      for (int i = 0; i < 3; ++i) {
        al += W[3 * i + p] * W[3 * i + p];
        be += W[3 * i + q] * W[3 * i + q];
        ga += W[3 * i + p] * W[3 * i + q];
      }
      if (!(fabs(ga) > 1e-15 * sqrt(al * be))) continue;
      rotated = true;
      const double zeta = (be - al) / (2.0 * ga);
      const double tt = (zeta >= 0.0 ? 1.0 : -1.0) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + tt * tt), s = c * tt;
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
  // Columns by singular value, largest first.
  double sig[3];
  int ord[3] = {0, 1, 2};
  for (int j = 0; j < 3; ++j) sig[j] = sqrt(W[j] * W[j] + W[3 + j] * W[3 + j] + W[6 + j] * W[6 + j]);
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2 - a; ++b)
      if (sig[ord[b]] < sig[ord[b + 1]]) { const int tmp = ord[b]; ord[b] = ord[b + 1]; ord[b + 1] = tmp; }
  double u[3][3], v[3][3];  // u[j], v[j]: the j-th singular vectors
  for (int j = 0; j < 3; ++j)
    for (int i = 0; i < 3; ++i) {
      u[j][i] = W[3 * i + ord[j]];
      v[j][i] = V[3 * i + ord[j]];
    }
  double R[9];
  if (!(sig[ord[0]] > 0.0)) {  // H = 0: torch's SVD gives U = V = I, so R = I
    for (int i = 0; i < 9; ++i) R[i] = i % 4 == 0 ? 1.0 : 0.0;
  } else {
    for (int i = 0; i < 3; ++i) u[0][i] /= sig[ord[0]];
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
// max_rot 0.3) from A [6, 6] row-major and b [6].
__device__ void solve_wls(const double* A, const double* b, double* xi) {
  double M[6][7];
  double sumd = 0.0;
  for (int i = 0; i < 6; ++i) sumd += A[7 * i];
  const double damp = 1e-6 * fmax(sumd / 6.0, 1.0);
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) M[i][j] = A[6 * i + j];
    M[i][i] = M[i][i] + 1e-2 * fmax(A[7 * i], 1e-12 * sumd) + damp;
    M[i][6] = b[i];
  }
  for (int c = 0; c < 6; ++c) {  // LU with partial pivoting
    int piv = c;
    for (int r = c + 1; r < 6; ++r)
      if (fabs(M[r][c]) > fabs(M[piv][c])) piv = r;
    if (piv != c)
      for (int j = 0; j < 7; ++j) { const double tmp = M[c][j]; M[c][j] = M[piv][j]; M[piv][j] = tmp; }
    for (int r = c + 1; r < 6; ++r) {
      const double f = M[r][c] / M[c][c];
      for (int j = c; j < 7; ++j) M[r][j] -= f * M[c][j];
    }
  }
  for (int r = 5; r >= 0; --r) {
    double v = M[r][6];
    for (int j = r + 1; j < 6; ++j) v -= M[r][j] * xi[j];
    xi[r] = v / M[r][r];
  }
  const double rot = sqrt(dot3(xi, xi));
  const double scale = fmin(0.3 / fmax(rot, 1e-12), 1.0);
  for (int i = 0; i < 6; ++i) xi[i] *= scale;
}

__global__ void __launch_bounds__(STEP_THREADS)
    reg_step_kernel(const float* __restrict__ partial, int nb, float* __restrict__ scan,
                    float* __restrict__ logliks, float* __restrict__ deltas, int it, int solver,
                    int first, int last, double tol) {
  __shared__ double sums[STEP_OUT];
  const bool done = scan[SCAN_DONE] != 0.0f;  // uniform: read before anyone writes
  if (!done) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int o = warp; o < STEP_OUT; o += STEP_THREADS / 32) {
      double v = 0.0;
      for (int r = lane; r < nb; r += 32) v += (double)partial[(size_t)r * STEP_OUT + o];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
      if (lane == 0) sums[o] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (done) {
    if (last) {
      logliks[it] = scan[SCAN_LL_LAST];
      deltas[it] = scan[SCAN_D_LAST];
    }
    return;
  }
  if (first) {
    for (int c = 0; c < 12; ++c) scan[SCAN_START + c] = scan[SCAN_POSE + c];
    scan[SCAN_LL] = (float)sums[58];
  }
  Pose64 cur, nw;
  load_pose(scan + SCAN_POSE, &cur);
  if (solver == 0) {
    solve_horn(sums, &nw);
  } else {
    double xi[6];
    Pose64 e;
    solve_wls(sums + 16, sums + 52, xi);
    se3_exp(xi, &e);
    matmul3(e.R, cur.R, nw.R);
    matvec3(e.R, cur.t, nw.t);
    for (int i = 0; i < 3; ++i) nw.t[i] += e.t[i];
  }
  store_pose(scan + SCAN_POSE, nw);
  if (!last) return;
  // delta of the stored (float32) poses: new o start^-1
  Pose64 p, s, rel;
  load_pose(scan + SCAN_POSE, &p);
  load_pose(scan + SCAN_START, &s);
  double St[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) St[3 * a + b] = s.R[3 * b + a];
  matmul3(p.R, St, rel.R);
  double Rs[3];
  matvec3(rel.R, s.t, Rs);
  for (int i = 0; i < 3; ++i) rel.t[i] = p.t[i] - Rs[i];
  double xi[6];
  se3_log(rel, xi);
  double d2 = 0.0;
  for (int i = 0; i < 6; ++i) d2 += xi[i] * xi[i];
  const double delta = sqrt(d2);
  const float ll = scan[SCAN_LL];
  logliks[it] = ll;
  deltas[it] = (float)delta;
  scan[SCAN_LL_LAST] = ll;
  scan[SCAN_D_LAST] = (float)delta;
  if (delta < tol) scan[SCAN_DONE] = 1.0f;
}

}  // namespace hgmm

extern "C" {

// One registration step on the scan state `scan` (float32, layout in
// hgmm_kernels.cuh) from the [nb, 59] partials of reg_stats. solver: 0 Horn,
// 1 Gauss-Newton. first: the iteration's first step (records its start pose
// and loglik); last: its last (writes logliks[it], deltas[it], done). Returns
// the CUDA error code of the launch.
int hgmm_reg_step(const void* partial, int nb, void* scan, void* logliks, void* deltas, int it,
                  int solver, int first, int last, double tol, void* stream) {
  if (nb < 1 || solver < 0 || solver > 1) return (int)cudaErrorInvalidValue;
  hgmm::reg_step_kernel<<<1, hgmm::STEP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), nb, static_cast<float*>(scan), static_cast<float*>(logliks),
      static_cast<float*>(deltas), it, solver, first, last, tol);
  return (int)cudaGetLastError();
}

}  // extern "C"
