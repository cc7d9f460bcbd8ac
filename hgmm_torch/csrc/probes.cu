// Unit-rate probes: what the card's arithmetic units sustain at the E-step's
// matrix shapes, each shape alone in a kernel.
//
// Replace the TPU kernels of benchmarks/mxu_microbench.py (_logits_kernel,
// _addonly_kernel, _stats_kernel, _norm_kernel) and benchmarks/vpu_microbench.py
// (_kernel, modes exp2 and cast). Plain twins: hgmm_torch/ops/probes.py (*_ref).
//
// Every probe repeats one body iters = steps * reps times inside the kernel
// and writes its accumulator out once; timing two rep counts and differencing
// cancels the launch, the staging and the write-out:
//   logits   out[K,T] += (wt[K,80] + eps_r) @ phi[80,T]
//   stats    out[32,K] += (phi32[32,T] + eps_r) @ e[K,T]^T
//   norm     out[8,T]  += (ones[8,K] + eps_r) @ e[K,T]
//   addonly  acc = x; acc += x + eps_r                      ([K,T] f32)
//   vpu      x <- -f32(bf16(exp2(x)))  or  x <- -f32(bf16(x))
// r = iteration mod reps; eps_r comes from the wrapper as a table, in the
// operand's type, so kernel and twin add identical bits.
//
// Design. The TPU bodies hold one tile in fast memory and run one core; a
// unit rate of this card is the whole card's, so every block takes its own
// slice of T (and of K where K is an output dimension), stages its operands
// ONCE into registers (tensor-core fragments, or the thread's own column) and
// loops. The contraction depths (80, T, K) and the output rows (K, 32, 8) are
// the measured shapes and are kept; where the contraction runs over the
// sliced axis (stats over T, norm over a K split) the blocks write partials
// that reduce_partials sums in a fixed order, as the E-step kernels do. The
// wrapper picks the slice widths so that the grid has at least one block for
// every SM and passes them in (`tile`, `nk`).
//   bf16 (the TPU bodies' arithmetic): nvcuda::wmma 16x16x16, bf16 operands,
//     float32 accumulate. Each rep adds eps_r to the A operand's fragments
//     element by element in bf16 (the same value on every element, so the
//     opaque fragment layout does not matter), multiplies into a zeroed
//     fragment and adds that into the accumulator: every rep's full product
//     is consumed, and the perturbation keeps the compiler from hoisting a
//     loop-invariant product. The 8-row norm output pads to a 16-row tile.
//   f32 (what em_stats.cu and reg_stats.cu execute): FMAs with one operand in
//     registers and the other read from shared memory at an address that is
//     uniform across the warp (a broadcast float4), the perturbed operand
//     rewritten in shared memory once a rep.
//
// What bounds them on the card: operations, by construction (operands are
// read once and stay on the SM): the tensor cores' mma.sync rate, the fp32
// FMA rate, the special-function unit's exp2 rate.
#include <cuda_bf16.h>
#include <mma.h>

#include "hgmm_kernels.cuh"

namespace hgmm {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int MAX_REPS = 64;   // length of the eps table a block stages
constexpr int PW = 4;          // warps per block of the tensor-core probes
constexpr int DEPTH = 80;      // contraction depth of the logits product
constexpr int LK = 16;         // output rows per block, logits f32
constexpr int ST = 32;         // T slice per block, stats f32

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void perturb(FragA& dst, const FragA& src, bf16 eps) {
#pragma unroll
  for (int i = 0; i < FragA::num_elements; ++i) dst.x[i] = __hadd(src.x[i], eps);
}

__device__ __forceinline__ void add_into(FragC& acc, const FragC& d) {
#pragma unroll
  for (int i = 0; i < FragC::num_elements; ++i) acc.x[i] += d.x[i];
}

template <typename T>
__device__ __forceinline__ void stage_eps(T* eps_s, const T* __restrict__ eps, int reps) {
  for (int i = threadIdx.x; i < reps; i += blockDim.x) eps_s[i] = eps[i];
}

// ---- logits, bf16 tensor cores. Block: 64 rows of K x (16 NT) columns of T;
// warp w owns rows 16 w .. 16 w + 15. grid (T / (16 NT), K / 64).
template <int NT>
__global__ void __launch_bounds__(32 * PW)
    probe_logits_bf16_kernel(const bf16* __restrict__ wt, const bf16* __restrict__ phi,
                             const bf16* __restrict__ eps, int t, int iters, int reps,
                             float* __restrict__ out) {
  __shared__ bf16 eps_s[MAX_REPS];
  stage_eps(eps_s, eps, reps);
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * 64 + warp * 16;
  const int col0 = blockIdx.x * (16 * NT);
  constexpr int KK = DEPTH / 16;
  FragA a[KK];
  FragBRow b[KK][NT];
  FragC acc[NT];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    wmma::load_matrix_sync(a[kk], wt + (size_t)row0 * DEPTH + 16 * kk, DEPTH);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      wmma::load_matrix_sync(b[kk][nt], phi + (size_t)(16 * kk) * t + col0 + 16 * nt, t);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) wmma::fill_fragment(acc[nt], 0.0f);
  __syncthreads();
  int r = 0;
  for (int it = 0; it < iters; ++it) {
    const bf16 e = eps_s[r];
    if (++r == reps) r = 0;
    FragA a2[KK];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) perturb(a2[kk], a[kk], e);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      FragC d;
      wmma::fill_fragment(d, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) wmma::mma_sync(d, a2[kk], b[kk][nt], d);
      add_into(acc[nt], d);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    wmma::store_matrix_sync(out + (size_t)row0 * t + col0 + 16 * nt, acc[nt], t,
                            wmma::mem_row_major);
}

// ---- stats, bf16 tensor cores. Block: all 32 rows x 64 columns of K over a
// T slice of 16 KT; warp w owns 16 columns of K. grid (T / (16 KT), K / 64).
// e [K, T] row-major is the col-major [T, K] operand B as it lies.
template <int KT>
__global__ void __launch_bounds__(32 * PW)
    probe_stats_bf16_kernel(const bf16* __restrict__ phi32, const bf16* __restrict__ e,
                            const bf16* __restrict__ eps, int k, int t, int iters, int reps,
                            float* __restrict__ partial) {
  __shared__ bf16 eps_s[MAX_REPS];
  stage_eps(eps_s, eps, reps);
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * (16 * KT);
  const int k0 = blockIdx.y * 64 + warp * 16;
  FragA a[2][KT];
  FragBCol b[KT];
  FragC acc[2];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
      wmma::load_matrix_sync(a[m][kk], phi32 + (size_t)(16 * m) * t + t0 + 16 * kk, t);
    wmma::load_matrix_sync(b[kk], e + (size_t)k0 * t + t0 + 16 * kk, t);
  }
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  __syncthreads();
  int r = 0;
  for (int it = 0; it < iters; ++it) {
    const bf16 ep = eps_s[r];
    if (++r == reps) r = 0;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      FragC d;
      wmma::fill_fragment(d, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        FragA a2;
        perturb(a2, a[m][kk], ep);
        wmma::mma_sync(d, a2, b[kk], d);
      }
      add_into(acc[m], d);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
    wmma::store_matrix_sync(partial + ((size_t)blockIdx.x * 32 + 16 * m) * k + k0, acc[m], k,
                            wmma::mem_row_major);
}

// ---- norm, bf16 tensor cores. Block: 16 columns of T; its PW warps split a
// K range of PW 16 NK between them and their sums are added in order at the
// end. grid (T / 16, K / (PW 16 NK)); the K splits are partials. The 8 rows
// of `ones` are staged into a 16-row tile whose lower half is zero.
template <int NK>
__global__ void __launch_bounds__(32 * PW)
    probe_norm_bf16_kernel(const bf16* __restrict__ ones, const bf16* __restrict__ e,
                           const bf16* __restrict__ eps, int k, int t, int iters, int reps,
                           float* __restrict__ partial) {
  __shared__ __align__(32) bf16 a_s[PW][16][16 * NK];
  __shared__ __align__(32) float red_s[PW][16][16];
  __shared__ bf16 eps_s[MAX_REPS];
  stage_eps(eps_s, eps, reps);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * 16;
  const int kbase = (blockIdx.y * PW + warp) * 16 * NK;
  for (int idx = lane; idx < 16 * 16 * NK; idx += 32) {
    const int row = idx / (16 * NK), c = idx % (16 * NK);
    a_s[warp][row][c] = row < 8 ? ones[(size_t)row * k + kbase + c] : __float2bfloat16_rn(0.0f);
  }
  __syncthreads();
  FragA a[NK];
  FragBRow b[NK];
  FragC acc;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    wmma::load_matrix_sync(a[kk], &a_s[warp][0][16 * kk], 16 * NK);
    wmma::load_matrix_sync(b[kk], e + (size_t)(kbase + 16 * kk) * t + col0, t);
  }
  wmma::fill_fragment(acc, 0.0f);
  int r = 0;
  for (int it = 0; it < iters; ++it) {
    const bf16 ep = eps_s[r];
    if (++r == reps) r = 0;
    FragC d;
    wmma::fill_fragment(d, 0.0f);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      FragA a2;
      perturb(a2, a[kk], ep);
      wmma::mma_sync(d, a2, b[kk], d);
    }
    add_into(acc, d);
  }
  wmma::store_matrix_sync(&red_s[warp][0][0], acc, 16, wmma::mem_row_major);
  __syncthreads();
  // 8 useful rows x 16 columns: one output per thread, warps summed in order.
  const int row = threadIdx.x / 16, c = threadIdx.x % 16;
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < PW; ++w) s += red_s[w][row][c];
  partial[((size_t)blockIdx.y * 8 + row) * t + col0 + c] = s;
}

// ---- logits, f32 FMA. Block: LK rows of K x 128 columns of T; a thread owns
// one column of phi (80 registers) and LK accumulators, and reads the
// perturbed weights from shared memory, every lane the same address.
// grid (T / 128, K / LK).
__global__ void __launch_bounds__(128)
    probe_logits_f32_kernel(const float* __restrict__ wt, const float* __restrict__ phi,
                            const float* __restrict__ eps, int t, int iters, int reps,
                            float* __restrict__ out) {
  __shared__ __align__(16) float w_s[LK * DEPTH];
  __shared__ __align__(16) float w2_s[LK * DEPTH];
  __shared__ float eps_s[MAX_REPS];
  stage_eps(eps_s, eps, reps);
  const int tid = threadIdx.x;
  const int col = blockIdx.x * 128 + tid;
  const int row0 = blockIdx.y * LK;
  for (int i = tid; i < LK * DEPTH; i += 128) w_s[i] = wt[(size_t)row0 * DEPTH + i];
  float p[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) p[d] = phi[(size_t)d * t + col];
  float acc[LK];
#pragma unroll
  for (int j = 0; j < LK; ++j) acc[j] = 0.0f;
  __syncthreads();
  const float4* w4 = reinterpret_cast<const float4*>(w2_s);
  int r = 0;
  for (int it = 0; it < iters; ++it) {
    const float e = eps_s[r];
    if (++r == reps) r = 0;
    __syncthreads();  // the previous rep's reads of w2_s are done
    for (int i = tid; i < LK * DEPTH; i += 128) w2_s[i] = w_s[i] + e;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < LK; j += 2) {
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int q = 0; q < DEPTH / 4; ++q) {
        const float4 u = w4[j * (DEPTH / 4) + q], v = w4[(j + 1) * (DEPTH / 4) + q];
        s0 = fmaf(u.x, p[4 * q], s0);
        s1 = fmaf(v.x, p[4 * q], s1);
        s0 = fmaf(u.y, p[4 * q + 1], s0);
        s1 = fmaf(v.y, p[4 * q + 1], s1);
        s0 = fmaf(u.z, p[4 * q + 2], s0);
        s1 = fmaf(v.z, p[4 * q + 2], s1);
        s0 = fmaf(u.w, p[4 * q + 3], s0);
        s1 = fmaf(v.w, p[4 * q + 3], s1);
      }
      acc[j] += s0;
      acc[j + 1] += s1;
    }
  }
#pragma unroll
  for (int j = 0; j < LK; ++j) out[(size_t)(row0 + j) * t + col] = acc[j];
}

// ---- stats, f32 FMA. Block: blockDim columns of K over a T slice of ST; a
// thread owns one row of e (ST registers) and 32 accumulators, and reads the
// perturbed phi32 slice from shared memory as broadcast float4 (em_stats.cu's
// phase 2: threads own components, the tile's points come from shared
// memory). grid (T / ST, K / blockDim); the T slices are partials.
__global__ void __launch_bounds__(128)
    probe_stats_f32_kernel(const float* __restrict__ phi32, const float* __restrict__ e,
                           const float* __restrict__ eps, int k, int t, int iters, int reps,
                           float* __restrict__ partial) {
  __shared__ __align__(16) float p_s[ST * 32];   // [tt][row]
  __shared__ __align__(16) float p2_s[ST * 32];
  __shared__ float eps_s[MAX_REPS];
  stage_eps(eps_s, eps, reps);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int kcol = blockIdx.y * nthr + tid;
  const int t0 = blockIdx.x * ST;
  for (int i = tid; i < ST * 32; i += nthr) {
    const int row = i / ST, tt = i % ST;
    p_s[tt * 32 + row] = phi32[(size_t)row * t + t0 + tt];
  }
  float ev[ST];
#pragma unroll
  for (int tt = 0; tt < ST; ++tt) ev[tt] = e[(size_t)kcol * t + t0 + tt];
  float acc[32];
#pragma unroll
  for (int f = 0; f < 32; ++f) acc[f] = 0.0f;
  __syncthreads();
  int r = 0;
  for (int it = 0; it < iters; ++it) {
    const float ep = eps_s[r];
    if (++r == reps) r = 0;
    __syncthreads();  // the previous rep's reads of p2_s are done
    for (int i = tid; i < ST * 32; i += nthr) p2_s[i] = p_s[i] + ep;
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < ST; ++tt) {
      const float4* pr = reinterpret_cast<const float4*>(p2_s + tt * 32);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 u = pr[q];
        acc[4 * q] = fmaf(u.x, ev[tt], acc[4 * q]);
        acc[4 * q + 1] = fmaf(u.y, ev[tt], acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(u.z, ev[tt], acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(u.w, ev[tt], acc[4 * q + 3]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < 32; ++f) partial[((size_t)blockIdx.x * 32 + f) * k + kcol] = acc[f];
}

// ---- addonly: one float4 a thread, two dependent adds an element and rep.
__global__ void __launch_bounds__(256)
    probe_addonly_kernel(const float4* __restrict__ x, const float* __restrict__ eps, int n4,
                         int iters, int reps, float4* __restrict__ out) {
  __shared__ float eps_s[MAX_REPS];
  stage_eps(eps_s, eps, reps);
  __syncthreads();
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4 v = x[i];
  float4 acc = v;
  int r = 0;
  for (int it = 0; it < iters; ++it) {
    const float e = eps_s[r];
    if (++r == reps) r = 0;
    acc.x += v.x + e;
    acc.y += v.y + e;
    acc.z += v.z + e;
    acc.w += v.w + e;
  }
  out[i] = acc;
}

// ---- vpu: one element a thread, a chain of iters dependent steps.
template <bool EXP2>
__global__ void __launch_bounds__(256)
    probe_vpu_kernel(const float* __restrict__ x, int n, int iters, float* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int it = 0; it < iters; ++it) {
    const float y = EXP2 ? exp2f(v) : v;
    v = -__bfloat162float(__float2bfloat16_rn(y));
  }
  out[i] = v;
}

}  // namespace hgmm

namespace {

bool bad_loop(int steps, int reps) {
  return steps < 0 || reps < 1 || reps > hgmm::MAX_REPS || (long long)steps * reps > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Every entry returns the CUDA error code of its launches (0 on success) and
// cudaErrorInvalidValue for a shape or tile it does not take.

// out[K, T] f32. f32 == 0: wt [K, 80], phi [80, T], eps [reps] bf16, tile 64
// or 32 (columns of T a block), K % 64 == 0, T % tile == 0. f32 == 1: the
// same in float32, K % 16 == 0, T % 128 == 0 (tile is not read).
int hgmm_probe_logits(const void* wt, const void* phi, const void* eps, int k, int t, int steps,
                      int reps, int f32, int tile, void* out, void* stream) {
  using namespace hgmm;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bad_loop(steps, reps) || k < 1 || t < 1) return (int)cudaErrorInvalidValue;
  const int iters = steps * reps;
  auto* o = static_cast<float*>(out);
  if (f32) {
    if (k % LK || t % 128) return (int)cudaErrorInvalidValue;
    probe_logits_f32_kernel<<<dim3(t / 128, k / LK), 128, 0, s>>>(
        static_cast<const float*>(wt), static_cast<const float*>(phi),
        static_cast<const float*>(eps), t, iters, reps, o);
    return (int)cudaGetLastError();
  }
  if (k % 64 || (tile != 64 && tile != 32) || t % tile) return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const bf16*>(wt);
  const auto* b = static_cast<const bf16*>(phi);
  const auto* e = static_cast<const bf16*>(eps);
  const dim3 grid(t / tile, k / 64);
  if (tile == 64)
    probe_logits_bf16_kernel<4><<<grid, 32 * PW, 0, s>>>(a, b, e, t, iters, reps, o);
  else
    probe_logits_bf16_kernel<2><<<grid, 32 * PW, 0, s>>>(a, b, e, t, iters, reps, o);
  return (int)cudaGetLastError();
}

// out[32, K] f32; partial is [T / tile, 32, K] scratch. f32 == 0: phi32
// [32, T], e [K, T], eps bf16, tile 64 or 32 (the T slice a block), K % 64
// == 0. f32 == 1: float32, tile 32, `threads` columns of K a block (a
// multiple of 32 up to 128 that divides K).
int hgmm_probe_stats(const void* phi32, const void* e, const void* eps, int k, int t, int steps,
                     int reps, int f32, int tile, int threads, void* partial, void* out,
                     void* stream) {
  using namespace hgmm;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bad_loop(steps, reps) || k < 1 || t < 1 || tile < 1 || t % tile)
    return (int)cudaErrorInvalidValue;
  const int iters = steps * reps;
  auto* part = static_cast<float*>(partial);
  if (f32) {
    if (tile != ST || threads < 32 || threads > 128 || threads % 32 || k % threads)
      return (int)cudaErrorInvalidValue;
    probe_stats_f32_kernel<<<dim3(t / ST, k / threads), threads, 0, s>>>(
        static_cast<const float*>(phi32), static_cast<const float*>(e),
        static_cast<const float*>(eps), k, t, iters, reps, part);
  } else {
    if (k % 64 || (tile != 64 && tile != 32)) return (int)cudaErrorInvalidValue;
    const auto* a = static_cast<const bf16*>(phi32);
    const auto* b = static_cast<const bf16*>(e);
    const auto* ep = static_cast<const bf16*>(eps);
    const dim3 grid(t / tile, k / 64);
    if (tile == 64)
      probe_stats_bf16_kernel<4><<<grid, 32 * PW, 0, s>>>(a, b, ep, k, t, iters, reps, part);
    else
      probe_stats_bf16_kernel<2><<<grid, 32 * PW, 0, s>>>(a, b, ep, k, t, iters, reps, part);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce_partials(part, t / tile, 32 * k, static_cast<float*>(out), s);
}

// out[8, T] f32 from ones [8, K], e [K, T], eps [reps], all bf16. nk in
// {1, 2, 4}: 16-deep steps of K a warp; K % (64 nk) == 0, T % 16 == 0;
// partial is [K / (64 nk), 8, T] scratch.
int hgmm_probe_norm(const void* ones, const void* e, const void* eps, int k, int t, int steps,
                    int reps, int nk, void* partial, void* out, void* stream) {
  using namespace hgmm;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bad_loop(steps, reps) || k < 1 || t < 1 || (nk != 1 && nk != 2 && nk != 4) ||
      k % (16 * PW * nk) || t % 16)
    return (int)cudaErrorInvalidValue;
  const int iters = steps * reps;
  const int ksplit = k / (16 * PW * nk);
  const auto* a = static_cast<const bf16*>(ones);
  const auto* b = static_cast<const bf16*>(e);
  const auto* ep = static_cast<const bf16*>(eps);
  auto* part = static_cast<float*>(partial);
  const dim3 grid(t / 16, ksplit);
  if (nk == 4)
    probe_norm_bf16_kernel<4><<<grid, 32 * PW, 0, s>>>(a, b, ep, k, t, iters, reps, part);
  else if (nk == 2)
    probe_norm_bf16_kernel<2><<<grid, 32 * PW, 0, s>>>(a, b, ep, k, t, iters, reps, part);
  else
    probe_norm_bf16_kernel<1><<<grid, 32 * PW, 0, s>>>(a, b, ep, k, t, iters, reps, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce_partials(part, ksplit, 8 * t, static_cast<float*>(out), s);
}

// out[n] f32 = x + sum over steps * reps of (x + eps_r); n % 4 == 0.
int hgmm_probe_addonly(const void* x, const void* eps, int n, int steps, int reps, void* out,
                       void* stream) {
  using namespace hgmm;
  if (bad_loop(steps, reps) || n < 4 || n % 4) return (int)cudaErrorInvalidValue;
  const int n4 = n / 4;
  probe_addonly_kernel<<<(n4 + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float*>(eps), n4, steps * reps, reps,
      static_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// out[n] f32: the chain of steps * reps iterations from x[n]; exp2 != 0:
// x <- -f32(bf16(exp2(x))), else x <- -f32(bf16(x)).
int hgmm_probe_vpu(const void* x, int n, int steps, int reps, int exp2, void* out, void* stream) {
  using namespace hgmm;
  if (bad_loop(steps, reps) || n < 1) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int nb = (n + 255) / 256;
  const auto* in = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  if (exp2)
    probe_vpu_kernel<true><<<nb, 256, 0, s>>>(in, n, steps * reps, o);
  else
    probe_vpu_kernel<false><<<nb, 256, 0, s>>>(in, n, steps * reps, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
