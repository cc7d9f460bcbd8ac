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
// operand's type, so kernel and twin add identical bits. Each rep's full
// product is formed in float32 and added into the accumulator (acc = acc + d);
// every rep's product is executed, none hoisted or merged.
//
// Design. The TPU bodies hold one tile in fast memory and run one core; a
// unit rate of this card is the whole card's, so every block takes its own
// slice of T (and of K where K is an output dimension), stages its operands
// ONCE (registers, or shared memory for the tensor cores' B operand) and
// loops. The contraction depths (80, T, K) and the output rows (K, 32, 8) are
// the measured shapes and are kept; where the contraction runs over the
// sliced axis (stats over T, norm over a K split) the blocks write partials
// that reduce_partials sums in a fixed order, as the E-step kernels do. The
// wrapper picks the slice widths (ops/probes.py:plan_*) and passes them in
// (`tile`, `nk`).
//   bf16 logits and stats (the TPU bodies' arithmetic): the warpgroup tensor
//     cores (wgmma, m64nNk16, A from registers, B from shared memory, float32
//     accumulate), each body's own note below.
//   bf16 norm: nvcuda::wmma 16x16x16 (mma.sync). Each rep adds eps_r to the A
//     operand's fragments element by element in bf16 (the same value on every
//     element, so the opaque fragment layout does not matter), multiplies into
//     a zeroed fragment and adds that into the accumulator. The 8-row norm
//     output pads to a 16-row tile.
//   f32 (what em_stats.cu and reg_stats.cu execute): FMAs with one operand in
//     registers and the other read from shared memory at an address that is
//     uniform across the warp (a broadcast float4), the perturbed operand
//     rewritten in shared memory once a rep.
//
// What bounds them on the card: operations, by construction (operands are
// read once and stay on the SM): the tensor cores' rate (wgmma for logits
// and stats, mma.sync for norm), the fp32 FMA rate, the special-function
// unit's exp2 rate.
#include <cuda_bf16.h>
#include <stdint.h>
#include <mma.h>

#include "hgmm_kernels.cuh"

namespace hgmm {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int MAX_REPS = 64;   // length of the eps table a block stages
constexpr int PW = 4;          // warps per block of the norm probe
constexpr int DEPTH = 80;      // contraction depth of the logits product
constexpr int LK = 16;         // output rows per block, logits f32
constexpr int ST = 32;         // T slice per block, stats f32

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
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

// ---- warpgroup tensor-core helpers (wgmma, sm_90a) for the bf16 logits and
// stats bodies. A warpgroup is four warps; warp w of it owns rows 16 w ..
// 16 w + 15 of the 64-row tile. Lane l holds, of A's 16-deep step (the RS
// form: A from registers, as mma.m16n8k16's A fragment), the pairs (row g,
// cols 2 q, 2 q + 1), (row g + 8, same cols), (row g, cols 2 q + 8, + 9),
// (row g + 8, same) in four 32-bit registers, g = l / 4, q = l % 4; and of
// the float32 product D, for each 8 columns j, (row g, cols 8 j + 2 q, + 1)
// and (row g + 8, same) in registers 4 j .. 4 j + 3.
constexpr int WG = 128;  // threads of a warpgroup

template <int N>
struct Wgmma;

// D[64, N] (+)= A[64, 16] (registers) @ B[16, N] (shared memory, descriptor
// b); SCALE_D = 0 ignores D's old contents, so the first step of a product
// needs no zeroed accumulator.
template <>
struct Wgmma<32> {
  template <int SCALE_D>
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(SCALE_D));
  }
};

template <>
struct Wgmma<64> {
  template <int SCALE_D>
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(SCALE_D));
  }
};

template <>
struct Wgmma<128> {
  template <int SCALE_D>
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(SCALE_D));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Descriptor of a K-major operand in shared memory in the canonical layout
// without swizzle: core matrices of 8 rows x 16 bytes (8 bf16 along K), each
// 128 contiguous bytes; the next core matrix along K lies `lbo` bytes on, the
// next 8 rows `sbo` bytes on. Fields: address, lbo and sbo, each >> 4.
__device__ __forceinline__ uint64_t kmajor_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = smem_u32(smem);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
constexpr uint64_t DESC_STEP = 256 >> 4;  // one 16-deep step: two core matrices along K

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// Shared-memory writes of this thread, ordered before later reads by wgmma
// (the async proxy); a barrier then makes every thread's writes visible.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The compiler sees a product's registers as written when its wgmma is
// issued; these empty statements pin each access to the registers of an
// in-flight product after the wait for it (and the writes of A before the
// fence that precedes the next wgmma).
template <int NR>
__device__ __forceinline__ void pin(float (&r)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int NR>
__device__ __forceinline__ void pin(uint32_t (&r)[NR][4]) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int NR>
__device__ __forceinline__ void add_into(float (&acc)[NR], float (&d)[NR]) {
  pin(d);  // after the wait for d's product
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] += d[i];
}

__device__ __forceinline__ uint32_t hadd2(uint32_t x, __nv_bfloat162 e) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  v = __hadd2(v, e);  // add.rn.bf16x2: both halves rounded once, as the twin rounds
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragments of rows row_lo and row_lo + 8, KS steps of 16 from `col`
// of a row-major bf16 matrix with `ld` columns.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* __restrict__ m, size_t ld,
                                       int row_lo, int col) {
  const bf16* lo = m + (size_t)row_lo * ld + col;
  const bf16* hi = lo + 8 * ld;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = ld_pair(lo + 16 * kk);
    a[kk][1] = ld_pair(hi + 16 * kk);
    a[kk][2] = ld_pair(lo + 16 * kk + 8);
    a[kk][3] = ld_pair(hi + 16 * kk + 8);
  }
}

// Steps 0 .. iters - 1 through two product buffers d: step x goes into
// d[x % 2] (issue(d[b], b) writes what the step needs, then issues and
// commits its wgmma group); while step x + 1's group is in flight the
// warpgroup waits for step x's (wgmma.wait_group 1) and retire(d[b]) adds
// its products into the accumulator, in step order. Every path is
// straight-line from the loop's head to the kernel's end, with buffer
// indices fixed at compile time and no group left in flight: ptxas keeps a
// pipeline only where it can see which group owns which registers (else it
// serializes every wgmma, which the build check of chip_smoke.py refuses).
// A deeper pipeline (three groups in flight) moved logits at N = 32 and
// stats by 2-3 % on an H100, for up to 60 more registers.
template <int NR, typename Issue, typename Retire>
__device__ __forceinline__ void pipeline(int iters, float (&d)[2][NR], Issue&& issue,
                                         Retire&& retire) {
  if (iters < 2) {
    if (iters == 1) {
      issue(d[0], 0);
      wg_wait<0>();
      retire(d[0]);
    }
    return;
  }
  issue(d[0], 0);
  int it = 1;
  for (; it + 1 < iters; it += 2) {
    issue(d[1], 1);
    wg_wait<1>();
    retire(d[0]);
    issue(d[0], 0);
    wg_wait<1>();
    retire(d[1]);
  }
  if (it < iters) {
    issue(d[1], 1);
    wg_wait<1>();
    retire(d[0]);
    wg_wait<0>();
    retire(d[1]);
  } else {
    wg_wait<0>();
    retire(d[0]);
  }
}

// ---- logits, bf16 on the warpgroup tensor cores.
// Replaces benchmarks/mxu_microbench.py:_logits_kernel (:54). Bound on the
// card: bf16 tensor-core operations (2 K 80 T a rep; the operands are read
// once). Design: a block is one warpgroup and owns 64 rows of K x N columns
// of T, grid (T / N, K / 64); ops/probes.py:plan_logits picks N in {32, 64}
// by shape: the wider tile wherever its grid still fills the card.
//   - A = wt + eps_r from registers (the RS form): wt's 64 x 80 rows stay in
//     20 registers a thread; a rep adds eps_r with 20 packed __hadd2 (two
//     elements an instruction) into its own A set (the registers of a group
//     in flight are not touched).
//   - B = phi[:, slice] staged once into shared memory, K-major (transposed
//     on the way in), no swizzle: the probe loops on-chip and the
//     differencing of two rep counts cancels the staging, so the tensor
//     memory accelerator would have nothing to hide; plain loads do.
//   - A rep is one group of 5 m64nNk16 wgmmas into one of two D buffers,
//     the first with scale-d = 0 (no zeroing pass); `pipeline` keeps the
//     next rep's group in flight while it waits for rep r's
//     (wgmma.wait_group 1) and adds its D into the float32 accumulator, in
//     rep order, so the add pass and the perturbation overlap the tensor
//     work.
// Registers: acc N / 2, two D buffers of N / 2 and two A sets of 20, wt 20.
template <int N>
__global__ void __launch_bounds__(WG)
    probe_logits_bf16_kernel(const bf16* __restrict__ wt, const bf16* __restrict__ phi,
                             const bf16* __restrict__ eps, int t, int iters, int reps,
                             float* __restrict__ out) {
  constexpr int KS = DEPTH / 16;
  constexpr int NR = N / 2;  // float32 registers of a 64 x N product a thread
  __shared__ __align__(128) bf16 b_s[N * DEPTH];  // [N/8][DEPTH/8][8 rows][8 along K]
  __shared__ bf16 eps_s[MAX_REPS];
  stage_eps(eps_s, eps, reps);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
  const int row0 = blockIdx.y * 64, col0 = blockIdx.x * N;
  for (int i = tid; i < DEPTH * N; i += WG) {
    const int k = i / N, n = i % N;  // coalesced along T
    b_s[(n >> 3) * (DEPTH * 8) + (k >> 3) * 64 + (n & 7) * 8 + (k & 7)] = phi[(size_t)k * t + col0 + n];
  }
  uint32_t w[KS][4];
  load_a(w, wt, DEPTH, row0 + 16 * warp + g, 2 * q);
  fence_async_smem();
  __syncthreads();
  const uint64_t desc = kmajor_desc(b_s, 128, DEPTH * 16);

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.0f;
  float d[2][NR];
  uint32_t a[2][KS][4];  // A set j feeds the products in d[j]
  int r = 0;
  auto issue = [&](float (&dj)[NR], int j) {
    const __nv_bfloat162 e2 = __bfloat162bfloat162(eps_s[r]);
    if (++r == reps) r = 0;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[j][kk][i] = hadd2(w[kk][i], e2);
    pin(a[j]);
    pin(dj);
    wg_fence();
    Wgmma<N>::template mma<0>(dj, a[j][0], desc);
#pragma unroll
    for (int kk = 1; kk < KS; ++kk) Wgmma<N>::template mma<1>(dj, a[j][kk], desc + kk * DESC_STEP);
    wg_commit();
  };
  pipeline(iters, d, issue, [&](float (&dj)[NR]) { add_into(acc, dj); });
  float* o = out + (size_t)(row0 + 16 * warp + g) * t + col0 + 2 * q;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(o + (size_t)8 * t + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---- stats, bf16 on the warpgroup tensor cores, computed as its transpose
// out^T[K, 32] = e[K, T] @ (phi32 + eps_r)^T[T, 32]: M is a 64-row slice of
// K (the stats orientation would fill half of every 64-row tile with
// phi32's 32 rows), and four reps share an instruction along N:
//   [d_r | d_r+1 | d_r+2 | d_r+3] = e @ [phi32 + eps_r ; ... ; phi32 + eps_r+3]^T,
// m64n128k16.
// Replaces benchmarks/mxu_microbench.py:_stats_kernel (:86). Bound on the
// card: bf16 tensor-core operations (2 32 K T a rep). Unlike logits, the
// perturbed operand is B, which wgmma reads from shared memory: every rep's
// B is written there by the block's threads and must reach the tensor cores
// (the async proxy) through fence.proxy.async, which waits for those stores
// while the wgmmas in flight read the same memory. That publication, not the
// tensor work, sets the pace (measured on an H100: the same loop with B
// written once runs at ~88 % of the bf16 peak, at ~50 % with a fenced
// rewrite every two reps); the design cuts the fences and the stores a flop:
//   - Four reps a wgmma, so one fence and one barrier every four reps (m64n32k16,
//     the one shape a rep alone allows, also runs well below the tensor
//     cores' rate). Each rep's product is still formed whole, in its own 32
//     columns of D, and added into the accumulator on its own, in rep order:
//     a thread holds the same (row, column) of the four reps in registers
//     i, 16 + i, 32 + i, 48 + i. The last iters % 4 reps run after the loop,
//     two on m64n64k16, one on m64n32k16.
//   - G warpgroups a block (one 64-row slice of K each) share each B tile, so
//     its stores are 1 / G of the reads; ops/probes.py:plan_stats picks G and
//     the depth slice D by shape. grid (T / D, K / (64 G)). The T slices are
//     partials [T / D, 32, K] that reduce_partials sums in a fixed order,
//     outside the differenced loop.
//   - A = the warpgroup's e rows, loaded into registers once (RS form, D / 4
//     registers a thread); they are never perturbed.
//   - B = the four reps' bf16(phi32 + eps), stacked, [128 x D], K-major as
//     phi32 lies, no swizzle, rewritten every four reps into a ring of three
//     buffers from phi32's slice in registers: packed __hadd2, one 16-byte
//     store a core-matrix row (the block's stores cover the buffer linearly:
//     no bank conflict), then fence.proxy.async and a block barrier before
//     the wgmmas read it. A warp's wait for a group says nothing of the other
//     warps' share of it, so the buffer written at step x is the one step
//     x - 3 read: every warp finished that step (its wait_group 1 at step
//     x - 2) before it reached the barrier of step x - 1.
//   - A step is one group of D / 16 wgmmas a warpgroup into one of two D
//     buffers (scale-d = 0 first), through `pipeline` as for logits.
//   - Staging once, looping on-chip: nothing for the tensor memory
//     accelerator to hide (the block computes each tile); the ring, 48 KB at
//     D = 64, is dynamic shared memory (cudaFuncAttributeMaxDynamicSharedMemorySize
//     is set in the C entry).
constexpr int STATS_NREP = 4;  // reps stacked along N in one wgmma
constexpr int stats_smem(int d) { return 3 * 32 * STATS_NREP * d * 2; }  // the ring

template <int D, int G>
__global__ void __launch_bounds__(WG * G)
    probe_stats_bf16_kernel(const bf16* __restrict__ phi32, const bf16* __restrict__ e,
                            const bf16* __restrict__ eps, int k, int t, int iters, int reps,
                            float* __restrict__ partial) {
  constexpr int KS = D / 16;
  constexpr int NR = 16;  // float32 registers of one rep's 64 x 32 product
  constexpr int NN = 32 * STATS_NREP;
  constexpr int HALF = 32 * D / 8 / (WG * G);  // 16-byte chunks of one rep's 32 rows a thread
  constexpr int RING = 3;  // see the note: step x writes what step x - 3 read
  static_assert(HALF >= 1 && 32 * D / 8 == HALF * WG * G, "D: a multiple of 32 G");
  extern __shared__ __align__(128) unsigned char stats_smem_raw[];
  auto b_s = reinterpret_cast<bf16 (*)[NN * D]>(stats_smem_raw);  // [RING][16][D/8][8 rows][8 along K]
  __shared__ bf16 eps_s[MAX_REPS];
  stage_eps(eps_s, eps, reps);
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
  const int t0 = blockIdx.x * D, k0 = (blockIdx.y * G + (tid >> 7)) * 64;
  // Chunk c lies at byte 16 c of a buffer: row n = 8 (c / D) + c % 8 (rep n /
  // 32 of the step, phi32's row n % 32), columns 8 ((c / 8) % (D / 8)) .. + 7
  // of the slice. A thread's chunks of rep h are tid + WG G (i + h HALF).
  uint4 base[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const int c = tid + WG * G * i;
    const int n = (c / D) * 8 + (c & 7), kc = (c >> 3) % (D / 8);
    base[i] = *reinterpret_cast<const uint4*>(phi32 + (size_t)n * t + t0 + 8 * kc);
  }
  uint32_t a[KS][4];
  load_a(a, e, t, k0 + 16 * warp + g, t0 + 2 * q);
  __syncthreads();  // eps_s
  const uint64_t desc0 = kmajor_desc(b_s[0], 128, D * 16);
  constexpr uint64_t DESC_BUF = (NN * D * 2) >> 4;

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.0f;
  int r = 0, buf = 0;
  // Write the B of the next `now` reps into buffer `buf` (rows 32 h .. for
  // rep h), publish it to the block's wgmmas and return its descriptor.
  auto write_b = [&](int now) {
    uint4* dst = reinterpret_cast<uint4*>(b_s[buf]);
#pragma unroll
    for (int h = 0; h < STATS_NREP; ++h) {
      if (h < now) {
        const __nv_bfloat162 e2 = __bfloat162bfloat162(eps_s[r]);
        if (++r == reps) r = 0;
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          const uint4 v = base[i];
          dst[tid + WG * G * (i + h * HALF)] =
              make_uint4(hadd2(v.x, e2), hadd2(v.y, e2), hadd2(v.z, e2), hadd2(v.w, e2));
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    const uint64_t desc = desc0 + buf * DESC_BUF;
    if (++buf == RING) buf = 0;
    return desc;
  };
  float d[2][NN / 2];
  auto issue = [&](float (&dj)[NN / 2], int) {
    const uint64_t desc = write_b(STATS_NREP);
    pin(dj);
    wg_fence();
    Wgmma<NN>::template mma<0>(dj, a[0], desc);
#pragma unroll
    for (int kk = 1; kk < KS; ++kk) Wgmma<NN>::template mma<1>(dj, a[kk], desc + kk * DESC_STEP);
    wg_commit();
  };
  pipeline(iters / STATS_NREP, d, issue, [&](float (&dj)[NN / 2]) {
    pin(dj);
#pragma unroll
    for (int h = 0; h < STATS_NREP; ++h)  // the step's reps, in order
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] += dj[h * NR + i];
  });
  // The last iters % 4 reps: two on m64n64k16, then one on m64n32k16, each
  // alone. Every warp's groups are done with the ring before it is rewritten.
  const int rest = iters % STATS_NREP;
  if (rest >= 2) {
    __syncthreads();
    const uint64_t desc = write_b(2);
    float dl[2 * NR];
    wg_fence();
    Wgmma<64>::template mma<0>(dl, a[0], desc);
#pragma unroll
    for (int kk = 1; kk < KS; ++kk) Wgmma<64>::template mma<1>(dl, a[kk], desc + kk * DESC_STEP);
    wg_commit();
    wg_wait<0>();
    pin(dl);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] += dl[h * NR + i];
  }
  if (rest & 1) {
    __syncthreads();
    const uint64_t desc = write_b(1);
    float dl[NR];
    wg_fence();
    Wgmma<32>::template mma<0>(dl, a[0], desc);
#pragma unroll
    for (int kk = 1; kk < KS; ++kk) Wgmma<32>::template mma<1>(dl, a[kk], desc + kk * DESC_STEP);
    wg_commit();
    wg_wait<0>();
    add_into(acc, dl);
  }
  // acc holds out^T rows m = 16 warp + g (+ 8), columns n = 8 j + 2 q (+ 1):
  // partial[slice][n][k0 + m].
  float* p = partial + (size_t)blockIdx.x * 32 * k + k0 + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const size_t n = 8 * j + 2 * q;
    p[n * k] = acc[4 * j];
    p[(n + 1) * k] = acc[4 * j + 1];
    p[n * k + 8] = acc[4 * j + 2];
    p[(n + 1) * k + 8] = acc[4 * j + 3];
  }
}

// Launch probe_stats_bf16_kernel<D, G>; its dynamic shared memory limit is
// raised once, at the first launch.
template <int D, int G>
cudaError_t launch_stats(dim3 grid, const bf16* a, const bf16* b, const bf16* ep, int k, int t,
                         int iters, int reps, float* part, cudaStream_t s) {
  constexpr int smem = stats_smem(D);
  static const cudaError_t attr = cudaFuncSetAttribute(
      probe_stats_bf16_kernel<D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  probe_stats_bf16_kernel<D, G><<<grid, WG * G, smem, s>>>(a, b, ep, k, t, iters, reps, part);
  return cudaGetLastError();
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
// or 32 (N, the columns of T a block), K % 64 == 0, T % tile == 0. f32 == 1: the
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
    probe_logits_bf16_kernel<64><<<grid, WG, 0, s>>>(a, b, e, t, iters, reps, o);
  else
    probe_logits_bf16_kernel<32><<<grid, WG, 0, s>>>(a, b, e, t, iters, reps, o);
  return (int)cudaGetLastError();
}

// out[32, K] f32; partial is [T / tile, 32, K] scratch. f32 == 0: phi32
// [32, T], e [K, T], eps bf16, tile 64 or 32 (D, the T slice a block),
// threads 128 G (G warpgroups a block, one 64-row slice of K each; G = 2 with
// tile 64 only), K % (64 G) == 0. f32 == 1: float32, tile 32, `threads` columns of K a block (a
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
    // threads / 128 = G warpgroups a block, one 64-row slice of K each
    const int wgs = threads / WG;
    if (threads % WG || k % (64 * wgs) || !((tile == 64 && (wgs == 1 || wgs == 2)) || (tile == 32 && wgs == 1)))
      return (int)cudaErrorInvalidValue;
    const auto* a = static_cast<const bf16*>(phi32);
    const auto* b = static_cast<const bf16*>(e);
    const auto* ep = static_cast<const bf16*>(eps);
    const dim3 grid(t / tile, k / (64 * wgs));
    cudaError_t launched;
    if (tile == 64 && wgs == 2)
      launched = launch_stats<64, 2>(grid, a, b, ep, k, t, iters, reps, part, s);
    else if (tile == 64)
      launched = launch_stats<64, 1>(grid, a, b, ep, k, t, iters, reps, part, s);
    else
      launched = launch_stats<32, 1>(grid, a, b, ep, k, t, iters, reps, part, s);
    if (launched != cudaSuccess) return (int)launched;
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
