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
//   bf16 logits, stats and norm (the TPU bodies' arithmetic): the warpgroup
//     tensor cores (wgmma, m64nNk16, A from registers, B from shared memory,
//     float32 accumulate), each body's own note below; stats and norm as
//     their transposes, so that their short side (32 and 8 rows) is N.
//   f32 (what em_stats.cu and reg_stats.cu execute): FMAs with one operand in
//     registers and the other read from shared memory at an address that is
//     uniform across the warp (a broadcast float4), the perturbed operand
//     rewritten in shared memory once a rep.
//
// What bounds them on the card: operations, by construction (operands are
// read once and stay on the SM): the tensor cores' rate (wgmma), the fp32
// FMA rate, the special-function unit's exp2 rate.
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hgmm_kernels.cuh"

namespace hgmm {

typedef __nv_bfloat16 bf16;

constexpr int MAX_REPS = 64;   // length of the eps table a block stages
constexpr int DEPTH = 80;      // contraction depth of the logits product
constexpr int LK = 16;         // output rows per block, logits f32
constexpr int ST = 32;         // T slice per block, stats f32

template <typename T>
__device__ __forceinline__ void stage_eps(T* eps_s, const T* __restrict__ eps, int reps) {
  for (int i = threadIdx.x; i < reps; i += blockDim.x) eps_s[i] = eps[i];
}

// ---- warpgroup tensor-core helpers (wgmma, sm_90a) for the bf16 logits,
// stats and norm bodies. A warpgroup is four warps; warp w of it owns rows 16 w ..
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
struct Wgmma<8> {
  template <int SCALE_D>
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(SCALE_D));
  }
};

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

// ---- norm, bf16 on the warpgroup tensor cores, computed as its transpose
// out^T[T, 8] = e^T[T, K] @ (ones + eps_r)^T[K, 8]: the stats body's design
// with 8 rows a rep instead of 32, e's transpose as A and the contraction
// over K. M is a 64-row tile of T (the norm orientation would pad ones' 8
// rows into a 16-row tile), and NORM_NREP = 16 reps share an instruction
// along N:
//   [d_r | ... | d_r+15] = e^T @ [ones + eps_r ; ... ; ones + eps_r+15]^T,
// m64n128k16: a step stores the same bytes of B and does the same tensor
// work a warpgroup as stats' four reps of 32 rows.
// Replaces benchmarks/mxu_microbench.py:_norm_kernel (:106). Bound on the
// card: bf16 tensor-core operations (2 8 K T a rep, the 8 useful rows). As
// for stats, the fenced rewrite of B, not the tensor work, sets the pace.
//   - A = the warpgroup's 64 rows of e^T over the block's K slice D, loaded
//     into registers once (a strided gather of e's columns, outside the
//     loop); the rows of a last, partial tile of T are zero and not stored
//     (T is a multiple of 16, so a warp's 16 rows all lie in T or all past
//     it; every warp still joins the warpgroup's wgmmas).
//   - B = the 16 reps' bf16(ones + eps), stacked (row 8 h + i: rep h, ones'
//     row i), [128 x D], K-major as ones lies, no swizzle, rewritten every 16
//     reps into a ring of three buffers (the stats body's note says why
//     three) with packed __hadd2, one 16-byte store a core-matrix row, then
//     fence.proxy.async and a block barrier. D divides 128 G, so all of a
//     thread's chunks hold the same 8 elements of ones (one uint4 in
//     registers), each for another rep: chunk c of a buffer is rep c / D.
//   - G warpgroups a block (G 64-row tiles of T) share each B tile;
//     ops/probes.py:plan_norm picks D by shape, G = 2. grid (ceil(T / 64 G),
//     K / D); the K slices are partials [K / D, 8, T] that reduce_partials
//     sums in a fixed order, outside the differenced loop.
//   - Each rep's 64 x 8 product is formed whole, in its own 8 columns of D
//     (registers 4 h .. 4 h + 3 of a thread), and added into the float32
//     accumulator (4 registers) on its own, in rep order, through `pipeline`.
//     The last iters % 16 reps run after the loop, one at a time on
//     m64n8k16 (their count is taken over steps x reps, so they run once a
//     launch, and not at all at the timed loops).
//   - The eps table is staged periodic, eps_s[i] = eps[i % reps] for i < reps
//     + 16, so rep h of a step that starts at rep r reads eps_s[r + h].
//   - What a thread does between its wait for a step and its next wgmma
//     delays the tensor work (the barrier waits for the slowest warp), so
//     nothing there waits on a load or divides: r advances by 16 % reps with
//     one conditional subtract, and a step's eps are loaded into registers a
//     step ahead. On an H100 each of the two read clearly faster.
constexpr int NORM_NREP = 16;  // reps stacked along N in one wgmma
constexpr int norm_smem(int d) { return 3 * 8 * NORM_NREP * d * 2; }  // the ring

// The A fragments of rows t and t + 8 of e^T, KS steps of 16 from column k,
// for e [., ld] row-major: A's pair (row t, cols k, k + 1) is e[k][t],
// e[k + 1][t]. Zero where !live.
template <int KS>
__device__ __forceinline__ void load_a_transposed(uint32_t (&a)[KS][4], const bf16* __restrict__ m,
                                                  size_t ld, int k, int t, bool live) {
  const bf16* p = m + (size_t)k * ld + t;
  auto pair = [&](int dk, int dt) -> uint32_t {
    if (!live) return 0u;
    const __nv_bfloat162 v = __halves2bfloat162(p[dk * ld + dt], p[(dk + 1) * ld + dt]);
    return *reinterpret_cast<const uint32_t*>(&v);
  };
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pair(16 * kk, 0);
    a[kk][1] = pair(16 * kk, 8);
    a[kk][2] = pair(16 * kk + 8, 0);
    a[kk][3] = pair(16 * kk + 8, 8);
  }
}

template <int D, int G>
__global__ void __launch_bounds__(WG * G)
    probe_norm_bf16_kernel(const bf16* __restrict__ ones, const bf16* __restrict__ e,
                           const bf16* __restrict__ eps, int k, int t, int iters, int reps,
                           float* __restrict__ partial) {
  constexpr int KS = D / 16;
  constexpr int NN = 8 * NORM_NREP;
  constexpr int THREADS = WG * G;
  constexpr int RING = 3;  // as stats: step x writes what step x - 3 read
  static_assert(D % 32 == 0 && THREADS % D == 0, "D: a multiple of 32 that divides 128 G");
  extern __shared__ __align__(128) unsigned char norm_smem_raw[];
  auto b_s = reinterpret_cast<bf16 (*)[NN * D]>(norm_smem_raw);  // [RING][16][D/8][8 rows][8 along K]
  __shared__ bf16 eps_s[MAX_REPS + NORM_NREP];
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
  for (int i = tid; i < reps + NORM_NREP; i += THREADS) eps_s[i] = eps[i % reps];
  const int k0 = blockIdx.y * D;
  const int row = (blockIdx.x * G + (tid >> 7)) * 64 + 16 * warp;  // the warp's first row of T
  const bool live = row < t;
  // Chunk c lies at byte 16 c of a buffer: row n = 8 (c / D) + c % 8 (rep
  // c / D of the step, ones' row c % 8 = tid % 8), columns 8 ((c / 8) % (D /
  // 8)) .. + 7 of the slice, the same for every chunk tid + 128 G j.
  const uint4 base =
      *reinterpret_cast<const uint4*>(ones + (size_t)(tid & 7) * k + k0 + 8 * ((tid % D) >> 3));
  uint32_t a[KS][4];
  load_a_transposed(a, e, t, k0 + 2 * q, row + g, live);
  __syncthreads();  // eps_s
  const uint64_t desc0 = kmajor_desc(b_s[0], 128, D * 16);
  constexpr uint64_t DESC_BUF = (NN * D * 2) >> 4;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int r = 0, buf = 0;
  const int step_adv = NORM_NREP % reps;  // r's advance a step, without a division in the loop
  // The eps of a whole step's chunks, loaded a step ahead (the loads would
  // otherwise stand between a wait and the next wgmma).
  constexpr int CH = NORM_NREP * D / THREADS;  // a thread's chunks a step
  __nv_bfloat162 e_step[CH];
  auto load_eps = [&]() {
#pragma unroll
    for (int j = 0; j < CH; ++j) e_step[j] = __bfloat162bfloat162(eps_s[r + (tid + THREADS * j) / D]);
  };
  load_eps();
  // Write the B of the next NOW reps into buffer `buf` (its chunks c < NOW D),
  // publish it to the block's wgmmas and return its descriptor.
  auto write_b = [&](auto now) {
    constexpr int NOW = decltype(now)::value;
    uint4* dst = reinterpret_cast<uint4*>(b_s[buf]);
#pragma unroll
    for (int j = 0; j < (NOW * D + THREADS - 1) / THREADS; ++j) {
      const int c = tid + THREADS * j;
      if ((NOW * D) % THREADS == 0 || c < NOW * D) {
        const __nv_bfloat162 e2 = NOW == NORM_NREP ? e_step[j] : __bfloat162bfloat162(eps_s[r + c / D]);
        dst[c] = make_uint4(hadd2(base.x, e2), hadd2(base.y, e2), hadd2(base.z, e2), hadd2(base.w, e2));
      }
    }
    if (NOW == NORM_NREP) {
      r += step_adv;
      if (r >= reps) r -= reps;
      load_eps();
    } else {
      r = (r + NOW) % reps;
    }
    fence_async_smem();
    __syncthreads();
    const uint64_t desc = desc0 + buf * DESC_BUF;
    if (++buf == RING) buf = 0;
    return desc;
  };
  float d[2][NN / 2];
  auto issue = [&](float (&dj)[NN / 2], int) {
    const uint64_t desc = write_b(std::integral_constant<int, NORM_NREP>());
    pin(dj);
    wg_fence();
    Wgmma<NN>::template mma<0>(dj, a[0], desc);
#pragma unroll
    for (int kk = 1; kk < KS; ++kk) Wgmma<NN>::template mma<1>(dj, a[kk], desc + kk * DESC_STEP);
    wg_commit();
  };
  pipeline(iters / NORM_NREP, d, issue, [&](float (&dj)[NN / 2]) {
    pin(dj);
#pragma unroll
    for (int h = 0; h < NORM_NREP; ++h)  // the step's reps, in order
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += dj[4 * h + i];
  });
  // The last iters % 16 reps, one at a time on m64n8k16. Every warp's groups
  // are done with the ring before it is rewritten.
  for (int rest = iters % NORM_NREP; rest > 0; --rest) {
    __syncthreads();
    const uint64_t desc = write_b(std::integral_constant<int, 1>());
    float dl[4];
    wg_fence();
    Wgmma<8>::template mma<0>(dl, a[0], desc);
#pragma unroll
    for (int kk = 1; kk < KS; ++kk) Wgmma<8>::template mma<1>(dl, a[kk], desc + kk * DESC_STEP);
    wg_commit();
    wg_wait<0>();
    pin(dl);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += dl[i];
  }
  // acc holds out^T rows row + g (+ 8), columns 2 q (+ 1): partial[slice][2 q (+ 1)][row + g (+ 8)].
  if (live) {
    float* p = partial + ((size_t)blockIdx.y * 8 + 2 * q) * t + row + g;
    p[0] = acc[0];
    p[t] = acc[1];
    p[8] = acc[2];
    p[t + 8] = acc[3];
  }
}

// Launch probe_norm_bf16_kernel<D, G>; its dynamic shared memory limit is
// raised once, at the first launch.
template <int D, int G>
cudaError_t launch_norm(dim3 grid, const bf16* a, const bf16* b, const bf16* ep, int k, int t,
                        int iters, int reps, float* part, cudaStream_t s) {
  constexpr int smem = norm_smem(D);
  static const cudaError_t attr = cudaFuncSetAttribute(
      probe_norm_bf16_kernel<D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  probe_norm_bf16_kernel<D, G><<<grid, WG * G, smem, s>>>(a, b, ep, k, t, iters, reps, part);
  return cudaGetLastError();
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

// ---- addonly: acc = x, then acc += x + eps_r for every iteration, two
// float32 adds an element and rep.
// Replaces benchmarks/mxu_microbench.py:_addonly_kernel (:73). Bound on the
// card: the FP32 lanes' issue rate (2 adds an element and rep, one lane
// instruction a clock; the bytes are read and written once). So the design
// cuts every instruction a rep issues besides the adds:
//   - ADD_VEC = 4 float4 a thread: thread i of the grid takes the float4s
//     i + j G, j < 4, G the grid's threads (coalesced loads); the grid is a
//     whole number of blocks an SM (ops/probes.py:plan_addonly);
//   - the loop is steps x reps (no wrap compare of the rep index), the reps
//     four at a time, their eps from one 16-byte shared-memory load issued a
//     trip ahead (the table repeats eps[0 .. 3] after the last whole four,
//     so the last trip of a step loads the next step's first four); the
//     last reps % 4 reps after them, in order, their eps in registers. A rep
//     is 32 adds a thread (v + eps, then acc + that), in the plain
//     version's order, so the result is bit-equal to it. An empty asm
//     statement makes the last reps' eps opaque on every step, so the
//     compiler cannot keep their x + eps_r in registers across steps
//     (chip_smoke.py counts the adds a rep in the SASS of the busiest loop:
//     ops/probes.py:addonly_sass_counts).
constexpr int ADD_THREADS = 256;
constexpr int ADD_VEC = 4;  // float4 a thread

__device__ __forceinline__ void add_rep(float4 (&acc)[ADD_VEC], const float4 (&v)[ADD_VEC], float e) {
#pragma unroll
  for (int j = 0; j < ADD_VEC; ++j) {
    acc[j].x += v[j].x + e;
    acc[j].y += v[j].y + e;
    acc[j].z += v[j].z + e;
    acc[j].w += v[j].w + e;
  }
}

__global__ void __launch_bounds__(ADD_THREADS)
    probe_addonly_kernel(const float4* __restrict__ x, const float* __restrict__ eps, int n4,
                         int steps, int reps, float4* __restrict__ out) {
  __shared__ __align__(16) float eps_s[MAX_REPS + 4];
  const int whole = reps & ~3, rest = reps & 3;
  for (int i = threadIdx.x; i < whole + 4; i += ADD_THREADS) eps_s[i] = eps[i < whole ? i : (i - whole) % reps];
  __syncthreads();
  const int i0 = blockIdx.x * ADD_THREADS + threadIdx.x, stride = gridDim.x * ADD_THREADS;
  if (i0 >= n4) return;  // no float4 of its own (a small n)
  float4 v[ADD_VEC], acc[ADD_VEC];
#pragma unroll
  for (int j = 0; j < ADD_VEC; ++j) {
    const int i = i0 + j * stride;
    v[j] = i < n4 ? x[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    acc[j] = v[j];
  }
  const float4* eps4 = reinterpret_cast<const float4*>(eps_s);
  float4 e = eps4[0];
  float e0 = rest > 0 ? eps[whole] : 0.0f, e1 = rest > 1 ? eps[whole + 1] : 0.0f,
        e2 = rest > 2 ? eps[whole + 2] : 0.0f;
  for (int s = 0; s < steps; ++s) {
    for (int r = 0; r < whole; r += 4) {
      const float4 next = eps4[r / 4 + 1];
      add_rep(acc, v, e.x);
      add_rep(acc, v, e.y);
      add_rep(acc, v, e.z);
      add_rep(acc, v, e.w);
      e = next;
    }
    if (rest) {
      asm volatile("" : "+f"(e0), "+f"(e1), "+f"(e2));
      add_rep(acc, v, e0);
      if (rest > 1) add_rep(acc, v, e1);
      if (rest > 2) add_rep(acc, v, e2);
    }
  }
#pragma unroll
  for (int j = 0; j < ADD_VEC; ++j) {
    const int i = i0 + j * stride;
    if (i < n4) out[i] = acc[j];
  }
}

// ---- vpu: K independent chains a thread, each a dependent chain of iters
// steps on one element.
//
// What bounds it: the special-function unit's exp2 rate (MUFU.EX2, 16 results
// a clock an SM). The conversion matters as much: the single convert
// F2F.BF16.F32 (what __float2bfloat16_rn compiles to) issues on the same
// quarter-rate path: on an H100, one element a thread read 2,205-2,223 us
// against a 1,026 us bound, and the chain without the exp2 (cast mode) 1,115. The
// packed convert F2FP.BF16.F32.PACK_AB (cvt.rn.bf16x2.f32) does not: with
// zero as its other operand it writes bf16(y) into the high half of a word
// whose low half is zero, which is float32(bf16(y)) itself, so the upcast
// goes too; it issues at half the FP32 rate (64 lanes a clock an SM), which
// bounds the cast chain. An exp2 step is then exp2f (MUFU.EX2 and its
// denormal fix-up: FSETP and two predicated FMULs), an FADD of the minus
// and one F2FP, under the SFU's 8 clocks a warp; rounding is the hardware's
// (to nearest even; NaN stays NaN, and values that round past the largest
// bfloat16 become inf, as in the twin). Rounding to bf16 with integer
// operations instead costs four INT32 instructions a step on the half-rate
// integer pipe, no faster than F2F on an H100 (PERF.md section 6).
//
// Layout (ops/probes.py:plan_vpu): block b takes the elements
// [b n / blocks, (b + 1) n / blocks), which spreads them over the SMs within
// one element; warp w of the block takes 32 K consecutive of them, chain j of
// lane l the element 32 j + l of that run (coalesced loads and stores). A
// warp runs as many chains as its run holds rows of 32 (the block's last
// warp may hold fewer), so a block costs the SFU one warp instruction an
// iteration for each 32 elements, rounded up once.

// float32(bf16(y)): the packed convert with zero as the low operand.
__device__ __forceinline__ float bf16_round(float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(0.0f, y);  // {.x: bf16(0), .y: bf16(y)}
  return __uint_as_float(*reinterpret_cast<const uint32_t*>(&p));
}

// -f32(bf16(y)) = f32(bf16(-y)) (rounding to nearest even is odd-symmetric):
// an FADD of the minus and the convert. Moving the minus onto exp2f's
// operands instead (a chain of u = -x) issues as many instructions a step
// and read slower on an H100 (PERF.md section 6).
template <bool EXP2>
__device__ __forceinline__ float vpu_step(float v) {
  return bf16_round(-(EXP2 ? exp2f(v) : v));
}

template <bool EXP2, int K>
__device__ __forceinline__ void vpu_chains(const float* __restrict__ x, float* __restrict__ out,
                                           long long at, long long end, int iters) {
  float v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = at + 32 * j < end ? x[at + 32 * j] : 0.0f;
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = vpu_step<EXP2>(v[j]);
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (at + 32 * j < end) out[at + 32 * j] = v[j];
}

// A warp's `rows` (1..K) chains: the instantiation of that many.
template <bool EXP2, int K>
__device__ __forceinline__ void vpu_rows(const float* __restrict__ x, float* __restrict__ out,
                                         long long at, long long end, int rows, int iters) {
  if constexpr (K > 1) {
    if (rows < K) return vpu_rows<EXP2, K - 1>(x, out, at, end, rows, iters);
  }
  vpu_chains<EXP2, K>(x, out, at, end, iters);
}

template <bool EXP2, int K>
__global__ void __launch_bounds__(1024)
    probe_vpu_kernel(const float* __restrict__ x, int n, int iters, float* __restrict__ out) {
  const long long lo = (long long)blockIdx.x * n / gridDim.x;
  const long long hi = (long long)(blockIdx.x + 1) * n / gridDim.x;
  const long long run = lo + (long long)(threadIdx.x / 32) * 32 * K;  // the warp's first element
  if (run >= hi) return;
  const int rows = (int)min((hi - run + 31) / 32, (long long)K);
  vpu_rows<EXP2, K>(x, out, run + threadIdx.x % 32, hi, rows, iters);
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

// out[8, T] f32 from ones [8, K], e [K, T], eps [reps], all bf16. tile: D,
// the K slice a block, and threads: 128 G, G warpgroups a block, one 64-row
// tile of T each; (D, G) in {(64, 2), (32, 2)}; K % tile == 0, T % 16
// == 0; partial is [K / tile, 8, T] scratch.
int hgmm_probe_norm(const void* ones, const void* e, const void* eps, int k, int t, int steps,
                    int reps, int tile, int threads, void* partial, void* out, void* stream) {
  using namespace hgmm;
  const auto s = static_cast<cudaStream_t>(stream);
  const int wgs = threads / WG;
  if (bad_loop(steps, reps) || k < 1 || t < 1 || threads % WG ||
      wgs != 2 || (tile != 64 && tile != 32) || k % tile || t % 16)
    return (int)cudaErrorInvalidValue;
  const int iters = steps * reps;
  const int ksplit = k / tile;
  const auto* a = static_cast<const bf16*>(ones);
  const auto* b = static_cast<const bf16*>(e);
  const auto* ep = static_cast<const bf16*>(eps);
  auto* part = static_cast<float*>(partial);
  const dim3 grid((t + 64 * wgs - 1) / (64 * wgs), ksplit);
  const cudaError_t launched = tile == 64 ? launch_norm<64, 2>(grid, a, b, ep, k, t, iters, reps, part, s)
                                           : launch_norm<32, 2>(grid, a, b, ep, k, t, iters, reps, part, s);
  if (launched != cudaSuccess) return (int)launched;
  return (int)launch_reduce_partials(part, ksplit, 8 * t, static_cast<float*>(out), s);
}

// out[n] f32 = x + sum over steps * reps of (x + eps_r); n % 4 == 0;
// `blocks` blocks of 256 threads, ADD_VEC float4 a thread, with blocks 256
// ADD_VEC >= n / 4.
int hgmm_probe_addonly(const void* x, const void* eps, int n, int steps, int reps, int blocks,
                       void* out, void* stream) {
  using namespace hgmm;
  if (bad_loop(steps, reps) || n < 4 || n % 4 || blocks < 1 ||
      (long long)blocks * ADD_THREADS * ADD_VEC < n / 4 ||
      (long long)blocks * ADD_THREADS * ADD_VEC > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const float4*>(x);
  const auto* ep = static_cast<const float*>(eps);
  auto* o = static_cast<float4*>(out);
  probe_addonly_kernel<<<blocks, ADD_THREADS, 0, s>>>(in, ep, n / 4, steps, reps, o);
  return (int)cudaGetLastError();
}

// out[n] f32: the chain of steps * reps iterations from x[n]; exp2 != 0:
// x <- -f32(bf16(exp2(x))), else x <- -f32(bf16(x)). chains in {1, 2, 4}
// (K, the chains a thread), `blocks` blocks of `threads` threads (a multiple
// of 32, at most 1024) with ceil(n / blocks) <= threads * chains.
int hgmm_probe_vpu(const void* x, int n, int steps, int reps, int exp2, int chains, int blocks,
                   int threads, void* out, void* stream) {
  using namespace hgmm;
  if (bad_loop(steps, reps) || n < 1 || blocks < 1 || blocks > n || threads < 32 ||
      threads > 1024 || threads % 32 || (chains != 1 && chains != 2 && chains != 4) ||
      ((long long)n + blocks - 1) / blocks > (long long)threads * chains)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  const int iters = steps * reps;
#define HGMM_VPU(E, K) probe_vpu_kernel<E, K><<<blocks, threads, 0, s>>>(in, n, iters, o)
  if (exp2) {
    if (chains == 4) HGMM_VPU(true, 4);
    else if (chains == 2) HGMM_VPU(true, 2);
    else HGMM_VPU(true, 1);
  } else {
    if (chains == 4) HGMM_VPU(false, 4);
    else if (chains == 2) HGMM_VPU(false, 2);
    else HGMM_VPU(false, 1);
  }
#undef HGMM_VPU
  return (int)cudaGetLastError();
}

}  // extern "C"
