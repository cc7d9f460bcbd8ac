"""Roofline of the port's kernels on one NVIDIA H100.

Counterpart of ``hgmm/eval/roofline.py``, which models a TPU's units; none of
its constants carries over. This module holds

- the card's published peaks (NVIDIA H100 SXM data sheet, 700 W), each a
  named constant, and the unit rates derived from them;
- ``kernel_bound``: the least time the card could take for one call of a
  kernel, ``max(needed operations / peak, bytes / bandwidth)``, and which of
  the two binds;
- ``estep_attainable``: the same bound for one fused E+M sweep, per point,
  over the card's three units (HBM stream, fp32 FMA, SFU exp2), which
  ``hgmm_torch.bench`` divides by.

The rates that the unit-rate probes reach on the card (``benchmarks/
mxu_microbench.py``, ``vpu_microbench.py``) move by ~10 % between runs; they
are recorded in ``PERF.md`` with the card's name and power limit, not here.

What is counted. Bytes: every input read once and every output written once,
whatever the kernel reads again. Operations: the work these inputs NEED, not
what a kernel executes: per point and visible component one logit (10 FMA =
20 flop, ``csrc/hgmm_kernels.cuh:logit``), one exp2 on the special-function
unit, and the kernel's contraction (10 FMA for the sufficient statistics,
``csrc/em_stats.cu`` phase 2; 12 FMA + 1 add for ``csrc/reg_stats.cu``). A
masked point needs its parent's ``branch`` children, not all K. Executed work
is more, and shows as a share of the bound below 100 %: the unmasked
``em_stats`` at K >= 33 (``em_stats_tiled_kernel``) evaluates each logit and
each exp2 once, and adds the max, the sum, the scale and the shuffles between
lanes to the 20 FMA a pair; the first ``em_stats`` body (K <= 32), the masked
body and ``reg_stats`` evaluate each logit once too (``reg_stats`` adds the
rescaling of its online softmax and the lanes' merge).
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, 700 W (dense rates, no sparsity).
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores; an FMA counts 2
H100_FP64_FLOPS = 34e12  # float64 outside the tensor cores
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, float32 accumulate
H100_HBM_BYTES = 3.35e12  # device memory, bytes/s
H100_SMS = 132
# Derived from the data sheet: 67e12 = 132 SMs x 128 lanes x 2 x clock.
H100_CLOCK_HZ = H100_FP32_FLOPS / (H100_SMS * 128 * 2)  # 1.98 GHz
# One add, multiply or FMA instruction per lane and clock.
H100_FP32_LANE_OPS = H100_FP32_FLOPS / 2.0
# Special-function unit: 16 results per clock and SM (NVIDIA's CUDA C++
# programming manual, table of arithmetic instruction throughput, compute
# capability 9.0).
H100_SFU_OPS = H100_SMS * 16 * H100_CLOCK_HZ  # ~4.19e12 exp2/s

FLOP_LOGIT = 20.0  # 10 FMA
FLOP_STATS = 20.0  # 10 FMA: gamma * psi into S
FLOP_REG = 25.0  # 12 FMA + 1 add: e * [mu | A6 | b3] and the mass
FLOP_REG_POINT = 200.0  # pose, features, horn 4x4, sparse J^T M J and J^T r
FLOP_KNN_PAIR = 8.0  # 3 sub, 1 mul, 2 FMA
# reg_stats' select body (32 < top_k < K): 4 radix passes over the K keys of
# a point, each key's prefix test and digit extraction a pass.
SELECT_PASSES = 4
OPS_SELECT_KEY = 2.0
# csrc/reg_step.cu after the partials' sum, by a count of the source: Horn's
# moments and a Jacobi SVD of 3 x 3 (~6 sweeps of 3 rotations, ~60 flop each),
# or the damped 6 x 6 system by LU (~150) and exp and compose (~150); log and
# the delta (~150). The larger of the two.
FLOP_REG_STEP = 1500.0
SCAN_BYTES = 2 * 32 * 4 + 2 * 4  # the scan state read and written, loglik and delta
# csrc/em_step.cu a component, by a count of the source: the M-step (~40),
# sym3_eigvalsh and the floor (~50 and an arccosine and a cosine, ~40 each),
# the Cholesky inverse (~45 and three square roots), logdet, b, c and the row
# (~40 and four logarithms, ~25 each), in float64.
FLOP_EM_STEP = 400.0
# csrc/reg_tables.cu a component, by a count of the source: the Cholesky
# inverse (~45 and three square roots and divisions, ~15 each), logdet and
# log pi (four logarithms, ~25 each), b, c and the two rows (~40), in float64.
FLOP_REG_TABLES = 250.0


@dataclasses.dataclass
class KernelBound:
    seconds: float  # the least time the card could take
    by: str  # "bytes" | "operations"
    unit: str  # the binding unit: "hbm" | "fp32" | "bf16" | "sfu"
    flops: float  # needed float operations (an FMA counts 2; lane ops count 1)
    sfu_ops: float  # needed special-function results
    bytes: float  # inputs read once + outputs written once


def _bound(flops: float, nbytes: float, sfu_ops: float = 0.0, unit: str = "fp32",
           flop_rate: float | None = None) -> KernelBound:
    rate = flop_rate or {"fp32": H100_FP32_FLOPS, "bf16": H100_BF16_FLOPS}[unit]
    t_flop = flops / rate
    t_sfu = sfu_ops / H100_SFU_OPS
    t_bytes = nbytes / H100_HBM_BYTES
    t_ops = max(t_flop, t_sfu)
    if t_bytes >= t_ops:
        return KernelBound(t_bytes, "bytes", "hbm", flops, sfu_ops, nbytes)
    return KernelBound(t_ops, "operations", unit if t_flop >= t_sfu else "sfu", flops, sfu_ops,
                       nbytes)


def _estep_point(k: int, masked: bool, branch: int) -> tuple[float, float, float]:
    """What one point of a fused E+M sweep needs: (fp32 flop, exp2 results,
    bytes streamed): 40 flop and one exp2 a visible component (all k, or the
    parent's min(branch, k) children), 16 B of point and 4 B of parent."""
    kk = min(branch, k) if masked else k
    return kk * (FLOP_LOGIT + FLOP_STATS), float(kk), 20.0 if masked else 16.0


def kernel_bound(kernel: str, **s) -> KernelBound:
    """The least time one call of `kernel` could take on the card.

    kernel and its shape arguments (counts from the ``.cu`` sources):

    - ``em_stats`` (n, k): n k (logit + statistics) = 40 flop and one exp2 a
      point and component; reads pts4 16 B a point and W [10, K] f32, writes
      S [K, 10] and loglik.
    - ``em_stats_masked`` (n, k, branch): the same over min(branch, k)
      components a point, plus 4 B of parent a point;
      ``em_stats_masked_wide`` (the body for branch > 8) the same function.
    - ``assign`` (n, k, branch=None): one logit a point and visible component
      (all k, or branch under a parent mask); reads 16 B (+ 4 B parent) and
      writes 4 B a point.
    - ``reg_stats`` (n, k, top_k=None): k logits a point (the gate needs them
      all), then 25 flop and one exp2 for each kept component (k, or top_k
      when 1 <= top_k < k) and ~200 flop a point for the pose, horn, A and
      b; reads 16 B a point, W and the [K, 12] aux table, writes 59 floats.
      ``reg_stats_select`` (n, k, top_k; 32 < top_k < k) the same, plus the
      threshold's SELECT_PASSES passes over the k keys a point,
      OPS_SELECT_KEY operations a key and pass.
    - ``reg_step`` (nb): the float64 sum of nb [59] partial rows and one pose
      solve (FLOP_REG_STEP) at the float64 peak; reads the rows and the scan
      state, writes the state and one loglik and delta.
    - ``em_step`` (k, rows=k, nb=1, branch=None): the float64 sum of nb
      partial rows of an em_stats body, 10 K + 1 floats each (10 branch + 1
      for the grouped body's rows: pass branch), an add a float, then
      FLOP_EM_STEP a component, at the float64 peak; reads the rows, total
      and cov_floor, writes pi, mu, sigma (13 floats a component), the
      [rows, 12] table and one loglik. nb = 1 is S and the loglik summed.
    - ``reg_tables`` (k): FLOP_REG_TABLES a component at the float64 peak;
      reads pi, mu, sigma (13 floats a component), writes wn and aux
      ([K, 12] each).
    - ``knn`` (nq, nt): 8 flop a pair; reads both clouds (12 B a point),
      writes 8 B a query.
    - ``probe_logits`` / ``probe_stats`` (k, t, steps, reps, dtype "bf16" or
      "f32"): steps reps products [K,80]@[80,T] / [32,T]@[T,K] at the bf16
      tensor-core or the fp32 peak; operands read and the output written
      once.
    - ``probe_norm`` (k, t, steps, reps): the 8 rows of [8,K]@[K,T] at the
      bf16 tensor-core peak (the kernel stacks 16 reps of them along N, so
      no row of its tiles is padding).
    - ``probe_addonly`` (k, t, steps, reps): 2 adds an element and rep, at
      one instruction a lane and clock.
    - ``probe_vpu`` (k, t, steps, reps, mode): mode "exp2": one SFU result an
      element and rep; mode "cast": 2 lane instructions (convert down, convert
      up with the sign folded in).
    """
    f4 = 4.0
    if kernel in ("em_stats", "em_stats_masked", "em_stats_masked_wide"):
        n, k = s["n"], s["k"]
        flops, exp2s, per_pt = _estep_point(k, kernel != "em_stats", s.get("branch", k))
        return _bound(n * flops, n * per_pt + (20 * k + 1) * f4, n * exp2s)
    if kernel == "assign":
        n, k, branch = s["n"], s["k"], s.get("branch")
        kk = k if branch is None else min(branch, k)
        per_pt = 16.0 + 4.0 + (0.0 if branch is None else 4.0)
        return _bound(n * kk * FLOP_LOGIT, n * per_pt + 10 * k * f4)
    if kernel in ("reg_stats", "reg_stats_select"):
        n, k, top_k = s["n"], s["k"], s.get("top_k")
        kept = k if top_k is None or top_k >= k else top_k
        select = SELECT_PASSES * OPS_SELECT_KEY * k if kernel == "reg_stats_select" else 0.0
        flops = n * (k * FLOP_LOGIT + select + kept * FLOP_REG + FLOP_REG_POINT)
        return _bound(flops, n * 16.0 + (22 * k + 12 + 59) * f4, n * kept)
    if kernel == "reg_step":
        nb = s["nb"]
        return _bound(nb * 59.0 + FLOP_REG_STEP, nb * 59 * f4 + SCAN_BYTES, flop_rate=H100_FP64_FLOPS)
    if kernel == "em_step":
        k, nb = s["k"], s.get("nb", 1)
        width = 10 * (s.get("branch") or k) + 1
        nbytes = (nb * width + 2) * f4 + 13 * k * f4 + 12 * s.get("rows", k) * f4 + f4
        return _bound(nb * width + k * FLOP_EM_STEP, nbytes, flop_rate=H100_FP64_FLOPS)
    if kernel == "reg_tables":
        k = s["k"]
        return _bound(k * FLOP_REG_TABLES, (13 + 24) * k * f4, flop_rate=H100_FP64_FLOPS)
    if kernel == "knn":
        nq, nt = s["nq"], s["nt"]
        return _bound(float(nq) * nt * FLOP_KNN_PAIR, 12.0 * (nq + nt) + 8.0 * nq)
    if not kernel.startswith("probe_"):
        raise ValueError(f"kernel_bound: unknown kernel {kernel!r}")
    k, t = s["k"], s["t"]
    products = float(s["steps"]) * s["reps"]
    if kernel in ("probe_logits", "probe_stats", "probe_norm"):
        dtype = s.get("dtype", "bf16")
        size = 2.0 if dtype == "bf16" else 4.0
        rows_a, depth, cols = {"probe_logits": (k, 80, t), "probe_stats": (32, t, k),
                               "probe_norm": (8, k, t)}[kernel]
        nbytes = (rows_a * depth + depth * cols) * size + rows_a * cols * f4
        return _bound(products * 2.0 * rows_a * depth * cols, nbytes,
                      unit="bf16" if dtype == "bf16" else "fp32")
    if kernel == "probe_addonly":
        return _bound(products * 2.0 * k * t, 2.0 * k * t * f4, flop_rate=H100_FP32_LANE_OPS)
    if kernel == "probe_vpu":
        if s["mode"] == "exp2":
            return _bound(0.0, 2.0 * k * t * f4, sfu_ops=products * k * t)
        return _bound(products * 2.0 * k * t, 2.0 * k * t * f4, flop_rate=H100_FP32_LANE_OPS)
    raise ValueError(f"kernel_bound: unknown kernel {kernel!r}")


@dataclasses.dataclass
class EstepRoofline:
    points_per_sec: float  # attainable: the slowest unit alone (perfect overlap)
    serial_points_per_sec: float  # no overlap of FMA and SFU work (context only)
    flops_per_point: float  # needed fp32 flop (an FMA counts 2)
    bound: str  # "hbm" | "fp32" | "sfu": the binding unit


def estep_attainable(
    k: int,
    masked: bool = False,
    branch: int = 8,
    fp32_flops: float = H100_FP32_FLOPS,
    hbm_bytes: float = H100_HBM_BYTES,
    sfu_ops: float = H100_SFU_OPS,
) -> EstepRoofline:
    """Attainable fused E+M sweep throughput for K components on one card,
    per point: the HBM stream (16 B of point, 4 B of parent when masked), the
    fp32 FMA work (40 flop a visible component) and the SFU's exp2 (one a
    visible component) each at its peak, the slowest one binding. The rates
    default to the published peaks; pass the rates the probes measured
    (``PERF.md``) to score against what the card reached. The needed work is
    ``kernel_bound``'s count for ``em_stats`` / ``em_stats_masked``, without
    the per-call weight table."""
    flops, exp2s, nbytes = _estep_point(k, masked, branch)
    t_hbm = nbytes / hbm_bytes
    t_fma = flops / fp32_flops
    t_sfu = exp2s / sfu_ops
    t = max(t_hbm, t_fma, t_sfu)
    # Explicit tie-break order (hbm > fp32 > sfu), as the reference's: on an
    # exact tie name the ceiling that is cheaper to lift first.
    if t == t_hbm:
        bound = "hbm"
    elif t == t_fma:
        bound = "fp32"
    else:
        bound = "sfu"
    return EstepRoofline(
        points_per_sec=1.0 / t,
        serial_points_per_sec=1.0 / max(t_hbm, t_fma + t_sfu),
        flops_per_point=flops,
        bound=bound,
    )
