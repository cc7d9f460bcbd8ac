"""The least time one NVIDIA H100 could take for the work a registration
needs: a frozen copy of the port's roofline arithmetic
(``hgmm_torch/eval/roofline.py``) for the kernels the benchmark's entries run.

Peaks: NVIDIA's H100 SXM data sheet at 700 W, dense rates. A bound is the
larger of the needed operations over their unit's peak and the needed bytes
over the HBM bandwidth. What is counted is what these inputs need, not what a
kernel executes: a masked point needs its parent's `branch` children, a point
of zero weight nothing, and a registration level only its live iterations.
"""

from __future__ import annotations

import dataclasses

H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores; an FMA counts 2
H100_FP64_FLOPS = 34e12  # float64 outside the tensor cores
H100_HBM_BYTES = 3.35e12  # bytes/s
H100_SMS = 132
H100_CLOCK_HZ = H100_FP32_FLOPS / (H100_SMS * 128 * 2)
H100_SFU_OPS = H100_SMS * 16 * H100_CLOCK_HZ  # exp2 results/s

FLOP_LOGIT = 20.0  # 10 FMA: features(y) . W[:, j]
FLOP_STATS = 20.0  # 10 FMA: gamma * features into S
FLOP_REG = 25.0  # 12 FMA + 1 add: gamma * [mu | A6 | b3] and the mass
FLOP_REG_POINT = 200.0  # pose, features, Horn 4x4, J^T M J and J^T r a point
FLOP_REG_STEP = 1500.0  # one pose solve (Horn's SVD or the damped 6x6), float64
FLOP_EM_STEP = 400.0  # the M-step of one component, float64
SCAN_BYTES = 2 * 32 * 4 + 2 * 4
F4 = 4.0


@dataclasses.dataclass(frozen=True)
class Need:
    """What some work needs: the least seconds the card could take, a call
    at a time; the float operations (an FMA counts 2); and the seconds those
    operations take at their own unit's peak (float32 or float64), bytes
    left out, which a share of the card's peak divides. Adds up."""

    seconds: float = 0.0
    flops: float = 0.0
    peak_s: float = 0.0

    def __add__(self, other: "Need") -> "Need":
        return Need(self.seconds + other.seconds, self.flops + other.flops, self.peak_s + other.peak_s)

    def __radd__(self, other) -> "Need":
        return self if other == 0 else self + other

    def __mul__(self, times: float) -> "Need":
        return Need(self.seconds * times, self.flops * times, self.peak_s * times)

    __rmul__ = __mul__


def bound(flops: float, nbytes: float, sfu: float = 0.0, flop_rate: float = H100_FP32_FLOPS) -> Need:
    """max(operations over their peak, bytes over bandwidth), the operations,
    and the operations over their peak."""
    return Need(max(flops / flop_rate, sfu / H100_SFU_OPS, nbytes / H100_HBM_BYTES), flops,
                flops / flop_rate)


def em_sweep(n: float, k: int, branch: int | None) -> Need:
    """One E-step over n points (every component, or the parent's `branch`
    children when branch is given) and the M-step of its k components."""
    kk = k if branch is None else min(branch, k)
    per_pt = 16.0 if branch is None else 20.0
    e = bound(n * kk * (FLOP_LOGIT + FLOP_STATS), n * per_pt + (20 * k + 1) * F4, n * kk)
    m = bound(10 * k + 1 + k * FLOP_EM_STEP, (10 * k + 3) * F4 + 25 * k * F4,
              flop_rate=H100_FP64_FLOPS)
    return e + m


def assign(n: float, k: int, branch: int | None) -> Need:
    kk = k if branch is None else min(branch, k)
    per_pt = 20.0 + (0.0 if branch is None else 4.0)
    return bound(n * kk * FLOP_LOGIT, n * per_pt + 10 * k * F4)


def reg_eval(n: float, k: int) -> Need:
    """One statistics pass of n points against k components, and the solve."""
    stats = bound(n * (k * (FLOP_LOGIT + FLOP_REG) + FLOP_REG_POINT),
                  n * 16.0 + (22 * k + 12 + 59) * F4, n * k)
    return stats + bound(59.0 + FLOP_REG_STEP, 59 * F4 + SCAN_BYTES, flop_rate=H100_FP64_FLOPS)


def fit_tree(n: float, branch: int, levels: int, sweeps: int) -> Need:
    """A tree fit of n live points: level 0 over its `branch` components,
    each further level masked to the parent's children, and the assignment
    before each further level."""
    total = Need()
    for level in range(levels):
        k = branch ** (level + 1)
        if level:
            total += assign(n, branch ** level, None if level == 1 else branch)
        total += sweeps * em_sweep(n, k, None if level == 0 else branch)
    return total


def live_iterations(deltas, n_iters: int, tol: float) -> list[int]:
    """Per level, the iterations that ran: up to and including the first
    whose delta falls below tol. deltas: every level's n_iters deltas, in
    order (a finished level repeats its last live delta)."""
    out = []
    for lo in range(0, len(deltas), n_iters):
        level = list(deltas[lo:lo + n_iters])
        below = [i for i, d in enumerate(level) if d < tol]
        out.append(below[0] + 1 if below else len(level))
    return out


def register(n: float, ks: list[int], live: list[int], n_iters: int, method: str,
             wls_inner: int) -> Need:
    """A coarse-to-fine registration of n live points: level l has ks[l]
    components and live[l] live iterations; a Horn iteration is one
    statistics pass, a WLS iteration wls_inner."""
    n_horn = n_iters // 2 if method == "horn+wls" else (n_iters if method == "horn" else 0)
    total = Need()
    for k, m in zip(ks, live):
        passes = min(m, n_horn) + max(m - n_horn, 0) * wls_inner
        total += passes * reg_eval(n, k)
    return total
