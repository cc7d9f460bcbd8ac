"""The least time one NVIDIA H100 could take for a registration whose
responsibilities are gated to each point's top_k components: a frozen copy of
the port's arithmetic for the gated ``reg_stats``
(``hgmm_torch/eval/roofline.kernel_bound("reg_stats", n=n, k=k, top_k=top_k)``),
with the peaks and counts of ``roofline.py``.

A gated point needs every one of its k logits (the gate needs them all), then
FLOP_REG and one exp2 for each kept component only (top_k, where 1 <= top_k
< k), and FLOP_REG_POINT for the pose, horn, A and b: at k = 512 and top_k =
8 that is 10,640 flop a point against the ungated 23,240. The bytes are the
ungated kernel's. Levels with k <= top_k are not gated.
"""

from __future__ import annotations

from regbench.harness.roofline import (F4, FLOP_LOGIT, FLOP_REG, FLOP_REG_POINT, FLOP_REG_STEP,
                                       H100_FP64_FLOPS, SCAN_BYTES, Need, bound)

# The largest top_k of the port's register-list body (reg_stats_top_k_kernel,
# hgmm_torch/ops/fused_em.py:MAX_TOP_K); a larger top_k < k runs the select body.
MAX_TOP_K = 32


def kept(k: int, top_k: int | None) -> int:
    """The components a point's statistics need: top_k where it gates, else k."""
    return top_k if top_k is not None and top_k < k else k


def top_k_body(k: int, top_k: int | None) -> bool:
    """Whether a level of k components runs the register-list gated body."""
    return top_k is not None and top_k < k and top_k <= MAX_TOP_K


def reg_stats(n: float, k: int, top_k: int | None) -> Need:
    """One statistics pass of n points against k components, gated to top_k."""
    kk = kept(k, top_k)
    return bound(n * (k * FLOP_LOGIT + kk * FLOP_REG + FLOP_REG_POINT),
                 n * 16.0 + (22 * k + 12 + 59) * F4, n * kk)


def reg_eval(n: float, k: int, top_k: int | None) -> Need:
    """One statistics pass and the pose solve."""
    return reg_stats(n, k, top_k) + bound(59.0 + FLOP_REG_STEP, 59 * F4 + SCAN_BYTES,
                                          flop_rate=H100_FP64_FLOPS)


def passes(live: int, n_iters: int, method: str, wls_inner: int) -> int:
    """The statistics passes of a level's `live` iterations: one a Horn
    iteration, wls_inner a WLS iteration."""
    n_horn = n_iters // 2 if method == "horn+wls" else (n_iters if method == "horn" else 0)
    return min(live, n_horn) + max(live - n_horn, 0) * wls_inner


def register(n: float, ks: list[int], live: list[int], n_iters: int, method: str, wls_inner: int,
             top_k: int | None) -> Need:
    """A coarse-to-fine registration of n live points, level l of ks[l]
    components with live[l] live iterations, each pass gated to top_k."""
    return sum((passes(m, n_iters, method, wls_inner) * reg_eval(n, k, top_k)
                for k, m in zip(ks, live)), Need())


def top_k_passes(n: float, ks: list[int], live: list[int], n_iters: int, method: str,
                 wls_inner: int, top_k: int | None) -> Need:
    """The statistics passes alone of the levels that run the register-list
    gated body: what reg_stats_top_k_kernel's device time is held to."""
    return sum((passes(m, n_iters, method, wls_inner) * reg_stats(n, k, top_k)
                for k, m in zip(ks, live) if top_k_body(k, top_k)), Need())
