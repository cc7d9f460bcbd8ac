"""Pieces every cell shares: the import guard, the build, the rate and the
tail, the device's description, and the comparison of two poses and two
mixtures."""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np

# Top-level module names that no process of the benchmark may hold, compared
# whole: the JAX package and JAX itself. "hgmm_torch" is not "hgmm".
FORBIDDEN = ("jax", "jaxlib", "flax", "hgmm")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def build(device: str, native: bool = False) -> float:
    """Compile the program's kernels (and with `native` its native reader)
    unless the checkout holds them already; the seconds that took, the
    import of the program left out. Nothing is built off the card."""
    if device != "cuda":
        return 0.0
    from hgmm_torch.data import native as reader
    from hgmm_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    if native:
        reader.build(verbose=False)
    return time.perf_counter() - t0


def rate(completed: int, wall_s: float) -> float:
    """Completed requests over the whole window's wall time."""
    return completed / wall_s


def p95(latencies) -> float:
    """The 95th percentile of every latency, linear between the two order
    statistics around it (numpy's default rule); a failed request counts as
    infinitely late."""
    x = np.sort(np.asarray(latencies, np.float64))
    pos = 0.95 * (x.size - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if np.isinf(x[hi]):
        return float("inf")
    return float(x[lo] + (pos - lo) * (x[hi] - x[lo]))


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi prints it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def rotation_gap(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The angle (rad) of Ra^T Rb, by atan2: exact near 0."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.arctan2(0.5 * np.linalg.norm(w), 0.5 * (np.trace(M) - 1.0)))


def translation_gap(ta: np.ndarray, tb: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(ta, np.float64) - np.asarray(tb, np.float64)))


def mixture_gap(prog, ref) -> float:
    """How far a fitted mixture (pi, mu, sigma as numpy) lies from the
    reference's: the summed weight moved, plus, over the components alive on
    both sides, each one's mean moved in its own standard deviations and
    covariance moved in its own norm, weighted by the reference's weights. A
    component dead on one side only (its weight at the emptiness threshold)
    counts by its weight alone."""
    pi_p, mu_p, sg_p = (np.asarray(a, np.float64) for a in prog)
    pi_r, mu_r, sg_r = (np.asarray(a, np.float64) for a in ref)
    if pi_p.shape != pi_r.shape:
        return float("inf")
    both = (pi_p > 0) & (pi_r > 0)
    sd = np.sqrt(np.maximum(np.trace(sg_r, axis1=1, axis2=2) / 3.0, 1e-300))
    dmu = np.linalg.norm(mu_p - mu_r, axis=1) / sd
    dsg = np.linalg.norm(sg_p - sg_r, axis=(1, 2)) / np.maximum(np.linalg.norm(sg_r, axis=(1, 2)), 1e-300)
    return float(np.abs(pi_p - pi_r).sum() + (pi_r * (dmu + dsg))[both].sum())


def worst(values) -> float:
    """The largest value; NaN counts as infinitely far."""
    vals = [float("inf") if not np.isfinite(v) else float(v) for v in values]
    return max(vals) if vals else float("inf")
