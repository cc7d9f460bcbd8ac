"""Partial, cluttered views of an object, made with numpy from the run's seed:
what a range scanner sees of a part it registers onto the part's full model.

A view is a fresh sample of the trefoil surface (``data.trefoil``, the
stand-in for the object scan) cropped to the share ``view_keep`` of it that
lies nearest a seeded view direction (the points with the largest
projections onto it), plus clutter: points uniform in the model's bounding
box grown by ``clutter_margin`` of its size on each side. ``outlier_share``
of the view's points are clutter. The points are shuffled, then moved by a
seeded pose's inverse, as ``data.pair_pool`` moves its sources, plus
Gaussian noise on every point.
"""

from __future__ import annotations

import numpy as np

from regbench.harness import data


def view(rng: np.random.Generator, n: int, view_keep: float) -> np.ndarray:
    """[n, 3] float64: the n points, of a fresh sample of n / view_keep, that
    lie farthest along a direction drawn uniformly from the sphere."""
    d = rng.standard_normal(3)
    d /= np.linalg.norm(d)
    sample = data.trefoil(rng, int(np.ceil(n / view_keep))).astype(np.float64)
    along = sample @ d
    return sample[np.argpartition(-along, n - 1)[:n]]


def clutter(rng: np.random.Generator, n: int, model: np.ndarray, margin: float) -> np.ndarray:
    """[n, 3] float64 uniform in the model's bounding box grown by `margin`
    of its size on each side."""
    lo, hi = model.min(0).astype(np.float64), model.max(0).astype(np.float64)
    pad = margin * (hi - lo)
    return rng.uniform(lo - pad, hi + pad, (n, 3))


def partial_pool(seed: int, n: int, pool: int, model: np.ndarray, view_keep: float,
                 outlier_share: float, clutter_margin: float, max_angle: float, max_trans: float,
                 noise: float) -> list[data.Pair]:
    """`pool` sources of n points each. A source's pair holds, as target, its
    points before the pose (the view and the clutter in the model's frame),
    and the pose (R, t) with R source + t ~ target; fit_seed is unused (the
    model is fitted once)."""
    out = []
    n_clutter = int(round(outlier_share * n))
    for j in range(pool):
        rng = np.random.default_rng(data.seeds(seed, 5, j))
        pts = np.concatenate([view(rng, n - n_clutter, view_keep),
                              clutter(rng, n_clutter, model, clutter_margin)])
        pts = pts[rng.permutation(n)]
        R, t = data.random_pose(rng, max_angle, max_trans)
        source = (pts - t) @ R + noise * rng.standard_normal((n, 3))
        out.append(data.Pair(pts.astype(np.float32), source.astype(np.float32), R, t, 0))
    return out
