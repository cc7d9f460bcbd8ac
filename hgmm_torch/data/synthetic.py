"""Synthetic point clouds, made with numpy from a seed.

Counterpart of ``hgmm/data/synthetic.py``: the same shapes (a tube around a
trefoil knot, a swept helix ribbon) as stand-ins for the Stanford scans,
which are not in the repository. The draws come from numpy, so they differ
from the JAX package's ``jax.random`` draws for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from hgmm_torch.models.se3 import Pose


def make_cloud_np(n: int, kind: str = "trefoil", seed: int = 0) -> np.ndarray:
    """[n, 3] float32 surface cloud.

    trefoil: tube (sigma 0.06) around a trefoil knot scaled by 0.3 — curved,
             self-occluding, no rotational symmetry.
    helix:   tube (sigma 0.08) around a helix scaled by 0.5.
    """
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 2.0 * np.pi, n)
    if kind == "trefoil":
        center = 0.3 * np.stack(
            [np.sin(t) + 2.0 * np.sin(2.0 * t), np.cos(t) - 2.0 * np.cos(2.0 * t),
             -np.sin(3.0 * t)], axis=-1)
        tube = 0.06
    elif kind == "helix":
        center = 0.5 * np.stack([np.cos(3.0 * t), np.sin(3.0 * t), t / np.pi - 1.0], axis=-1)
        tube = 0.08
    else:
        raise ValueError(f"unknown cloud kind: {kind}")
    return (center + tube * rng.standard_normal((n, 3))).astype(np.float32)


def make_cloud(n: int, kind: str = "trefoil", seed: int = 0, device=None) -> torch.Tensor:
    """make_cloud_np as a float32 tensor on `device`."""
    return torch.from_numpy(make_cloud_np(n, kind, seed)).to(device)


def perturb(
    points: torch.Tensor,
    pose: Pose,
    noise: float = 0.0,
    keep_fraction: float = 1.0,
    seed: int = 0,
) -> torch.Tensor:
    """Source cloud of a registration pair: the rigid transform, then
    Gaussian noise, then a random subset of keep_fraction of the points."""
    rng = np.random.default_rng(seed)
    out = pose.apply(points)
    if noise > 0:
        eps = rng.standard_normal(tuple(out.shape)).astype(np.float32)
        out = out + noise * torch.from_numpy(eps).to(out.device)
    if keep_fraction < 1.0:
        n = points.shape[0]
        idx = rng.permutation(n)[: max(int(n * keep_fraction), 1)]
        out = out[torch.from_numpy(idx).to(out.device)]
    return out
