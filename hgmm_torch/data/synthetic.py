"""Synthetic point clouds, made with numpy from a seed.

Counterpart of ``hgmm/data/synthetic.py``: the same shapes (a tube around a
trefoil knot, a swept helix ribbon, a sample of a random 12-component
mixture) as stand-ins for the Stanford scans,
which are not in the repository. The draws come from numpy, so they differ
from the JAX package's ``jax.random`` draws for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from hgmm_torch.models.se3 import Pose
from hgmm_torch.ops.gaussians import MixtureParams
from hgmm_torch.utils.device import resolve_device


def sample_gmm(params: MixtureParams, n: int, generator: torch.Generator | None = None) -> torch.Tensor:
    """Draw n points [n, 3] from a mixture: a component by pi, then
    mu + chol(sigma) z. Draws from `generator` on the CPU (the reference draws
    from a jax.random key: same distribution, other draws); the points land on
    the parameters' device."""
    pi, mu, sigma = (a.detach().to("cpu", torch.float64) for a in params)
    comp = torch.multinomial(pi / pi.sum(), n, replacement=True, generator=generator)
    z = torch.randn(n, 3, generator=generator, dtype=torch.float64)
    chol = torch.linalg.cholesky(sigma)
    pts = mu[comp] + torch.einsum("nij,nj->ni", chol[comp], z)
    return pts.to(dtype=params.mu.dtype, device=params.mu.device)


def make_cloud_np(n: int, kind: str = "trefoil", seed: int = 0) -> np.ndarray:
    """[n, 3] float32 surface cloud.

    trefoil: tube (sigma 0.06) around a trefoil knot scaled by 0.3 — curved,
             self-occluding, no rotational symmetry.
    helix:   tube (sigma 0.08) around a helix scaled by 0.5.
    blob:    sample of a random 12-component mixture (means uniform in
             [-1, 1]^3, covariances a a^T + 0.01 I with a ~ 0.15 N(0, 1),
             equal weights).
    """
    rng = np.random.default_rng(seed)
    if kind == "blob":
        mu = rng.uniform(-1.0, 1.0, (12, 3))
        a = 0.15 * rng.standard_normal((12, 3, 3))
        sigma = np.einsum("kij,klj->kil", a, a) + 0.01 * np.eye(3)
        comp = rng.integers(0, 12, n)
        chol = np.linalg.cholesky(sigma)
        z = rng.standard_normal((n, 3))
        return (mu[comp] + np.einsum("nij,nj->ni", chol[comp], z)).astype(np.float32)
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
    """make_cloud_np as a float32 tensor on `device` (None: the card, and an
    error without one; "cpu" for the plain path)."""
    return torch.from_numpy(make_cloud_np(n, kind, seed)).to(resolve_device(device))


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


def lidar_mixture_np(k: int, seed: int = 0, extent: float = 40.0, minor: float = 0.02):
    """A K-component mixture at LiDAR scale, numpy (pi [K], mu [K,3],
    sigma [K,3,3] float32): means uniform in +-extent metres, near-planar
    covariances (two axes of 0.5-3 m, a minor axis of `minor` metres) in
    random orientations, Dirichlet weights."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-extent, extent, (k, 3))
    q, _ = np.linalg.qr(rng.standard_normal((k, 3, 3)))
    axes = np.concatenate([rng.uniform(0.5, 3.0, (k, 2)), np.full((k, 1), minor)], axis=1)
    sigma = np.einsum("kij,kj,klj->kil", q, axes ** 2, q)
    pi = rng.dirichlet(np.ones(k))
    return pi.astype(np.float32), mu.astype(np.float32), sigma.astype(np.float32)


def lidar_points_np(n: int, mixture, seed: int = 0, extent: float = 40.0, pad: float = 0.3):
    """[n, 3] points and [n] weights at LiDAR scale, numpy float32: of the
    live rows, half are drawn from `mixture` (pi, mu, sigma) and half uniform
    in +-extent metres; the last `pad` share are zero-weight rows at the
    origin, as the odometry bucket pads a frame."""
    rng = np.random.default_rng(seed)
    pi, mu, sigma = (np.asarray(a, np.float64) for a in mixture)
    n_pad = int(round(pad * n))
    n_live = n - n_pad
    n_mix = n_live // 2
    comp = rng.choice(pi.size, size=n_mix, p=pi / pi.sum())
    chol = np.linalg.cholesky(sigma)
    on = mu[comp] + np.einsum("nij,nj->ni", chol[comp], rng.standard_normal((n_mix, 3)))
    uniform = rng.uniform(-extent, extent, (n_live - n_mix, 3))
    pts = np.concatenate([on, uniform, np.zeros((n_pad, 3))]).astype(np.float32)
    w = np.concatenate([np.ones(n_live), np.zeros(n_pad)]).astype(np.float32)
    return pts, w
