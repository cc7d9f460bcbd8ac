"""Plain fit of a hierarchical Gaussian mixture: the benchmark's reference.

A frozen, plain PyTorch statement of what the tree fit computes, written from
its definition and imported by nothing of the program under test: EM sweeps
(the E-step as a softmax over the logits log[pi_j N(y; mu_j, Sigma_j)], the
closed-form M-step with the covariance floor), the hard assignment of every
point to one component between levels, the seeding of each parent's children
and the adaptive cut (arXiv 1807.02587). Every contraction over points is a
matrix product, so the precision of the matrix unit applies to all of them;
rows run in blocks so that a full-size cloud fits.

Everything runs in the dtype and on the device it is given: float64 for the
reference, float32 with TF32 matrix products for its control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

NEG_INF = -1e30
LOG_2PI = math.log(2.0 * math.pi)
BLOCK = 1 << 16  # rows a block
COV_REG = 1e-6
COV_FLOOR_REL = 1e-4
MIN_WEIGHT = 1e-6
# Eigenvalue allowance of the covariance floor, a share of |trace| + ||Sigma||_F.
FLOOR_ALLOWANCE = 2e-4
CHILD_OFFSET = 0.6
CHILD_SCALE = 0.35
CHOL_JITTER = 1e-9
# Children seeded along the cube's corners (branch 8), unit length.
CUBE = np.array([[-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1],
                 [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1]], np.float64) / math.sqrt(3.0)


class Mixture(NamedTuple):
    pi: torch.Tensor  # [K]
    mu: torch.Tensor  # [K, 3]
    sigma: torch.Tensor  # [K, 3, 3]


def features(p: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N, 10]: x^2, y^2, z^2, xy, xz, yz, x, y, z, 1."""
    x, y, z = p.unbind(1)
    return torch.stack([x * x, y * y, z * z, x * y, x * z, y * z, x, y, z, torch.ones_like(x)], 1)


def sym_unpack(p: torch.Tensor) -> torch.Tensor:
    """[..., 6] = [m00, m11, m22, m01, m02, m12] -> [..., 3, 3]."""
    a, d, f, b, c, e = p.unbind(-1)
    return torch.stack([torch.stack([a, b, c], -1), torch.stack([b, d, e], -1),
                        torch.stack([c, e, f], -1)], -2)


def precisions(m: Mixture) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A = Sigma^-1 (symmetrised), b = A mu, and c = mu.b + logdet Sigma +
    3 log 2pi - 2 log pi (a dead component, pi = 0, gets -2 log pi = 2e30)."""
    A = torch.linalg.inv(m.sigma)
    A = 0.5 * (A + A.mT)
    b = torch.einsum("kij,kj->ki", A, m.mu)
    log_pi = torch.where(m.pi > 0, torch.log(torch.clamp(m.pi, min=1e-38)),
                         torch.full_like(m.pi, NEG_INF))
    c = (m.mu * b).sum(1) + torch.logdet(m.sigma) + 3.0 * LOG_2PI - 2.0 * log_pi
    return A, b, c


def loglik_weights(m: Mixture) -> torch.Tensor:
    """W [10, K] with log[pi_j N(y; mu_j, Sigma_j)] = -1/2 features(y) @ W."""
    A, b, c = precisions(m)
    return torch.stack([A[:, 0, 0], A[:, 1, 1], A[:, 2, 2], 2 * A[:, 0, 1], 2 * A[:, 0, 2],
                        2 * A[:, 1, 2], -2 * b[:, 0], -2 * b[:, 1], -2 * b[:, 2], c], 0)


def softmax_rows(logits: torch.Tensor, outlier: float | None = None):
    """Responsibilities [N, K] and log-evidence [N]. With an outlier logit l0
    the normaliser adds exp(l0). A row whose every logit is at the floor
    (a point whose components are all dead) gets zeros."""
    m = logits.max(1, keepdim=True).values
    if outlier is not None:
        m = torch.clamp(m, min=outlier)
    m_safe = torch.clamp(m, min=NEG_INF)
    e = torch.exp(logits - m_safe)
    s = e.sum(1, keepdim=True)
    if outlier is not None:
        s = s + torch.exp(outlier - m_safe)
    gamma = e / torch.clamp(s, min=1e-38)
    dead = m <= NEG_INF
    gamma = torch.where(dead, torch.zeros_like(gamma), gamma)
    lse = (m_safe + torch.log(torch.clamp(s, min=1e-38)))[:, 0]
    return gamma, torch.where(dead[:, 0], torch.zeros_like(lse), lse)


def child_columns(parent: torch.Tensor, branch: int) -> torch.Tensor:
    """[N, branch] indices of each point's parent's children."""
    return parent.long()[:, None] * branch + torch.arange(branch, device=parent.device)[None, :]


def estep(points, weights, m: Mixture, parent=None, branch=None):
    """Sufficient statistics S [K, 10] = Gamma^T features and the weighted
    log-likelihood; with a parent, each point sees its parent's children only."""
    W = loglik_weights(m)
    k = W.shape[1]
    S = torch.zeros((k, 10), dtype=points.dtype, device=points.device)
    ll = torch.zeros((), dtype=points.dtype, device=points.device)
    for lo in range(0, points.shape[0], BLOCK):
        psi = features(points[lo:lo + BLOCK])
        logits = -0.5 * (psi @ W)
        w = weights[lo:lo + BLOCK]
        if parent is None:
            gamma, lse = softmax_rows(logits)
        else:
            cols = child_columns(parent[lo:lo + BLOCK], branch)
            g, lse = softmax_rows(logits.gather(1, cols))
            gamma = torch.zeros_like(logits).scatter_(1, cols, g)
        S += (gamma * w[:, None]).mT @ psi
        ll += (lse * w).sum()
    return S, ll


def assign(points, m: Mixture, parent=None, branch=None) -> torch.Tensor:
    """[N] the most likely component (among the parent's children when a
    parent is given); ties go to the lowest index."""
    W = loglik_weights(m)
    out = []
    for lo in range(0, points.shape[0], BLOCK):
        logits = -0.5 * (features(points[lo:lo + BLOCK]) @ W)
        if parent is None:
            out.append(logits.argmax(1))
        else:
            cols = child_columns(parent[lo:lo + BLOCK], branch)
            out.append(cols.gather(1, logits.gather(1, cols).argmax(1, keepdim=True))[:, 0])
    return torch.cat(out)


def covariance_floor(sigma: torch.Tensor, floor: float) -> torch.Tensor:
    """Raise every eigenvalue to at least `floor` (less the allowance) by
    adding the deficit times I."""
    sym = 0.5 * (sigma + sigma.mT)
    lmin = torch.linalg.eigvalsh(sym)[:, 0]
    bound = torch.abs(torch.diagonal(sym, dim1=1, dim2=2).sum(1)) + torch.sqrt(
        torch.clamp((sym * sym).sum((1, 2)), min=0.0))
    bump = torch.clamp(floor - (lmin - FLOOR_ALLOWANCE * bound), min=0.0)
    return sym + bump[:, None, None] * torch.eye(3, dtype=sym.dtype, device=sym.device)


def mstep(S: torch.Tensor, total: float, cov_floor: float) -> Mixture:
    """pi = T0 / total, mu = T1 / T0, Sigma = T2 / T0 - mu mu^T + reg I,
    floored; a component holding too little weight is dead (pi 0, mu 0, I)."""
    T0, T1, T2 = S[:, 9], S[:, 6:9], sym_unpack(S[:, 0:6])
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    least = max(1e-6 * total, MIN_WEIGHT)
    empty = T0 <= least
    safe = torch.clamp(T0, min=least)
    mu = torch.where(empty[:, None], torch.zeros_like(T1), T1 / safe[:, None])
    sigma = T2 / safe[:, None, None] - mu[:, :, None] * mu[:, None, :] + COV_REG * eye
    sigma = torch.where(empty[:, None, None], eye.expand_as(sigma), sigma)
    sigma = covariance_floor(sigma, max(cov_floor, COV_REG))
    pi = torch.where(empty, torch.zeros_like(T0), T0 / total)
    return Mixture(pi, mu, sigma)


def init_mixture(points32: torch.Tensor, weights32, k: int, generator: torch.Generator, dtype,
                 device) -> Mixture:
    """The level-0 start: k means drawn from the points without replacement
    (torch.randperm, or by weight with torch.multinomial, on the CPU
    generator), an isotropic covariance from the bounding box's longest side,
    equal weights. points32 [N, 3] and weights32 [N] (or None) are the float32
    cloud on the CPU."""
    n = points32.shape[0]
    if weights32 is None:
        idx = torch.randperm(n, generator=generator)[:k]
        live = points32
    else:
        w = weights32.to(torch.float64)
        idx = torch.multinomial(w / w.sum(), k, replacement=False, generator=generator)
        live = points32[weights32 > 0]
    p = live.to(torch.float64)
    scale = max(float((p.amax(0) - p.amin(0)).max()), 1e-6)
    var = (scale / max(k ** (1.0 / 3.0), 1.0)) ** 2
    mu = points32[idx].to(dtype=dtype, device=device)
    sigma = (var * torch.eye(3, dtype=dtype, device=device)).expand(k, 3, 3).clone()
    return Mixture(torch.full((k,), 1.0 / k, dtype=dtype, device=device), mu, sigma)


def seed_children(m: Mixture, branch: int) -> Mixture:
    """Each parent's children: means at 0.6 of the parent's Cholesky factor
    along the cube's corners, covariances 0.35 of the parent's, weight split
    evenly."""
    if branch != 8:
        raise ValueError("the reference seeds branch 8 only")
    eye = torch.eye(3, dtype=m.sigma.dtype, device=m.sigma.device)
    chol = torch.linalg.cholesky(m.sigma + CHOL_JITTER * eye)
    dirs = torch.as_tensor(CUBE, dtype=m.mu.dtype, device=m.mu.device)
    mu = (m.mu[:, None, :] + CHILD_OFFSET * torch.einsum("kij,bj->kbi", chol, dirs)).reshape(-1, 3)
    return Mixture(torch.repeat_interleave(m.pi / branch, branch),
                   mu, torch.repeat_interleave(CHILD_SCALE * m.sigma, branch, dim=0))


def fit_tree(points32: torch.Tensor, weights32, branch: int, levels: int, sweeps: int,
             generator: torch.Generator, dtype=torch.float64, device="cpu") -> list[Mixture]:
    """The tree's levels, coarse to fine: level 0 fitted to every point, each
    further level's children fitted to the points the level above assigns to
    their parent. points32, weights32: the float32 cloud and weights (None:
    all 1) on the CPU."""
    pts = points32.to(dtype=dtype, device=device)
    w = (torch.ones(pts.shape[0], dtype=dtype, device=device) if weights32 is None
         else weights32.to(dtype=dtype, device=device))
    total = float(w.sum())
    mean = (pts * w[:, None]).sum(0) / total
    cov_floor = COV_FLOOR_REL * float((w[:, None] * (pts - mean) ** 2).sum() / (3.0 * total))
    m = init_mixture(points32, weights32, branch, generator, dtype, device)
    out, parent = [], None
    for level in range(levels):
        if level:
            parent = assign(pts, m, parent, None if parent is None else branch)
            m = seed_children(m, branch)
        for _ in range(sweeps):
            S, _ = estep(pts, w, m, parent, branch)
            m = mstep(S, total, cov_floor)
        out.append(m)
    return out


def complexity(m: Mixture) -> torch.Tensor:
    """The smallest eigenvalue's share of the trace (planar nodes score low)."""
    eig = torch.linalg.eigvalsh(0.5 * (m.sigma + m.sigma.mT))
    return eig[:, 0] / torch.clamp(eig.sum(1), min=1e-30)


def cut(levels: list[Mixture], branch: int, threshold: float) -> Mixture:
    """The mixed-resolution mixture: a node of the level above the leaves
    whose complexity is at most `threshold` (and whose children hold weight)
    stands for its children; the rest are the leaves. Dead components are
    dropped; weights sum to 1."""
    if threshold <= 0.0 or len(levels) < 2:
        return levels[-1]
    coarse, leaves = levels[-2], levels[-1]
    mass = leaves.pi.reshape(-1, branch).sum(1)
    keep = (complexity(coarse) <= threshold) & (mass > 0)
    pi = torch.cat([torch.where(keep, mass, torch.zeros_like(mass)),
                    torch.where(torch.repeat_interleave(keep, branch),
                                torch.zeros_like(leaves.pi), leaves.pi)])
    live = pi > 0
    pi = pi / torch.clamp(pi.sum(), min=1e-30)
    return Mixture(pi[live], torch.cat([coarse.mu, leaves.mu])[live],
                   torch.cat([coarse.sigma, leaves.sigma])[live])
