"""Hierarchical GMM tree: level-synchronous build and adaptive cut.

Counterpart of ``hgmm/models/gmm_tree.py``. Level l holds branch^(l+1)
Gaussians as flat arrays; the child block of node p is [p*J, (p+1)*J) at
level l+1. Level 0 is a flat EM fit; each deeper level seeds J children per
parent from the parent's covariance and runs EM sweeps in which every point
sees only its parent's children (``ops.em_stats_grouped`` on the points
grouped by parent once a level). Parents are hard (argmax) assignments
(``ops.assign``), re-derived after each level.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from hgmm_torch import ops
from hgmm_torch.models.gmm import em_sweeps, init_params, scene_variance, total_weight
from hgmm_torch.ops.gaussians import MixtureParams, sym3_eigvalsh
from hgmm_torch.utils.profiling import span

# Child seeding directions for J=8: cube corners (unit norm).
_CUBE = np.array(
    [[-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1],
     [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1]],
    dtype=np.float32,
) / np.sqrt(3.0)


def _threefry2x32(k1: np.uint32, k2: np.uint32, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) on uint32 counter pairs."""
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _jax_normal(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """What jax.random.normal(jax.random.PRNGKey(seed), shape) draws in
    float32, with jax's default threefry2x32 and partitionable counters:
    counter i of the flattened shape is hashed as the pair (0, i), the two
    words are xor-ed, the top 23 bits become a uniform in
    [nextafter(-1, 0), 1), and sqrt(2) erfinv maps it to a normal."""
    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF),
                               np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    one = np.float32(1.0)
    u = ((b0 ^ b1) >> np.uint32(9) | one.view(np.uint32)).view(np.float32) - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, u * (one - lo) + lo)
    z = np.sqrt(2.0) * torch.special.erfinv(torch.from_numpy(u.astype(np.float64)))
    return z.numpy().astype(np.float32).reshape(shape)


def _child_directions(branch: int) -> np.ndarray:
    if branch == 8:
        return _CUBE
    # Deterministic pseudo-uniform directions for other branch factors: the
    # JAX package's draw from jax.random.PRNGKey(7), reproduced bit for bit
    # up to the last rounding of erfinv.
    g = _jax_normal(7, (branch, 3))
    return g / np.linalg.norm(g, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _directions_on(branch: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The child directions as a tensor on `device`, copied there once (a copy
    to the card makes the host wait)."""
    return torch.from_numpy(_child_directions(branch)).to(dtype=dtype, device=device)


def seed_children(parents: MixtureParams, branch: int) -> MixtureParams:
    """Split every parent into `branch` children: means offset by 0.6 along
    the parent's Cholesky directions, covariance scaled by 0.35, weight split
    evenly. Deterministic."""
    kp = parents.pi.shape[0]
    dirs = _directions_on(branch, parents.mu.dtype, parents.mu.device)  # [J, 3]
    eye = torch.eye(3, dtype=parents.sigma.dtype, device=parents.sigma.device)
    chol = torch.linalg.cholesky_ex(parents.sigma + 1e-9 * eye).L  # [Kp, 3, 3]
    offsets = torch.einsum("kij,bj->kbi", chol, dirs)  # [Kp, J, 3]
    mu = (parents.mu[:, None, :] + 0.6 * offsets).reshape(kp * branch, 3)
    sigma = torch.repeat_interleave(parents.sigma * 0.35, branch, dim=0)
    pi = torch.repeat_interleave(parents.pi / branch, branch, dim=0)
    return MixtureParams(pi=pi, mu=mu, sigma=sigma)


def _fit_tree(
    points: torch.Tensor,
    init0: MixtureParams,
    branch: int,
    levels: int,
    em_iters: int,
    cov_reg: float,
    cov_type: str,
    point_weights: torch.Tensor | None = None,
    cov_floor_rel: float = 1e-4,
):
    """Level-synchronous build. Returns (per-level params, the final loglik
    of each level [levels])."""
    total = total_weight(points, point_weights)
    cov_floor = cov_floor_rel * scene_variance(points, point_weights)
    prep = ops.prepare(points, point_weights)  # one buffer for every level
    return fit_levels(prep, init0, branch, levels, em_iters, total, cov_floor, cov_reg, cov_type)


def fit_levels(prep: ops.Prepared, init0: MixtureParams, branch: int, levels: int, em_iters: int,
               total, cov_floor, cov_reg: float, cov_type: str, mesh=None):
    """The levels of _fit_tree on a prepared buffer, with its total weight
    and covariance floor; with a mesh, on this rank's shard, each sweep added
    over the mesh (em_sweeps) and each rank grouping its own points by
    parent. Returns (per-level params, the final loglik of each level)."""
    fit = em_sweeps(prep, init0, em_iters, total, cov_floor, cov_reg, cov_type, mesh)
    level_params = [fit.params]
    level_logliks = [fit.logliks[-1]]
    parent = None
    for _ in range(1, levels):
        with span("hgmm_torch.fit.group"):
            parent = ops.assign(prep, fit.table, parent, None if parent is None else branch)
            p = seed_children(level_params[-1], branch)
            # One grouping of the points by parent for the level's sweeps.
            groups = ops.group_by_parent(prep, parent, branch, p.pi.shape[0])
        fit = em_sweeps(groups, p, em_iters, total, cov_floor, cov_reg, cov_type, mesh)
        level_params.append(fit.params)
        level_logliks.append(fit.logliks[-1])
    return tuple(level_params), torch.stack(level_logliks)


def node_complexity(params: MixtureParams) -> torch.Tensor:
    """Per-node complexity in [0, 1]: the smallest eigenvalue's share of the
    covariance trace (near-planar nodes score low)."""
    eigs = sym3_eigvalsh(params.sigma)
    return eigs[:, 0] / torch.clamp(torch.sum(eigs, dim=1), min=1e-30)


@dataclasses.dataclass
class GmmTree:
    """Fitted hierarchical GMM; levels[l].pi are global weights (each level
    sums to 1)."""

    levels: tuple[MixtureParams, ...]
    branch: int

    @classmethod
    def fit(
        cls,
        points: torch.Tensor,
        branch: int = 8,
        levels: int = 3,
        em_iters: int = 12,
        generator: torch.Generator | None = None,
        cov_reg: float = 1e-6,
        cov_type: str = "full",
        point_weights: torch.Tensor | None = None,
        cov_floor_rel: float = 1e-4,
        init0: MixtureParams | None = None,
    ) -> tuple["GmmTree", torch.Tensor]:
        """init0: optional level-0 start; None draws one from the data with
        `generator` (seed 0 when None)."""
        with span("hgmm_torch.fit"):
            if init0 is None:
                if generator is None:
                    generator = torch.Generator().manual_seed(0)
                init0 = init_params(points, branch, generator, point_weights=point_weights)
            lvls, logliks = _fit_tree(
                points, init0, branch, levels, em_iters, cov_reg, cov_type, point_weights,
                cov_floor_rel,
            )
            return cls(levels=lvls, branch=branch), logliks

    @property
    def n_leaves(self) -> int:
        return self.levels[-1].pi.shape[0]

    def leaf_mixture(self) -> MixtureParams:
        return self.levels[-1]

    def cut_mixture(self, complexity_threshold: float = 0.0, compact: bool = True) -> MixtureParams:
        """Mixed-resolution mixture: a node of level L-2 whose complexity is
        <= threshold replaces its children and takes exactly their total
        weight; other nodes are replaced by their children. With compact=True
        the zero-weight components are dropped on the host and K is padded
        to a multiple of 64. threshold 0 gives the leaves."""
        if len(self.levels) < 2 or complexity_threshold <= 0.0:
            return self.leaf_mixture()
        coarse, leaves = self.levels[-2], self.levels[-1]
        leaf_mass = torch.sum(leaves.pi.reshape(-1, self.branch), dim=1)
        keep_coarse = (node_complexity(coarse) <= complexity_threshold) & (leaf_mass > 0)
        zero = torch.zeros_like(leaf_mass)
        pi = torch.cat([
            torch.where(keep_coarse, leaf_mass, zero),
            torch.where(torch.repeat_interleave(keep_coarse, self.branch),
                        torch.zeros_like(leaves.pi), leaves.pi),
        ])
        pi = pi / torch.clamp(torch.sum(pi), min=1e-30)
        out = MixtureParams(
            pi=pi, mu=torch.cat([coarse.mu, leaves.mu]), sigma=torch.cat([coarse.sigma, leaves.sigma])
        )
        return compact_mixture(out) if compact else out


def compact_mixture(params: MixtureParams, bucket: int = 64) -> MixtureParams:
    """Drop zero-weight components and pad K up to a multiple of `bucket`
    with identity-covariance, pi = 0 components (inert in every kernel).
    Runs on the host: one device-to-host copy; the result goes back to the
    parameters' device."""
    dev = params.pi.device
    pi = params.pi.detach().cpu().numpy()
    keep = np.flatnonzero(pi > 0)
    if keep.size == 0:
        keep = np.array([0])
    k_pad = max(bucket, -(-keep.size // bucket) * bucket)
    if k_pad == pi.shape[0] and keep.size == pi.shape[0]:
        return params
    pad = k_pad - keep.size
    pi_c = np.concatenate([pi[keep], np.zeros(pad, pi.dtype)])
    mu_c = np.concatenate([params.mu.detach().cpu().numpy()[keep], np.zeros((pad, 3), np.float32)])
    sigma_c = np.concatenate([
        params.sigma.detach().cpu().numpy()[keep],
        np.broadcast_to(np.eye(3, dtype=np.float32), (pad, 3, 3)),
    ])
    return MixtureParams(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in (pi_c, mu_c, sigma_c)))


def fit_gmm_tree(points, branch=8, levels=3, em_iters=12, generator=None, **kw):
    return GmmTree.fit(points, branch=branch, levels=levels, em_iters=em_iters,
                       generator=generator, **kw)
