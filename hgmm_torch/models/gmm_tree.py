"""Hierarchical GMM tree: level-synchronous build and adaptive cut.

Counterpart of ``hgmm/models/gmm_tree.py``. Level l holds branch^(l+1)
Gaussians as flat arrays; the child block of node p is [p*J, (p+1)*J) at
level l+1. Level 0 is a flat EM fit; each deeper level seeds J children per
parent from the parent's covariance and runs EM sweeps in which every point
sees only its parent's children (``ops.em_stats_masked``). Parents are hard
(argmax) assignments (``ops.assign``), re-derived after each level.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hgmm_torch import ops
from hgmm_torch.models.gmm import em_fit, init_params, scene_variance, total_weight
from hgmm_torch.ops.gaussians import (
    MixtureParams,
    mstep_update,
    pack_loglik_weights,
    sym3_eigvalsh,
)

# Child seeding directions for J=8: cube corners (unit norm).
_CUBE = np.array(
    [[-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1],
     [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1]],
    dtype=np.float32,
) / np.sqrt(3.0)


def _child_directions(branch: int) -> np.ndarray:
    if branch == 8:
        return _CUBE
    # Deterministic pseudo-uniform directions for other branch factors. The
    # JAX package draws these from jax.random, so they differ from its own.
    g = np.random.default_rng(7).standard_normal((branch, 3)).astype(np.float32)
    return g / np.linalg.norm(g, axis=1, keepdims=True)


def seed_children(parents: MixtureParams, branch: int) -> MixtureParams:
    """Split every parent into `branch` children: means offset by 0.6 along
    the parent's Cholesky directions, covariance scaled by 0.35, weight split
    evenly. Deterministic."""
    kp = parents.pi.shape[0]
    dirs = torch.from_numpy(_child_directions(branch)).to(parents.mu)  # [J, 3]
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
    params0, ll0 = em_fit(
        points, init0, n_iters=em_iters, cov_reg=cov_reg, cov_type=cov_type,
        point_weights=point_weights, cov_floor_rel=cov_floor_rel,
    )
    level_params = [params0]
    level_logliks = [ll0[-1]]
    prep = ops.prepare(points, point_weights)  # one buffer for every level
    parent = ops.assign(prep, pack_loglik_weights(params0))
    for _ in range(1, levels):
        p = seed_children(level_params[-1], branch)
        ll = None
        for _ in range(em_iters):
            stats = ops.em_stats_masked(prep, pack_loglik_weights(p), parent, branch)
            T0, T1, T2 = ops.unpack_suffstats(stats.S)
            p = mstep_update(
                T0, T1, T2, total, cov_reg=cov_reg, cov_type=cov_type, cov_floor=cov_floor
            )
            ll = stats.loglik
        level_params.append(p)
        level_logliks.append(ll)
        parent = ops.assign(prep, pack_loglik_weights(p), parent, branch)
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
