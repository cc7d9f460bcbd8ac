"""Flat K-component GMM fit via EM.

Counterpart of ``hgmm/models/gmm.py``. The EM loop is a Python loop over
sweeps (``em_sweeps``); each sweep is one E-step contraction
(``hgmm_torch.ops.em_partials``) on the fit's packed weight table and the
closed-form M-step (``hgmm_torch.ops.em_step``), which writes the next
parameters, table and loglik in place: on the card the E-step kernel's body
and the M-step kernel, which sums the body's partial rows, with no value read
back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from hgmm_torch import ops
from hgmm_torch.ops.gaussians import MixtureParams, pack_loglik_weights


def init_params(
    points: torch.Tensor,
    k: int,
    generator: torch.Generator | None = None,
    point_weights: torch.Tensor | None = None,
) -> MixtureParams:
    """Random-subset means and an isotropic covariance from the bounding box.

    Means are drawn without replacement, with probability proportional to
    the weight when weights are given (zero-weight padding never seeds a
    component). Deterministic given the generator's state; the draws differ
    from the JAX package's ``jax.random.choice``.
    """
    n = points.shape[0]
    if point_weights is None:
        idx = torch.randperm(n, generator=generator)[:k]
        lo = torch.amin(points, dim=0)
        hi = torch.amax(points, dim=0)
    else:
        w = point_weights.detach().to("cpu", torch.float64)
        n_live = int((w > 0).sum())
        if n_live < k:
            raise ValueError(
                f"init_params: only {n_live} positive-weight points for k={k} components"
            )
        idx = torch.multinomial(w / w.sum(), k, replacement=False, generator=generator)
        live = (point_weights > 0)[:, None]
        lo = torch.amin(torch.where(live, points, torch.full_like(points, float("inf"))), dim=0)
        hi = torch.amax(torch.where(live, points, torch.full_like(points, float("-inf"))), dim=0)
    mu = points[idx.to(points.device)]
    scale = torch.clamp(torch.max(hi - lo), min=1e-6)
    var = (scale / max(k ** (1.0 / 3.0), 1.0)) ** 2
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    sigma = (var * eye).expand(k, 3, 3).clone()
    pi = torch.full((k,), 1.0 / k, dtype=points.dtype, device=points.device)
    return MixtureParams(pi=pi, mu=mu, sigma=sigma)


def scene_variance(points: torch.Tensor, point_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted mean squared deviation per axis (scalar, data units^2)."""
    if point_weights is None:
        mean = torch.mean(points, dim=0)
        return torch.mean((points - mean) ** 2)
    w = point_weights[:, None]
    tw = torch.clamp(torch.sum(point_weights), min=1e-30)
    mean = torch.sum(points * w, dim=0) / tw
    return torch.sum(w * (points - mean) ** 2) / (3.0 * tw)


def total_weight(points: torch.Tensor, point_weights: torch.Tensor | None) -> torch.Tensor:
    if point_weights is None:
        return torch.full((), float(points.shape[0]), dtype=points.dtype, device=points.device)
    return torch.sum(point_weights)


def em_sweeps(data, init: MixtureParams, n_iters: int, total, cov_floor, cov_reg: float = 1e-6,
              cov_type: str = "full", mesh=None) -> ops.EmFit:
    """`n_iters` EM sweeps from `init` on `data`: an ops.Prepared buffer, or
    a tree level's points grouped by parent (ops.group_by_parent). Each sweep
    is the E-step on the fit's packed table (ops.em_partials) and
    ops.em_step; total and cov_floor are 0-d tensors on the data's device.
    With a mesh (hgmm_torch.parallel), `data` is this rank's shard, total and
    cov_floor are the mesh's, and each sweep sums its E-step to one row
    (ops.em_row) and adds that row over the mesh before the M-step, which
    then runs replicated. Returns the fit state: params, table, logliks
    [n_iters]."""
    fit = ops.new_fit(init, n_iters, total, cov_floor, masked=not isinstance(data, ops.Prepared))
    for it in range(n_iters):
        if mesh is None:
            parts = ops.em_partials(data, fit.table)
        else:
            parts = ops.em_row(data, fit.table)
            mesh.all_reduce_(parts.partial)
        ops.em_step(parts, fit, it, cov_reg, cov_type)
    return fit


def em_fit(
    points: torch.Tensor,
    init: MixtureParams,
    n_iters: int = 30,
    cov_reg: float = 1e-6,
    cov_type: str = "full",
    point_weights: torch.Tensor | None = None,
    cov_floor_rel: float = 1e-4,
) -> tuple[MixtureParams, torch.Tensor]:
    """Run `n_iters` EM sweeps; returns (params, loglik history [n_iters]).

    cov_floor_rel: covariance-eigenvalue floor as a fraction of the scene
    variance, so covariances on degenerate data (points on a curve) stop
    collapsing at a physically small scale."""
    total = total_weight(points, point_weights)
    cov_floor = cov_floor_rel * scene_variance(points, point_weights)
    fit = em_sweeps(ops.prepare(points, point_weights), init, n_iters, total, cov_floor, cov_reg,
                    cov_type)
    return fit.params, fit.logliks


def log_likelihood(params: MixtureParams, points: torch.Tensor) -> torch.Tensor:
    """Mean per-point log-likelihood under the mixture."""
    return ops.em_stats(points, pack_loglik_weights(params)).loglik / points.shape[0]


@dataclasses.dataclass
class Gmm:
    """Fitted flat GMM over a target cloud."""

    params: MixtureParams

    @classmethod
    def fit(
        cls,
        points: torch.Tensor,
        k: int = 64,
        n_iters: int = 30,
        generator: torch.Generator | None = None,
        cov_reg: float = 1e-6,
        cov_type: str = "full",
        cov_floor_rel: float = 1e-4,
        point_weights: torch.Tensor | None = None,
    ) -> tuple["Gmm", torch.Tensor]:
        """generator: draws the initial means (seed 0 when None)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = init_params(points, k, generator, point_weights=point_weights)
        params, logliks = em_fit(
            points, init, n_iters=n_iters, cov_reg=cov_reg, cov_type=cov_type,
            cov_floor_rel=cov_floor_rel, point_weights=point_weights,
        )
        return cls(params), logliks

    def log_likelihood(self, points: torch.Tensor) -> torch.Tensor:
        return log_likelihood(self.params, points)


# The reference's names: hgmm.GmmParams is the mixture tuple, hgmm.fit_gmm a
# flat fit.
GmmParams = MixtureParams


def fit_gmm(points, k=64, n_iters=30, generator=None, **kw) -> tuple[Gmm, torch.Tensor]:
    return Gmm.fit(points, k=k, n_iters=n_iters, generator=generator, **kw)
