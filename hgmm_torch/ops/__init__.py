"""hgmm_torch.ops — the E-step contractions, dispatched by device.

Counterpart of ``hgmm/ops/__init__.py``. A tensor on the CPU goes to the
plain version in ``em_ref``; a CUDA tensor goes to the CUDA kernel in
``fused_em``, which launches or raises. There is no other switch.

Loops call ``prepare(points)`` once and pass the ``Prepared`` buffer to every
sweep or iteration; raw [N, 3] points are accepted too and prepared per call.
The E-step functions take W [10, K] or the packed table of a fit
(``Packed``); a fit's sweep is ``em_partials`` on ``fit.table`` (on the card
the E-step body alone, its partial rows not summed), then ``em_step`` on the
fit state ``new_fit`` made, which sums the rows and runs the M-step. A
sharded sweep or scan step sums this device's rows to one row first
(``em_row``, ``reg_row``) and adds that row over the mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hgmm_torch.ops import em_ref, fused_em
from hgmm_torch.ops.em_ref import EmFit, EmPartials, EmStats, Packed, RegScan, RegStats  # noqa: F401
from hgmm_torch.ops.gaussians import (  # noqa: F401
    PHI_DIM,
    MixtureParams,
    features,
    mstep_update,
    pack_loglik_weights,
    precision_terms,
    sym_pack,
    sym_unpack,
    unpack_suffstats,
)


class Prepared(NamedTuple):
    """The point buffer every kernel reads: [4, N] f32, rows x, y, z, w
    (w = the point weight, 1 when none was given)."""

    pts4: torch.Tensor

    @property
    def n(self) -> int:
        return self.pts4.shape[1]

    @property
    def points(self) -> torch.Tensor:  # [N, 3] view
        return self.pts4[:3].T

    @property
    def weights(self) -> torch.Tensor:  # [N] view
        return self.pts4[3]


def prepare(points: torch.Tensor, point_weights: torch.Tensor | None = None) -> Prepared:
    """Build the [4, N] buffer once per fit or registration scan."""
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points: expected [N, 3], got {tuple(points.shape)}")
    pts = points.to(torch.float32)
    w = (torch.ones_like(pts[:, 0]) if point_weights is None
         else point_weights.to(device=pts.device, dtype=torch.float32))
    return Prepared(torch.cat([pts.T, w[None, :]], dim=0).contiguous())


def _prep(points, point_weights=None) -> Prepared:
    """A Prepared as it is (its weights were given to prepare(); passing
    point_weights beside it raises, as in the reference), raw points prepared
    with point_weights."""
    if isinstance(points, Prepared):
        if point_weights is not None:
            raise ValueError("weights are baked into Prepared at prepare()")
        return points
    return prepare(points, point_weights)


def em_stats(points, W, point_weights=None, outlier_logit=None) -> EmStats:
    """E-step + sufficient statistics (see em_ref.em_stats)."""
    p = _prep(points, point_weights)
    if p.pts4.is_cuda:
        return fused_em.em_stats(p.pts4, W, outlier_logit)
    return em_ref.em_stats(p.points, W, p.weights, outlier_logit)


def em_stats_masked(points, W, parent, branch, point_weights=None) -> EmStats:
    """Tree-level E-step masked to each point's parent's child block."""
    p = _prep(points, point_weights)
    if p.pts4.is_cuda:
        return fused_em.em_stats_masked(p.pts4, W, parent, branch)
    return em_ref.em_stats_masked(p.points, W, parent, branch, p.weights)


class Grouped(NamedTuple):
    """A tree level's points and parents for the masked E-step on the CPU;
    on the card group_by_parent() returns fused_em.ParentGroups, the points
    sorted by parent and their chunk plan."""

    prep: Prepared
    parent: torch.Tensor
    branch: int


def group_by_parent(points, parent, branch: int, k: int):
    """Group a level's points by parent once, for every sweep on that
    assignment (em_stats_grouped). On the card this reads the per-parent
    counts on the host once."""
    p = _prep(points)
    if p.pts4.is_cuda:
        return fused_em.group_by_parent(p.pts4, parent, branch, k)
    return Grouped(p, parent, branch)


def em_stats_grouped(groups, W) -> EmStats:
    """em_stats_masked on grouped points."""
    if isinstance(groups, fused_em.ParentGroups):
        return fused_em.em_stats_grouped(groups, W)
    return em_ref.em_stats_masked(groups.prep.points, W, groups.parent, groups.branch,
                                  groups.prep.weights)


def new_fit(init: MixtureParams, n_iters: int, total, cov_floor, masked: bool = False) -> EmFit:
    """The state of a fit of `n_iters` sweeps from `init` on init's device
    (em_ref.EmFit): its table has the rows that an unmasked (or, masked=True,
    a grouped) em_stats call of K = init's reads."""
    return em_ref.new_fit(init, n_iters, total, cov_floor, fused_em.table_rows(init.k, masked))


def em_partials(data, W) -> EmPartials:
    """The E-step of a fit's sweep on `data`, a Prepared buffer or a level's
    points grouped by parent (group_by_parent): on the card the body's
    partial rows, one launch, summed by em_step; on the CPU the plain
    statistics as one row (em_ref.partials_of)."""
    if isinstance(data, fused_em.ParentGroups):
        return fused_em.em_partials_grouped(data, W)
    if isinstance(data, Prepared) and data.pts4.is_cuda:
        return fused_em.em_partials(data.pts4, W)
    return em_ref.partials_of(em_stats(data, W) if isinstance(data, Prepared) else em_stats_grouped(data, W))


def em_row(data, W) -> EmPartials:
    """The E-step of a sharded sweep: em_partials summed on this device to
    one plain row [1, K*10 + 1] (S row-major, then the loglik), which the
    sweep adds over the mesh before em_step. The grouped body's rows depend on
    the rank's own points by parent, so they cannot be summed across ranks
    element by element; one row is also K*10 + 1 floats to send, not nb
    times that. On the card the body and its reduce kernel; on the CPU
    em_partials' one row."""
    if isinstance(data, fused_em.ParentGroups):
        out = torch.empty((1, data.k * 10 + 1), dtype=torch.float32, device=data.pts4.device)
        fused_em.em_partials_grouped(data, W, out)
        return EmPartials(out, data.k, 1, 1)
    if isinstance(data, Prepared) and data.pts4.is_cuda:
        k = W.k if isinstance(W, Packed) else W.shape[1]
        out = torch.empty((1, k * 10 + 1), dtype=torch.float32, device=data.pts4.device)
        fused_em.em_partials(data.pts4, W, None, out)
        return EmPartials(out, k, 1, 1)
    return em_partials(data, W)


def em_step(stats, fit: EmFit, it: int, cov_reg: float = 1e-6, cov_type: str = "full") -> None:
    """The M-step of sweep `it` on the fit state, in place (em_ref.em_step),
    from the sweep's EmPartials (em_partials)."""
    if fit.mu.is_cuda:
        return fused_em.em_step(stats, fit, it, cov_reg, cov_type)
    return em_ref.em_step(stats, fit, it, cov_reg, cov_type)


def assign(points, W, parent=None, branch=None) -> torch.Tensor:
    """Per-point argmax component, [N] int32."""
    p = _prep(points)
    if p.pts4.is_cuda:
        return fused_em.assign(p.pts4, W, parent, branch)
    return em_ref.assign(p.points, W, parent, branch)


def reg_stats(x, W, mu, A6, b3, pose, point_weights=None, top_k=None, outlier_logit=None) -> RegStats:
    """Registration statistics at pose (R, t), applied to the source x."""
    p = _prep(x, point_weights)
    if p.pts4.is_cuda:
        return fused_em.reg_stats(p.pts4, W, mu, A6, b3, pose, top_k, outlier_logit)
    return em_ref.reg_stats(p.points, W, mu, A6, b3, pose, p.weights, top_k, outlier_logit)


class RegProblem(NamedTuple):
    """The inputs of a registration scan on the CPU; on the card
    reg_problem() returns fused_em.RegTables, the same built once."""

    prep: Prepared
    W: torch.Tensor
    mu: torch.Tensor
    A6: torch.Tensor
    b3: torch.Tensor
    top_k: int | None
    outlier_logit: float | None


def reg_problem(x, W, mu, A6, b3, point_weights=None, top_k=None, outlier_logit=None):
    """What every iteration of one scan reuses, built once."""
    p = _prep(x, point_weights)
    if p.pts4.is_cuda:
        return fused_em.reg_tables(p.pts4, W, mu, A6, b3, top_k, outlier_logit)
    return RegProblem(p, W, mu, A6, b3, top_k, outlier_logit)


def new_scan(R: torch.Tensor, t: torch.Tensor, n_iters: int) -> RegScan:
    """A scan's state on the pose's device (float32 on the card)."""
    if R.is_cuda:
        return fused_em.new_scan(R, t, n_iters)
    return em_ref.new_scan(R, t, n_iters)


def reg_partials(problem, scan: RegScan) -> torch.Tensor:
    """The [nb, 59] reg_stats rows at the scan's pose. The kernel reads the
    pose and the done flag on the card (and does nothing once done); the CPU
    path reads the flag on the host and skips its work the same way."""
    if isinstance(problem, fused_em.RegTables):
        return fused_em.reg_partials(problem, scan.state, scan.state[em_ref.SCAN_DONE:em_ref.SCAN_DONE + 1])
    if bool(scan.done):
        return torch.zeros((1, em_ref.REG_OUT), dtype=scan.state.dtype)
    st = em_ref.reg_stats(problem.prep.points, problem.W, problem.mu, problem.A6, problem.b3, scan.pose,
                          problem.prep.weights, problem.top_k, problem.outlier_logit)
    return em_ref.pack_reg(st).to(scan.state.dtype)


def reg_row(problem, scan: RegScan) -> torch.Tensor:
    """reg_partials summed on this device to one row [1, 59], which a
    sharded scan step adds over the mesh before reg_step (a shard's row count
    depends on its size, and shards given by shard_points_from_host differ):
    on the card the statistics kernel and its reduce kernel (which, once the
    scan is done, sums the last live rows again: reg_step then reads nothing);
    on the CPU reg_partials' one row."""
    if isinstance(problem, fused_em.RegTables):
        out = torch.empty((1, em_ref.REG_OUT), dtype=torch.float32, device=problem.pts4.device)
        fused_em.reg_partials(problem, scan.state, scan.state[em_ref.SCAN_DONE:em_ref.SCAN_DONE + 1],
                              out)
        return out
    return reg_partials(problem, scan)


def reg_step(partial, scan: RegScan, it: int, solver: int, first: bool, last: bool, tol: float) -> None:
    """One step of the registration iterate on the scan (in place)."""
    if scan.state.is_cuda:
        return fused_em.reg_step(partial, scan, it, solver, first, last, tol)
    return em_ref.reg_step(partial, scan, it, solver, first, last, tol)
