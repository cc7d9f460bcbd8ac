"""Sharded EM and registration over a mesh (BASELINE.json config 5).

Counterpart of ``hgmm/parallel/sharded.py``. Each function is one rank's
program (``mesh.per_rank``: given an ``EmulatedMesh`` it runs on each of its
ranks and returns rank 0's result). A rank holds its shard of the points;
every E-step reduces on the rank to one row of O(K) sufficient statistics
(``ops.em_row``) or of the 59 pose statistics (``ops.reg_row``), and that row
is the only traffic: ``mesh.all_reduce_``. Mixture parameters, the M-step
(``ops.em_step``) and the pose step (``ops.reg_step``) are replicated: every
rank computes them from the same sums. On the card nothing in a sweep or a
scan step reads back to the host: the body, its reduce, the all-reduce and
the step kernel, all queued.

The points are the whole cloud, which each rank pads with zero-weight rows
to a multiple of the mesh size and slices to its equal share, or the rank's
own rows (``mesh.shard_points_from_host``). The global scalars of a fit, the
live weight and the scene variance behind the covariance floor, are summed
over the mesh in both cases.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hgmm_torch import ops
from hgmm_torch.models.gmm import em_sweeps, init_params
from hgmm_torch.models.gmm_tree import GmmTree, fit_levels
from hgmm_torch.models.se3 import Pose
from hgmm_torch.ops.gaussians import MixtureParams
from hgmm_torch.parallel.mesh import ShardedPoints, make_mesh, per_rank, points_sharding
from hgmm_torch.pipelines.register import model_terms, run_registration_scan


def pad_points_for_mesh(points: torch.Tensor, mesh, tile: int = 1):
    """Pad [N, 3] so N divides mesh.size * tile; returns (points, weights)
    with zero weight on the padding rows."""
    n = points.shape[0]
    mult = mesh.size * tile
    n_pad = -(-n // mult) * mult
    like = dict(dtype=points.dtype, device=points.device)
    w = torch.ones(n, **like)
    if n_pad != n:
        points = torch.cat([points, torch.zeros((n_pad - n, 3), **like)])
        w = torch.cat([w, torch.zeros(n_pad - n, **like)])
    return points, w


def _mesh_for(points, mesh):
    """The mesh given, else make_mesh() on the points' device."""
    if mesh is not None:
        return mesh
    return make_mesh((points.local if isinstance(points, ShardedPoints) else points).device)


def _shard(points, mesh, point_weights):
    """This rank's rows and their weights, on the mesh's device: a
    ShardedPoints' own rows, or the rank's share of the whole cloud padded to
    the mesh (padding weight 0)."""
    if isinstance(points, ShardedPoints):
        local = points.local
        w = (torch.ones(local.shape[0], dtype=local.dtype, device=local.device)
             if point_weights is None else point_weights.to(device=local.device, dtype=local.dtype))
        return local, w
    n = points.shape[0]
    padded, w = pad_points_for_mesh(points, mesh)
    if point_weights is not None:
        w = torch.cat([point_weights.to(device=w.device, dtype=w.dtype), w[n:]])
    rows = points_sharding(mesh, padded.shape[0])
    return padded[rows].to(mesh.device), w[rows].to(mesh.device)


def _mesh_scalars(prep: ops.Prepared, mesh, cov_floor_rel: float):
    """The fit's total weight and covariance floor (cov_floor_rel times the
    weighted scene variance, models.gmm.scene_variance) over every rank: Σw,
    Σwx and Σwx² summed over the mesh in float64, one all-reduce. 0-d float32
    tensors on the mesh's device."""
    p = prep.pts4.double()
    x, w = p[:3], p[3]
    m = torch.cat([w.sum().reshape(1), (x * w).sum(1), (x * x * w).sum(1)])
    mesh.all_reduce_(m)
    tw = torch.clamp(m[0], min=1e-30)
    var = (m[4:].sum() - (m[1:4] ** 2).sum() / tw) / (3.0 * tw)
    return m[0].float(), (cov_floor_rel * var).float()


def _on(params: MixtureParams, device) -> MixtureParams:
    return MixtureParams(*(a.to(device) for a in params))


@per_rank
def sharded_em_fit(
    points,
    init: MixtureParams,
    mesh=None,
    n_iters: int = 30,
    cov_reg: float = 1e-6,
    cov_type: str = "full",
    point_weights: torch.Tensor | None = None,
    cov_floor_rel: float = 1e-4,
):
    """Distributed twin of models.gmm.em_fit: the same math, each sweep's
    statistics summed over the mesh. points: the whole cloud [N, 3] or this
    rank's rows (ShardedPoints); point_weights: the same rows' weights. The
    mesh defaults to make_mesh() on the points' device. Returns (params,
    loglik history [n_iters]), replicated."""
    mesh = _mesh_for(points, mesh)
    local, w = _shard(points, mesh, point_weights)
    prep = ops.prepare(local, w)
    total, cov_floor = _mesh_scalars(prep, mesh, cov_floor_rel)
    fit = em_sweeps(prep, _on(init, mesh.device), n_iters, total, cov_floor, cov_reg, cov_type, mesh)
    return fit.params, fit.logliks


@per_rank
def sharded_tree_fit(
    points,
    mesh=None,
    branch: int = 8,
    levels: int = 3,
    em_iters: int = 12,
    generator: torch.Generator | None = None,
    cov_reg: float = 1e-6,
    cov_type: str = "full",
    cov_floor_rel: float = 1e-4,
    point_weights: torch.Tensor | None = None,
    init0: MixtureParams | None = None,
) -> GmmTree:
    """Distributed level-synchronous GMM-tree build (config 5 + config 2):
    level 0 by sharded flat EM, each deeper level by the masked child EM on
    each rank's points grouped by that rank's parents (models.gmm_tree.
    fit_levels). Returns the GmmTree, replicated.

    point_weights: per-point weights (zero-weight bucket padding neither
    seeds nor fits). init0: a level-0 warm start (e.g. an existing map's
    level 0, pipelines.mapping.update_map); None draws one from the whole
    cloud with `generator` (seed 0 when None), so points given as this
    rank's rows alone (ShardedPoints) need init0."""
    if init0 is None:
        if isinstance(points, ShardedPoints):
            raise ValueError("sharded_tree_fit: points given as this rank's rows need init0 (the "
                             "default init draws from the whole cloud)")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init0 = init_params(points, branch, generator, point_weights=point_weights)
    mesh = _mesh_for(points, mesh)
    local, w = _shard(points, mesh, point_weights)
    prep = ops.prepare(local, w)
    total, cov_floor = _mesh_scalars(prep, mesh, cov_floor_rel)
    lvls, _ = fit_levels(prep, _on(init0, mesh.device), branch, levels, em_iters, total, cov_floor,
                         cov_reg, cov_type, mesh)
    return GmmTree(levels=lvls, branch=branch)


class ShardedRegResult(NamedTuple):
    pose: Pose
    logliks: torch.Tensor
    deltas: torch.Tensor
    converged: torch.Tensor


def _scan(local, w, params: MixtureParams, mesh, pose: Pose, n_iters, method, tol, top_k,
          outlier_logit, wls_inner):
    """One registration scan on this rank's rows, each step's statistics
    summed on the rank (ops.reg_row) and over the mesh."""
    W, mu, A6, b3 = model_terms(_on(params, mesh.device))
    problem = ops.reg_problem(local, W, mu, A6, b3, w, top_k, outlier_logit)
    return run_registration_scan(lambda scan: mesh.all_reduce_(ops.reg_row(problem, scan)),
                                 pose.R, pose.t, n_iters, method, tol, wls_inner)


@per_rank
def sharded_register_tree(
    source,
    tree: GmmTree,
    mesh=None,
    init_pose: Pose | None = None,
    complexity_threshold: float = 0.0,
    n_iters: int = 50,
    method: str = "horn+wls",
    tol: float = 1e-7,
    top_k: int | None = None,
    outlier_logit: float | None = None,
    wls_inner: int = 2,
    point_weights: torch.Tensor | None = None,
) -> ShardedRegResult:
    """Distributed twin of pipelines.register.register_tree: coarse-to-fine
    down the tree's levels (the last one cut at complexity_threshold), the
    pose statistics summed over the mesh the only traffic."""
    mesh = _mesh_for(source, mesh)
    local, w = _shard(source, mesh, point_weights)
    pose = Pose.identity(local.dtype, mesh.device) if init_pose is None else init_pose
    levels = list(tree.levels)
    if complexity_threshold > 0.0:
        levels[-1] = tree.cut_mixture(complexity_threshold)
    lls, deltas, done = [], [], None
    for params in levels:
        (R, t, done), ll, dd = _scan(local, w, params, mesh, pose, n_iters, method, tol, top_k,
                                     outlier_logit, wls_inner)
        pose = Pose(R, t)
        lls.append(ll)
        deltas.append(dd)
    return ShardedRegResult(pose, torch.cat(lls), torch.cat(deltas), done)


@per_rank
def sharded_register_points(
    source,
    params: MixtureParams,
    mesh=None,
    init_pose: Pose | None = None,
    n_iters: int = 50,
    method: str = "horn+wls",
    tol: float = 1e-7,
    top_k: int | None = None,
    outlier_logit: float | None = None,
    wls_inner: int = 2,
    point_weights: torch.Tensor | None = None,
) -> ShardedRegResult:
    """Distributed twin of pipelines.register.register_points.
    point_weights: per-point weights (zero-weight bucket padding adds no
    pose statistics)."""
    mesh = _mesh_for(source, mesh)
    local, w = _shard(source, mesh, point_weights)
    pose = Pose.identity(local.dtype, mesh.device) if init_pose is None else init_pose
    (R, t, done), lls, deltas = _scan(local, w, params, mesh, pose, n_iters, method, tol, top_k,
                                      outlier_logit, wls_inner)
    return ShardedRegResult(Pose(R, t), lls, deltas, done)
