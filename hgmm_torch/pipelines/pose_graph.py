"""Pose-graph optimization: dense Gauss-Newton on SE(3) with exact autodiff
Jacobians.

Counterpart of the dense half of ``hgmm/pipelines/pose_graph.py`` (the
segment-wise Schur solver over devices waits for the ``torch.distributed``
port). Parametrization: right-perturbation T_i <- T_i * Exp(xi_i). Edge
residual r_e = Log(Z_e^-1 * T_i^-1 * T_j) in R^6; the per-edge 6x6 Jacobians
come from ``torch.func.jacfwd`` of the residual at xi = 0, batched over edges
with ``torch.func.vmap`` — exact, with no hand-derived adjoints.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from hgmm_torch.models.se3 import Pose, se3_exp, se3_log


class EdgeList(NamedTuple):
    """Batch of relative-pose constraints i -> j."""

    i: torch.Tensor  # [E] int64 source node
    j: torch.Tensor  # [E] int64 target node
    R: torch.Tensor  # [E, 3, 3] measured relative rotation (frame i -> j)
    t: torch.Tensor  # [E, 3] measured relative translation
    weight: torch.Tensor  # [E] scalar information weight


def odometry_chain_edges(rel_poses) -> EdgeList:
    """Edges (k, k+1) from a list of frame-to-frame relative poses
    (Z_k = pose of frame k+1 expressed in frame k)."""
    e = len(rel_poses)
    R = torch.stack([p.R for p in rel_poses])
    return EdgeList(
        i=torch.arange(e, device=R.device),
        j=torch.arange(1, e + 1, device=R.device),
        R=R,
        t=torch.stack([p.t for p in rel_poses]),
        weight=torch.ones(e, dtype=R.dtype, device=R.device),
    )


def concat_edge_lists(a: EdgeList, b: EdgeList) -> EdgeList:
    return EdgeList(*(torch.cat([x, y.to(x.device)]) for x, y in zip(a, b)))


def _edge_residual(xi_i, xi_j, Ti_R, Ti_t, Tj_R, Tj_t, Z_R, Z_t):
    Ti = Pose(Ti_R, Ti_t).compose(se3_exp(xi_i))
    Tj = Pose(Tj_R, Tj_t).compose(se3_exp(xi_j))
    return se3_log(Pose(Z_R, Z_t).inverse().compose(Ti.inverse().compose(Tj)))


def _res_and_jac(TiR, Tit, TjR, Tjt, ZR, Zt):
    zero = torch.zeros(6, dtype=TiR.dtype, device=TiR.device)
    args = (zero, zero, TiR, Tit, TjR, Tjt, ZR, Zt)
    return (_edge_residual(*args), jacfwd(_edge_residual, argnums=0)(*args),
            jacfwd(_edge_residual, argnums=1)(*args))


# [E] poses and measurements -> residuals [E, 6], Jacobians [E, 6, 6] (x2).
_res_and_jacs = vmap(_res_and_jac)


class PoseGraphResult(NamedTuple):
    R: torch.Tensor  # [M, 3, 3]
    t: torch.Tensor  # [M, 3]
    residual_history: torch.Tensor  # [n_iters] sum of squared residuals

    def poses(self) -> list[Pose]:
        return [Pose(self.R[m], self.t[m]) for m in range(self.R.shape[0])]


def _robust_weight(weight, res, robust_delta):
    """IRLS Geman-McClure reweighting: the edge weight is scaled by
    (delta^2 / (delta^2 + ||r||^2))^2 — ~1 for residuals below delta,
    ~(delta/||r||)^4 above it. The kernel is redescending: a false loop
    closure is switched off rather than merely bounded. None = pure GN."""
    if robust_delta is None:
        return weight
    r2 = torch.sum(res * res, dim=1)
    d2 = robust_delta * robust_delta
    return weight * (d2 / (d2 + r2)) ** 2


def refine_pose_graph(
    R: torch.Tensor,  # [M, 3, 3] initial absolute poses
    t: torch.Tensor,  # [M, 3]
    edges: EdgeList,
    n_iters: int = 10,
    damping: float = 1e-6,
    gauge_weight: float = 1e8,
    robust_delta: float | None = None,
) -> PoseGraphResult:
    """Dense Gauss-Newton (one device; M up to a few hundred). Node 0 is
    gauge-fixed by a strong prior. robust_delta: see _robust_weight.

    Edge endpoints are validated first: an out-of-range index raises
    ValueError (the JAX package's eager check; a gather on the card would
    fault instead)."""
    m = int(R.shape[0])
    idx = torch.cat([edges.i, edges.j]).cpu()
    bad = idx[(idx < 0) | (idx >= m)]
    if bad.numel():
        raise ValueError(f"edge endpoints {sorted(set(bad.tolist()))} out of range for {m} nodes")
    dev, dtype = R.device, R.dtype
    ei, ej = edges.i.to(dev).long(), edges.j.to(dev).long()
    eR, et, ew = (x.to(device=dev, dtype=dtype) for x in (edges.R, edges.t, edges.weight))
    # Flat [M*M] block index of each edge's four Hessian blocks.
    blocks = torch.cat([ei * m + ei, ej * m + ej, ei * m + ej, ej * m + ei])
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    costs = []
    for _ in range(n_iters):
        res, Ji, Jj = _res_and_jacs(R[ei], t[ei], R[ej], t[ej], eR, et)
        w_r = _robust_weight(ew, res, robust_delta)
        w = w_r[:, None, None]
        H = torch.zeros((m * m, 6, 6), dtype=dtype, device=dev)
        H.index_add_(0, blocks, torch.cat([
            w * torch.einsum("eai,eaj->eij", Ji, Ji), w * torch.einsum("eai,eaj->eij", Jj, Jj),
            w * torch.einsum("eai,eaj->eij", Ji, Jj), w * torch.einsum("eai,eaj->eij", Jj, Ji),
        ]))
        g = torch.zeros((m, 6), dtype=dtype, device=dev)
        g.index_add_(0, torch.cat([ei, ej]), torch.cat([
            w_r[:, None] * torch.einsum("eai,ea->ei", Ji, res),
            w_r[:, None] * torch.einsum("eai,ea->ei", Jj, res),
        ]))
        # Gauge prior on node 0 + Levenberg damping.
        H[0] += gauge_weight * eye6
        Hd = H.view(m, m, 6, 6).transpose(1, 2).reshape(6 * m, 6 * m)
        Hd = Hd + damping * torch.eye(6 * m, dtype=dtype, device=dev)
        delta = -torch.linalg.solve(Hd, g.reshape(6 * m)).reshape(m, 6)
        upd = vmap(se3_exp)(delta)
        t = t + torch.einsum("mij,mj->mi", R, upd.t)
        R = torch.einsum("mij,mjk->mik", R, upd.R)
        costs.append(torch.sum(w_r * torch.sum(res * res, dim=1)))
    return PoseGraphResult(R, t, torch.stack(costs) if costs else torch.zeros(0, dtype=dtype, device=dev))
