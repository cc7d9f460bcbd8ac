"""ICP baselines: point-to-point ICP on the nearest-neighbour kernel, and a
float64 numpy ICP.

Counterpart of ``hgmm/baselines/icp.py``: the comparison baseline for the
GMM registration, as the reference repository charted it. Nearest
neighbours come from ``hgmm_torch.ops.knn`` (the CUDA kernel for CUDA
tensors), the rigid solve from the weighted Horn/Umeyama of
``hgmm_torch.models.pose``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hgmm_torch.models.pose import solve_horn
from hgmm_torch.models.se3 import Pose, se3_log
from hgmm_torch.ops.knn import nearest_neighbor


class IcpResult(NamedTuple):
    pose: Pose
    rmse_history: torch.Tensor  # [n_iters] RMS matched distance per iteration
    converged: torch.Tensor  # [] bool


def icp(
    source: torch.Tensor,
    target: torch.Tensor,
    n_iters: int = 30,
    init_pose: Pose | None = None,
    tol: float = 1e-7,
    max_dist: float | None = None,
) -> IcpResult:
    """Point-to-point ICP. max_dist: reject matches beyond this distance
    (partial-overlap robustness).

    The semantics are those of the JAX scan: the pose freezes from the
    iteration after the increment falls below `tol`, and every later
    rmse_history entry is the RMS at the frozen pose. That takes one more
    nearest-neighbour search after convergence; the iterations after it
    re-emit its value. The host reads the convergence test once per live
    iteration.
    """
    if init_pose is None:
        init_pose = Pose.identity(source.dtype, source.device)
    R, t = init_pose.R, init_pose.t
    P = torch.cat([source, torch.ones_like(source[:, :1])], dim=1)
    done = frozen = False  # frozen: the RMS at the frozen pose is measured
    history = []
    for _ in range(n_iters):
        if not frozen:
            pose = Pose(R, t)
            idx, d2 = nearest_neighbor(pose.apply(source), target)
            if max_dist is not None:
                w = (d2 < max_dist * max_dist).to(source.dtype)
            else:
                w = torch.ones_like(d2)
            rmse = torch.sqrt(torch.sum(d2 * w) / torch.clamp(torch.sum(w), min=1.0))
            if done:
                frozen = True
            else:
                matched = target[idx.long()]
                Q = torch.cat([matched * w[:, None], w[:, None]], dim=1)
                new = solve_horn(P.T @ Q)
                delta = torch.linalg.norm(se3_log(new.compose(pose.inverse())))
                R, t = new.R, new.t
                done = bool(delta < tol)
        history.append(rmse)
    return IcpResult(Pose(R, t), torch.stack(history), torch.tensor(done, device=source.device))


def icp_numpy(source, target, n_iters: int = 30, tol: float = 1e-9) -> Pose:
    """Trusted slow float64 CPU reference (a serial point-to-point ICP with
    a dense distance matrix). Returns a float32 Pose."""
    src = np.asarray(source, np.float64)
    tgt = np.asarray(target, np.float64)
    R = np.eye(3)
    t = np.zeros(3)
    prev_err = np.inf
    for _ in range(n_iters):
        y = src @ R.T + t
        d2 = (
            np.sum(y * y, axis=1)[:, None]
            - 2.0 * y @ tgt.T
            + np.sum(tgt * tgt, axis=1)[None, :]
        )
        idx = np.argmin(d2, axis=1)
        m = tgt[idx]
        xc, mc = src.mean(0), m.mean(0)
        H = (src - xc).T @ (m - mc)
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
        t = mc - R @ xc
        err = float(np.mean(np.min(d2, axis=1)))
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return Pose(torch.from_numpy(R.astype(np.float32)), torch.from_numpy(t.astype(np.float32)))
