"""SE(3) pose solvers: weighted Horn/Umeyama and Mahalanobis Gauss-Newton.

Counterpart of ``hgmm/models/pose.py``. Both consume O(1)-sized statistics
(the [4, 4] Horn cross-moments, the [6, 6] normal equations); the 3x3 SVD
and the 6x6 solve are left to ``torch.linalg``, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import torch

from hgmm_torch.models.se3 import Pose, se3_exp


def solve_horn(horn: torch.Tensor, min_weight: float = 1e-9) -> Pose:
    """Weighted Horn/Umeyama rigid solve from horn = P^T Q, P = [x | 1],
    Q = [w nu | w]: H = sum_i w_i (x_i - xbar)(nu_i - nubar)^T, H = U D V^T,
    R = V diag(1, 1, det(V U^T)) U^T, t = nubar - R xbar."""
    Sw = torch.clamp(horn[3, 3], min=min_weight)
    Sx = horn[0:3, 3]
    Snu = horn[3, 0:3]
    xbar = Sx / Sw
    nubar = Snu / Sw
    H = horn[0:3, 0:3] - torch.outer(Sx, Snu) / Sw
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.T
    d = torch.sign(torch.linalg.det(V @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = V @ D @ U.T
    return Pose(R, nubar - R @ xbar)


def solve_wls_increment(
    A: torch.Tensor,
    b: torch.Tensor,
    damping: float = 1e-6,
    marquardt: float = 1e-2,
    max_rot: float = 0.3,
) -> torch.Tensor:
    """Solve the Mahalanobis Gauss-Newton normal equations for the twist
    increment, with Marquardt damping (lambda diag A), a small Tikhonov term
    and a cap of the rotation norm at max_rot."""
    diag = torch.diagonal(A)
    lm = marquardt * torch.diag(torch.maximum(diag, 1e-12 * torch.sum(diag)))
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    A = A + lm + damping * eye * torch.clamp(torch.trace(A) / 6.0, min=1.0)
    xi = torch.linalg.solve_ex(A, b).result
    rot = torch.linalg.norm(xi[:3])
    scale = torch.clamp(max_rot / torch.clamp(rot, min=1e-12), max=1.0)
    return xi * scale


def apply_wls_increment(pose: Pose, xi: torch.Tensor) -> Pose:
    """Left-compose the increment: T <- exp(xi^) T."""
    return se3_exp(xi).compose(pose)


def weighted_umeyama(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor | None = None) -> Pose:
    """Direct weighted rigid alignment of paired clouds."""
    if w is None:
        w = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    P = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    Q = torch.cat([y * w[:, None], w[:, None]], dim=1)
    return solve_horn(P.T @ Q)
