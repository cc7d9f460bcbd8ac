"""Plain PyTorch versions of the EM and registration contractions.

Counterpart of ``hgmm/ops/em_ref.py``. Every CUDA kernel in
``hgmm_torch/csrc`` has its plain twin here: the twin is the path for CPU
tensors and the oracle the kernels are checked against on the card. They
materialize the [N, K] logits, so they are meant for small N or checking.

Contracts (shared with the kernels in ``hgmm_torch.ops.fused_em``):

  em_stats(points, W, point_weights, outlier_logit) -> EmStats(S [K,10], loglik)
  em_stats_masked(points, W, parent, branch, ...)   -> same, logits masked to
                                                       the parent's child block
  assign(points, W, parent, branch)                 -> [N] int32 argmax
  reg_stats(x, W, mu, A6, b3, pose, ...)            -> RegStats(horn [4,4],
                                                       A [6,6], b [6], loglik)

The matmuls here run in full float32: ``hgmm_torch`` turns TF32 off for
``torch.backends.cuda.matmul`` and ``torch.backends.cudnn`` when imported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hgmm_torch.ops.gaussians import features, sym_unpack

NEG_INF = -1e30


class EmStats(NamedTuple):
    S: torch.Tensor  # [K, 10] Gamma^T Psi (T2 | T1 | T0 packed)
    loglik: torch.Tensor  # [] weighted data log-likelihood


class RegStats(NamedTuple):
    """Registration statistics: horn [4,4] = P^T Q with P = [x | 1] on the
    untransformed source and Q = [gamma mu | sum gamma]; A [6,6], b [6] the
    Mahalanobis Gauss-Newton normal equations on the se(3) twist; loglik."""

    horn: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    loglik: torch.Tensor


def _logits(points: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """[N, K] log[pi_j N(y_i)] = -1/2 psi(y) @ W."""
    return -0.5 * (features(points) @ W[:10])


def _soft(logits: torch.Tensor, outlier_logit=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Row softmax + per-row logsumexp. With an outlier logit l0 the
    normalizer is exp(l0) + sum_j exp(l_ij), so responsibility rows sum to
    < 1. Rows whose every logit is at or below the mask floor (dead rows)
    get zero responsibilities and zero log-evidence."""
    m = torch.max(logits, dim=1, keepdim=True).values
    if outlier_logit is not None:
        m = torch.clamp(m, min=float(outlier_logit))
    m_safe = torch.clamp(m, min=NEG_INF)
    e = torch.exp(logits - m_safe)
    s = torch.sum(e, dim=1, keepdim=True)
    if outlier_logit is not None:
        s = s + torch.exp(float(outlier_logit) - m_safe)
    gamma = e / torch.clamp(s, min=1e-38)
    dead = m <= NEG_INF
    gamma = torch.where(dead, torch.zeros_like(gamma), gamma)
    lse = (m_safe + torch.log(torch.clamp(s, min=1e-38)))[:, 0]
    lse = torch.where(dead[:, 0], torch.zeros_like(lse), lse)
    return gamma, lse


def _weighted(gamma, lse, point_weights):
    if point_weights is None:
        return gamma, lse
    return gamma * point_weights[:, None], lse * point_weights


def em_stats(points, W, point_weights=None, outlier_logit=None) -> EmStats:
    """Dense E-step + sufficient statistics. points [N, 3], W [10, K]."""
    gamma, lse = _soft(_logits(points, W), outlier_logit)
    gamma, lse = _weighted(gamma, lse, point_weights)
    return EmStats(S=gamma.T @ features(points), loglik=torch.sum(lse))


def child_mask_logits(logits: torch.Tensor, parent: torch.Tensor, branch: int) -> torch.Tensor:
    """Mask [N, K] logits so point i sees only components
    [parent_i * branch, (parent_i + 1) * branch)."""
    comp = torch.arange(logits.shape[1], device=logits.device)[None, :]
    ok = torch.div(comp, branch, rounding_mode="floor") == parent.long()[:, None]
    return torch.where(ok, logits, torch.full_like(logits, NEG_INF))


def em_stats_masked(points, W, parent, branch, point_weights=None) -> EmStats:
    """em_stats with each point restricted to its parent's child block."""
    gamma, lse = _soft(child_mask_logits(_logits(points, W), parent, branch))
    gamma, lse = _weighted(gamma, lse, point_weights)
    return EmStats(S=gamma.T @ features(points), loglik=torch.sum(lse))


def assign(points, W, parent=None, branch=None) -> torch.Tensor:
    """Per-point argmax component, [N] int32, optionally restricted to the
    parent's child block. Ties go to the lowest index."""
    logits = _logits(points, W)
    if parent is not None:
        if branch is None:
            raise ValueError("assign: a parent mask needs its branch")
        logits = child_mask_logits(logits, parent, branch)
    return torch.argmax(logits, dim=1).to(torch.int32)


def top_k_mask_logits(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep each row's top-k logits (ties at the threshold kept)."""
    if k >= logits.shape[1]:
        return logits
    thresh = torch.topk(logits, k, dim=1).values[:, -1:]
    return torch.where(logits >= thresh, logits, torch.full_like(logits, NEG_INF))


def reg_stats(
    x, W, mu, A6, b3, pose, point_weights=None, top_k=None, outlier_logit=None,
) -> RegStats:
    """Registration E-step statistics. x [N, 3] source points; pose (R, t)
    applied as y = x R^T + t; mu [K,3], A6 [K,6] packed precisions,
    b3 [K,3] = Sigma^-1 mu."""
    R, t = pose
    y = x @ R.T + t
    logits = _logits(y, W)
    if top_k is not None:
        logits = top_k_mask_logits(logits, top_k)
    gamma, lse = _soft(logits, outlier_logit)
    gamma, lse = _weighted(gamma, lse, point_weights)

    # Horn moments: P^T Q, P = [x | 1], Q = [gamma @ mu | gamma @ 1].
    w = torch.sum(gamma, dim=1)
    P = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    Q = torch.cat([gamma @ mu, w[:, None]], dim=1)
    horn = P.T @ Q

    # Mahalanobis GN on the twist xi = [omega, v]: residual r_i = M_i y_i - u_i
    # with M_i = sum_j gamma_ij Sigma_j^-1, u_i = sum_j gamma_ij b_j and
    # J_i = [-[y_i]_x | I].
    M = sym_unpack(gamma @ A6)  # [N, 3, 3]
    u = gamma @ b3
    r = torch.einsum("nij,nj->ni", M, y) - u
    zeros = torch.zeros_like(y[:, 0])
    yx, yy, yz = y[:, 0], y[:, 1], y[:, 2]
    negyhat = torch.stack(
        [torch.stack([zeros, yz, -yy], -1), torch.stack([-yz, zeros, yx], -1),
         torch.stack([yy, -yx, zeros], -1)],
        dim=-2,
    )
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand_as(negyhat)
    J = torch.cat([negyhat, eye], dim=-1)  # [N, 3, 6]
    MJ = torch.einsum("nij,njk->nik", M, J)
    A = torch.einsum("nij,nik->jk", J, MJ)
    b = -torch.einsum("nij,ni->j", J, r)
    return RegStats(horn=horn, A=A, b=b, loglik=torch.sum(lse))
