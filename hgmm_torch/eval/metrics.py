"""Registration quality metrics. Counterpart of ``hgmm/eval/metrics.py:11-44``."""

from __future__ import annotations

import math

import torch

from hgmm_torch.models.se3 import Pose, se3_log, so3_log


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Root-mean-square point-to-point distance of paired clouds [N, 3]."""
    return torch.sqrt(torch.mean(torch.sum((a - b) ** 2, dim=-1)))


def registration_rmse(pose: Pose, source: torch.Tensor, gt_pose: Pose) -> torch.Tensor:
    """RMSE between the source moved by the estimated and by the true pose."""
    return rmse(pose.apply(source), gt_pose.apply(source))


def rotation_error_deg(pose: Pose, gt_pose: Pose) -> torch.Tensor:
    """Geodesic rotation error in degrees."""
    return torch.linalg.norm(so3_log(pose.R @ gt_pose.R.T)) * (180.0 / math.pi)


def translation_error(pose: Pose, gt_pose: Pose) -> torch.Tensor:
    return torch.linalg.norm(pose.t - gt_pose.t)


def pose_delta_norm(a: Pose, b: Pose) -> torch.Tensor:
    """|| log(a b^-1) ||: scalar pose discrepancy."""
    return torch.linalg.norm(se3_log(a.compose(b.inverse())))
