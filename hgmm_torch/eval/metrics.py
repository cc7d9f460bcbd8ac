"""Registration and odometry quality metrics. Counterpart of ``hgmm/eval/metrics.py``."""

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


def ate(est_poses, gt_poses) -> torch.Tensor:
    """Absolute trajectory error: RMSE of the translations with no alignment
    (odometry frames share the origin). est/gt: sequences of absolute Pose;
    the ground truth is moved to the estimate's device."""
    est_t = torch.stack([p.t for p in est_poses])
    gt_t = torch.stack([p.t for p in gt_poses]).to(device=est_t.device, dtype=est_t.dtype)
    return torch.sqrt(torch.mean(torch.sum((est_t - gt_t) ** 2, dim=-1)))


def kitti_gt_trajectory(cam_poses, calib_velo_to_cam: Pose) -> list[Pose]:
    """KITTI ground truth -> the velodyne-frame trajectory odometry estimates.

    cam_poses: P_k = T_{cam0 <- cam_k} from data.kitti.load_poses;
    calib_velo_to_cam: Tr = T_{cam <- velo} from load_calib_velo_to_cam.
    Returns T_{velo0 <- velo_k} = Tr^-1 P_0^-1 P_k Tr: absolute poses in the
    frame-0 velodyne frame, as pipelines.odometry.run_odometry gives them."""
    tr = calib_velo_to_cam
    tr_inv = tr.inverse()
    p0_inv = cam_poses[0].inverse()
    return [tr_inv.compose(p0_inv.compose(p).compose(tr)) for p in cam_poses]


def kitti_ate(est_poses, cam_poses, calib_velo_to_cam: Pose) -> torch.Tensor:
    """Absolute trajectory error of an odometry run against KITTI ground
    truth (poses.txt + calib.txt), in the velodyne frame."""
    gt = kitti_gt_trajectory(cam_poses, calib_velo_to_cam)
    return ate(est_poses, gt[: len(est_poses)])
