"""SE(3) utilities: exp/log maps, composition, application.

Counterpart of ``hgmm/models/se3.py``. A pose is (R [3,3], t [3]) acting as
y = R x + t; a twist xi in R^6 is ordered [omega (rotation), v (translation)].
The small-angle series branches are selected with ``torch.where``, so no
function here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pose(NamedTuple):
    """Rigid transform y = R @ x + t."""

    R: torch.Tensor  # [3, 3]
    t: torch.Tensor  # [3]

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Pose":
        return Pose(torch.eye(3, dtype=dtype, device=device),
                    torch.zeros(3, dtype=dtype, device=device))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points [..., 3]."""
        return points @ self.R.T + self.t

    def compose(self, other: "Pose") -> "Pose":
        """self o other: first apply `other`, then `self`."""
        return Pose(self.R @ other.R, self.R @ other.t + self.t)

    def inverse(self) -> "Pose":
        Rt = self.R.T
        return Pose(Rt, -(Rt @ self.t))

    def matrix(self) -> torch.Tensor:
        """Homogeneous [4, 4] matrix."""
        m = torch.eye(4, dtype=self.R.dtype, device=self.R.device)
        m[:3, :3] = self.R
        m[:3, 3] = self.t
        return m

    @staticmethod
    def from_matrix(m: torch.Tensor) -> "Pose":
        return Pose(m[:3, :3], m[:3, 3])


def hat(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: hat(w) @ v = w x v."""
    wx, wy, wz = omega.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack(
        [torch.stack([z, -wz, wy]), torch.stack([wz, z, -wx]), torch.stack([-wy, wx, z])]
    )


def _series_coeffs(theta2: torch.Tensor):
    """a = sin(t)/t, b = (1 - cos t)/t^2, c = (t - sin t)/t^3 with Taylor
    fallbacks for theta^2 < 1e-8."""
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta + 1e-32)
    )
    return a, b, c


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with a Taylor fallback near theta = 0."""
    a, b, _ = _series_coeffs(torch.sum(omega * omega))
    K = hat(omega)
    return torch.eye(3, dtype=omega.dtype, device=omega.device) + a * K + b * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse of so3_exp, atan2-based; valid for theta well below pi."""
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    w2 = torch.sum(w * w)  # = 4 sin^2(theta)
    c = torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    small = w2 < 1e-12
    w2_safe = torch.where(small, torch.ones_like(w2), w2)
    s = 0.5 * torch.sqrt(w2_safe)
    theta = torch.atan2(s, c)
    scale = torch.where(small, 0.5 + w2 / 48.0, theta / (2.0 * s))
    return scale * w


def se3_exp(xi: torch.Tensor) -> Pose:
    """Exponential map R^6 -> SE(3), xi = [omega, v]."""
    omega, v = xi[:3], xi[3:]
    a, b, c = _series_coeffs(torch.sum(omega * omega))
    K = hat(omega)
    KK = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * K + b * KK
    V = eye + b * K + c * KK
    return Pose(R, V @ v)


def se3_log(pose: Pose) -> torch.Tensor:
    """Logarithm map SE(3) -> R^6."""
    omega = so3_log(pose.R)
    _, b, c = _series_coeffs(torch.sum(omega * omega))
    K = hat(omega)
    V = torch.eye(3, dtype=omega.dtype, device=omega.device) + b * K + c * (K @ K)
    v = torch.linalg.solve_ex(V, pose.t).result  # V is never singular here
    return torch.cat([omega, v])
