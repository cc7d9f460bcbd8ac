"""SE(3) utilities: exp/log maps, composition, application.

Counterpart of ``hgmm/models/se3.py``. A pose is (R [3,3], t [3]) acting as
y = R x + t; a twist xi in R^6 is ordered [omega (rotation), v (translation)].
The small-angle series branches are selected with ``torch.where``, so no
function here reads a value back to the host, and every map is elementwise
arithmetic: ``torch.func.vmap`` batches it and ``torch.func.jacfwd``
differentiates it exactly, as ``jax.vmap``/``jax.jacfwd`` do the JAX package's
(the pose graph evaluates every Jacobian at xi = 0, on the series branch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hgmm_torch.utils.device import resolve_device


class Pose(NamedTuple):
    """Rigid transform y = R @ x + t."""

    R: torch.Tensor  # [3, 3]
    t: torch.Tensor  # [3]

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Pose":
        """The identity on `device` (None: the card, and an error without
        one)."""
        device = resolve_device(device)
        return Pose(torch.eye(3, dtype=dtype, device=device),
                    torch.zeros(3, dtype=dtype, device=device))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points [..., 3]."""
        return points @ self.R.mT + self.t

    def compose(self, other: "Pose") -> "Pose":
        """self o other: first apply `other`, then `self`."""
        return Pose(self.R @ other.R, self.R @ other.t + self.t)

    def inverse(self) -> "Pose":
        Rt = self.R.mT
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
    """so(3) hat operator: hat(w) @ v = w x v. omega [..., 3] -> [..., 3, 3]."""
    wx, wy, wz = omega.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack(
        [torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
         torch.stack([-wy, wx, z], -1)],
        dim=-2,
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
    c = torch.clamp((R[0, 0] + R[1, 1] + R[2, 2] - 1.0) * 0.5, -1.0, 1.0)
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


def _solve3(V: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """V^-1 t for a 3x3 V by Cramer's rule (triple products of V's columns)."""
    c0, c1, c2 = V[:, 0], V[:, 1], V[:, 2]
    x12, x20, x01 = torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0), torch.linalg.cross(c0, c1)
    return torch.stack([t @ x12, t @ x20, t @ x01]) / (c0 @ x12)


def se3_log(pose: Pose) -> torch.Tensor:
    """Logarithm map SE(3) -> R^6."""
    omega = so3_log(pose.R)
    _, b, c = _series_coeffs(torch.sum(omega * omega))
    K = hat(omega)
    V = torch.eye(3, dtype=omega.dtype, device=omega.device) + b * K + c * (K @ K)
    return torch.cat([omega, _solve3(V, pose.t)])  # V is never singular here


def random_pose(generator: torch.Generator | None = None, max_angle: float = 0.5,
                max_trans: float = 0.3, dtype=torch.float32, device=None) -> Pose:
    """Random SE(3) for tests and synthetic benchmarks: a uniform axis, an
    angle uniform in [-max_angle, max_angle], a translation uniform in
    [-max_trans, max_trans]^3. Draws from `generator` (the reference draws
    from a jax.random key: same distribution, other draws), on `device`
    (None: the card, and an error without one)."""
    device = resolve_device(device)
    axis = torch.randn(3, generator=generator, dtype=torch.float64)
    axis = axis / (torch.linalg.norm(axis) + 1e-12)
    angle = (2.0 * torch.rand((), generator=generator, dtype=torch.float64) - 1.0) * max_angle
    t = (2.0 * torch.rand(3, generator=generator, dtype=torch.float64) - 1.0) * max_trans
    return Pose(so3_exp(axis * angle).to(dtype=dtype, device=device), t.to(dtype=dtype, device=device))
