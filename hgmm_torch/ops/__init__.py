"""hgmm_torch.ops — the E-step contractions, dispatched by device.

Counterpart of ``hgmm/ops/__init__.py``. A tensor on the CPU goes to the
plain version in ``em_ref``; a CUDA tensor goes to the CUDA kernel in
``fused_em``, which launches or raises. There is no other switch.

Loops call ``prepare(points)`` once and pass the ``Prepared`` buffer to every
sweep or iteration; raw [N, 3] points are accepted too and prepared per call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hgmm_torch.ops import em_ref, fused_em
from hgmm_torch.ops.em_ref import EmStats, RegStats  # noqa: F401
from hgmm_torch.ops.gaussians import MixtureParams, unpack_suffstats  # noqa: F401


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


def _prep(points) -> Prepared:
    return points if isinstance(points, Prepared) else prepare(points)


def em_stats(points, W, outlier_logit=None) -> EmStats:
    """E-step + sufficient statistics (see em_ref.em_stats)."""
    p = _prep(points)
    if p.pts4.is_cuda:
        return fused_em.em_stats(p.pts4, W, outlier_logit)
    return em_ref.em_stats(p.points, W, p.weights, outlier_logit)


def em_stats_masked(points, W, parent, branch) -> EmStats:
    """Tree-level E-step masked to each point's parent's child block."""
    p = _prep(points)
    if p.pts4.is_cuda:
        return fused_em.em_stats_masked(p.pts4, W, parent, branch)
    return em_ref.em_stats_masked(p.points, W, parent, branch, p.weights)


def assign(points, W, parent=None, branch=None) -> torch.Tensor:
    """Per-point argmax component, [N] int32."""
    p = _prep(points)
    if p.pts4.is_cuda:
        return fused_em.assign(p.pts4, W, parent, branch)
    return em_ref.assign(p.points, W, parent, branch)


def reg_stats(x, W, mu, A6, b3, pose, top_k=None, outlier_logit=None) -> RegStats:
    """Registration statistics at pose (R, t), applied to the source x."""
    p = _prep(x)
    if p.pts4.is_cuda:
        return fused_em.reg_stats(p.pts4, W, mu, A6, b3, pose, top_k, outlier_logit)
    return em_ref.reg_stats(p.points, W, mu, A6, b3, pose, p.weights, top_k, outlier_logit)
