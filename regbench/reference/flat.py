"""Plain flat-mixture fit and registration onto it: the reference of the
flat cells, written from the definition and imported by nothing of the
program under test.

The fit: K means drawn from the target without replacement by
``torch.randperm`` on the CPU generator the program's fit is given (the draw
of ``mixture.init_mixture``), an isotropic start from the bounding box, then
EM sweeps over every point and every component (``mixture.estep``, the
closed-form ``mixture.mstep`` with its covariance floor). The registration:
``register.register_level``'s iterations of the source onto that one mixture
from the identity (Horn's closed form each iteration for ``"horn"``), ending
once an iteration moves the pose by less than ``tol``.

Departures from the program, none of which changes the function computed:
the sums over points are matrix products in blocks of ``mixture.BLOCK``
rows, in the given dtype (float64 for the reference, float32 with TF32
products for its control), where the program sums float32 partial rows of
its kernels' blocks; the small solves run on the host in numpy; and the
iterations stop at convergence where the program runs all of them with its
state frozen once done.
"""

from __future__ import annotations

import numpy as np
import torch

from regbench.reference.mixture import COV_FLOOR_REL, Mixture, estep, init_mixture, mstep
from regbench.reference.register import TOL, register_level


def fit_flat(points32: torch.Tensor, k: int, sweeps: int, generator: torch.Generator,
             dtype=torch.float64, device="cpu") -> Mixture:
    """The flat K-component mixture of `sweeps` EM sweeps over every point.
    points32: the float32 cloud [N, 3] on the CPU."""
    pts = points32.to(dtype=dtype, device=device)
    w = torch.ones(pts.shape[0], dtype=dtype, device=device)
    total = float(pts.shape[0])
    mean = pts.mean(0)
    cov_floor = COV_FLOOR_REL * float(((pts - mean) ** 2).sum() / (3.0 * total))
    m = init_mixture(points32, None, k, generator, dtype, device)
    for _ in range(sweeps):
        S, _ = estep(pts, w, m)
        m = mstep(S, total, cov_floor)
    return m


def register(source32: torch.Tensor, m: Mixture, n_iters: int, method: str, tol: float = TOL):
    """The pose (R, t) as numpy, T(source) ~ target, of `n_iters` iterations
    onto the one mixture `m` from the identity, in m's dtype and on its
    device. source32: float32 [N, 3] on the CPU."""
    dtype, device = m.mu.dtype, m.mu.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    x = source32.to(dtype=dtype, device=device)
    w = torch.ones(x.shape[0], dtype=dtype, device=device)
    pose = (np.eye(3, dtype=np_dtype), np.zeros(3, np_dtype))
    pose, _ = register_level(x, w, m, pose, n_iters, method, None, tol)
    return pose
