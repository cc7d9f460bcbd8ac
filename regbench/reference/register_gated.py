"""Plain coarse-to-fine registration with a top_k gate onto a fitted mixture
tree: the benchmark's reference for config 3 (anisotropic covariances, the
Mahalanobis pose solve, a uniform outlier term, each point's responsibilities
gated to its top_k components).

The solves, the schedule and the tree walk are those of
``regbench/reference/register.py``; only the statistics differ. At the pose,
each point's logits log[pi_j N(y; mu_j, Sigma_j)] over every component are
computed; each point keeps its top_k largest (every logit equal to the top_k-th
is kept too, so exact ties keep more than top_k) and the rest are dropped;
the responsibilities are the softmax over the kept logits with the outlier
logit's exp(l0) added to the normaliser; the statistics follow as without the
gate. top_k of K or more gates nothing. Plain torch, in the dtype the levels
carry (float64 for the reference), blocked over points; nothing of the port
under test.

Departures from Eckart, Kim and Kautz, arXiv 1807.02587:
- the paper's E-step descends the tree point by point, keeping the most
  likely children at each level and stopping at a coarser node whose
  complexity is low enough; here every level is a registration stage of its
  own, from the last level's pose, and the gate keeps the exact top_k of the
  level's whole mixture (complexity threshold 0: the last level is the leaves);
- the paper's M-step minimises its own approximation of the Mahalanobis
  objective; here Horn's closed form on the virtual targets runs for the first
  half of a level's iterations, then damped Gauss-Newton steps (two an
  iteration) of the Mahalanobis least squares on the full precision matrices,
  the rotation of a step capped at 0.3 rad, as register.py states;
- the uniform outlier term is a fixed logit (0.0 for config 3), not a
  density fitted to the scene;
- a level ends after n_iters iterations or at the first that moves the pose
  by less than `tol`.
"""

from __future__ import annotations

import numpy as np
import torch

from regbench.reference.mixture import BLOCK, NEG_INF, Mixture, cut, features, softmax_rows
from regbench.reference.register import (TOL, WLS_INNER, compose, inverse, model_terms, se3_exp, se3_log,
                                         solve_horn, solve_wls)


def gate(logits: torch.Tensor, top_k: int | None) -> torch.Tensor:
    """Each row's top_k largest logits kept (ties at the threshold kept), the
    rest at the floor; top_k None or >= K keeps every logit."""
    if top_k is None or top_k >= logits.shape[1]:
        return logits
    thresh = torch.topk(logits, top_k, dim=1).values[:, -1:]
    return torch.where(logits >= thresh, logits, torch.full_like(logits, NEG_INF))


def statistics(x, w, terms, R: np.ndarray, t: np.ndarray, outlier, top_k):
    """At the pose (R, t): horn [4, 4], the normal equations A [6, 6], b [6],
    as numpy in the points' precision, each point gated to its top_k
    components."""
    W, table = terms
    Rt = torch.as_tensor(R, dtype=x.dtype, device=x.device)
    tt = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    horn = torch.zeros((4, 4), dtype=x.dtype, device=x.device)
    A = torch.zeros((6, 6), dtype=x.dtype, device=x.device)
    b = torch.zeros(6, dtype=x.dtype, device=x.device)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    for lo in range(0, x.shape[0], BLOCK):
        xb = x[lo:lo + BLOCK]
        y = xb @ Rt.T + tt
        gamma, _ = softmax_rows(gate(-0.5 * (features(y) @ W), top_k), outlier)
        G = (gamma * w[lo:lo + BLOCK, None]) @ table  # [N, 13]
        P = torch.cat([xb, torch.ones_like(xb[:, :1])], 1)
        horn += P.mT @ torch.cat([G[:, 0:3], G[:, 12:13]], 1)
        a = G[:, 3:9]
        M = torch.stack([torch.stack([a[:, 0], a[:, 3], a[:, 4]], -1),
                         torch.stack([a[:, 3], a[:, 1], a[:, 5]], -1),
                         torch.stack([a[:, 4], a[:, 5], a[:, 2]], -1)], -2)
        r = torch.einsum("nij,nj->ni", M, y) - G[:, 9:12]
        z = torch.zeros_like(y[:, 0])
        neg_hat = torch.stack([torch.stack([z, y[:, 2], -y[:, 1]], -1),
                               torch.stack([-y[:, 2], z, y[:, 0]], -1),
                               torch.stack([y[:, 1], -y[:, 0], z], -1)], -2)
        J = torch.cat([neg_hat, eye.expand_as(neg_hat)], -1)
        A += torch.einsum("nij,nik->jk", J, torch.einsum("nij,njk->nik", M, J))
        b -= torch.einsum("nij,ni->j", J, r)
    np_dtype = np.float64 if x.dtype == torch.float64 else np.float32
    return (horn.cpu().numpy().astype(np_dtype), A.cpu().numpy().astype(np_dtype),
            b.cpu().numpy().astype(np_dtype))


def register_level(x, w, m: Mixture, pose, n_iters: int, method: str, outlier, top_k,
                   tol: float = TOL):
    """One level's iterations from `pose`; returns (pose, live iterations)."""
    n_horn = n_iters // 2 if method == "horn+wls" else (n_iters if method == "horn" else 0)
    terms = model_terms(m)
    R, t = pose
    for it in range(n_iters):
        start = (R, t)
        for _ in range(1 if it < n_horn else WLS_INNER):
            horn, A, b = statistics(x, w, terms, R, t, outlier, top_k)
            if it < n_horn:
                R, t = solve_horn(horn)
            else:
                R, t = compose(se3_exp(solve_wls(A, b)), (R, t))
        if np.linalg.norm(se3_log(*compose((R, t), inverse(start)))) < tol:
            return (R, t), it + 1
    return (R, t), n_iters


def register_tree(source32: torch.Tensor, weights32, levels: list[Mixture], branch: int,
                  n_iters: int, method: str, outlier, threshold: float, top_k, init=None,
                  tol: float = TOL):
    """The pose (R, t) as numpy, with T(source) ~ target, from `init`
    (identity when None), down the levels, each point gated to its top_k
    components at every level; the last level is the adaptive cut at
    `threshold`. source32, weights32: float32 on the CPU."""
    dtype, device = levels[0].mu.dtype, levels[0].mu.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    x = source32.to(dtype=dtype, device=device)
    w = (torch.ones(x.shape[0], dtype=dtype, device=device) if weights32 is None
         else weights32.to(dtype=dtype, device=device))
    pose = ((np.eye(3, dtype=np_dtype), np.zeros(3, np_dtype)) if init is None
            else (np.asarray(init[0], np_dtype), np.asarray(init[1], np_dtype)))
    for li, m in enumerate(levels):
        if li == len(levels) - 1:
            m = cut(levels, branch, threshold)
        pose, _ = register_level(x, w, m, pose, n_iters, method, outlier, top_k, tol)
    return pose
