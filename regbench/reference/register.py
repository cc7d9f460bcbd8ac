"""Plain coarse-to-fine registration onto a fitted mixture tree: the
benchmark's reference.

Each iteration takes the E-step statistics of the source at the current pose
(responsibilities over the components, with a uniform outlier term when one
is given) and solves for a new pose: Horn's closed form on the virtual
targets, or one damped Gauss-Newton step of the Mahalanobis least squares on
the se(3) twist. "horn+wls" runs Horn for the first half of the iterations.
An iteration that moves the pose by less than `tol` ends the level; the next
level starts from its pose. The statistics are matrix products on the device
in the given dtype; the 4x4, 3x3 and 6x6 solves run on the host in numpy, in
float64 for the reference and float32 for its control.
"""

from __future__ import annotations

import numpy as np
import torch

from regbench.reference.mixture import BLOCK, Mixture, cut, features, loglik_weights, precisions, softmax_rows

TOL = 1e-7
WLS_INNER = 2
DAMPING = 1e-6
MARQUARDT = 1e-2
MAX_ROT = 0.3


def hat(w: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]], dtype=w.dtype)


def _series(theta2):
    theta = np.sqrt(theta2 + 1e-32)
    if theta2 < 1e-8:
        return 1.0 - theta2 / 6.0, 0.5 - theta2 / 24.0, 1.0 / 6.0 - theta2 / 120.0
    return (np.sin(theta) / theta, (1.0 - np.cos(theta)) / theta2,
            (theta - np.sin(theta)) / (theta2 * theta + 1e-32))


def se3_exp(xi: np.ndarray):
    a, b, c = _series(float(xi[:3] @ xi[:3]))
    K = hat(xi[:3])
    eye = np.eye(3, dtype=xi.dtype)
    R = eye + a * K + b * (K @ K)
    V = eye + b * K + c * (K @ K)
    return R.astype(xi.dtype), (V @ xi[3:]).astype(xi.dtype)


def so3_log(R: np.ndarray) -> np.ndarray:
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], dtype=R.dtype)
    w2 = float(w @ w)
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    if w2 < 1e-12:
        return (0.5 + w2 / 48.0) * w
    s = 0.5 * np.sqrt(w2)
    return (np.arctan2(s, c) / (2.0 * s)) * w


def se3_log(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    omega = so3_log(R)
    _, b, c = _series(float(omega @ omega))
    K = hat(omega)
    V = np.eye(3, dtype=R.dtype) + b * K + c * (K @ K)
    return np.concatenate([omega, np.linalg.solve(V, t)])


def compose(a, b):
    """a o b: first b, then a."""
    return a[0] @ b[0], a[0] @ b[1] + a[1]


def inverse(a):
    return a[0].T, -(a[0].T @ a[1])


def solve_horn(horn: np.ndarray):
    """The weighted rigid fit of the source onto its virtual targets from
    horn = P^T Q, P = [x | 1], Q = [sum_j gamma_ij mu_j | sum_j gamma_ij]."""
    sw = max(horn[3, 3], 1e-9)
    sx, snu = horn[0:3, 3], horn[3, 0:3]
    H = horn[0:3, 0:3] - np.outer(sx, snu) / sw
    U, _, Vt = np.linalg.svd(H)
    V = Vt.T
    d = np.sign(np.linalg.det(V @ U.T))
    R = V @ np.diag(np.array([1.0, 1.0, d], dtype=horn.dtype)) @ U.T
    return R, snu / sw - R @ (sx / sw)


def solve_wls(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The twist of one damped Gauss-Newton step, its rotation capped."""
    diag = np.diag(A)
    A = (A + MARQUARDT * np.diag(np.maximum(diag, 1e-12 * diag.sum()))
         + DAMPING * max(np.trace(A) / 6.0, 1.0) * np.eye(6, dtype=A.dtype))
    xi = np.linalg.solve(A, b)
    rot = np.linalg.norm(xi[:3])
    return xi * min(MAX_ROT / max(rot, 1e-12), 1.0)


def model_terms(m: Mixture):
    """What every iteration reuses: W [10, K] and [mu | A (6 packed) | b | 1] [K, 13]."""
    A, b, _ = precisions(m)
    a6 = torch.stack([A[:, 0, 0], A[:, 1, 1], A[:, 2, 2], A[:, 0, 1], A[:, 0, 2], A[:, 1, 2]], 1)
    return loglik_weights(m), torch.cat([m.mu, a6, b, torch.ones_like(b[:, :1])], 1)


def statistics(x, w, terms, R: np.ndarray, t: np.ndarray, outlier):
    """At the pose (R, t): horn [4, 4], the normal equations A [6, 6], b [6],
    as float64 numpy."""
    W, table = terms
    Rt = torch.as_tensor(R, dtype=x.dtype, device=x.device)
    tt = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    horn = torch.zeros((4, 4), dtype=x.dtype, device=x.device)
    A = torch.zeros((6, 6), dtype=x.dtype, device=x.device)
    b = torch.zeros(6, dtype=x.dtype, device=x.device)
    for lo in range(0, x.shape[0], BLOCK):
        xb = x[lo:lo + BLOCK]
        y = xb @ Rt.T + tt
        gamma, _ = softmax_rows(-0.5 * (features(y) @ W), outlier)
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
        J = torch.cat([neg_hat, torch.eye(3, dtype=x.dtype, device=x.device).expand_as(neg_hat)], -1)
        A += torch.einsum("nij,nik->jk", J, torch.einsum("nij,njk->nik", M, J))
        b -= torch.einsum("nij,ni->j", J, r)
    np_dtype = np.float64 if x.dtype == torch.float64 else np.float32
    return (horn.cpu().numpy().astype(np_dtype), A.cpu().numpy().astype(np_dtype),
            b.cpu().numpy().astype(np_dtype))


def register_level(x, w, m: Mixture, pose, n_iters: int, method: str, outlier, tol: float = TOL):
    """One level's iterations from `pose`; returns (pose, live iterations)."""
    n_horn = n_iters // 2 if method == "horn+wls" else (n_iters if method == "horn" else 0)
    terms = model_terms(m)
    R, t = pose
    for it in range(n_iters):
        start = (R, t)
        for _ in range(1 if it < n_horn else WLS_INNER):
            horn, A, b = statistics(x, w, terms, R, t, outlier)
            if it < n_horn:
                R, t = solve_horn(horn)
            else:
                R, t = compose(se3_exp(solve_wls(A, b)), (R, t))
        if np.linalg.norm(se3_log(*compose((R, t), inverse(start)))) < tol:
            return (R, t), it + 1
    return (R, t), n_iters


def register_tree(source32: torch.Tensor, weights32, levels: list[Mixture], branch: int,
                  n_iters: int, method: str, outlier, threshold: float, init=None,
                  tol: float = TOL):
    """The pose (R, t) as numpy, with T(source) ~ target, from `init`
    (identity when None), down the levels; the last level is the adaptive cut
    at `threshold`. source32, weights32: float32 on the CPU."""
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
        pose, _ = register_level(x, w, m, pose, n_iters, method, outlier, tol)
    return pose
