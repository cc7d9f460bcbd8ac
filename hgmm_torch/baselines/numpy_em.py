"""Trusted slow pure-numpy GMM-EM + registration (float64).

A copy of ``hgmm/baselines/numpy_em.py`` (importing anything under ``hgmm``
imports ``jax``): the "parity against our own trusted slow implementation"
oracle of BASELINE.md, straightforward textbook EM with no feature-matmul
tricks, used by tests to validate the fast engine's numerics end-to-end."""

from __future__ import annotations

import numpy as np


def em_fit_numpy(points, k, n_iters=50, seed=0, cov_reg=1e-6):
    """Returns (pi [K], mu [K,3], sigma [K,3,3], loglik_history)."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    rng = np.random.default_rng(seed)
    mu = pts[rng.choice(n, k, replace=False)].copy()
    sigma = np.stack([np.eye(3) * np.var(pts) for _ in range(k)])
    pi = np.full(k, 1.0 / k)
    lls = []
    for _ in range(n_iters):
        log_p = np.zeros((n, k))
        for j in range(k):
            d = pts - mu[j]
            Sinv = np.linalg.inv(sigma[j])
            quad = np.einsum("ni,ij,nj->n", d, Sinv, d)
            _, logdet = np.linalg.slogdet(sigma[j])
            log_p[:, j] = (
                -0.5 * (quad + logdet + 3 * np.log(2 * np.pi)) + np.log(pi[j])
            )
        m = log_p.max(axis=1, keepdims=True)
        w = np.exp(log_p - m)
        s = w.sum(axis=1, keepdims=True)
        gamma = w / s
        lls.append(float(np.sum(m.squeeze(1) + np.log(s.squeeze(1)))))
        t0 = gamma.sum(0)
        mu = (gamma.T @ pts) / t0[:, None]
        for j in range(k):
            d = pts - mu[j]
            sigma[j] = (gamma[:, j, None] * d).T @ d / t0[j] + cov_reg * np.eye(3)
        pi = t0 / n
    return pi, mu, sigma, np.array(lls)


def register_numpy(source, pi, mu, sigma, n_iters=40):
    """EM-ICP with weighted Horn in float64 (oracle for register_points)."""
    src = np.asarray(source, np.float64)
    R = np.eye(3)
    t = np.zeros(3)
    k = pi.shape[0]
    Sinv = np.stack([np.linalg.inv(s) for s in sigma])
    logdet = np.array([np.linalg.slogdet(s)[1] for s in sigma])
    for _ in range(n_iters):
        y = src @ R.T + t
        log_p = np.zeros((src.shape[0], k))
        for j in range(k):
            d = y - mu[j]
            quad = np.einsum("ni,ij,nj->n", d, Sinv[j], d)
            log_p[:, j] = -0.5 * (quad + logdet[j] + 3 * np.log(2 * np.pi)) + np.log(
                np.maximum(pi[j], 1e-300)
            )
        m = log_p.max(axis=1, keepdims=True)
        w = np.exp(log_p - m)
        gamma = w / w.sum(axis=1, keepdims=True)
        nu = gamma @ mu
        xc = src.mean(0)
        nc = nu.mean(0)
        H = (src - xc).T @ (nu - nc)
        U, _, Vt = np.linalg.svd(H)
        d_ = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, 1.0, d_]) @ U.T
        t = nc - R @ xc
    return R, t
