"""Plain back end of a LiDAR SLAM sequence: the benchmark's reference for
loop closures, pose-graph refinement and the global map.

It takes the program's dead-reckoned chain as its input (the absolute poses
and each pair's final log-likelihood, copied to float64) and redoes the back
end from the scans alone, with nothing of the program:

- closures: candidate pairs (i, j), j - i > min_separation, whose positions
  lie within a radius that grows with j - i and whose headings differ by at
  most max_heading, nearest relative to their radius first; each verified,
  within a budget and one a neighbourhood, by registering scan j onto frame
  i's tree (the chain's model of frame i: the same fit from the same draw)
  from the chain's relative pose, and scan i onto frame j's tree the other
  way; accepted when the registration converged (or moved less than
  accept_delta), its log-likelihood a point is at least the chain's median
  plus the margin, and the two estimates agree within reciprocal_tol median
  steps; the edge is the geodesic midpoint of the two, weighted by its
  log-likelihood;
- refinement: dense Gauss-Newton on SE(3), right perturbations, residual
  Log(Z^-1 T_i^-1 T_j) a edge, analytic Jacobians, a gauge prior of 1e8 on
  node 0 and damping of 1e-6, in float64 with the solve in numpy;
- the map: the scans moved by the refined poses, joined, voxelized, put in
  the bucket (subsampled by a generator of the map's seed, or padded with
  zero weights) and fitted with the plain tree fit.

Departures from the program, each one deliberate:

- the candidates' distances are taken in float32, as the program's chain
  holds its positions, so that near-equal candidates sort as they do there:
  the order is a decision on the chain, which is an input here, and a
  float64 re-evaluation would swap candidates a rounding apart;
- a verification reuses the tree that the reference chain fitted to the
  frame (``chain``), where the program fits it again (counted as
  ``closure.fits``);
- the map is fused by the program's refined poses, so that the map's check
  holds the fuse and the fit alone; the refined poses are checked on their
  own against this file's refinement;
- the fuse moves the scans in float32, as the program's scans and poses are
  held: the voxel grid is a decision on each point, and a float64 transform
  puts a point a rounding from a voxel's face in the next voxel. One voxel
  more or less shifts every later voxel's index, and with it the map fit's
  drawn start; on the H100 that alone moved the fitted map by 0.19 (the
  worst level's fit_gap) where the same fit from the program's own cloud
  moved it by 4e-4.

Everything runs in the dtype and on the device it is given: float64 for the
reference, float32 with TF32 matrix products for its control. TF32 is off
when this module is imported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from regbench.reference.mixture import BLOCK, cut, features, fit_tree, softmax_rows
from regbench.reference.odometry import frame_generator, frames, voxel_downsample
from regbench.reference.register import (
    TOL,
    WLS_INNER,
    compose,
    hat,
    inverse,
    model_terms,
    se3_exp,
    se3_log,
    solve_horn,
    solve_wls,
    statistics,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GAUGE = 1e8
DAMPING = 1e-6
BERNOULLI = (1.0, -0.5, 1.0 / 6.0, 0.0, -1.0 / 30.0, 0.0, 1.0 / 42.0, 0.0, -1.0 / 30.0, 0.0,
             5.0 / 66.0)


class Registration(NamedTuple):
    pose: tuple  # (R [3, 3], t [3]) numpy
    loglik: float  # at the start of the last level's last live iteration
    delta: float  # that iteration's motion, ||Log(new start^-1)||
    converged: bool  # the last level ended on delta < tol


# --- the chain, keeping every tree it fits


def chain(scans, model: dict, voxel, bucket: int, seed: int, n_pairs: int, dtype=torch.float64,
          device="cpu"):
    """regbench.reference.odometry.chain, keeping what the back end reads:
    returns the first n_pairs pairs' Registrations (pose: the relative pose,
    numpy), the frames [(points, weights)] and {frame: levels} of the target
    frames it fitted."""
    fr = frames(scans, voxel, bucket, seed)
    regs, trees, prev = [], {}, None
    for i in range(n_pairs):
        trees[i] = frame_tree(fr, i, model, seed, dtype, device)
        regs.append(register(fr[i + 1], trees[i], model, prev))
        prev = regs[-1].pose
    return regs, fr, trees


def absolute(rel) -> list[tuple]:
    """The absolute poses of a chain of relative ones, frame 0 the identity."""
    R0 = np.asarray(rel[0][0]) if rel else np.eye(3)
    out = [(np.eye(3, dtype=R0.dtype), np.zeros(3, R0.dtype))]
    for p in rel:
        out.append(compose(out[-1], p))
    return out


def frame_tree(fr, i: int, model: dict, seed: int, dtype, device):
    tp, tw = fr[i]
    return fit_tree(torch.from_numpy(tp), torch.from_numpy(tw), model["branch"], model["levels"],
                    model["fit_iters"], frame_generator(seed, i), dtype, device)


# --- a registration with its log-likelihood, motion and convergence


def register(frame, levels, model: dict, init=None) -> Registration:
    """Scan `frame` (points, weights float32) onto a tree, coarse to fine,
    from `init` (the identity when None), as regbench.reference.register
    does it, keeping what a closure's acceptance reads."""
    pts, wts = frame
    dtype, device = levels[0].mu.dtype, levels[0].mu.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    x = torch.from_numpy(pts).to(dtype=dtype, device=device)
    w = torch.from_numpy(wts).to(dtype=dtype, device=device)
    pose = ((np.eye(3, dtype=np_dtype), np.zeros(3, np_dtype)) if init is None
            else (np.asarray(init[0], np_dtype), np.asarray(init[1], np_dtype)))
    n_iters, method, outlier = model["reg_iters"], model["method"], model["outlier_logit"]
    n_horn = n_iters // 2 if method == "horn+wls" else (n_iters if method == "horn" else 0)
    inner = model.get("wls_inner", WLS_INNER)
    tol = model.get("tol", TOL)
    for li, m in enumerate(levels):
        if li == len(levels) - 1:
            m = cut(levels, model["branch"], model["complexity_threshold"])
        terms = model_terms(m)
        converged = False
        for it in range(n_iters):
            start = pose
            for _ in range(1 if it < n_horn else inner):
                horn, A, b = statistics(x, w, terms, *pose, outlier)
                pose = solve_horn(horn) if it < n_horn else compose(se3_exp(solve_wls(A, b)), pose)
            delta = float(np.linalg.norm(se3_log(*compose(pose, inverse(start)))))
            if delta < tol:
                converged = True
                break
    return Registration(pose, loglik(x, w, terms, start, outlier), delta, converged)


def loglik(x, w, terms, pose, outlier) -> float:
    """sum_n w_n log(sum_j pi_j N(R x_n + t; mu_j, Sigma_j) + e^outlier)."""
    W = terms[0]
    R = torch.as_tensor(pose[0], dtype=x.dtype, device=x.device)
    t = torch.as_tensor(pose[1], dtype=x.dtype, device=x.device)
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for lo in range(0, x.shape[0], BLOCK):
        y = x[lo:lo + BLOCK] @ R.T + t
        _, lse = softmax_rows(-0.5 * (features(y) @ W), outlier)
        total += (lse * w[lo:lo + BLOCK]).sum()
    return float(total)


# --- closures


def candidates(abs_t: np.ndarray, abs_R: np.ndarray, cfg: dict) -> list[tuple[int, int]]:
    """The gated pairs (i, j), nearest relative to their radius first (ties
    in the order i, then j)."""
    t = np.asarray(abs_t, np.float32)
    f = t.shape[0]
    if f < cfg["min_separation"] + 2:
        return []
    med = max(float(np.median(np.linalg.norm(np.diff(t, axis=0), axis=1))), 1e-12)
    dists = np.linalg.norm(t[:, None] - t[None, :], axis=-1)
    out = []
    for i in range(f):
        for j in range(i + cfg["min_separation"] + 1, f):
            dist = float(dists[i, j])
            radius = max(med * (cfg["radius_steps"] + cfg["drift_rate"] * (j - i)), 1e-30)
            Rij = np.asarray(abs_R[i], np.float64).T @ np.asarray(abs_R[j], np.float64)
            angle = math.acos(min(max(0.5 * (np.trace(Rij) - 1.0), -1.0), 1.0))
            if dist < radius and angle <= cfg["max_heading"]:
                out.append((dist / radius, i, j))
    out.sort(key=lambda c: c[0])  # stable: equal ratios keep (i, j) order
    return [(i, j) for _, i, j in out]


def _near(i: int, j: int, used, sep: int) -> bool:
    return any(abs(i - u) <= sep or abs(j - u) <= sep for u in used)


def closures(abs_poses, logliks, fr, trees: dict, model: dict, cfg: dict, seed: int, dtype,
             device) -> list[tuple[int, int, tuple, float]]:
    """The accepted edges (i, j, (R, t), weight) in the order accepted.
    abs_poses: the chain's [(R, t)]; logliks: its pairs' final
    log-likelihoods; fr: the bucketed frames; trees: {frame: levels}, filled
    here for frames the chain did not fit."""
    abs_R = np.stack([np.asarray(R, np.float64) for R, _ in abs_poses])
    abs_t = np.stack([np.asarray(t, np.float64) for _, t in abs_poses])
    cands = candidates(abs_t, abs_R, cfg)
    med = float(np.median(np.linalg.norm(np.diff(abs_t, axis=0), axis=1))) if len(abs_t) > 1 else 1.0
    mass = [max(float(np.sum(w, dtype=np.float64)), 1.0) for _, w in fr]
    ll_ref = float(np.nanmedian([ll / mass[k + 1] for k, ll in enumerate(logliks)]))

    def tree(k):
        if k not in trees:
            trees[k] = frame_tree(fr, k, model, seed, dtype, device)
        return trees[k]

    reg = dict(model, reg_iters=cfg.get("reg_iters") or model["reg_iters"])
    accepted, used, verified = [], set(), 0
    sep = cfg["min_separation"]
    for i, j in cands:
        if verified >= cfg["max_candidates"]:
            break
        if _near(i, j, used, sep):
            continue
        verified += 1
        init = compose(inverse((abs_R[i], abs_t[i])), (abs_R[j], abs_t[j]))
        fwd = register(fr[j], tree(i), reg, init)
        ll_pp = fwd.loglik / mass[j]
        ok = ((fwd.converged or fwd.delta < cfg["accept_delta"])
              and (not math.isfinite(ll_ref) or ll_pp >= ll_ref + cfg["accept_loglik_margin"]))
        pose = fwd.pose
        if ok and cfg["reciprocal_tol"] is not None:
            rev = register(fr[i], tree(j), reg, inverse(init))
            d = se3_log(*compose(inverse(fwd.pose), inverse(rev.pose)))
            ok = (float(np.linalg.norm(d)) <= cfg["reciprocal_tol"] * med
                  and (rev.converged or rev.delta < cfg["accept_delta"]))
            pose = compose(fwd.pose, se3_exp(0.5 * d))
        if not ok:
            continue
        rel_q = 0.0 if not math.isfinite(ll_ref) else min(ll_pp - ll_ref, 0.0)
        accepted.append((i, j, pose, cfg["weight_scale"] * math.exp(max(rel_q, -3.0))))
        used.update((i, j))
    return accepted


# --- refinement


def adjoint(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Ad_T on twists [omega, v]: T Exp(xi) T^-1 = Exp(Ad_T xi)."""
    out = np.zeros((6, 6), R.dtype)
    out[:3, :3] = R
    out[3:, :3] = hat(t) @ R
    out[3:, 3:] = R
    return out


def left_jacobian_inv(xi: np.ndarray) -> np.ndarray:
    """J_l^-1(xi) = sum_n B_n / n! ad(xi)^n (Bernoulli numbers; the series
    converges for rotations below 2 pi and is summed to the tenth power),
    with ad(xi) = [[omega^, 0], [v^, omega^]]: Log(Exp(d) Exp(xi)) = xi +
    J_l^-1(xi) d + O(d^2)."""
    ad = np.zeros((6, 6), xi.dtype)
    ad[:3, :3] = hat(xi[:3])
    ad[3:, :3] = hat(xi[3:])
    ad[3:, 3:] = hat(xi[:3])
    out, power = np.zeros((6, 6), xi.dtype), np.eye(6, dtype=xi.dtype)
    for n, b in enumerate(BERNOULLI):
        if b:
            out += (b / math.factorial(n)) * power
        power = power @ ad
    return out


def refine(abs_poses, edges, n_iters: int, dtype=np.float64) -> list[tuple]:
    """Dense Gauss-Newton from the chain's poses [(R, t)] over edges [(i, j,
    (R, t) of j in i, weight)]; returns the poses [(R, t)] in `dtype`."""
    poses = [(np.asarray(R, dtype), np.asarray(t, dtype)) for R, t in abs_poses]
    edges = [(i, j, (np.asarray(Z[0], dtype), np.asarray(Z[1], dtype)), weight)
             for i, j, Z, weight in edges]
    m = len(poses)
    for _ in range(n_iters):
        H = np.zeros((6 * m, 6 * m), dtype)
        g = np.zeros(6 * m, dtype)
        for i, j, Z, weight in edges:
            Zinv = inverse(Z)
            E = compose(Zinv, compose(inverse(poses[i]), poses[j]))
            r = se3_log(*E)
            Jj = left_jacobian_inv(-r)
            Ji = -left_jacobian_inv(r) @ adjoint(*Zinv)
            for a, Ja in ((i, Ji), (j, Jj)):
                g[6 * a:6 * a + 6] += weight * Ja.T @ r
                for b, Jb in ((i, Ji), (j, Jj)):
                    H[6 * a:6 * a + 6, 6 * b:6 * b + 6] += weight * Ja.T @ Jb
        H[:6, :6] += GAUGE * np.eye(6, dtype=dtype)
        delta = -np.linalg.solve(H + DAMPING * np.eye(6 * m, dtype=dtype), g).reshape(m, 6)
        poses = [compose(p, se3_exp(d)) for p, d in zip(poses, delta)]
    return poses


def chain_edges(rel_poses) -> list:
    """The odometry edges (k, k + 1, relative pose, 1)."""
    return [(k, k + 1, (R, t), 1.0) for k, (R, t) in enumerate(rel_poses)]


# --- the map


def fuse(scans, poses, voxel: float | None) -> np.ndarray:
    """The scans moved by the poses (float32, see above) and joined,
    voxelized when voxel > 0 (None: the joined cloud's bounding-box diagonal
    / 256)."""
    world = np.concatenate([np.asarray(s, np.float32) @ np.asarray(R, np.float32).T
                            + np.asarray(t, np.float32) for s, (R, t) in zip(scans, poses)])
    if voxel is None:
        voxel = float(np.linalg.norm(world.max(0) - world.min(0))) / 256.0
    return voxel_downsample(world, voxel) if voxel > 0 else world


def bucketed(cloud: np.ndarray, bucket: int, seed: int):
    """(points [bucket, 3] float32, weights [bucket] float32)."""
    n = cloud.shape[0]
    if n > bucket:
        idx = np.random.default_rng(seed).choice(n, size=bucket, replace=False)
        return cloud[idx].astype(np.float32), np.ones(bucket, np.float32)
    pts = np.concatenate([cloud.astype(np.float32), np.zeros((bucket - n, 3), np.float32)])
    return pts, np.concatenate([np.ones(n, np.float32), np.zeros(bucket - n, np.float32)])


def build_map(scans, poses, cfg: dict, dtype=torch.float64, device="cpu"):
    """The map's levels, coarse to fine, and the fused cloud's size."""
    cloud = fuse(scans, poses, cfg["voxel"])
    pts, wts = bucketed(cloud, cfg["bucket"], cfg["seed"])
    levels = fit_tree(torch.from_numpy(pts), torch.from_numpy(wts), cfg["branch"], cfg["levels"],
                      cfg["em_iters"], torch.Generator().manual_seed(cfg["seed"]), dtype, device)
    return levels, cloud.shape[0]
