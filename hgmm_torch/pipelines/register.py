"""Pairwise rigid registration: a loop of (E-step statistics, pose solve).

Counterpart of ``hgmm/pipelines/register.py``. Methods:
- "horn": weighted Horn/Umeyama on virtual targets (large basin);
- "wls": Mahalanobis Gauss-Newton on the se(3) twist (anisotropic-exact);
- "horn+wls": Horn for the first half of the iterations, then WLS.

The iterate is a Python loop. After each live iteration the host reads the
pose increment to test convergence (one device-to-host sync per iteration);
once converged, the remaining iterations do no work.
"""

from __future__ import annotations

import typing

import torch

from hgmm_torch import ops
from hgmm_torch.models.gmm import Gmm
from hgmm_torch.models.gmm_tree import GmmTree
from hgmm_torch.models.pose import apply_wls_increment, solve_horn, solve_wls_increment
from hgmm_torch.models.se3 import Pose, se3_log
from hgmm_torch.ops.gaussians import MixtureParams, pack_loglik_weights, precision_terms, sym_pack


class RegistrationResult(typing.NamedTuple):
    pose: Pose
    logliks: torch.Tensor  # [n_iters] data log-likelihood per iteration
    deltas: torch.Tensor  # [n_iters] ||se3 increment|| per iteration
    converged: torch.Tensor  # [] bool


def run_registration_scan(stats_fn, init_R, init_t, n_iters: int, method: str, tol, wls_inner: int):
    """The shared registration iterate: a Horn phase, then a WLS phase.

    stats_fn(R, t) -> (horn [4,4], A [6,6], b [6], loglik []).
    `done` carries from the Horn phase into the WLS phase, so a converged
    Horn phase skips every WLS iteration. Iterations after convergence
    re-emit the last live (loglik, delta), so logliks[-1] and deltas[-1]
    always hold the converged state.

    Returns ((R, t, done), logliks [n_iters], deltas [n_iters]).
    """
    if method not in ("horn", "wls", "horn+wls"):
        raise ValueError(f"unknown registration method {method!r}")
    n_horn = n_iters // 2 if method == "horn+wls" else (n_iters if method == "horn" else 0)
    R, t = init_R, init_t
    done = False
    ll_last = d_last = torch.zeros((), dtype=init_R.dtype, device=init_R.device)
    lls, deltas = [], []
    for it in range(n_iters):
        if not done:
            horn, A, b, ll = stats_fn(R, t)
            if it < n_horn:
                new = solve_horn(horn)
            else:
                new = apply_wls_increment(Pose(R, t), solve_wls_increment(A, b))
                # Further Gauss-Newton steps, refreshing associations each time.
                for _ in range(wls_inner - 1):
                    _, A2, b2, _ = stats_fn(new.R, new.t)
                    new = apply_wls_increment(new, solve_wls_increment(A2, b2))
            delta = torch.linalg.norm(se3_log(new.compose(Pose(R, t).inverse())))
            R, t, ll_last, d_last = new.R, new.t, ll, delta
            done = bool(delta < tol)
        lls.append(ll_last)
        deltas.append(d_last)
    return (R, t, done), torch.stack(lls), torch.stack(deltas)


def model_terms(params: MixtureParams):
    """Per-component terms every registration iteration reuses: W [10,K],
    mu [K,3], A6 [K,6] packed precisions, b3 [K,3] = Sigma^-1 mu."""
    A, b, _ = precision_terms(params)
    return pack_loglik_weights(params), params.mu, sym_pack(A), b


def register_points(
    source: torch.Tensor,
    params: MixtureParams,
    init_pose: Pose | None = None,
    n_iters: int = 50,
    method: str = "horn+wls",
    tol: float = 1e-7,
    top_k: int | None = None,
    outlier_logit: float | None = None,
    point_weights: torch.Tensor | None = None,
    wls_inner: int = 2,
) -> RegistrationResult:
    """Register `source` [N, 3] onto a fitted mixture. Returns the pose T
    with T(source) ~ target."""
    if init_pose is None:
        init_pose = Pose.identity(source.dtype, source.device)
    W, mu, A6, b3 = model_terms(params)
    prep = ops.prepare(source, point_weights)  # built once for the scan

    def stats_fn(R, t):
        st = ops.reg_stats(prep, W, mu, A6, b3, (R, t), top_k, outlier_logit)
        return st.horn, st.A, st.b, st.loglik

    (R, t, done), logliks, deltas = run_registration_scan(
        stats_fn, init_pose.R, init_pose.t, n_iters, method, tol, wls_inner
    )
    return RegistrationResult(
        pose=Pose(R, t), logliks=logliks, deltas=deltas,
        converged=torch.tensor(done, device=source.device),
    )


def register_tree(
    source: torch.Tensor,
    tree: GmmTree,
    init_pose: Pose | None = None,
    n_iters: int = 50,
    method: str = "wls",
    tol: float = 1e-7,
    top_k: int | None = None,
    outlier_logit: float | None = None,
    point_weights: torch.Tensor | None = None,
    wls_inner: int = 2,
    complexity_threshold: float = 0.0,
) -> RegistrationResult:
    """Coarse-to-fine registration down the tree: level 0 (wide basin), then
    each finer level warm-started from the last pose, ending on the leaves
    or on their adaptive complexity cut. `n_iters` is per level."""
    pose = Pose.identity(source.dtype, source.device) if init_pose is None else init_pose
    lls, deltas, res = [], [], None
    for li, params in enumerate(tree.levels):
        if li == len(tree.levels) - 1 and complexity_threshold > 0.0:
            params = tree.cut_mixture(complexity_threshold)
        res = register_points(
            source, params, init_pose=pose, n_iters=n_iters, method=method, tol=tol,
            top_k=top_k, outlier_logit=outlier_logit, point_weights=point_weights,
            wls_inner=wls_inner,
        )
        pose = res.pose
        lls.append(res.logliks)
        deltas.append(res.deltas)
    return RegistrationResult(
        pose=pose, logliks=torch.cat(lls), deltas=torch.cat(deltas), converged=res.converged
    )


def register_pair(
    source: torch.Tensor,
    target: torch.Tensor | None = None,
    model: Gmm | GmmTree | MixtureParams | None = None,
    model_kind: str = "tree",
    k: int = 64,
    branch: int = 8,
    levels: int = 3,
    fit_iters: int = 20,
    complexity_threshold: float = 0.0,
    generator: torch.Generator | None = None,
    **register_kw,
) -> RegistrationResult:
    """End-to-end pairwise registration: fit a mixture to `target` (or take
    a prefit `model`), then register `source` onto it.
    model_kind: "flat" or "tree"."""
    if model is None:
        if target is None:
            raise ValueError("register_pair needs a target cloud or a prefit model")
        if model_kind == "flat":
            model, _ = Gmm.fit(target, k=k, n_iters=fit_iters, generator=generator)
        else:
            model, _ = GmmTree.fit(
                target, branch=branch, levels=levels, em_iters=fit_iters, generator=generator
            )
    if isinstance(model, GmmTree):
        return register_tree(source, model, complexity_threshold=complexity_threshold, **register_kw)
    params = model.params if isinstance(model, Gmm) else model
    return register_points(source, params, **register_kw)
