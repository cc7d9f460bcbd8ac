"""Pairwise rigid registration: a loop of (E-step statistics, pose solve).

Counterpart of ``hgmm/pipelines/register.py``. Methods:
- "horn": weighted Horn/Umeyama on virtual targets (large basin);
- "wls": Mahalanobis Gauss-Newton on the se(3) twist (anisotropic-exact);
- "horn+wls": Horn for the first half of the iterations, then WLS.

The iterate runs a fixed number of iterations with `done` carried, as the
reference's lax.scan does, and nothing crosses to the host inside a scan:
the pose, the iteration's start, the outputs and the done flag live in one
state buffer (``ops.new_scan``, made for the level's tables). Each step is two launches on the card, the
statistics kernel (``ops.reg_partials``: ``csrc/reg_stats.cu``, which returns
at once when the scan is done) and the step kernel (``ops.reg_step``: ``csrc/reg_step.cu``,
the partials' sum and the pose solve); a scan's steps (``scan_schedule``)
launch from one host call there (``ops.reg_scan``). A sharded run steps from
Python and puts its all_reduce of the 59 statistics between the two. On the
CPU both are the plain versions, a step at a time.

The source buffer is prepared once a registration (``ops.prepare``) and each
level's tables are built from its mixture by ``ops.reg_problem_of``: on the
card one launch (``csrc/reg_tables.cu``), on the CPU ``model_terms``.

Spans (``utils/profiling.span``): ``hgmm_torch.reg`` the whole registration,
``.reg.cut`` the complexity cut of the last level, ``.reg.prep`` a level's
tables, ``.reg.scan`` a level's iterate. Counters: ``reg.steps`` the steps
launched, ``reg.native_steps`` those launched by the one host call,
``reg.live_steps`` those run before done (the scan state's SCAN_LIVE, read
after the traced block); on the card a gated level's tables add the top_k
body's own (``fused_em.TOPK_COUNTERS``).
"""

from __future__ import annotations

import functools
import typing

import torch

from hgmm_torch import ops
from hgmm_torch.models.gmm import Gmm
from hgmm_torch.models.gmm_tree import GmmTree
from hgmm_torch.models.se3 import Pose
from hgmm_torch.ops.em_ref import SCAN_LIVE, model_terms  # noqa: F401  (the reference's name here)
from hgmm_torch.ops.gaussians import MixtureParams
from hgmm_torch.utils import profiling
from hgmm_torch.utils.profiling import span


class RegistrationResult(typing.NamedTuple):
    pose: Pose
    logliks: torch.Tensor  # [n_iters] data log-likelihood per iteration
    deltas: torch.Tensor  # [n_iters] ||se3 increment|| per iteration
    converged: torch.Tensor  # [] bool


class ScanStep(typing.NamedTuple):
    it: int  # the iteration, which indexes logliks and deltas
    solver: int  # 0 Horn, 1 WLS (Gauss-Newton)
    first: bool  # the iteration's first step: records its start pose and loglik
    last: bool  # its last: writes logliks[it], deltas[it] and done


@functools.lru_cache(maxsize=64)
def scan_schedule(n_iters: int, method: str, wls_inner: int) -> tuple[ScanStep, ...]:
    """A scan's steps in order, known on the host from the iteration index:
    "horn+wls" runs Horn for the first n_iters // 2 iterations, then WLS; a
    Horn iteration is one step, a WLS iteration max(wls_inner, 1)."""
    if method not in ("horn", "wls", "horn+wls"):
        raise ValueError(f"unknown registration method {method!r}")
    n_horn = n_iters // 2 if method == "horn+wls" else (n_iters if method == "horn" else 0)
    out = []
    for it in range(n_iters):
        solver = 0 if it < n_horn else 1
        steps = 1 if solver == 0 else max(wls_inner, 1)
        out.extend(ScanStep(it, solver, s == 0, s == steps - 1) for s in range(steps))
    return tuple(out)


def run_registration_scan(problem, init_R, init_t, n_iters: int, method: str, tol, wls_inner: int, mesh=None):
    """The shared registration iterate on a level's tables (ops.reg_problem_of):
    a Horn phase, then a WLS phase (scan_schedule).

    Each step reads the [nb, 59] reg_stats rows at the scan's pose (horn 16,
    A 36, b 6, loglik; summed by the step): ops.reg_partials, or with a mesh
    (hgmm_torch.parallel) this rank's rows summed to one (ops.reg_row) and
    added over the mesh. Every iteration runs: once `done`
    is set (delta < tol), the statistics and the step do no work, and the
    outputs re-emit the last live (loglik, delta), so logliks[-1] and
    deltas[-1] always hold the converged state. `done` carries from the Horn
    phase into the WLS phase. A WLS iteration takes wls_inner Gauss-Newton
    steps, refreshing the statistics each time; its loglik is its first
    statistics'. Without a mesh the steps go to ops.reg_scan (on the card
    one host call); a mesh steps from here, its all_reduce between a step's
    two launches.

    Returns ((R, t, done), logliks [n_iters], deltas [n_iters]), done a bool
    tensor on the pose's device.
    """
    steps = scan_schedule(n_iters, method, wls_inner)
    with span("hgmm_torch.reg.scan"):
        scan = ops.new_scan(problem, init_R, init_t, n_iters)
        profiling.count("reg.steps", len(steps))
        profiling.count_later("reg.live_steps", scan.state, SCAN_LIVE)
        if mesh is None:
            ops.reg_scan(problem, scan, steps, tol)
        else:
            for it, solver, first, last in steps:
                rows = ops.reg_row(problem, scan)
                mesh.all_reduce_(rows.partial)
                ops.reg_step(rows, scan, it, solver, first, last, tol)
        R, t = scan.pose
        return (R, t, scan.done), scan.logliks, scan.deltas


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
    with span("hgmm_torch.reg"):
        if init_pose is None:
            init_pose = Pose.identity(source.dtype, source.device)
        return _register_points(ops.prepare(source, point_weights), params, init_pose, n_iters, method,
                                tol, top_k, outlier_logit, wls_inner)


def _register_points(prep, params, init_pose, n_iters, method, tol, top_k, outlier_logit,
                     wls_inner) -> RegistrationResult:
    """One scan of the prepared source onto `params` (register_points, or a
    level of register_tree), inside the registration's span."""
    with span("hgmm_torch.reg.prep"):
        # The level's tables and the partials, once for the scan.
        problem = ops.reg_problem_of(prep, params, top_k, outlier_logit)
    (R, t, done), logliks, deltas = run_registration_scan(problem, init_pose.R, init_pose.t, n_iters, method,
                                                          tol, wls_inner)
    return RegistrationResult(pose=Pose(R, t), logliks=logliks, deltas=deltas, converged=done)


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
    with span("hgmm_torch.reg"):
        pose = Pose.identity(source.dtype, source.device) if init_pose is None else init_pose
        prep = ops.prepare(source, point_weights)  # one source buffer for every level
        lls, deltas, res = [], [], None
        for li, params in enumerate(tree.levels):
            if li == len(tree.levels) - 1 and complexity_threshold > 0.0:
                with span("hgmm_torch.reg.cut"):
                    params = tree.cut_mixture(complexity_threshold)
            res = _register_points(prep, params, pose, n_iters, method, tol, top_k, outlier_logit,
                                   wls_inner)
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
