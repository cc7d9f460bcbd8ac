"""Loop-closure detection from registered scan pairs.

Counterpart of ``hgmm/pipelines/loop_closure.py``. Candidate non-adjacent
frame pairs are proposed by pose proximity (translation distance + heading
gate on the dead-reckoned trajectory); each candidate is verified by the same
tree/flat registration the odometry loop runs (initialized from the
dead-reckoned relative pose), and survivors become an EdgeList with
log-likelihood-derived weights for pose-graph refinement. No ground-truth
edge is involved anywhere.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from hgmm_torch.convert import to_numpy
from hgmm_torch.models.se3 import Pose, se3_exp, se3_log
from hgmm_torch.pipelines.pose_graph import EdgeList


@dataclasses.dataclass
class ClosureConfig:
    """Candidate gating + acceptance thresholds for loop-closure detection.

    Scale-free defaults: the proximity radius is a multiple of the
    trajectory's median per-step translation, so one config serves unit-scale
    scans and metric-scale KITTI sequences.
    """

    min_separation: int = 5  # skip near-adjacent frames (the chain covers them)
    radius_steps: float = 2.0  # candidate gate: |t_i - t_j| < this x median step
    # Drift allowance: the gate radius grows with the separation j - i as
    # radius_steps*med + drift_rate*med*(j-i), because dead-reckoned position
    # error accumulates with travelled path. 0 restores the
    # separation-independent gate.
    drift_rate: float = 0.05
    max_heading: float = 1.2  # rad: relative rotation angle gate
    max_candidates: int = 8  # verification budget (registrations are the cost)
    accept_delta: float = 1e-3  # non-converged candidates need delta below this
    # Accept if per-point loglik >= (chain median) + margin; margin < 0
    # admits slightly-worse-than-chain overlaps (partial view overlap).
    accept_loglik_margin: float = -1.5
    weight_scale: float = 10.0  # max edge weight (chain edges weigh 1)
    reg_iters: int | None = None  # override OdometryConfig.reg_iters
    # Reciprocal verification: also register i onto j's model and require the
    # two estimates to agree (||log(Z_fwd * Z_rev)|| below this fraction of
    # the median step length); accepted edges use the geodesic mean of the
    # two estimates. None disables.
    reciprocal_tol: float | None = 0.5


def propose_candidates(abs_poses: list[Pose], cfg: ClosureConfig) -> list[tuple[int, int]]:
    """Pose-proximity candidate pairs (i < j), nearest relative to the gate
    first. Vectorized numpy over all F^2 pairs (distance + relative-heading
    gates via trace(Ri^T Rj))."""
    t = np.stack([to_numpy(p.t) for p in abs_poses])  # [F, 3]
    R = np.stack([to_numpy(p.R) for p in abs_poses])  # [F, 3, 3]
    f = t.shape[0]
    if f < cfg.min_separation + 2:
        return []
    steps = np.linalg.norm(np.diff(t, axis=0), axis=1)
    med = float(np.median(steps)) if steps.size else 0.0
    med = max(med, 1e-12)
    dist = np.linalg.norm(t[:, None] - t[None, :], axis=-1)  # [F, F]
    # Geodesic rotation angle: cos(theta) = (trace(Ri^T Rj) - 1) / 2.
    tr = np.einsum("iab,jab->ij", R, R)
    ang = np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0))
    ii, jj = np.meshgrid(np.arange(f), np.arange(f), indexing="ij")
    # Separation-aware gate, clamped positive (the j <= i half is masked out
    # by ok anyway).
    radius = np.maximum(med * (cfg.radius_steps + cfg.drift_rate * (jj - ii)), 1e-30)
    ok = (jj - ii > cfg.min_separation) & (dist < radius) & (ang <= cfg.max_heading)
    # Nearest relative to the gate first: raw distance would prefer small
    # separations under a separation-dependent gate.
    order = np.argsort((dist / radius)[ok], kind="stable")
    return list(zip(ii[ok][order].tolist(), jj[ok][order].tolist()))


def reciprocal_check(fwd: Pose, rev: Pose, tol: float):
    """Reciprocal-consistency gate + fusion for a verified pair.

    fwd estimates Z (pose of j in frame i), rev estimates Z^-1. Returns
    (consistent, fused, disagreement) where disagreement =
    ||log(fwd^-1 o rev^-1)||, consistent = disagreement <= tol, and fused =
    fwd o exp(log(fwd^-1 o rev^-1)/2), the geodesic midpoint of fwd and
    rev^-1."""
    d = se3_log(fwd.inverse().compose(rev.inverse()))
    dn = float(torch.linalg.norm(d))
    fused = fwd.compose(se3_exp(0.5 * d))
    return dn <= tol, fused, dn


def _near_used(i: int, j: int, used, sep: int) -> bool:
    return any(abs(i - u) <= sep or abs(j - u) <= sep for u in used)


def detect_loop_closures(
    frames,
    result,
    odo_cfg,
    config: ClosureConfig | None = None,
    mesh=None,
    metrics=None,
) -> EdgeList | None:
    """Verify proximity candidates by registration; emit accepted edges.

    frames: list of (points [N,3], weights [N]) as built by run_odometry.
    result: OdometryResult of the dead-reckoned chain (abs_poses, logliks).
    odo_cfg: the OdometryConfig the chain ran with — verification registers
    with the same model family, iteration budget and device, so acceptance
    thresholds are comparable with the chain logliks. mesh: verification fits
    and registrations run points-sharded over it (run_odometry's mesh).
    Returns an EdgeList on the poses' device, or None when nothing passed.
    """
    from hgmm_torch.pipelines.odometry import _fit_frame_model, _register_to_model, frame_generator

    cfg = config or ClosureConfig()
    if cfg.reg_iters is not None:
        odo_cfg = dataclasses.replace(odo_cfg, reg_iters=cfg.reg_iters)
    # max_candidates is a verification budget: neighbourhood-redundant
    # candidates are skipped for free before the budget is charged.
    cands = propose_candidates(result.abs_poses, cfg)
    if not cands:
        return None
    t_all = np.stack([to_numpy(p.t) for p in result.abs_poses])
    steps = np.linalg.norm(np.diff(t_all, axis=0), axis=1)
    med_step = float(np.median(steps)) if steps.size else 1.0

    # Per-point chain loglik reference: pair (k, k+1) registered the weighted
    # source frame k+1.
    chain_ll = [ll / max(float(np.sum(frames[k + 1][1])), 1.0)
                for k, ll in enumerate(result.logliks)]
    ll_ref = float(np.nanmedian(chain_ll)) if chain_ll else np.nan

    # Per-frame model cache, drawn with the chain's generator of each frame,
    # so a cached closure model is the chain's model of that frame.
    models: dict[int, object] = {}

    def model_of(idx: int):
        if idx not in models:
            models[idx] = _fit_frame_model(frames[idx], odo_cfg,
                                           frame_generator(odo_cfg.seed, idx), mesh)
        return models[idx]

    accepted: list[tuple[int, int, Pose, float]] = []
    used: set[int] = set()
    skip_used: set[int] = set()
    verified = 0
    budget_skipped = 0
    for i, j in cands:
        if verified >= cfg.max_candidates:
            # Count the distinct-neighbourhood candidates left unverified, so
            # the budget cut is observable.
            if not _near_used(i, j, used | skip_used, cfg.min_separation):
                budget_skipped += 1
                skip_used.update((i, j))
                if metrics is not None:
                    metrics.log({"event": "loop_closure_candidate_skipped", "i": i, "j": j,
                                 "reason": "verification_budget"})
            continue
        # One closure per neighbourhood: a cluster of candidates around one
        # revisit collapses to its best (nearest) pair.
        if _near_used(i, j, used, cfg.min_separation):
            continue
        verified += 1
        init = result.abs_poses[i].inverse().compose(result.abs_poses[j])
        res = _register_to_model(model_of(i), frames[j], odo_cfg, init, mesh)
        delta = float(res.deltas[-1])
        ll_pp = float(res.logliks[-1]) / max(float(np.sum(frames[j][1])), 1.0)
        ok_conv = bool(res.converged) or delta < cfg.accept_delta
        ok_ll = (not np.isfinite(ll_ref)) or (ll_pp >= ll_ref + cfg.accept_loglik_margin)
        pose, ok_recip, recip_d = res.pose, True, None
        if ok_conv and ok_ll and cfg.reciprocal_tol is not None:
            rev = _register_to_model(model_of(j), frames[i], odo_cfg, init.inverse(), mesh)
            ok_recip, pose, recip_d = reciprocal_check(res.pose, rev.pose,
                                                       cfg.reciprocal_tol * med_step)
            ok_recip = ok_recip and (bool(rev.converged) or float(rev.deltas[-1]) < cfg.accept_delta)
        accepted_flag = bool(ok_conv and ok_ll and ok_recip)
        if metrics is not None:
            metrics.log({"event": "loop_closure_candidate", "i": i, "j": j,
                         "accepted": accepted_flag, "loglik_pp": ll_pp, "loglik_ref": ll_ref,
                         "delta": delta, "reciprocal_disagreement": recip_d})
        if not accepted_flag:
            continue
        # Log-likelihood-derived weight: at-or-above chain quality earns the
        # full weight_scale, degrading smoothly (bounded at e^-3) for weaker
        # overlaps.
        rel_q = 0.0 if not np.isfinite(ll_ref) else min(ll_pp - ll_ref, 0.0)
        accepted.append((i, j, pose, cfg.weight_scale * float(np.exp(max(rel_q, -3.0)))))
        used.update((i, j))
    if budget_skipped:
        warnings.warn(
            f"detect_loop_closures: verification budget (max_candidates={cfg.max_candidates}) "
            f"left {budget_skipped} distinct candidate neighborhoods unverified — raise "
            f"ClosureConfig.max_candidates to cover more revisits",
            stacklevel=2,
        )
    if not accepted:
        return None
    dev = result.abs_poses[0].R.device
    return EdgeList(
        i=torch.tensor([a[0] for a in accepted], device=dev),
        j=torch.tensor([a[1] for a in accepted], device=dev),
        R=torch.stack([a[2].R for a in accepted]),
        t=torch.stack([a[2].t for a in accepted]),
        weight=torch.tensor([a[3] for a in accepted], dtype=torch.float32, device=dev),
    )
