"""Frame-to-frame LiDAR odometry via hierarchical-GMM registration
(BASELINE.json config 4: "KITTI LiDAR scan-pair sequence").

Counterpart of ``hgmm/pipelines/odometry.py``. A host loop over frames:
frames stay numpy on the host, each is padded or subsampled to one fixed
point bucket, and each pair's points go to ``OdometryConfig.device`` for the
target fit and the registration (the card unless the caller names another
device). Warm starts: each pair starts from the
previous relative pose (constant velocity). Resumable at frame granularity
through ``hgmm_torch.utils.checkpoint``. With a mesh (``hgmm_torch.parallel``)
each pair's fit and registration run points-sharded over it and refinement
runs the distributed Schur solver.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch

from hgmm_torch.models.gmm import Gmm
from hgmm_torch.models.gmm_tree import GmmTree
from hgmm_torch.models.se3 import Pose
from hgmm_torch.pipelines.pose_graph import (
    EdgeList,
    PoseGraphResult,
    concat_edge_lists,
    odometry_chain_edges,
    refine_chain_sharded,
    refine_pose_graph,
)
from hgmm_torch.pipelines.register import register_points, register_tree
from hgmm_torch.utils import checkpoint as ckpt
from hgmm_torch.utils.device import resolve_device
from hgmm_torch.utils.profiling import span


@dataclasses.dataclass
class OdometryConfig:
    model_kind: str = "tree"  # "tree" | "flat"
    k: int = 64  # flat mixture size
    branch: int = 8
    levels: int = 3
    fit_iters: int = 10
    reg_iters: int = 30
    # Damped Mahalanobis WLS: the Horn surrogate is biased on plane-dominated
    # LiDAR mixtures (see configs.presets.CONFIG4_KITTI).
    method: str = "wls"
    top_k: int | None = None
    # Uniform-outlier log-density: it must sit well below typical in-model
    # log-densities, or the outlier absorbs the responsibility mass and the
    # pose stops moving (metric LiDAR scenes ~ -8, unit-scale scans ~ -3).
    # None disables outlier gating.
    outlier_logit: float | None = -8.0
    complexity_threshold: float = 0.0
    voxel: float | None = None  # host-side voxel downsample (meters)
    bucket: int = 16384  # fixed per-frame point budget (pad/subsample)
    warm_start: bool = True
    seed: int = 0
    # Where the fits and registrations run: None is the card, and raises
    # without one; "cpu" runs the plain PyTorch path.
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)


@dataclasses.dataclass
class OdometryResult:
    abs_poses: list[Pose]  # [F] absolute poses (frame 0 = identity)
    rel_poses: list[Pose]  # [F-1] frame k -> k+1
    logliks: list[float]  # final registration loglik per pair
    # Loop closures verified by registration (run_odometry(detect_closures=
    # True)); refine_odometry consumes them by default.
    closures: EdgeList | None = None


def _bucketize(points: np.ndarray, bucket: int, rng: np.random.Generator):
    """Pad or subsample to exactly `bucket` points; returns (pts, weights)."""
    n = points.shape[0]
    if n >= bucket:
        idx = rng.choice(n, size=bucket, replace=False)
        return points[idx].astype(np.float32), np.ones(bucket, np.float32)
    pad = np.zeros((bucket - n, 3), np.float32)
    w = np.concatenate([np.ones(n, np.float32), np.zeros(bucket - n, np.float32)])
    return np.concatenate([points.astype(np.float32), pad]), w


def frame_generator(seed: int, frame: int) -> torch.Generator:
    """The CPU generator that draws frame `frame`'s model init: a function of
    (seed, frame) only, so a resumed run sees the same draw whatever its start
    frame, loop-closure verification refits the chain's model of a frame, and
    two runs with one seed are identical (the JAX package's
    fold_in(PRNGKey(seed), frame)). CPU whatever the device: init_params draws
    on the host."""
    state = np.random.SeedSequence((seed, frame)).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def _on(frame, device):
    with span("hgmm_torch.odo.upload"):
        pts, w = frame
        return torch.from_numpy(pts).to(device), torch.from_numpy(w).to(device)


def _fit_frame_model(tgt, cfg: OdometryConfig, generator: torch.Generator, mesh=None):
    """Fit the per-frame target model: flat MixtureParams or a GmmTree
    (registered coarse-to-fine), through the sharded fits with a mesh.
    Loop-closure verification caches these per frame index — the fit
    dominates per-candidate cost."""
    pts, w = _on(tgt, cfg.device)
    if mesh is not None:
        from hgmm_torch.models.gmm import init_params
        from hgmm_torch.parallel import sharded_em_fit, sharded_tree_fit

        if cfg.model_kind == "flat":
            params, _ = sharded_em_fit(pts, init_params(pts, cfg.k, generator, point_weights=w), mesh,
                                       n_iters=cfg.fit_iters, point_weights=w)
            return params
        return sharded_tree_fit(pts, mesh, branch=cfg.branch, levels=cfg.levels,
                                em_iters=cfg.fit_iters, generator=generator, point_weights=w)
    if cfg.model_kind == "flat":
        gmm, _ = Gmm.fit(pts, k=cfg.k, n_iters=cfg.fit_iters, generator=generator,
                         point_weights=w)
        return gmm.params
    tree, _ = GmmTree.fit(pts, branch=cfg.branch, levels=cfg.levels, em_iters=cfg.fit_iters,
                          generator=generator, point_weights=w)
    return tree


def _register_to_model(model, src, cfg: OdometryConfig, init: Pose, mesh=None):
    """Register source frame points onto a fitted model (sharded with a
    mesh)."""
    pts, w = _on(src, cfg.device)
    reg_kw = dict(init_pose=init, n_iters=cfg.reg_iters, method=cfg.method, top_k=cfg.top_k,
                  outlier_logit=cfg.outlier_logit, point_weights=w)
    if mesh is not None:
        from hgmm_torch.parallel import sharded_register_points, sharded_register_tree

        if isinstance(model, GmmTree):
            return sharded_register_tree(pts, model, mesh,
                                         complexity_threshold=cfg.complexity_threshold, **reg_kw)
        return sharded_register_points(pts, model, mesh, **reg_kw)
    if isinstance(model, GmmTree):
        # Coarse-to-fine down the tree: the leaf basin alone is smaller than
        # typical frame motion.
        return register_tree(pts, model, complexity_threshold=cfg.complexity_threshold, **reg_kw)
    return register_points(pts, model, **reg_kw)


def _register_frames(tgt, src, cfg: OdometryConfig, generator: torch.Generator, init: Pose,
                     mesh=None):
    """Fit a model to the target frame and register the source frame onto it
    (one odometry pair)."""
    return _register_to_model(_fit_frame_model(tgt, cfg, generator, mesh), src, cfg, init, mesh)


def run_odometry(
    scans: Sequence[np.ndarray] | Iterable[np.ndarray],
    config: OdometryConfig | None = None,
    checkpoint_path: str | Path | None = None,
    checkpoint_every: int = 10,
    metrics=None,
    mesh=None,
    detect_closures: bool = False,
    closure_config=None,
) -> OdometryResult:
    """Sequential scan-to-scan registration. `scans` yields [N_i, 3] arrays
    (hgmm_torch.data.kitti loads real sequences).

    metrics: optional hgmm_torch.utils.profiling.MetricsLog — one JSONL
    record per pair. mesh: a hgmm_torch.parallel mesh; each pair's fit and
    registration run points-sharded over it (config 5 of BASELINE.json:
    multi-host frames), and so does closure verification. detect_closures: after the chain, propose loop-closure
    candidates by pose proximity and verify them by registration
    (pipelines.loop_closure); accepted edges land in result.closures and feed
    refine_odometry by default. The poses stay on the config's device."""
    cfg = config or OdometryConfig()
    from hgmm_torch.data.kitti import voxel_downsample

    rng = np.random.default_rng(cfg.seed)
    frames = []
    with span("hgmm_torch.odo.frames"):
        for s in scans:
            s = np.asarray(s)
            if cfg.voxel:
                s = voxel_downsample(s, cfg.voxel)
            frames.append(_bucketize(s, cfg.bucket, rng))
    f = len(frames)
    if f < 2:
        raise ValueError("run_odometry: need at least two scans")

    start = 0
    rel_poses: list[Pose] = []
    abs_poses: list[Pose] = [Pose.identity(device=cfg.device)]
    logliks: list[float] = []
    if checkpoint_path is not None:
        state = ckpt.load_odometry(checkpoint_path, device=cfg.device)
        if state is not None:
            start, rel_poses, abs_poses, logliks = state

    prev_rel = rel_poses[-1] if rel_poses else Pose.identity(device=cfg.device)
    for i in range(start, f - 1):
        with span("hgmm_torch.odo.pair"):
            init = prev_rel if cfg.warm_start else Pose.identity(device=cfg.device)
            res = _register_frames(frames[i], frames[i + 1], cfg, frame_generator(cfg.seed, i), init,
                                   mesh)
            # res.pose maps source (frame i+1) points into frame i: that IS the
            # pose of frame i+1 expressed in frame i.
            rel = res.pose
            rel_poses.append(rel)
            abs_poses.append(abs_poses[-1].compose(rel))
            logliks.append(float(res.logliks[-1]))
            if metrics is not None:
                metrics.log_registration(f"pair_{i}_{i + 1}", res)
            prev_rel = rel
            if checkpoint_path is not None and (i + 1) % checkpoint_every == 0:
                ckpt.save_odometry(checkpoint_path, i + 1, rel_poses, abs_poses, logliks)

    if checkpoint_path is not None:
        ckpt.save_odometry(checkpoint_path, f - 1, rel_poses, abs_poses, logliks)
    result = OdometryResult(abs_poses=abs_poses, rel_poses=rel_poses, logliks=logliks)
    if detect_closures:
        from hgmm_torch.pipelines.loop_closure import detect_loop_closures

        result.closures = detect_loop_closures(frames, result, cfg, config=closure_config,
                                               mesh=mesh, metrics=metrics)
    return result


def refine_odometry(
    result: OdometryResult,
    loop_closures: EdgeList | None = None,
    n_iters: int = 10,
    mesh=None,
    robust_delta: float | None = None,
) -> PoseGraphResult:
    """Pose-graph refinement of an odometry run.

    loop_closures: optional EdgeList to append to the chain; defaults to the
    closures detected by run_odometry(detect_closures=True). mesh: a
    hgmm_torch.parallel mesh; refinement runs the distributed segment-wise
    Schur solver (pose_graph.refine_chain_sharded), which takes any chain
    length and closure count and falls back to the dense solver for chains
    too short to shard. robust_delta: Geman-McClure gate on edge residual
    norms (pose_graph._robust_weight). The graph is solved on the poses'
    device."""
    if loop_closures is None:
        loop_closures = result.closures
    R = torch.stack([p.R for p in result.abs_poses])
    t = torch.stack([p.t for p in result.abs_poses])
    if mesh is not None:
        return refine_chain_sharded(R, t, torch.stack([p.R for p in result.rel_poses]),
                                    torch.stack([p.t for p in result.rel_poses]), mesh,
                                    n_iters=n_iters, closures=loop_closures,
                                    robust_delta=robust_delta)
    if R.shape[0] > 512:
        # The dense solver builds an [M, M, 6, 6] Hessian per Gauss-Newton
        # step: a 2000-frame KITTI chain is ~2.3 GB of Hessian.
        warnings.warn(
            f"refine_odometry: dense pose-graph solve on {R.shape[0]} nodes builds an "
            f"[M, M, 6, 6] Hessian — pass mesh= to use the distributed Schur solver at this "
            f"scale",
            stacklevel=2,
        )
    edges = odometry_chain_edges(result.rel_poses)
    if loop_closures is not None:
        edges = concat_edge_lists(edges, loop_closures)
    return refine_pose_graph(R, t, edges, n_iters=n_iters, robust_delta=robust_delta)
