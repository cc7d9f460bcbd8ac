"""Global mixture-map building + map-based localization.

Counterpart of ``hgmm/pipelines/mapping.py``. After odometry and refinement
give globally consistent poses, the frames are fused into ONE
hierarchical-GMM map of the scene: the union of pose-transformed points,
voxel-downsampled and padded to a bucket, fit with ``GmmTree.fit`` (with a
mesh, points-sharded by ``parallel.sharded_tree_fit``). The map is then a
registration target: ``localize`` runs the coarse-to-fine registration of a
new scan against it (relocalization without the original frames).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from hgmm_torch.convert import to_numpy
from hgmm_torch.models.gmm_tree import GmmTree
from hgmm_torch.models.se3 import Pose
from hgmm_torch.utils.profiling import count, span


def _to_bucket(points, bucket, rng, weights=None, device=None):
    """Subsample (above) or zero-weight pad (below) to exactly `bucket`
    points, as tensors on `device`. Warns when evidence is dropped."""
    n = points.shape[0]
    if weights is None:
        weights = np.ones(n, np.float32)
    if n > bucket:
        warnings.warn(
            f"map fit bucket {bucket} < fused cloud {n}: subsampling {n - bucket} points away "
            f"— raise MapConfig.bucket or coarsen MapConfig.voxel to keep full evidence",
            stacklevel=3,
        )
        idx = rng.choice(n, size=bucket, replace=False)
        pts, w = points[idx], weights[idx]
    else:
        pad = bucket - n
        pts = np.concatenate([points, np.zeros((pad, 3), np.float32)])
        w = np.concatenate([weights, np.zeros(pad, np.float32)])
    return (torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(device),
            torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(device))


def _chol_samples(mu, sigma, z):
    """mu[K,3] + chol(sigma[K,3,3]) @ z[..., 3] Gaussian samples (shared by
    sample_mixture and viz.export_map), numpy."""
    chol = np.linalg.cholesky(sigma + 1e-9 * np.eye(3, dtype=sigma.dtype))
    return mu + np.einsum("...ij,...j->...i", chol, z)


@dataclasses.dataclass
class MapConfig:
    branch: int = 8
    levels: int = 3
    em_iters: int = 12
    voxel: float | None = None  # fuse-time voxel (meters); None = auto
    # Point budget of the fused cloud: subsample above, zero-weight pad below.
    bucket: int = 1 << 18
    seed: int = 0


def fuse_frames(frames, poses, voxel: float | None = None) -> np.ndarray:
    """Transform each frame's points by its (refined) absolute pose and
    concatenate into one world-frame cloud (numpy on the host).

    frames: sequence of [N_i, 3] arrays, or (points, weights) tuples as built
    by run_odometry (zero-weight padding rows are dropped).
    poses: matching absolute Pose per frame (e.g. PoseGraphResult.poses()).
    voxel: voxel-grid downsample of the fused cloud; None picks the fused
    cloud's bbox diagonal / 256, 0 disables.
    """
    from hgmm_torch.data.kitti import voxel_downsample

    if len(frames) != len(poses):
        raise ValueError(f"{len(frames)} frames vs {len(poses)} poses")
    # One device-to-host copy of all poses, then numpy transforms.
    Rs = to_numpy(torch.stack([p.R for p in poses]))
    ts = to_numpy(torch.stack([p.t for p in poses]))
    world = []
    for i, f in enumerate(frames):
        if isinstance(f, tuple):
            pts, w = f
            pts = np.asarray(pts)[np.asarray(w) > 0]
        else:
            pts = np.asarray(f)
        world.append(pts.astype(np.float32) @ Rs[i].T + ts[i])
    fused = np.concatenate(world, axis=0)
    if voxel is None:
        bbox = fused.max(axis=0) - fused.min(axis=0)
        voxel = float(np.linalg.norm(bbox)) / 256.0
    if voxel > 0:
        fused = voxel_downsample(fused, voxel)
    return fused.astype(np.float32)


def build_map(frames, poses, config: MapConfig | None = None, mesh=None) -> GmmTree:
    """Fit the global GMM-tree map to the fused world cloud, on the poses'
    device. mesh: the fit runs points-sharded over it
    (parallel.sharded_tree_fit, the config-5 program: at KITTI scale the fused
    cloud is the 10M+-point workload of BASELINE.json:11).

    Traced as ``hgmm_torch.map``, holding ``hgmm_torch.map.fuse`` (the fused,
    voxelized cloud put in its bucket on the device) and ``hgmm_torch.map.fit``;
    counters ``map.fused_points`` (the cloud offered to the bucket) and
    ``map.dropped_points`` (subsampled away by it)."""
    cfg = config or MapConfig()
    with span("hgmm_torch.map"):
        with span("hgmm_torch.map.fuse"):
            fused = fuse_frames(frames, poses, voxel=cfg.voxel)
            _count_bucket(fused.shape[0], cfg.bucket)
            pts, weights = _to_bucket(fused, cfg.bucket, np.random.default_rng(cfg.seed),
                                      device=poses[0].R.device)
        generator = torch.Generator().manual_seed(cfg.seed)
        with span("hgmm_torch.map.fit"):
            if mesh is not None:
                from hgmm_torch.parallel import sharded_tree_fit

                return sharded_tree_fit(pts, mesh, branch=cfg.branch, levels=cfg.levels,
                                        em_iters=cfg.em_iters, generator=generator,
                                        point_weights=weights)
            tree, _ = GmmTree.fit(pts, branch=cfg.branch, levels=cfg.levels, em_iters=cfg.em_iters,
                                  generator=generator, point_weights=weights)
            return tree


def _count_bucket(n: int, bucket: int) -> None:
    count("map.fused_points", n)
    count("map.dropped_points", max(n - bucket, 0))


def localize(
    scan,
    map_tree: GmmTree,
    init_pose: Pose | None = None,
    mesh=None,
    n_iters: int = 40,
    method: str = "wls",
    outlier_logit: float | None = -8.0,
    complexity_threshold: float = 0.0,
):
    """Register a scan against the prebuilt map (relocalization), on the
    map's device.

    The map's coarse levels give the wide basin (register_tree); the scan only
    needs pose proximity to the mapped area, not a matching frame. Returns the
    RegistrationResult whose pose maps scan points into the map (world) frame
    (with a mesh, sharded over it: parallel.sharded_register_tree's
    ShardedRegResult).
    """
    from hgmm_torch.pipelines.register import register_tree

    dev = map_tree.levels[0].mu.device
    if isinstance(scan, torch.Tensor):
        scan = scan.to(device=dev, dtype=torch.float32)
    else:
        scan = torch.from_numpy(np.asarray(scan, np.float32)).to(dev)
    kw = dict(init_pose=init_pose, n_iters=n_iters, method=method, outlier_logit=outlier_logit,
              complexity_threshold=complexity_threshold)
    if mesh is not None:
        from hgmm_torch.parallel import sharded_register_tree

        return sharded_register_tree(scan, map_tree, mesh, **kw)
    return register_tree(scan, map_tree, **kw)


def sample_mixture(params, n: int, seed: int = 0) -> np.ndarray:
    """Draw n points from a MixtureParams (host-side numpy): components by
    weight, then their Gaussians via Cholesky. Synthesizes a map's evidence
    when the original frames are gone (update_map)."""
    pi = to_numpy(params.pi).astype(np.float64)
    mu = to_numpy(params.mu)
    sigma = to_numpy(params.sigma)
    live = pi > 0
    pi, mu, sigma = pi[live], mu[live], sigma[live]
    pi = pi / pi.sum()
    rng = np.random.default_rng(seed)
    comp = rng.choice(pi.size, size=n, p=pi)
    z = rng.standard_normal((n, 3)).astype(np.float32)
    return _chol_samples(mu[comp], sigma[comp], z).astype(np.float32)


def update_map(
    map_tree: GmmTree,
    frames,
    poses,
    config: MapConfig | None = None,
    mesh=None,
    carry_points: int | None = None,
    old_new_ratio: float = 1.0,
) -> GmmTree:
    """Extend an existing map with newly registered frames, without the
    frames the map was built from (multi-session mapping).

    The old map's evidence is carried by `carry_points` samples from its leaf
    mixture, weighted so that it carries `old_new_ratio` times the new
    points' total mass. The refit warm-starts level 0 from the old map's
    level 0 (GmmTree.fit(init0=...)), on the map's device; with a mesh the
    refit runs points-sharded (parallel.sharded_tree_fit)."""
    cfg = config or MapConfig()
    with span("hgmm_torch.map"):
        with span("hgmm_torch.map.fuse"):
            fused_new = fuse_frames(frames, poses, voxel=cfg.voxel)
            n_new = fused_new.shape[0]
            if carry_points is None:
                carry_points = min(n_new, cfg.bucket // 2)
            old_pts = sample_mixture(map_tree.leaf_mixture(), carry_points, seed=cfg.seed + 1)
            pts = np.concatenate([fused_new, old_pts])
            # Old evidence mass = old_new_ratio x new mass, whatever the sample counts.
            w = np.concatenate([
                np.ones(n_new, np.float32),
                np.full(carry_points, old_new_ratio * n_new / max(carry_points, 1), np.float32),
            ])
            init0 = map_tree.levels[0]
            _count_bucket(pts.shape[0], cfg.bucket)
            pts_t, w_t = _to_bucket(pts, cfg.bucket, np.random.default_rng(cfg.seed), weights=w,
                                    device=init0.mu.device)
        if int(init0.pi.shape[0]) != cfg.branch:
            raise ValueError(
                f"map branch {init0.pi.shape[0]} != MapConfig.branch {cfg.branch}: the warm "
                f"start must match the tree layout"
            )
        with span("hgmm_torch.map.fit"):
            if mesh is not None:
                from hgmm_torch.parallel import sharded_tree_fit

                return sharded_tree_fit(pts_t, mesh, branch=cfg.branch, levels=cfg.levels,
                                        em_iters=cfg.em_iters, point_weights=w_t, init0=init0)
            tree, _ = GmmTree.fit(pts_t, branch=cfg.branch, levels=cfg.levels, em_iters=cfg.em_iters,
                                  point_weights=w_t, init0=init0)
            return tree
