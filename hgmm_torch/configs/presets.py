"""Named benchmark/config presets — one per BASELINE.json config row.

A copy of ``hgmm/configs/presets.py``: that module is plain dataclasses, but
importing anything under ``hgmm`` imports ``jax`` (``hgmm/__init__.py``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RegistrationPreset:
    name: str
    description: str
    model_kind: str = "tree"  # "flat" | "tree"
    k: int = 64
    branch: int = 8
    levels: int = 3
    fit_iters: int = 20
    reg_iters: int = 50
    method: str = "horn+wls"
    cov_type: str = "full"
    top_k: int | None = None
    outlier_logit: float | None = None
    complexity_threshold: float = 0.0


# Config 1: single-pair rigid registration, flat 64-component GMM-EM
# (CPU-runnable reference) [BASELINE.json:7]
CONFIG1_FLAT64 = RegistrationPreset(
    name="config1_flat64",
    description="flat K=64 GMM-EM pairwise registration (bunny-class)",
    model_kind="flat",
    k=64,
    method="horn",
)

# Config 2: hierarchical GMM (3 levels, 8-way) [BASELINE.json:8]
CONFIG2_TREE = RegistrationPreset(
    name="config2_tree_8x3",
    description="hierarchical 8-way/3-level GMM-tree registration "
    "(dragon/happy-buddha-class)",
    model_kind="tree",
    branch=8,
    levels=3,
    fit_iters=12,
    # Adaptive mixed-resolution cut (arXiv 1807.02587): coarsen geometrically
    # simple parents. At 0.02 roughly the simplest quarter of an object-scale
    # scan's nodes coarsen; measured (registration_suite, trefoil 20k) the
    # K=512->~384 cut registers ~1.5-2x faster at sub-noise RMSE change.
    complexity_threshold=0.02,
)

# Config 3: anisotropic covariances + Mahalanobis solve, noisy/partial
# overlap [BASELINE.json:9]
CONFIG3_MAHALANOBIS = RegistrationPreset(
    name="config3_mahalanobis",
    description="anisotropic full-covariance + Mahalanobis WLS pose solve, "
    "uniform-outlier gating for noise/partial overlap",
    model_kind="tree",
    branch=8,
    levels=3,
    method="horn+wls",
    outlier_logit=0.0,
    top_k=8,
)

# Config 4: KITTI frame-to-frame odometry [BASELINE.json:10] — see
# hgmm.pipelines.odometry.OdometryConfig for runtime knobs.
CONFIG4_KITTI = RegistrationPreset(
    name="config4_kitti_odometry",
    description="KITTI velodyne scan-pair odometry via hierarchical-GMM "
    "registration; voxel 0.3 m, bucket 16384 pts",
    model_kind="tree",
    branch=8,
    levels=3,
    fit_iters=10,
    reg_iters=30,
    # Damped Mahalanobis WLS: the exact anisotropic M-step. The isotropic
    # Horn surrogate is structurally biased on plane-dominated LiDAR
    # mixtures and diverges (measured on the kitti_mini fixture: loglik
    # strictly decreases under horn steps, while WLS converges from
    # identity in <10 iters).
    method="wls",
    # Uniform-outlier log-density ~ log(p_out / scene volume): metric
    # scenes need ~ -8 (0.0 drowned every Gaussian at LiDAR scale).
    outlier_logit=-8.0,
    # LiDAR scenes are plane-dominated: the node-complexity median on the
    # kitti_mini fixture is ~4e-4, so 0.005 coarsens most planar patches.
    # Measured on the fixture: 2-3x faster odometry at mm-level ATE change
    # (0.0018 -> ~0.003 m over 4 frames).
    complexity_threshold=0.005,
)

# Config 5: multi-host distributed [BASELINE.json:11] — same presets, run
# through hgmm.parallel.sharded_* over a Mesh.
CONFIG5_DISTRIBUTED = RegistrationPreset(
    name="config5_distributed",
    description="10M+ points sharded across hosts; psum EM + sharded "
    "Schur pose-graph refinement",
    model_kind="tree",
    branch=8,
    levels=3,
)

PRESETS = {
    p.name: p
    for p in (
        CONFIG1_FLAT64,
        CONFIG2_TREE,
        CONFIG3_MAHALANOBIS,
        CONFIG4_KITTI,
        CONFIG5_DISTRIBUTED,
    )
}
