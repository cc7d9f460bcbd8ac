"""Exports: an alignment or a map as a colored PLY any viewer opens, and
matplotlib plots of an alignment or a trajectory (skipped where matplotlib is
absent).

Counterpart of ``hgmm/viz/export.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from hgmm_torch.convert import to_numpy


def export_alignment(path, source, target, pose, snapshot: bool = False) -> None:
    """Write a colored PLY: target gray, transformed source red."""
    source = to_numpy(source)
    target = to_numpy(target)
    aligned = source @ to_numpy(pose.R).T + to_numpy(pose.t)
    pts = np.concatenate([target, aligned]).astype(np.float32)
    col = np.concatenate(
        [
            np.tile(np.array([[180, 180, 180]], np.uint8), (len(target), 1)),
            np.tile(np.array([[220, 40, 40]], np.uint8), (len(aligned), 1)),
        ]
    )
    _save_colored_ply(path, pts, col)
    if snapshot:
        save_snapshot(str(Path(path).with_suffix(".png")), target, aligned)


def _save_colored_ply(path, points: np.ndarray, colors: np.ndarray) -> None:
    n = points.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(
        n,
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("r", "u1"), ("g", "u1"), ("b", "u1")],
    )
    rec["x"], rec["y"], rec["z"] = points.T
    rec["r"], rec["g"], rec["b"] = colors.T
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def save_snapshot(path, target, aligned) -> None:
    """Matplotlib 3D scatter snapshot; does nothing where matplotlib is not
    installed."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(*to_numpy(target).T, s=1, c="gray", alpha=0.5, label="target")
    ax.scatter(*to_numpy(aligned).T, s=1, c="red", alpha=0.5, label="aligned")
    ax.legend()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def export_trajectory(path, est_poses, gt_poses=None, refined_poses=None, closures=None) -> None:
    """Top-down trajectory plot: the dead-reckoned chain, optional ground
    truth and refined overlays, and detected loop closures drawn as chords.
    Does nothing where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return

    def _xy(poses):
        return np.stack([to_numpy(p.t) for p in poses])[:, :2]

    fig, ax = plt.subplots(figsize=(7, 7))
    est = _xy(est_poses)
    ax.plot(est[:, 0], est[:, 1], "o-", ms=3, color="#c22", label="odometry")
    if refined_poses is not None:
        ref = _xy(refined_poses)
        ax.plot(ref[:, 0], ref[:, 1], "o-", ms=3, color="#16a", label="refined")
    if gt_poses is not None:
        gt = _xy(gt_poses)
        ax.plot(gt[:, 0], gt[:, 1], "--", color="gray", label="ground truth")
    if closures is not None:
        base = _xy(refined_poses if refined_poses is not None else est_poses)
        ii, jj = to_numpy(closures.i).tolist(), to_numpy(closures.j).tolist()
        for n, (a, b) in enumerate(zip(ii, jj)):
            ax.plot(base[[a, b], 0], base[[a, b], 1], ":", color="#3a3", lw=1.5,
                    label="loop closure" if n == 0 else None)
    ax.set_aspect("equal")
    ax.legend()
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def export_map(path, tree, samples_per_leaf: int = 24, seed: int = 0) -> None:
    """Write a global GMM-tree map (pipelines.mapping.build_map) as a colored
    PLY: leaf means in red, then `samples_per_leaf` points drawn from each
    live leaf in gray, brighter for heavier leaves."""
    from hgmm_torch.pipelines.mapping import _chol_samples

    leaves = tree.leaf_mixture()
    pi, mu, sigma = to_numpy(leaves.pi), to_numpy(leaves.mu), to_numpy(leaves.sigma)
    live = pi > 0
    mu_l, sig_l, pi_l = mu[live], sigma[live], pi[live]
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((mu_l.shape[0], samples_per_leaf, 3)).astype(np.float32)
    samples = _chol_samples(mu_l[:, None, :], sig_l[:, None, :, :], z).reshape(-1, 3)
    # Brightness encodes relative leaf weight (log-scaled).
    w = np.clip(np.log(pi_l / pi_l.max()) / np.log(1e-3), 0.0, 1.0)
    shades = np.repeat((200 - 140 * w).astype(np.uint8), samples_per_leaf)
    pts = np.concatenate([mu_l, samples]).astype(np.float32)
    col = np.concatenate([
        np.tile(np.array([[220, 40, 40]], np.uint8), (mu_l.shape[0], 1)),
        np.stack([shades, shades, shades], axis=1),
    ])
    _save_colored_ply(path, pts, col)
