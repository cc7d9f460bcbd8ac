"""Alignment export: a colored PLY pair any viewer opens, and an optional
matplotlib snapshot (skipped where matplotlib is absent).

Counterpart of ``hgmm/viz/export.py:12-66``; ``export_trajectory`` and
``export_map`` wait for the port's odometry and mapping.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def export_alignment(path, source, target, pose, snapshot: bool = False) -> None:
    """Write a colored PLY: target gray, transformed source red."""
    source = _np(source)
    target = _np(target)
    aligned = source @ _np(pose.R).T + _np(pose.t)
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
    ax.scatter(*_np(target).T, s=1, c="gray", alpha=0.5, label="target")
    ax.scatter(*_np(aligned).T, s=1, c="red", alpha=0.5, label="aligned")
    ax.legend()
    fig.savefig(path, dpi=120)
    plt.close(fig)
