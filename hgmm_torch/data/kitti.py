"""KITTI odometry dataset loaders (BASELINE.json config 4).

Counterpart of ``hgmm/data/kitti.py`` on its numpy paths (the JAX package's
native C++ reader is not ported yet). Velodyne scans are flat little-endian
float32 [N, 4] (x, y, z, reflectance) ``.bin`` files; poses are 3x4
row-major matrices per line (cam0 frame); calib.txt carries the Tr
velo->cam0 extrinsic.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from hgmm_torch.convert import pose_from_numpy
from hgmm_torch.models.se3 import Pose


def load_velodyne_bin(path: str | Path, dtype=np.float32) -> np.ndarray:
    """Read a KITTI velodyne scan -> [N, 3] xyz (reflectance dropped)."""
    raw = np.fromfile(str(path), dtype="<f4")
    if raw.size % 4 != 0:
        raise ValueError(f"{path}: size {raw.size} not divisible by 4")
    return raw.reshape(-1, 4)[:, :3].astype(dtype, copy=False)


def save_velodyne_bin(path: str | Path, points: np.ndarray) -> None:
    """Write [N, 3] or [N, 4] points in KITTI .bin layout (test fixtures)."""
    pts = np.asarray(points, dtype="<f4")
    if pts.shape[1] == 3:
        pts = np.concatenate([pts, np.zeros_like(pts[:, :1])], axis=1)
    pts.tofile(str(path))


def load_poses(path: str | Path) -> list[Pose]:
    """KITTI ground-truth poses file: each line 12 floats (3x4 row-major)."""
    return [pose_from_numpy(m[:, :3], m[:, 3]) for m in np.loadtxt(str(path)).reshape(-1, 3, 4)]


def load_calib_velo_to_cam(path: str | Path) -> Pose:
    """Parse Tr (velo->cam0) from a KITTI odometry calib.txt."""
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                m = np.array(line.split(":", 1)[1].split(), np.float64).reshape(3, 4)
                return pose_from_numpy(m[:, :3], m[:, 3])
    raise ValueError(f"no Tr entry in {path}")


def sequence_scan_paths(seq_dir: str | Path) -> list[Path]:
    """Sorted velodyne .bin paths of a KITTI odometry sequence directory."""
    return sorted((Path(seq_dir) / "velodyne").glob("*.bin"))


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Host-side voxel-grid downsample: one point per occupied voxel, the
    centroid of its points, in the order of the voxels' hash keys."""
    keys = np.floor(points / voxel).astype(np.int64)
    # Hash voxel coords into one int64 (no collisions within +-2^20 cells).
    h = (keys[:, 0] & 0xFFFFF) | ((keys[:, 1] & 0xFFFFF) << 20) | (
        (keys[:, 2] & 0xFFFFF) << 40
    )
    uniq, inv = np.unique(h, return_inverse=True)
    sums = np.zeros((uniq.size, 3), dtype=np.float64)
    np.add.at(sums, inv, points)
    counts = np.bincount(inv, minlength=uniq.size)[:, None]
    return (sums / counts).astype(points.dtype)
