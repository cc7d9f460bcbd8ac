"""KITTI odometry dataset loaders (BASELINE.json config 4).

Counterpart of ``hgmm/data/kitti.py``. Velodyne scans are flat
little-endian float32 [N, 4] (x, y, z, reflectance) ``.bin`` files; poses
are 3x4 row-major matrices per line (cam0 frame); calib.txt carries the Tr
velo->cam0 extrinsic. Scans and voxelization go through the native C++
reader (``hgmm_torch.data.native``) when its library has been built, else
through numpy, with the same results.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from hgmm_torch.convert import pose_from_numpy
from hgmm_torch.data import native
from hgmm_torch.models.se3 import Pose
from hgmm_torch.utils.device import resolve_device


def load_velodyne_bin(path: str | Path, dtype=np.float32) -> np.ndarray:
    """Read a KITTI velodyne scan -> [N, 3] xyz (reflectance dropped)."""
    if native.available():
        out = native.load_kitti_bin(str(path))
        if out is not None:
            return out.astype(dtype, copy=False)
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


def load_poses(path: str | Path, device=None) -> list[Pose]:
    """KITTI ground-truth poses file: each line 12 floats (3x4 row-major),
    as poses on `device` (None: the card, and an error without one)."""
    device = resolve_device(device)
    return [pose_from_numpy(m[:, :3], m[:, 3], device) for m in np.loadtxt(str(path)).reshape(-1, 3, 4)]


def load_calib_velo_to_cam(path: str | Path, device=None) -> Pose:
    """Parse Tr (velo->cam0) from a KITTI odometry calib.txt, as a pose on
    `device` (None: the card, and an error without one)."""
    device = resolve_device(device)
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                m = np.array(line.split(":", 1)[1].split(), np.float64).reshape(3, 4)
                return pose_from_numpy(m[:, :3], m[:, 3], device)
    raise ValueError(f"no Tr entry in {path}")


def sequence_scan_paths(seq_dir: str | Path) -> list[Path]:
    """Sorted velodyne .bin paths of a KITTI odometry sequence directory."""
    return sorted((Path(seq_dir) / "velodyne").glob("*.bin"))


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Host-side voxel-grid downsample: one point per occupied voxel, the
    centroid of its points, in the order of the voxels' hash keys. Runs the
    native single-pass hash table when its library is built (~7x faster at
    10M points on the reference's host); the numpy path below is
    bit-compatible on float32 points."""
    if native.available():
        out = native.voxel_downsample(points, voxel)
        if out is not None:
            return out.astype(points.dtype, copy=False)
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
