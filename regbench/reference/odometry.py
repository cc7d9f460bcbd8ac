"""Plain frame-to-frame odometry over a scan sequence: the benchmark's
reference.

Each scan is voxel-downsampled (one point per occupied voxel, the centroid of
its points, voxels in the order of their packed integer keys) when a voxel
size is given, then subsampled without replacement to the point bucket by
one numpy generator of the run's seed, or padded with zero-weight points at
the origin. Pair i fits a tree to scan i, its start drawn from a CPU torch
generator of (seed, i), and registers scan i + 1 onto it from the pose of
pair i - 1 (the identity for pair 0). The relative pose of pair i maps scan
i + 1 into the frame of scan i.
"""

from __future__ import annotations

import numpy as np
import torch

from regbench.reference.mixture import fit_tree
from regbench.reference.register import register_tree


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    keys = np.floor(points / voxel).astype(np.int64)
    h = (keys[:, 0] & 0xFFFFF) | ((keys[:, 1] & 0xFFFFF) << 20) | ((keys[:, 2] & 0xFFFFF) << 40)
    uniq, inv = np.unique(h, return_inverse=True)
    sums = np.zeros((uniq.size, 3), np.float64)
    np.add.at(sums, inv, points)
    counts = np.bincount(inv, minlength=uniq.size)[:, None]
    return (sums / counts).astype(points.dtype)


def frames(scans, voxel: float | None, bucket: int, seed: int):
    """[(points [bucket, 3] float32, weights [bucket] float32)] a scan."""
    rng = np.random.default_rng(seed)
    out = []
    for s in scans:
        s = np.asarray(s)
        if voxel:
            s = voxel_downsample(s, voxel)
        n = s.shape[0]
        if n >= bucket:
            out.append((s[rng.choice(n, size=bucket, replace=False)].astype(np.float32),
                        np.ones(bucket, np.float32)))
        else:
            out.append((np.concatenate([s.astype(np.float32), np.zeros((bucket - n, 3), np.float32)]),
                        np.concatenate([np.ones(n, np.float32), np.zeros(bucket - n, np.float32)])))
    return out


def frame_generator(seed: int, frame: int) -> torch.Generator:
    state = np.random.SeedSequence((seed, frame)).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def chain(scans, model: dict, voxel: float | None, bucket: int, seed: int, n_pairs: int,
          dtype=torch.float64, device="cpu"):
    """The relative poses [(R, t) numpy] of the first n_pairs pairs."""
    fr = frames(scans, voxel, bucket, seed)
    rel, prev = [], None
    for i in range(n_pairs):
        (tp, tw), (sp, sw) = fr[i], fr[i + 1]
        levels = fit_tree(torch.from_numpy(tp), torch.from_numpy(tw), model["branch"],
                          model["levels"], model["fit_iters"], frame_generator(seed, i), dtype, device)
        prev = register_tree(torch.from_numpy(sp), torch.from_numpy(sw), levels, model["branch"],
                             model["reg_iters"], model["method"], model["outlier_logit"],
                             model["complexity_threshold"], init=prev, tol=model["tol"])
        rel.append(prev)
    return rel
