"""Checkpoints of fitted mixtures, trees and odometry state as plain npz.

Counterpart of ``hgmm/utils/checkpoint.py`` with the same npz keys, so a
file saved by either package loads in the other. Arrays are saved from the
host as numpy and load as float32 tensors on `device`: None is the card,
and an error without one; "cpu" loads for the plain path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from hgmm_torch import convert
from hgmm_torch.models.gmm_tree import GmmTree
from hgmm_torch.ops.gaussians import MixtureParams
from hgmm_torch.utils.device import resolve_device


def save_odometry(path: str | Path, frame_idx: int, rel_poses, abs_poses, logliks=None) -> None:
    np.savez(
        str(path),
        frame_idx=frame_idx,
        rel_R=np.stack([convert.to_numpy(p.R) for p in rel_poses]) if rel_poses else np.zeros((0, 3, 3)),
        rel_t=np.stack([convert.to_numpy(p.t) for p in rel_poses]) if rel_poses else np.zeros((0, 3)),
        abs_R=np.stack([convert.to_numpy(p.R) for p in abs_poses]),
        abs_t=np.stack([convert.to_numpy(p.t) for p in abs_poses]),
        # Per-pair final logliks: loop-closure acceptance compares candidate
        # quality against the chain median, so resumed runs must carry them.
        logliks=np.asarray([float(x) for x in logliks] if logliks is not None else [],
                           dtype=np.float64),
    )


def load_odometry(path: str | Path, device=None):
    """Returns (frame_idx, rel_poses, abs_poses, logliks) or None."""
    device = resolve_device(device)
    path = Path(path)
    if not path.exists():
        return None
    z = np.load(str(path))
    rel = [convert.pose_from_numpy(R, t, device) for R, t in zip(z["rel_R"], z["rel_t"])]
    ab = [convert.pose_from_numpy(R, t, device) for R, t in zip(z["abs_R"], z["abs_t"])]
    lls = list(z["logliks"]) if "logliks" in z.files else []
    if len(lls) < len(rel):  # older checkpoints: pad honestly with NaN
        lls = lls + [float("nan")] * (len(rel) - len(lls))
    return int(z["frame_idx"]), rel, ab, lls


def save_mixture(path: str | Path, params: MixtureParams) -> None:
    np.savez(str(path), pi=convert.to_numpy(params.pi), mu=convert.to_numpy(params.mu), sigma=convert.to_numpy(params.sigma))


def load_mixture(path: str | Path, device=None) -> MixtureParams:
    z = np.load(str(path))
    return convert.mixture_from_numpy(z["pi"], z["mu"], z["sigma"], device)


def save_tree(path: str | Path, tree: GmmTree) -> None:
    arrays = {"branch": np.asarray(tree.branch), "levels": np.asarray(len(tree.levels))}
    for i, lvl in enumerate(tree.levels):
        arrays[f"pi_{i}"] = convert.to_numpy(lvl.pi)
        arrays[f"mu_{i}"] = convert.to_numpy(lvl.mu)
        arrays[f"sigma_{i}"] = convert.to_numpy(lvl.sigma)
    np.savez(str(path), **arrays)


def load_tree(path: str | Path, device=None) -> GmmTree:
    z = np.load(str(path))
    levels = [(z[f"pi_{i}"], z[f"mu_{i}"], z[f"sigma_{i}"]) for i in range(int(z["levels"]))]
    return convert.tree_from_numpy(levels, int(z["branch"]), device)
