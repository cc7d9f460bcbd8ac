"""The scans of a route driven twice, for the SLAM cell: two laps of a
spiral around the middle of ``data.lidar_world``'s scene, the radius growing
linearly with the frame index by ``lap_growth`` metres a lap, as a car keeps
another lane on its second pass. Frame k and frame k + frames_a_lap see the
same place from ``lap_growth`` metres apart, so the second lap revisits the
first and loop closure has work. Each scan is drawn as ``data.lidar_loop``
draws it (a KITTI HDL-64E's range and sector, a sample of ``scan_points``,
noise, a reflectance drawn and dropped), and the true poses are kept."""

from __future__ import annotations

import numpy as np

from regbench.harness.data import lidar_world


def two_laps(rng: np.random.Generator, world_points: int, n_box: int, n_pillar: int, frames: int,
             laps: int, scan_points: int, step: float, range_m: float, fov: float, noise: float,
             lap_growth: float):
    """(scans [frames] of [N, 3] float32, true poses [(R [3, 3], t [3])]
    float64, sensor to world). A lap is frames // laps frames of `step`
    metres at its first radius."""
    world = lidar_world(rng, world_points, n_box, n_pillar)
    per_lap = frames // laps
    radius0 = per_lap * step / (2 * np.pi)
    scans, poses = [], []
    for k in range(frames):
        th = 2 * np.pi * k / per_lap
        radius = radius0 + lap_growth * k / per_lap
        c, s = np.cos(th + np.pi / 2), np.sin(th + np.pi / 2)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        t = np.array([radius * np.cos(th), radius * np.sin(th), 0.0])
        local = (world - t) @ R
        keep = ((np.linalg.norm(local[:, :2], axis=1) < range_m)
                & (np.abs(np.arctan2(local[:, 1], local[:, 0])) < fov))
        local = local[keep]
        if local.shape[0] > scan_points:
            local = local[rng.choice(local.shape[0], scan_points, replace=False)]
        local = local + rng.normal(0.0, noise, local.shape)
        rng.uniform(0.0, 1.0, (local.shape[0], 1))
        scans.append(local.astype("<f4"))
        poses.append((R, t))
    return scans, poses


def ate(poses, truth) -> float:
    """The absolute trajectory error (m): the root mean square distance
    between the estimated positions and the true ones, both taken relative to
    frame 0."""
    R0, t0 = truth[0]
    est = np.stack([np.asarray(t, np.float64) for _, t in poses])
    true = np.stack([R0.T @ (t - t0) for _, t in truth])
    return float(np.sqrt(np.mean(np.sum((est - true) ** 2, axis=1))))
