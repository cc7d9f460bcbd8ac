"""The benchmark's inputs, made with numpy from the run's seed, in memory.

Frozen copies of the generators the smoke run and the registration suite use
(``chip_smoke.py``: ``lidar_world``, ``write_lidar_sequence``;
``hgmm_torch.data.synthetic.make_cloud_np``; ``registration_suite.make_problem``),
so that later changes to the program cannot move the yardstick:

- ``trefoil``: a tube of radius 0.06 around a trefoil knot scaled by 0.3, the
  stand-in for an object scan;
- ``pair_pool``: object-scan pairs, each a trefoil, a random pose (a uniform
  axis, an angle of at most ``max_angle``, a translation of at most
  ``max_trans`` a coordinate) and the source, the trefoil moved by the pose's
  inverse plus Gaussian noise, with the seed of its fit's start;
- ``lidar_world`` and ``lidar_loop``: a ~60 m x 60 m scene (ground, two
  facades, boxes and pillars) and the scans of a sensor driving one closed
  loop around it, as KITTI's HDL-64E sees it: within ``range`` metres and a
  sector of +-``fov`` rad about the heading, ``scan_points`` points a scan,
  plus noise; float32 [N, 3] as a KITTI ``.bin`` file holds them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def seeds(seed: int, *path: int) -> np.random.SeedSequence:
    """The seed sequence of one input of the run (any whole seed >= 0)."""
    return np.random.SeedSequence([int(seed), *path])


def trefoil(rng: np.random.Generator, n: int) -> np.ndarray:
    t = rng.uniform(0.0, 2.0 * np.pi, n)
    center = 0.3 * np.stack([np.sin(t) + 2.0 * np.sin(2.0 * t), np.cos(t) - 2.0 * np.cos(2.0 * t),
                             -np.sin(3.0 * t)], axis=-1)
    return (center + 0.06 * rng.standard_normal((n, 3))).astype(np.float32)


def random_pose(rng: np.random.Generator, max_angle: float, max_trans: float):
    """(R [3, 3], t [3]) float64: a uniform axis, an angle uniform in
    [-max_angle, max_angle], a translation uniform in [-max_trans, max_trans]^3."""
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis) + 1e-12
    w = axis * rng.uniform(-max_angle, max_angle)
    theta = np.linalg.norm(w)
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    a = np.sin(theta) / theta if theta > 1e-8 else 1.0
    b = (1.0 - np.cos(theta)) / theta ** 2 if theta > 1e-8 else 0.5
    return np.eye(3) + a * K + b * (K @ K), rng.uniform(-max_trans, max_trans, 3)


class Pair(NamedTuple):
    target: np.ndarray  # [N, 3] float32
    source: np.ndarray  # [N, 3] float32: R^T (target - t) + noise
    R: np.ndarray  # the true pose, float64: R source + t ~ target
    t: np.ndarray
    fit_seed: int  # seeds the CPU torch generator of the target's fit


def pair_pool(seed: int, n: int, pool: int, max_angle: float, max_trans: float,
              noise: float) -> list[Pair]:
    out = []
    for j in range(pool):
        rng = np.random.default_rng(seeds(seed, 1, j))
        target = trefoil(rng, n)
        R, t = random_pose(rng, max_angle, max_trans)
        source = (target.astype(np.float64) - t) @ R + noise * rng.standard_normal((n, 3))
        out.append(Pair(target, source.astype(np.float32), R, t,
                        int(seeds(seed, 2, j).generate_state(1, np.uint64)[0] >> np.uint64(1))))
    return out


def lidar_world(rng: np.random.Generator, n: int, n_box: int = 30, n_pillar: int = 16) -> np.ndarray:
    """[~n, 3] float64: ground at -1.7 m, facades at y = 25 and x = -25,
    n_box boxes with two faces each and n_pillar pillars."""
    def u(lo, hi, m):
        return rng.uniform(lo, hi, m)

    m = n // 3
    chunks = [np.stack([u(-30, 30, m), u(-30, 30, m), rng.normal(0, 0.02, m) - 1.7], 1)]
    m = n // 8
    chunks.append(np.stack([u(-30, 30, m), 25.0 + rng.normal(0, 0.02, m), u(-1.7, 6.0, m)], 1))
    chunks.append(np.stack([-25.0 + rng.normal(0, 0.02, m), u(-30, 30, m), u(-1.7, 6.0, m)], 1))
    per = (n - sum(len(c) for c in chunks)) // (2 * n_box + n_pillar)
    centers = rng.uniform(-22, 22, (n_box + n_pillar, 2))
    for cx, cy in centers[:n_box]:
        hx, hy, h = u(1.0, 2.5, 1)[0], u(1.0, 2.5, 1)[0], u(1.0, 3.5, 1)[0]
        sx, sy = rng.choice([-1.0, 1.0], 2)
        chunks.append(np.stack([np.full(per, cx + sx * hx), cy + u(-hy, hy, per),
                                u(-1.7, -1.7 + h, per)], 1))
        chunks.append(np.stack([cx + u(-hx, hx, per), np.full(per, cy + sy * hy),
                                u(-1.7, -1.7 + h, per)], 1))
    for cx, cy in centers[n_box:]:
        a = u(0, 2 * np.pi, per)
        chunks.append(np.stack([cx + 0.3 * np.cos(a), cy + 0.3 * np.sin(a), u(-1.7, 4.0, per)], 1))
    return np.concatenate(chunks)


def lidar_loop(rng: np.random.Generator, world_points: int, n_box: int, n_pillar: int,
               frames: int, scan_points: int, step: float, range_m: float, fov: float,
               noise: float) -> list[np.ndarray]:
    """The scans [N, 3] float32 of one closed loop of `frames` steps of
    `step` metres around the middle of the world, the sensor heading along
    the loop. Each scan's reflectance is drawn and dropped, as reading a KITTI
    .bin drops it, so the draws follow the smoke run's sequence writer."""
    world = lidar_world(rng, world_points, n_box, n_pillar)
    radius = frames * step / (2 * np.pi)
    scans = []
    for k in range(frames):
        th = 2 * np.pi * k / frames
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
    return scans
