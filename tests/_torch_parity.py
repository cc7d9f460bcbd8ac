"""Shared inputs of the port's odometry, loop-closure and mapping parity
tests: one deterministic numpy init for both packages, and the sequences of
tests/test_odometry.py and tests/test_loop_closure.py rebuilt with numpy.

The JAX package draws a fit's initial means with jax.random and the port with
a torch.Generator, so whole-run parity patches both packages' init_params
(in models.gmm, models.gmm_tree and parallel.sharded) with init_np: a seeded
numpy choice among the positive-weight points and the JAX package's
bounding-box covariance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgmm.models import gmm as jgmm
from hgmm.models import gmm_tree as jtree
from hgmm.ops import gaussians as jg
from hgmm.parallel import sharded as jsharded
from hgmm_torch.data.synthetic import make_cloud_np
from hgmm_torch.models import gmm as tgmm
from hgmm_torch.models import gmm_tree as ttree
from hgmm_torch.models.se3 import Pose, so3_exp
from hgmm_torch.ops import gaussians as tg
from hgmm_torch.parallel import sharded as tsharded


def _host(x):
    if x is None:
        return None
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def init_np(points, k, point_weights=None):
    """(pi, mu, sigma) numpy: k means drawn without replacement among the
    positive-weight points (numpy seed 0), isotropic covariance from their
    bounding box (hgmm/models/gmm.py:init_params)."""
    pts = _host(points).astype(np.float32)
    w = _host(point_weights)
    live = np.arange(pts.shape[0]) if w is None else np.flatnonzero(w > 0)
    idx = np.random.default_rng(0).choice(live, size=k, replace=False)
    span = pts[live].max(0) - pts[live].min(0)
    var = np.float32((max(float(span.max()), 1e-6) / max(k ** (1.0 / 3.0), 1.0)) ** 2)
    sigma = np.broadcast_to(var * np.eye(3, dtype=np.float32), (k, 3, 3)).copy()
    return np.full(k, 1.0 / k, np.float32), pts[idx].copy(), sigma


def _jax_init(points, k, key, point_weights=None):
    return jg.MixtureParams(*map(jnp.asarray, init_np(points, k, point_weights)))


def _torch_init(points, k, generator=None, point_weights=None):
    return tg.MixtureParams(*(torch.from_numpy(a).to(points.device)
                              for a in init_np(points, k, point_weights)))


@pytest.fixture(scope="module")
def same_init():
    """Patch both packages' init_params with init_np for the module."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jgmm, jtree, jsharded):
            mp.setattr(mod, "init_params", _jax_init)
        for mod in (tgmm, ttree, tsharded):
            mp.setattr(mod, "init_params", _torch_init)
        yield


def _yaw_pose(angle, t):
    return Pose(so3_exp(torch.tensor([0.0, 0.0, angle], dtype=torch.float32)),
                torch.tensor(t, dtype=torch.float32))


def odometry_sequence(n_frames=5, n_scene=4000, step_angle=0.06, step_t=0.05):
    """tests/test_odometry.py:15-31 with numpy draws: a trefoil scene seen from
    a slowly moving sensor, frame k = the scene in frame k + 0.002 noise."""
    scene = make_cloud_np(n_scene, "trefoil", seed=0)
    gt = [Pose.identity(device="cpu")]
    for _ in range(1, n_frames):
        gt.append(gt[-1].compose(_yaw_pose(step_angle, [step_t, 0.0, 0.01])))
    frames = []
    for k in range(n_frames):
        pts = gt[k].inverse().apply(torch.from_numpy(scene)).numpy()
        noise = np.random.default_rng(100 + k).standard_normal(pts.shape).astype(np.float32)
        frames.append((pts + 0.002 * noise).astype(np.float32))
    return frames, gt


def loop_sequence(n_frames=12, n_scene=4000, noise=0.004, fov=1.6, seed=0):
    """tests/test_loop_closure.py:21-49 with numpy draws: a closed loop
    through a trefoil scene with a swaying heading, each frame seeing a
    +-fov bearing sector (the drift source) plus noise."""
    scene = make_cloud_np(n_scene, "trefoil", seed=seed)
    step_len = 0.09
    radius = step_len * n_frames / (2 * np.pi)
    gt = []
    for k in range(n_frames):
        th = 2 * np.pi * k / n_frames
        gt.append(_yaw_pose(0.3 * np.sin(th), [radius * np.cos(th) - radius,
                                               radius * np.sin(th), 0.0]))
    frames = []
    for k in range(n_frames):
        pts = gt[k].inverse().apply(torch.from_numpy(scene)).numpy()
        pts = pts[np.abs(np.arctan2(pts[:, 1], pts[:, 0])) < fov]
        pts = pts + noise * np.random.default_rng(1000 + k).standard_normal(pts.shape)
        frames.append(pts.astype(np.float32))
    return frames, gt


def to_jax_pose(p):
    from hgmm.models.se3 import Pose as JPose

    return JPose(jnp.asarray(_host(p.R)), jnp.asarray(_host(p.t)))


def to_torch_pose(p):
    return Pose(torch.from_numpy(np.array(p.R, np.float32)), torch.from_numpy(np.array(p.t, np.float32)))
