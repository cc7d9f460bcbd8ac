"""The benchmark's plain reference against the port's CPU path (its plain
PyTorch versions of every kernel), at small sizes, on both configurations'
input generators: the tree fit level by level, the registration onto one
tree, the odometry chain, and the pieces they share (the start's draws, the
voxel downsample, the frames' generators)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from regbench.harness import common, data
from regbench.reference import mixture, odometry, register

SEED = 2147483801


def _pool(n=4000, pool=2):
    return data.pair_pool(SEED, n, pool, 0.2, 0.06, 0.002)


def _levels(tree):
    return [tuple(a.detach().numpy() for a in lv) for lv in tree.levels]


def _np(levels):
    return [tuple(a.numpy() for a in lv) for lv in levels]


def test_start_draws_match_the_port():
    from hgmm_torch.models.gmm import init_params

    p = _pool()[0]
    pts = torch.from_numpy(p.target)
    prog = init_params(pts, 8, torch.Generator().manual_seed(p.fit_seed))
    ref = mixture.init_mixture(pts, None, 8, torch.Generator().manual_seed(p.fit_seed),
                               torch.float64, "cpu")
    np.testing.assert_array_equal(prog.mu.numpy(), ref.mu.numpy().astype(np.float32))
    np.testing.assert_allclose(prog.sigma.numpy(), ref.sigma.numpy(), rtol=1e-6)
    w = torch.ones(pts.shape[0])
    w[::3] = 0.0
    prog = init_params(pts, 8, torch.Generator().manual_seed(5), point_weights=w)
    ref = mixture.init_mixture(pts, w, 8, torch.Generator().manual_seed(5), torch.float64, "cpu")
    np.testing.assert_array_equal(prog.mu.numpy(), ref.mu.numpy().astype(np.float32))


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_tree_fit_matches_the_port(levels):
    from hgmm_torch import GmmTree

    p = _pool(20000 if levels == 3 else 4000)[0]
    gen = lambda: torch.Generator().manual_seed(p.fit_seed)  # noqa: E731
    tree, _ = GmmTree.fit(torch.from_numpy(p.target), branch=8, levels=levels, em_iters=12,
                          generator=gen())
    ref = mixture.fit_tree(torch.from_numpy(p.target), None, 8, levels, 12, gen())
    gaps = [common.mixture_gap(a, b) for a, b in zip(_levels(tree), _np(ref))]
    assert len(gaps) == levels
    assert max(gaps) < 2e-3, gaps


def test_weighted_tree_fit_matches_the_port():
    from hgmm_torch import GmmTree

    rng = np.random.default_rng(3)
    scans = data.lidar_loop(rng, 40000, 30, 16, 1, 3000, 1.0, 40.0, 1.6, 0.01)
    (pts, w), = odometry.frames(scans, None, 4096, 3)
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    tree, _ = GmmTree.fit(torch.from_numpy(pts), branch=8, levels=2, em_iters=10, generator=gen(),
                          point_weights=torch.from_numpy(w))
    ref = mixture.fit_tree(torch.from_numpy(pts), torch.from_numpy(w), 8, 2, 10, gen())
    gaps = [common.mixture_gap(a, b) for a, b in zip(_levels(tree), _np(ref))]
    assert max(gaps) < 2e-3, gaps


@pytest.mark.parametrize("threshold", [0.0, 0.02])
def test_registration_onto_one_tree_matches_the_port(threshold):
    from hgmm_torch import GmmTree, register_pair

    p = _pool(6000)[1]
    tree, _ = GmmTree.fit(torch.from_numpy(p.target), branch=8, levels=3, em_iters=12,
                          generator=torch.Generator().manual_seed(p.fit_seed))
    res = register_pair(torch.from_numpy(p.source), model=tree, complexity_threshold=threshold,
                        n_iters=50, method="horn+wls")
    # The reference registers onto the port's own tree here, to hold the
    # registration alone.
    levels = [mixture.Mixture(*(a.double() for a in lv)) for lv in tree.levels]
    R, t = register.register_tree(torch.from_numpy(p.source), None, levels, 8, 50, "horn+wls", None,
                                  threshold)
    assert common.rotation_gap(res.pose.R.numpy(), R) < 1e-5
    assert common.translation_gap(res.pose.t.numpy(), t) < 1e-5
    # ... and both land on the pose the pair was made with.
    assert common.rotation_gap(R, p.R) < 5e-3
    assert common.translation_gap(t, p.t) < 5e-3


def test_cut_drops_simple_parents_like_the_port():
    from hgmm_torch import GmmTree

    p = _pool(6000)[0]
    tree, _ = GmmTree.fit(torch.from_numpy(p.target), branch=8, levels=3, em_iters=12,
                          generator=torch.Generator().manual_seed(p.fit_seed))
    levels = [mixture.Mixture(*(a.double() for a in lv)) for lv in tree.levels]
    for thr in (0.0, 0.02, 0.2):
        prog = tree.cut_mixture(thr)
        ref = mixture.cut(levels, 8, thr)
        live, ref_pi = prog.pi.numpy() > 0, ref.pi.numpy()
        assert int(live.sum()) == int((ref_pi > 0).sum())
        np.testing.assert_allclose(np.sort(prog.pi.numpy()[live]), np.sort(ref_pi[ref_pi > 0]), rtol=1e-5)


def test_voxel_downsample_matches_the_port():
    from hgmm_torch.data import kitti

    scan = data.lidar_loop(np.random.default_rng(5), 40000, 30, 16, 1, 8000, 1.0, 40.0, 1.6, 0.01)[0]
    np.testing.assert_array_equal(odometry.voxel_downsample(scan, 0.3), kitti.voxel_downsample(scan, 0.3))


def test_frames_and_their_generators_match_the_port():
    from hgmm_torch.pipelines.odometry import _bucketize, frame_generator

    scans = data.lidar_loop(np.random.default_rng(6), 40000, 30, 16, 2, 3000, 1.0, 40.0, 1.6, 0.01)
    rng = np.random.default_rng(SEED)
    for (p, w), s in zip(odometry.frames(scans, None, 2048, SEED), scans):
        q, v = _bucketize(s, 2048, rng)
        np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(w, v)
    for frame in (0, 7):
        a = torch.randperm(100, generator=frame_generator(SEED, frame))
        b = torch.randperm(100, generator=odometry.frame_generator(SEED, frame))
        assert torch.equal(a, b)


def test_odometry_chain_matches_the_port():
    from hgmm_torch import OdometryConfig, run_odometry

    model = dict(branch=8, levels=3, fit_iters=10, reg_iters=30, method="wls", outlier_logit=-8.0,
                 complexity_threshold=0.0, tol=1e-7)
    scans = data.lidar_loop(np.random.default_rng(data.seeds(SEED, 3)), 40000, 30, 16, 3, 6000, 1.0,
                            40.0, 1.6, 0.01)
    res = run_odometry(scans, OdometryConfig(voxel=0.3, bucket=1024, seed=SEED, device="cpu"))
    ref = odometry.chain(scans, model, 0.3, 1024, SEED, 2)
    for pose, (R, t) in zip(res.rel_poses, ref):
        assert common.rotation_gap(pose.R.numpy(), R) < 1e-4
        assert common.translation_gap(pose.t.numpy(), t) < 1e-3
