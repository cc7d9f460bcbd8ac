"""hgmm_torch.pipelines.odometry against hgmm.pipelines.odometry on the CPU.

Both packages run from one numpy init (_torch_parity.same_init), on the
sequence of tests/test_odometry.py rebuilt with numpy. Their float32 sums run
in different orders, so the chains agree to ~1e-5 per pose, far inside the
1e-3 held here and the 0.02 ATE bound of tests/test_odometry.py:43.
"""

import numpy as np
import pytest
import torch

from _torch_parity import odometry_sequence, same_init, to_torch_pose  # noqa: F401
from hgmm.data import kitti as jkitti
from hgmm.pipelines import odometry as jodo
from hgmm_torch.data import kitti as tkitti
from hgmm_torch.eval.metrics import ate, pose_delta_norm
from hgmm_torch.pipelines import odometry as todo
from hgmm_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

FLAT = dict(model_kind="flat", k=16, fit_iters=8, reg_iters=15, bucket=1024)
TREE = dict(model_kind="tree", branch=8, levels=3, fit_iters=6, reg_iters=8, bucket=1024)
RUNS = {"flat": (FLAT, 4), "tree": (TREE, 3)}


@pytest.fixture(scope="module")
def runs(same_init):
    """Each config through both packages on the same frames."""
    out = {}
    for name, (kw, n_frames) in RUNS.items():
        frames, gt = odometry_sequence(n_frames=n_frames)
        ref = jodo.run_odometry(frames, jodo.OdometryConfig(**kw))
        got = todo.run_odometry(frames, todo.OdometryConfig(**kw, device="cpu"))
        out[name] = frames, gt, ref, got
    return out


def test_bucketize_is_bit_equal():
    frames, _ = odometry_sequence(n_frames=2)
    for bucket in (1024, 8000):  # subsample and pad
        a = todo._bucketize(frames[1], bucket, np.random.default_rng(3))
        b = jodo._bucketize(frames[1], bucket, np.random.default_rng(3))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", list(RUNS))
def test_run_odometry_matches_jax(runs, name):
    _, gt, ref, got = runs[name]
    assert len(got.abs_poses) == len(ref.abs_poses) == len(gt)
    for p, q in zip(got.abs_poses, ref.abs_poses):
        assert float(pose_delta_norm(p, to_torch_pose(q))) < 1e-3
    np.testing.assert_allclose(got.logliks, ref.logliks, rtol=1e-3)
    assert float(ate(got.abs_poses, gt)) < 0.02  # tests/test_odometry.py:43
    assert got.closures is None


def test_resumed_run_equals_full_run(same_init, tmp_path):
    frames, _ = odometry_sequence(n_frames=4)
    cfg = todo.OdometryConfig(**FLAT, device="cpu")
    ck = tmp_path / "odo.npz"
    full = todo.run_odometry(frames, cfg, checkpoint_path=ck, checkpoint_every=1)
    tckpt.save_odometry(ck, 2, full.rel_poses[:2], full.abs_poses[:3], full.logliks[:2])
    resumed = todo.run_odometry(frames, cfg, checkpoint_path=ck)
    assert len(resumed.abs_poses) == len(full.abs_poses)
    for p, q in zip(resumed.abs_poses, full.abs_poses):
        torch.testing.assert_close(p.R, q.R, rtol=0, atol=1e-6)
        torch.testing.assert_close(p.t, q.t, rtol=0, atol=1e-6)
    assert resumed.logliks == full.logliks


def test_two_runs_with_one_seed_are_identical():
    """The default init, drawn from the per-frame generator, not the patch."""
    frames, _ = odometry_sequence(n_frames=3)
    cfg = todo.OdometryConfig(**TREE, device="cpu")
    a, b = todo.run_odometry(frames, cfg), todo.run_odometry(frames, cfg)
    for p, q in zip(a.abs_poses, b.abs_poses):
        assert torch.equal(p.R, q.R) and torch.equal(p.t, q.t)
    g1, g2 = todo.frame_generator(0, 5), todo.frame_generator(0, 5)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    assert g1.device.type == "cpu"
    assert not torch.equal(torch.rand(4, generator=todo.frame_generator(0, 6)),
                           torch.rand(4, generator=todo.frame_generator(1, 5)))


def test_refine_odometry_on_the_jax_chain(runs):
    """The JAX chain carried across, refined by both packages."""
    _, _, ref, _ = runs["flat"]
    carried = todo.OdometryResult(abs_poses=[to_torch_pose(p) for p in ref.abs_poses],
                                  rel_poses=[to_torch_pose(p) for p in ref.rel_poses],
                                  logliks=list(ref.logliks))
    jr = jodo.refine_odometry(ref, n_iters=5)
    tr = todo.refine_odometry(carried, n_iters=5)
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-3)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-3)
    assert bool(torch.isfinite(tr.t).all()) and tr.R.shape == (4, 3, 3)


def test_refine_odometry_warns_past_512_nodes():
    from hgmm_torch.models.se3 import Pose

    rel = [Pose.identity()] * 512
    res = todo.OdometryResult(abs_poses=[Pose.identity()] * 513, rel_poses=rel, logliks=[])
    with pytest.warns(UserWarning, match="dense pose-graph solve on 513 nodes"):
        out = todo.refine_odometry(res, n_iters=0)
    assert out.R.shape == (513, 3, 3)


def test_voxel_downsample_matches_jax():
    """hgmm.data.kitti.voxel_downsample runs its native C++ path where the
    library is built; the port's numpy path gives the same points in the
    same order."""
    frames, _ = odometry_sequence(n_frames=2)
    lidar = np.random.default_rng(0).uniform(-40, 40, (50_000, 3)).astype(np.float32)
    for pts, voxel in ((frames[1], 0.05), (lidar, 0.3), (lidar, 2.0)):
        got, ref = tkitti.voxel_downsample(pts, voxel), jkitti.voxel_downsample(pts, voxel)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_config_fields_match_jax():
    jfields = {f.name: f.default for f in jodo.OdometryConfig.__dataclass_fields__.values()}
    tfields = {f.name: f.default for f in todo.OdometryConfig.__dataclass_fields__.values()}
    assert tfields.pop("device") is None  # the card; "cpu" is asked for
    assert tfields == jfields


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_direct_form_oracle(scale):
    """em_ref.*_direct (float64, (y - mu)^T Sigma^-1 (y - mu)), the oracle of
    the metric-scale kernel checks, equal the expanded feature form evaluated
    in float64, at unit and at LiDAR scale."""
    from hgmm_torch.data.synthetic import lidar_mixture_np, lidar_points_np
    from hgmm_torch.models.se3 import so3_exp
    from hgmm_torch.ops import em_ref
    from hgmm_torch.ops.gaussians import MixtureParams, pack_loglik_weights, precision_terms, sym_pack

    mix = lidar_mixture_np(16, seed=1, extent=scale)
    pts, w = (torch.from_numpy(a) for a in lidar_points_np(2000, mix, seed=2, extent=scale))
    p32 = MixtureParams(*(torch.from_numpy(a) for a in mix))
    p64 = MixtureParams(*(a.double() for a in p32))
    pose = (so3_exp(torch.tensor([0.0, 0.02, 0.05])), torch.tensor([0.1, -0.1, 0.02]))
    pose64 = tuple(v.double() for v in pose)
    W64 = pack_loglik_weights(p64)
    for outlier in (None, -8.0):
        got = em_ref.em_stats_direct(pts, p32, w, outlier)
        ref = em_ref.em_stats(pts.double(), W64, w.double(), outlier)
        torch.testing.assert_close(got.S, ref.S, rtol=1e-7, atol=1e-6)
        torch.testing.assert_close(got.loglik, ref.loglik, rtol=1e-9, atol=1e-6)
    A, b, _ = precision_terms(p64)
    got = em_ref.reg_stats_direct(pts, p32, pose, w, -8.0)
    ref = em_ref.reg_stats(pts.double(), W64, p64.mu, sym_pack(A), b, pose64, w.double(), None, -8.0)
    for f in got._fields:
        torch.testing.assert_close(getattr(got, f), getattr(ref, f), rtol=1e-7, atol=1e-6)
    parent = torch.randint(0, 2, (2000,), generator=torch.Generator().manual_seed(0))
    got = em_ref.em_stats_direct(pts, p32, w, None, parent, 8)
    ref = em_ref.em_stats_masked(pts.double(), W64, parent, 8, w.double())
    torch.testing.assert_close(got.S, ref.S, rtol=1e-7, atol=1e-6)


@pytest.fixture(scope="module")
def sharded_flat(same_init):
    """tests/test_odometry.py:72: the flat model through a mesh, by hgmm (its
    8 fake devices) and the port (3 ranks emulated on the CPU), and the
    port's unsharded run, on the same frames."""
    from hgmm.parallel import make_mesh
    from hgmm_torch.parallel import EmulatedMesh

    frames, gt = odometry_sequence(n_frames=3, n_scene=2000)
    kw = dict(model_kind="flat", k=16, fit_iters=8, reg_iters=12, bucket=1024, outlier_logit=None)
    ref = jodo.run_odometry(frames, jodo.OdometryConfig(**kw), mesh=make_mesh())
    got = todo.run_odometry(frames, todo.OdometryConfig(**kw, device="cpu"), mesh=EmulatedMesh(3, "cpu"))
    single = todo.run_odometry(frames, todo.OdometryConfig(**kw, device="cpu"))
    return gt, ref, got, single


def test_sharded_odometry_matches_jax_mesh(sharded_flat):
    gt, ref, got, single = sharded_flat
    for p, q, r in zip(got.abs_poses, ref.abs_poses, single.abs_poses):
        assert float(pose_delta_norm(p, to_torch_pose(q))) < 1e-3
        assert float(pose_delta_norm(p, r)) < 1e-3
    np.testing.assert_allclose(got.logliks, ref.logliks, rtol=1e-3)
    assert float(ate(got.abs_poses, gt)) < 0.05  # tests/test_odometry.py:85


def test_sharded_tree_odometry_and_refinement(runs, sharded_flat):
    """The tree model through 2 emulated ranks equals the unsharded chain;
    refine_odometry(mesh=) runs the Schur solver and equals hgmm's."""
    from hgmm.parallel import make_mesh
    from hgmm_torch.parallel import EmulatedMesh

    frames, _, _, single = runs["tree"]
    got = todo.run_odometry(frames, todo.OdometryConfig(**TREE, device="cpu"),
                            mesh=EmulatedMesh(2, "cpu"))
    for p, q in zip(got.abs_poses, single.abs_poses):
        assert float(pose_delta_norm(p, q)) < 1e-3
    _, ref, chain, _ = sharded_flat
    jr = jodo.refine_odometry(ref, n_iters=5, mesh=make_mesh())
    carried = todo.OdometryResult(abs_poses=[to_torch_pose(p) for p in ref.abs_poses],
                                  rel_poses=[to_torch_pose(p) for p in ref.rel_poses],
                                  logliks=list(ref.logliks))
    tr = todo.refine_odometry(carried, n_iters=5, mesh=EmulatedMesh(2, "cpu"))
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-3)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-3)
    dense = todo.refine_odometry(carried, n_iters=5)
    np.testing.assert_allclose(tr.t.numpy(), dense.t.numpy(), atol=1e-3)


def test_dense_refinement_warning_names_the_mesh():
    """Past 512 nodes the dense solve warns and names mesh= (hgmm/pipelines/
    odometry.py:288-292)."""
    from hgmm_torch.models.se3 import Pose

    res = todo.OdometryResult(abs_poses=[Pose.identity()] * 600, rel_poses=[Pose.identity()] * 599,
                              logliks=[])
    with pytest.warns(UserWarning, match="pass mesh= to use the distributed Schur solver"):
        todo.refine_odometry(res, n_iters=0)
